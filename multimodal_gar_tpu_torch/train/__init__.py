"""Port of multimodal_gar_tpu/train: losses, the train and eval steps, the
checkpoint manager and the training loop."""
