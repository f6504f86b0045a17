"""Port of multimodal_gar_tpu/parallel: the ('data', 'fsdp') mesh over
``torch.distributed`` (mesh.py) and the cross-process collectives of
evaluation and logging (multihost.py)."""
