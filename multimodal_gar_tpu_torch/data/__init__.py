"""Port of multimodal_gar_tpu/data: the host input pipeline (numpy copies, torch collate)."""
