"""Port of multimodal_gar_tpu/eval: the JRDB-Act evaluator."""
