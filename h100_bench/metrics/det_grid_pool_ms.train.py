"""The RoI grid pool of a Voxel R-CNN training step's forward
(models/roi_grid_pool.py: ROIGridPool over the sampled RoIs): the mean
over the traced part of the window of the program span
"voxelrcnn.grid_pool" (utils/profiling.py: span), its device time (CUDA
events), or its host time where there is no card.

This reader imports the program (``span_records``) inside ``read``, after
the checks that find nothing to read; a program without spans gives None.
"""

SPAN = "voxelrcnn.grid_pool"


def read(rec):
    if rec.get("loop") != "train":
        return None
    try:
        from multimodal_gar_tpu_torch.utils.profiling import span_records
    except ImportError:                      # a program without spans
        return None
    xs = [r["host_ms"] if r["device_ms"] is None else r["device_ms"]
          for r in span_records().records if r["name"] == SPAN]
    return sum(xs) / len(xs) if xs else None
