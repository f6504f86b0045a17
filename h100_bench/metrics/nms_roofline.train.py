"""The proposal NMS kernels' share of their roofline in a Voxel R-CNN
training step (ops/kernels/nms_bev.py: the suppression words kernel and
the sweep kernel), summed time against the least time of the operations
and bytes counts/voxelrcnn.py gives from the program's NMS counters;
harness.roofline_pct. None where the program counts nothing."""
from harness import roofline_pct

KERNELS = ("nms_bev_words_kernel", "nms_sweep_kernel")
PARTS = ("nms",)


def read(rec):
    if "nms_flop" not in (rec.get("traced_counts") or {}):
        return None
    return roofline_pct(rec, "train", KERNELS, PARTS)
