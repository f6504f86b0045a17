"""The I3D stem kernel's share of its roofline in a request
(ops/kernels/stem_conv.py; harness.roofline_pct)."""
from harness import roofline_pct

KERNELS = ("stem_conv_kernel",)
PARTS = ("stem",)


def read(rec):
    return roofline_pct(rec, "eval", KERNELS, PARTS)
