"""The x-window sparse conv kernel's share of its roofline, the 11 layers
of a request summed (ops/kernels/window_conv.py; harness.roofline_pct)."""
from harness import roofline_pct

KERNELS = ("window_conv_kernel",)
PARTS = ("sparse_fwd",)


def read(rec):
    return roofline_pct(rec, "eval", KERNELS, PARTS)
