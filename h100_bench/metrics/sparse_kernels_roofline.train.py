"""The sparse kernels' share of their roofline in a training step, summed
time against summed bound: the forward (ops/kernels/window_conv.py's
x-window kernel, or K3 in subm_conv.py over index maps), K3's data
gradient and K4's weight gradient (sparse_wgrad.py);
harness.roofline_pct."""
from harness import roofline_pct

KERNELS = ("window_conv_kernel", "subm_conv_kernel", "wgrad_partial_kernel",
           "wgrad_reduce_kernel")
PARTS = ("sparse_fwd", "sparse_dgrad", "sparse_wgrad")


def read(rec):
    return roofline_pct(rec, "train", KERNELS, PARTS)
