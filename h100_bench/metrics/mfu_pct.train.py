"""The whole step's share of the chip's float32 peak (harness.mfu_pct).
A step counts no backward of the frozen I3D, which never runs."""
from harness import mfu_pct


def read(rec):
    return mfu_pct(rec, "train")
