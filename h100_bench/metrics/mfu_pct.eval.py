"""The whole request's share of the chip's float32 peak (harness.mfu_pct)."""
from harness import mfu_pct


def read(rec):
    return mfu_pct(rec, "eval")
