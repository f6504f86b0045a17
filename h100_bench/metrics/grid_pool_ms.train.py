"""The ROIGridPool forward of a training step:
the mean of the span "grid_pool" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "train", "grid_pool")
