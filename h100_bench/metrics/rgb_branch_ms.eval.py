"""The RGB branch (models/rgb_backbone.py, models/i3d.py) of a request:
the mean of the span "rgb_branch" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "eval", "rgb_branch")
