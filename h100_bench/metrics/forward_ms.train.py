"""The model's forward of a training step:
the mean of the span "forward" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "train", "forward")
