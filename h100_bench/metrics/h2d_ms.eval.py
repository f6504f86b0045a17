"""The clip's transfer to the device (Batch.to) of a request:
the mean of the span "h2d" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "eval", "h2d")
