"""What a training step does after the forward: the losses, the
backward, the non-finite guard and the update:
the mean of the span "after_forward" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "train", "after_forward")
