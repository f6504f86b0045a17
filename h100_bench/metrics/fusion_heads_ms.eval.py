"""Fusion and heads (models/fusion.py, models/mgar.py: GARFusionNet) of
a request:
the mean of the span "fusion_heads" over the window (harness.span_mean_ms)."""
from harness import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "eval", "fusion_heads")
