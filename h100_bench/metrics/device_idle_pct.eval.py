"""The device's idle share of a traced eval window (harness.idle_pct)."""
from harness import idle_pct


def read(rec):
    return idle_pct(rec, "eval")
