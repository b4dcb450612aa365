"""Device: share of the traced window in which no kernel or copy ran; %."""
from harness import readers


def read(rec):
    return readers.idle_pct(rec)
