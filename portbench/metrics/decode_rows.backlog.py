"""Scheduler: mean live rows of an ``LM.decode_paged`` call in the
window (its live-row mask); rows."""
from harness import readers


def read(rec):
    rows = [len(lengths) for _, lengths in readers.decode_rows(rec)]
    return sum(rows) / len(rows) if rows else None
