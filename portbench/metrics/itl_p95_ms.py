"""Gap between successive tokens, 95th percentile over every gap of
every request inside the window (a gap that holds an admission counts
whole); milliseconds, host clock."""
from harness import readers
from harness.served import pct


def read(rec):
    gaps = readers.token_gaps_s(rec)
    return 1e3 * pct(gaps, 95) if gaps else None
