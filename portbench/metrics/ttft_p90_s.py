"""Time to first token, 90th percentile over every request due in the
window, from its due time (a request still without one at the close counts
the time it has waited); seconds, host clock."""
from harness import readers
from harness.served import pct


def read(rec):
    return pct(readers.ttft_s(rec), 90)
