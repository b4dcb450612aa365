"""Scheduler: due time to the admitting ``prefill_requests`` call, 90th
percentile over the requests due in the window; seconds."""
from harness import readers
from harness.served import pct


def read(rec):
    return pct(readers.queue_wait_s(rec), 90) if rec.spans else None
