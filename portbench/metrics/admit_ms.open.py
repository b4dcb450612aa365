"""Engine: mean CUDA-event span of ``RealEngine.prefill_requests`` (one
admission: its chunk steps over the whole grid); ms."""
from harness import readers


def read(rec):
    return readers.mean_ms(rec, "prefill_requests")
