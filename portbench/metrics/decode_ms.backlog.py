"""Model step: mean CUDA-event span of ``LM.decode_paged``; ms."""
from harness import readers


def read(rec):
    return readers.mean_ms(rec, "decode_paged")
