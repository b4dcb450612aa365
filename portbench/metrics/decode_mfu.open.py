"""Model step: useful FLOPs of the window's ``LM.decode_paged`` calls
over their CUDA-event spans at 989 TFLOP/s (bf16 dense peak); %."""
from harness import readers


def read(rec):
    return readers.mfu_pct(rec, prefill=False)
