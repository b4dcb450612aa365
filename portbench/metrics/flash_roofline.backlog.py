"""Kernels: the paged flash entry (prefill chunks) at its roofline: the
least time its launches need (live rows, real tokens, real heads) over
their device time; %."""
from harness import readers

KERNELS = readers.FLASH_PAGED


def read(rec):
    return readers.flash_roofline_pct(rec, KERNELS)
