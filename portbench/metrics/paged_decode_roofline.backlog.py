"""Kernels: the paged decode at its roofline: the least time its launches
need (live rows, real heads) over their device time; %."""
from harness import readers

KERNELS = readers.PAGED_DECODE


def read(rec):
    return readers.decode_roofline_pct(rec, KERNELS)
