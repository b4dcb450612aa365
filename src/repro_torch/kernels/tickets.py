"""Ticket counters of the split decodes' in-launch combine
(``include/split_decode.cuh``), shared by the dense and the paged decode.

One zeroed int32 buffer per (device, stream), allocated once (grown when a
call needs more) and left zero by every launch: the last live split of a
(row, KV group) resets its ticket.  Launches on one stream never overlap,
so no two launches count on the same tickets at once, whichever of the two
kernels they are."""
from __future__ import annotations

import torch

BUFFERS: dict = {}


def tickets_for(device, stream: int, n: int):
    """At least ``n`` zeroed tickets for launches on ``stream`` of ``device``."""
    key = (device, stream)
    t = BUFFERS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 2 * (0 if t is None else t.numel()), 256),
                        dtype=torch.int32, device=device)
        BUFFERS[key] = t
    return t
