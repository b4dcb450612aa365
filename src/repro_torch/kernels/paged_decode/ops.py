"""Paged decode attention: the checked wrapper of ``csrc/paged_decode.cu``.

For a CUDA tensor it launches the kernel (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ops import MAX_GROUP_DIMS, split_count
from repro_torch.kernels.paged_decode import ref
from repro_torch.kernels.tickets import tickets_for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 8 + [_I] * 9 + [_F, _F, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def n_splits(B: int, Hkv: int, n_pg: int) -> int:
    """Page splits per (row, KV group): the dense decode's rule
    (``decode_attention.ops.split_count``), a page for its tile."""
    return split_count(B, Hkv, n_pg)


def split_spans(length: int, window, n_pg: int, splits: int, blk: int = 32,
                positions=None):
    """Tiles ``[begin, end)`` each split of a row reads, as
    include/split_decode.cuh computes them on the device (the lines from
    ``first`` to ``n`` of decode_kernel), for the paged decode (a tile is
    a page, ``n_pg`` the table width) and the dense one (a tile is 32
    positions, ``n_pg`` the cache's tiles): the row's visible tiles, from
    the one holding ``length - window`` to the one holding its last
    position (a length past the row's ``positions``, by default ``n_pg *
    blk``, is clamped to it), cut into ``splits`` spans of ``ceil(visible
    / splits)`` tiles; a span past the visible range is empty (``end ==
    begin``), and the non-empty ones come first."""
    first = max(0, length - window) if window and window > 0 else 0
    length = min(length, n_pg * blk if positions is None else positions)
    vis_lo = first // blk
    vis_hi = -(-length // blk) if length > first else vis_lo
    per = -(-(vis_hi - vis_lo) // splits)
    spans = []
    for sp in range(splits):
        begin = vis_lo + sp * per
        spans.append((begin, begin + max(0, min(begin + per, vis_hi) - begin)))
    return spans


def paged_decode_attention(q, k_arena, v_arena, page_table, lengths, *,
                           window=None, softcap=None, scale=None):
    """q: (B, H, D); arenas: (P, BLOCK, Hkv, D); page_table: (B, n_pg)
    int32 physical page per logical block; lengths: (B,) int32 valid tokens
    per row (0 = dead row: its output is zeros).  Returns (B, H, D).  One
    launch per call, on the current stream."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(
            q, k_arena, v_arena, page_table, lengths, window=window,
            softcap=softcap, scale=scale)
    _build.refuse_grad("paged_decode_attention", q, k_arena, v_arena)
    B, H, D = q.shape
    P, blk, Hkv, _ = k_arena.shape
    n_pg = page_table.shape[1]
    if q.dtype not in DTYPES:
        raise TypeError(f"paged decode takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena)):
        if t.dtype != q.dtype or t.device != q.device or t.shape != k_arena.shape:
            raise ValueError(f"{name} must match q's dtype/device and k_arena's shape")
    if H % Hkv or D > MAX_HEAD_DIM or D % 8 or k_arena.shape[3] != D:
        raise ValueError(f"bad heads/dim: H={H} Hkv={Hkv} D={D}")
    if (H // Hkv) * D > MAX_GROUP_DIMS:
        raise ValueError(f"{H // Hkv} query heads of {D} dims per KV head exceed "
                         f"the {MAX_GROUP_DIMS} a block holds in registers")
    for name, t in (("page_table", page_table), ("lengths", lengths)):
        if t.dtype != torch.int32 or t.device != q.device:
            raise TypeError(f"{name} must be int32 on {q.device}")
    if page_table.shape[0] != B or lengths.shape != (B,):
        raise ValueError("page_table / lengths batch does not match q")
    if not all(t.is_contiguous() for t in (q, k_arena, v_arena, page_table,
                                            lengths)):
        raise ValueError("paged decode needs contiguous inputs")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("arenas must be 16-byte aligned (16-byte loads)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    ns = n_splits(B, Hkv, n_pg)
    part = torch.empty((B, H, ns, D + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = tickets_for(q.device, stream, B * Hkv)
    fn = _build.function("paged_decode", "paged_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             part.data_ptr(), tickets.data_ptr(),
             B, H, Hkv, D, P, blk, n_pg, ns, window or 0,
             float(softcap or 0.0), float(scale), DTYPES[q.dtype], stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
