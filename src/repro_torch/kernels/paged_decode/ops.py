"""Paged decode attention: the checked wrapper of ``csrc/paged_decode.cu``.

For a CUDA tensor it launches the kernel (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_I, _F, _F, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_PAGE_BYTES = 8 * 256 * 16    # one head's K page: 8 16-byte loads a thread


def paged_decode_attention(q, k_arena, v_arena, page_table, lengths, *,
                           window=None, softcap=None, scale=None):
    """q: (B, H, D); arenas: (P, BLOCK, Hkv, D); page_table: (B, n_pg)
    int32 physical page per logical block; lengths: (B,) int32 valid tokens
    per row (0 = dead row: its output is zeros).  Returns (B, H, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return ref.paged_decode_attention_ref(
            q, k_arena, v_arena, page_table, lengths, window=window,
            softcap=softcap, scale=scale)
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
    if blk * D * q.element_size() > MAX_PAGE_BYTES:
        raise ValueError(f"page of {blk} x {D} too large for the kernel")
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
    fn = _build.function("paged_decode", "paged_decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             B, H, Hkv, D, P, blk, n_pg, window or 0, float(softcap or 0.0),
             float(scale), DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
