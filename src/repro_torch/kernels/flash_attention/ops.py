"""Flash attention: the checked wrappers of ``csrc/flash_attention.cu``.

``flash_attention`` is the dense entry (the function of the TPU kernel);
``paged_flash_attention`` reads K/V from the paged arena and carries the
serving path's prefill chunks and speculative verify windows.  For a CUDA
tensor each launches the kernel (no fallback); for a CPU tensor each runs
its plain version in ``ref.py``."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.c_longlong * 3
_DENSE_ARGS = [_P] * 4 + [_I] * 9 + [_F, _F] \
    + [ctypes.POINTER(ctypes.c_longlong)] * 3 + [_I, _P]
_PAGED_ARGS = [_P] * 7 + [_I] * 9 + [_F, _F, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_ROWS = 64          # query rows (heads x query indices) per block
TILE = 32              # keys per tile; the paged entry's page size


def _query_tile(G: int, Sq: int) -> int:
    """Query indices per block: all G heads of a KV group share the block's
    K/V tiles, up to MAX_ROWS rows."""
    return max(1, min(Sq, MAX_ROWS // G))


def _check(q, tensors, H, Hkv, D, contiguous=True):
    if q.dtype not in DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, not {q.dtype}")
    for name, t in tensors.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if H % Hkv or D > MAX_HEAD_DIM or D % 8 or H // Hkv > MAX_ROWS:
        raise ValueError(f"bad heads/dim: H={H} Hkv={Hkv} D={D}")
    if contiguous and not all(t.is_contiguous() for t in (q, *tensors.values())):
        raise ValueError("flash attention needs contiguous inputs")
    # K/V rows move as 16-byte loads
    row = 16 // q.element_size()
    if any(t.data_ptr() % 16 or any(st % row for st in t.stride()[:-1])
           for t in tensors.values()):
        raise ValueError("K/V rows must be 16-byte aligned (16-byte loads)")


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    scale=None):
    """q: (B, H, S, D); k, v: (B, Hkv, Skv, D) -> (B, H, S, D).  Any
    strides with the D elements of each tensor contiguous (k and v sharing
    theirs), so (B, S, H, D) tensors can come in as ``transpose(1, 2)``
    views; the output has q's layout."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _check(q, {"k": k, "v": v}, H, Hkv, D, contiguous=False)
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError("k / v shape does not match q")
    if v.stride() != k.stride() or any(t.stride(-1) != 1 for t in (q, k)):
        raise ValueError("k and v must share strides, each with unit stride along D")
    out = torch.empty_like(q)      # q's layout where q is a dense permutation
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "flash_attention", _DENSE_ARGS)
    bsh = lambda t: _STRIDES(t.stride(0), t.stride(2), t.stride(1))  # noqa: E731
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, Hkv, S, Skv, D, _query_tile(H // Hkv, S), int(causal),
             window or 0, float(softcap or 0.0), float(scale),
             bsh(q), bsh(out), bsh(k),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


def paged_flash_attention(q, k_arena, v_arena, page_table, pos0, active=None,
                          *, window=None, softcap=None, scale=None):
    """q: (B, Sq, H, D), query i of row b at position pos0[b] + i; arenas:
    (P, BLOCK, Hkv, D); page_table: (B, n_pg) int32; pos0: (B,) int32;
    active: (B,) bool or None (a dead row's output is zeros).  Causal
    attention over the row's pages -> (B, Sq, H, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return ref.paged_attention_ref(q, k_arena, v_arena, page_table, pos0,
                                       active, window=window, softcap=softcap,
                                       scale=scale)
    B, Sq, H, D = q.shape
    P, blk, Hkv, _ = k_arena.shape
    n_pg = page_table.shape[1]
    _check(q, {"k_arena": k_arena, "v_arena": v_arena}, H, Hkv, D)
    if v_arena.shape != k_arena.shape or k_arena.shape[3] != D or blk != TILE:
        raise ValueError(f"arena must be (P, {TILE}, Hkv, {D}) like k_arena")
    for name, t in (("page_table", page_table), ("pos0", pos0)):
        if t.dtype != torch.int32 or t.device != q.device or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous int32 on {q.device}")
    if page_table.shape[0] != B or pos0.shape != (B,):
        raise ValueError("page_table / pos0 batch does not match q")
    act = None
    if active is not None:
        if active.shape != (B,) or active.device != q.device:
            raise ValueError("active must be (B,) on q's device")
        act = active.to(torch.int32)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("flash_attention", "paged_flash_attention",
                         _PAGED_ARGS)
    err = fn(q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
             page_table.data_ptr(), pos0.data_ptr(),
             None if act is None else act.data_ptr(), out.data_ptr(),
             B, Sq, H, Hkv, D, P, n_pg, _query_tile(H // Hkv, Sq),
             window or 0, float(softcap or 0.0), float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_flash_attention")
    paged_flash_attention.launches += 1
    return out


flash_attention.launches = 0
paged_flash_attention.launches = 0
