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
TILE = 32              # the paged entry's page size
SMEM_LIMIT = 232_448   # shared memory a block may use on an H100
# csrc/flash_attention.cu, tensor-core (bf16) body: keys per K/V tile and
# tiles in the cp.async ring (kKeys, kStages)
TC_KEYS, TC_STAGES = 64, 3
# scalar (float32) body: query rows a block holds and keys per tile
F32_MAX_ROWS, F32_KEYS = 64, 32


def padded_width(D: int) -> int:
    """The bf16 body's D, padded with zero columns to a multiple of 64
    (the 128-byte swizzle's width): 64, 128 or 256."""
    return 64 if D <= 64 else 128 if D <= 128 else 256


def max_rows(D: int, dtype) -> int:
    """Query rows (heads x query indices) a block holds: the bf16 body two
    64-row warpgroups, one at D > 128 (a thread's registers); the float32
    body 64."""
    if dtype == torch.float32:
        return F32_MAX_ROWS
    return 64 if padded_width(D) > 128 else 128


def smem_bytes(G: int, D: int, tq: int, dtype) -> int:
    """Dynamic shared memory of one block, as the launchers in
    csrc/flash_attention.cu size it (TcLayout::kBytes; launch_scalar)."""
    R = G * tq
    if dtype == torch.float32:
        R4 = (R + 3) & ~3
        return 4 * (2 * R4 * D + F32_KEYS * (D + 4) + F32_KEYS * D
                    + R4 * F32_KEYS + 3 * R)
    DP = padded_width(D)
    rows = 64 * -(-R // 64)                 # one or two warpgroups of 64
    return 1024 + rows * DP * 2 + TC_STAGES * 2 * TC_KEYS * DP * 2


def plan(G: int, D: int, Sq: int, dtype) -> dict:
    """Launch plan of one call: query indices per block (``tq``; all G
    heads of a KV group share the block's K/V tiles), the block's rows and
    their limit, warpgroups (bf16), threads and shared memory."""
    limit = max_rows(D, dtype)
    tq = max(1, min(Sq, limit // G))
    rows = G * tq
    return {"tq": tq, "rows": rows, "max_rows": limit,
            "threads": 256 if dtype == torch.float32 else 128 * -(-rows // 64),
            "smem": smem_bytes(G, D, tq, dtype)}


def check_heads(H: int, Hkv: int, D: int, dtype):
    """Raises on a head layout the kernel does not take: every registered
    config's (H / Hkv, D) passes (tests/test_torch_kernel_plans.py)."""
    if dtype not in DTYPES:
        raise TypeError(f"flash attention takes float32 or bfloat16, not {dtype}")
    if H % Hkv or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"bad heads/dim: H={H} Hkv={Hkv} D={D} (D a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}, H a multiple of Hkv)")
    if H // Hkv > max_rows(D, dtype):
        raise ValueError(f"{H // Hkv} query heads per KV head exceed the "
                         f"{max_rows(D, dtype)} rows a block holds at D={D}")


def _check(q, tensors, H, Hkv, D, contiguous=True):
    check_heads(H, Hkv, D, q.dtype)
    for name, t in tensors.items():
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q's dtype and device")
    if contiguous and not all(t.is_contiguous() for t in (q, *tensors.values())):
        raise ValueError("flash attention needs contiguous inputs")
    # q, K and V rows move as 16-byte copies
    row = 16 // q.element_size()
    if any(t.data_ptr() % 16 or any(st % row for st in t.stride()[:-1])
           for t in (q, *tensors.values())):
        raise ValueError("q / K / V rows must be 16-byte aligned (16-byte loads)")


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
    tq = plan(H // Hkv, D, S, q.dtype)["tq"]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, Hkv, S, Skv, D, tq, int(causal),
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
             B, Sq, H, Hkv, D, P, n_pg, plan(H // Hkv, D, Sq, q.dtype)["tq"],
             window or 0, float(softcap or 0.0), float(scale),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "paged_flash_attention")
    paged_flash_attention.launches += 1
    return out


flash_attention.launches = 0
paged_flash_attention.launches = 0
