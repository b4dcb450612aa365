"""Dense decode attention: the checked wrapper of
``csrc/decode_attention.cu``.

For a CUDA tensor it launches the kernel (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.tickets import tickets_for

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _F, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP_DIMS = 32 * 256        # G * D: 32 acc registers a thread, 256 threads
TILE = 32              # positions per tile (kernel constant kTile)
# blocks a split-K decode aims for: two per SM of the H100's 132.  Also
# the paged decode's rule: at its serving batches (2-4 rows of 200-664
# tokens) 264 beat 132 and 512 on the card, at one row it tied 512
# (scripts/decode_splits.py)
TARGET_CTAS = 264


def split_count(B: int, Hkv: int, units: int) -> int:
    """Splits per (row, KV group) of a split-K decode over ``units`` tiles
    of keys (this kernel's 32-position tiles, the paged decode's pages):
    enough blocks to cover the card twice, never more than one a tile."""
    return max(1, min(units, -(-TARGET_CTAS // max(B * Hkv, 1))))


def n_splits(B: int, Hkv: int, S: int) -> int:
    """Position splits per (row, KV group) over an S-position cache."""
    return split_count(B, Hkv, -(-S // TILE))


def decode_attention(q, k, v, lengths, *, window=None, softcap=None,
                     scale=None):
    """q: (B, H, D); k, v: (B, S, Hkv, D) (the slot pool's layout);
    lengths: (B,) int32 valid positions per row, attended in
    [max(0, len - window), len) (0 = dead row: the kernel writes zeros).
    Returns (B, H, D).  One launch per call, on the current stream."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k, v, lengths, window=window,
                                        softcap=softcap, scale=scale)
    _build.refuse_grad("decode_attention", q, k, v)
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or t.shape != (B, S, Hkv, D):
            raise ValueError(f"{name} must be (B, S, Hkv, D) with q's dtype/device")
    if H % Hkv or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"bad heads/dim: H={H} Hkv={Hkv} D={D}")
    if (H // Hkv) * D > MAX_GROUP_DIMS:
        raise ValueError(f"{H // Hkv} query heads of {D} dims per KV head exceed "
                         f"the {MAX_GROUP_DIMS} a block holds in registers")
    if lengths.dtype != torch.int32 or lengths.device != q.device \
            or lengths.shape != (B,):
        raise TypeError(f"lengths must be (B,) int32 on {q.device}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("decode attention needs contiguous inputs")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k / v must be 16-byte aligned (16-byte loads)")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    ns = n_splits(B, Hkv, S)
    part = torch.empty((B, H, ns, D + 2), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tickets = tickets_for(q.device, stream, B * Hkv)
    fn = _build.function("decode_attention", "decode_attention", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
             part.data_ptr(), out.data_ptr(), tickets.data_ptr(),
             B, H, Hkv, S, D, ns, window or 0, float(softcap or 0.0),
             float(scale), DTYPES[q.dtype], stream)
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
