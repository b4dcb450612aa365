"""Chunkwise mLSTM: the checked wrapper of ``csrc/mlstm.cu``.

For a CUDA tensor it launches the kernel (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 13 + [_I] * 5 + [_F, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64                 # the kernels' kMaxL
COLS = 32                      # columns of C (and of v, h) per block: kCols
MAX_SMEM = 232_448             # bytes of shared memory a block may use


def smem_bytes(L: int, dh: int) -> int:
    """The recurrent kernel's shared memory: the block's columns of C, all
    of n, the gated (L, L) scores (padded to 16 bytes), its columns of the
    v chunk, a q tile and a k tile of 32 e-columns, and five gate vectors,
    in float32."""
    return 4 * (dh * COLS + dh + -(-L * L // 4) * 4 + L * COLS + 2 * L * 32
                + 5 * L)


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, *, chunk, scale=1.0):
    """q, k, v: (B, S, H, dh) float32 or bfloat16; log_i, log_f: (B, S, H)
    float32; state: (C (B, H, dh, dh), n (B, H, dh), m (B, H)) float32 or
    None (C = n = 0, m = -1e30); chunk: the chunk length L (``min(chunk,
    S)``, ragged tail masked); scale multiplies q.  Returns h (B, S, H, dh)
    in q's dtype and the final state (C, n, m), float32."""
    if not q.is_cuda:
        return ref.mlstm_ref(q, k, v, log_i, log_f, state, chunk=chunk,
                             scale=scale)
    B, S, H, dh = q.shape
    L = min(chunk, S)
    if q.dtype not in DTYPES:
        raise TypeError(f"mlstm takes float32 or bfloat16, not {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or t.shape != q.shape:
            raise ValueError(f"{name} must match q's shape, dtype and device")
    for name, t in (("log_i", log_i), ("log_f", log_f)):
        if t.dtype != torch.float32 or t.device != q.device \
                or t.shape != (B, S, H):
            raise TypeError(f"{name} must be (B, S, H) float32 on q's device")
    if state is not None:
        for name, t, shape in zip(("C", "n", "m"), state,
                                  ((B, H, dh, dh), (B, H, dh), (B, H))):
            if t.dtype != torch.float32 or t.device != q.device \
                    or t.shape != shape or not t.is_contiguous():
                raise TypeError(f"state {name} must be contiguous {shape} "
                                "float32 on q's device")
    if S == 0 or L > MAX_CHUNK or dh % COLS or smem_bytes(L, dh) > MAX_SMEM:
        raise ValueError(f"unsupported mlstm shape: dh={dh} L={L}")
    if not all(t.is_contiguous() for t in (q, k, v, log_i, log_f)):
        raise ValueError("mlstm needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k)):
        raise ValueError("mlstm reads q and k in 16-byte loads: align them")
    n_chunks = -(-S // L)
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty_like(q)
    C, n, m = (torch.empty((B, H, dh, dh), **f32), torch.empty((B, H, dh), **f32),
               torch.empty((B, H), **f32))
    if B * H == 0:
        return h, (C, n, m)
    scores = torch.empty((B * H, n_chunks, L, L), **f32)       # scratch
    C0, n0, m0 = (None, None, None) if state is None else state
    fn = _build.function("mlstm", "mlstm", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
             log_f.data_ptr(), *(None if t is None else t.data_ptr()
                                 for t in (C0, n0, m0)),
             scores.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
             m.data_ptr(), B, S, H, dh, L, scale, DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm")
    mlstm_chunkwise.launches += 1
    return h, (C, n, m)


mlstm_chunkwise.launches = 0
