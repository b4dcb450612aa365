"""Chunked SSD scan: the checked wrapper of ``csrc/mamba_scan.cu``.

For a CUDA tensor it launches the kernel (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                  # the kernel's block
MAX_COLS = 64                  # columns of P per block
MAX_SMEM = 232_448             # bytes of shared memory a block may use


def smem_bytes(L: int, N: int, PB: int) -> int:
    """The kernel's shared memory: loga, its cumsum and decays, B, C, the
    block's columns of the xbar chunk, the (L, L) decay-masked C.B^T and
    its columns of the state, in f32."""
    return 4 * (3 * L + L * (N + 1) + L * N + L * PB + L * L + N * PB)


def mamba_scan(xbar, loga, Bm, Cm, h0=None, *, chunk):
    """xbar: (B, S, H, P); loga: (B, S, H) float32; Bm, Cm: (B, S, N), the
    dtype of xbar; h0: (B, H, N, P) float32 or None (zeros); chunk: the
    chunk length L (``min(chunk, S)``, ragged tail masked).  Returns y (B, S,
    H, P) in xbar's dtype and the final state (B, H, N, P) float32."""
    if not xbar.is_cuda:
        return ref.mamba_scan_ref(xbar, loga, Bm, Cm, h0, chunk=chunk)
    B, S, H, P = xbar.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    if xbar.dtype not in DTYPES:
        raise TypeError(f"mamba scan takes float32 or bfloat16, not {xbar.dtype}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.dtype != xbar.dtype or t.device != xbar.device or t.shape != (B, S, N):
            raise ValueError(f"{name} must be (B, S, N) with xbar's dtype and device")
    if loga.dtype != torch.float32 or loga.device != xbar.device \
            or loga.shape != (B, S, H):
        raise TypeError("loga must be (B, S, H) float32 on xbar's device")
    if h0 is not None and (h0.dtype != torch.float32 or h0.device != xbar.device
                           or h0.shape != (B, H, N, P) or not h0.is_contiguous()):
        raise TypeError("h0 must be contiguous (B, H, N, P) float32 on xbar's device")
    PB = min(P, MAX_COLS)
    if S == 0 or P % PB or THREADS % PB or smem_bytes(L, N, PB) > MAX_SMEM:
        raise ValueError(f"unsupported scan shape: P={P} N={N} L={L}")
    if not all(t.is_contiguous() for t in (xbar, loga, Bm, Cm)):
        raise ValueError("mamba scan needs contiguous inputs")
    y = torch.empty_like(xbar)
    h_out = torch.empty((B, H, N, P), dtype=torch.float32, device=xbar.device)
    if B * H == 0:
        return y, h_out
    fn = _build.function("mamba_scan", "mamba_scan", _ARGTYPES)
    err = fn(xbar.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h_out.data_ptr(), B, S, H, P, N, L, PB, DTYPES[xbar.dtype],
             torch.cuda.current_stream(xbar.device).cuda_stream)
    _build.check(err, "mamba_scan")
    mamba_scan.launches += 1
    return y, h_out


mamba_scan.launches = 0
