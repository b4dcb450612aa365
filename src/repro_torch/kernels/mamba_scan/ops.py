"""Chunked SSD scan: the checked wrapper of ``csrc/mamba_scan.cu``.

For a CUDA tensor it launches the kernels (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mamba_scan import ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256                  # the scalar kernel's block (and the state pass's)
MAX_COLS = 64                  # columns of P per scalar block
MAX_SMEM = 232_448             # bytes of shared memory a block may use
TC_MAX_L, TC_MAX_N, TC_MAX_P = 128, 16, 128  # shapes the tensor-core kernels take
SPLIT_BELOW = 264              # chunk units under which a unit is one
                               # 64-column group of P: kSplitBelow
BLOCKS_PER_SM = 2              # resident chunk blocks an SM: kBlocksPerSm
SMS = 132                      # an H100's streaming multiprocessors (the
                               # kernel asks the device; the plan assumes it)
SM_SMEM = 233_472              # shared memory of an SM (1 KB a block reserved)


def smem_bytes(L: int, N: int, PB: int) -> int:
    """The scalar kernel's shared memory: loga, its cumsum and decays, B, C,
    the block's columns of the xbar chunk, the (L, L) decay-masked C.B^T and
    its columns of the state, in f32."""
    return 4 * (3 * L + L * (N + 1) + L * N + L * PB + L * L + N * PB)


def tc_smem_bytes(nwg: int) -> int:
    """``TcLayout<NWG>::kBytes``: two stages of xbar (two 64-column blocks
    of 64 NWG rows), the C | B tile and the entering state (two 16-row
    blocks), three f32 step vectors, and the 1024-byte alignment slack."""
    rows = 64 * nwg
    stage = 2 * rows * 128 + rows * 128 + 2 * TC_MAX_N * 128
    return 1024 + 2 * stage + 3 * rows * 4


def plan(B: int, S: int, H: int, P: int, N: int, L: int, dtype, has_h0: bool) -> dict:
    """The launches of one call, as csrc/mamba_scan.cu makes them: the path
    ("boot": bf16, no start state, one chunk; "chunked": bf16 chunk states,
    state passing, chunk outputs; "scalar": float32) and each kernel's grid,
    threads and shared memory (dynamic bytes, the alignment slack included;
    a chunk kernel's grid is its blocks, each walking an equal share of its
    units), and the float32 scratch the chunked path needs."""
    n_chunks = -(-S // L)
    if dtype == torch.bfloat16:
        nwg = 2 if L > 64 else 1
        # units (b * H + h, chunk, column group); blocks of an equal share
        n_cb = -(-P // 64)
        ncb = n_cb if n_cb > 1 and n_chunks * B * H >= SPLIT_BELOW else 1
        units = (B * H, n_chunks, n_cb // ncb)
        n_units = B * H * n_chunks * (n_cb // ncb)
        per_block = -(-n_units // (BLOCKS_PER_SM * SMS))
        chunk = {"threads": 128 * nwg, "grid": (-(-n_units // per_block),), "units": units,
                 "smem": tc_smem_bytes(nwg), "cols": 64 * ncb}
        if not has_h0 and S <= L:
            return {"path": "boot", "scratch": 0,
                    "kernels": [{"name": f"chunk_tc<{nwg},kBoot>", **chunk}]}
        # f32 chunk states, bf16 entering states, f32 decays
        return {"path": "chunked",
                "scratch": 3 * B * H * n_chunks * N * P // 2 + B * H * n_chunks,
                "kernels": [{"name": f"chunk_tc<{nwg},kStates>", **chunk},
                            {"name": "pass_states", "threads": THREADS, "smem": 0,
                             "grid": (B * H, -(-N * P // (4 * THREADS)))},
                            {"name": f"chunk_tc<{nwg},kOutputs>", **chunk}]}
    PB = min(P, MAX_COLS)
    return {"path": "scalar", "scratch": 0,
            "kernels": [{"name": "scan_kernel", "threads": THREADS, "grid": (B * H, P // PB),
                         "smem": smem_bytes(L, N, PB), "cols": PB}]}


def mamba_scan(xbar, loga, Bm, Cm, h0=None, *, chunk):
    """xbar: (B, S, H, P); loga: (B, S, H) float32; Bm, Cm: (B, S, N), the
    dtype of xbar; h0: (B, H, N, P) float32 or None (zeros); chunk: the
    chunk length L (``min(chunk, S)``, ragged tail masked).  Returns y (B, S,
    H, P) in xbar's dtype and the final state (B, H, N, P) float32."""
    if not xbar.is_cuda:
        return ref.mamba_scan_ref(xbar, loga, Bm, Cm, h0, chunk=chunk)
    _build.refuse_grad("mamba_scan", xbar, loga, Bm, Cm, h0)
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
    if S == 0:
        raise ValueError("mamba scan needs at least one step")
    p = plan(B, S, H, P, N, L, xbar.dtype, h0 is not None)
    if p["path"] == "scalar":
        PB = p["kernels"][0]["cols"]
        if P % PB or THREADS % PB or p["kernels"][0]["smem"] > MAX_SMEM:
            raise ValueError(f"unsupported scan shape: P={P} N={N} L={L}")
    else:
        PB = 0
        if L > TC_MAX_L or N not in (8, 16) or P > TC_MAX_P or P % 8:
            raise ValueError(f"unsupported bf16 scan shape: P={P} N={N} L={L} (the "
                             f"tensor-core kernels take L <= {TC_MAX_L}, N 8 or 16, "
                             f"P <= {TC_MAX_P} and a multiple of 8)")
        if any(t.data_ptr() % 16 for t in (xbar, Bm, Cm)) \
                or (h0 is not None and h0.data_ptr() % 16):
            raise ValueError("the scan's tensor-core kernels read xbar, Bm, Cm and h0 "
                             "in 16-byte loads: align them")
    if not all(t.is_contiguous() for t in (xbar, loga, Bm, Cm)):
        raise ValueError("mamba scan needs contiguous inputs")
    y = torch.empty_like(xbar)
    h_out = torch.empty((B, H, N, P), dtype=torch.float32, device=xbar.device)
    if B * H == 0:
        return y, h_out
    scratch = torch.empty((p["scratch"],), dtype=torch.float32, device=xbar.device) \
        if p["scratch"] else None
    fn = _build.function("mamba_scan", "mamba_scan", _ARGTYPES)
    err = fn(xbar.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             B, S, H, P, N, L, PB, DTYPES[xbar.dtype],
             torch.cuda.current_stream(xbar.device).cuda_stream)
    _build.check(err, "mamba_scan")
    mamba_scan.launches += 1
    mamba_scan.boot_launches += int(p["path"] == "boot")
    return y, h_out


mamba_scan.launches = 0
mamba_scan.boot_launches = 0           # of them, calls on the one-launch boot path
