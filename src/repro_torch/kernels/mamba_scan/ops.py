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


def scratch_floats(B: int, S: int, H: int, P: int, N: int, L: int) -> int:
    """Floats of the chunked path's scratch (``plan``'s "scratch"): the f32
    chunk states, the bf16 entering states and the f32 decays.  The
    float32 path writes its chunk states and decays there too, where a
    backward will read them."""
    n_chunks = -(-S // L)
    return 3 * B * H * n_chunks * N * P // 2 + B * H * n_chunks


def mamba_scan(xbar, loga, Bm, Cm, h0=None, *, chunk):
    """xbar: (B, S, H, P); loga: (B, S, H) float32; Bm, Cm: (B, S, N), the
    dtype of xbar; h0: (B, H, N, P) float32 or None (zeros); chunk: the
    chunk length L (``min(chunk, S)``, ragged tail masked).  Returns y (B, S,
    H, P) in xbar's dtype and the final state (B, H, N, P) float32.  On the
    card, where grad mode is on and an input requires grad, the call goes
    through ``MambaScan`` (the same launches, their scratch kept for the
    backward kernel)."""
    if not xbar.is_cuda:
        return ref.mamba_scan_ref(xbar, loga, Bm, Cm, h0, chunk=chunk)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (xbar, loga, Bm, Cm, h0)):
        return MambaScan.apply(xbar, loga, Bm, Cm, h0, chunk)
    return _forward(xbar, loga, Bm, Cm, h0, chunk, save=False)[:2]


def _forward(xbar, loga, Bm, Cm, h0, chunk, save):
    """One call of csrc/mamba_scan.cu -> (y, h_out, scratch): the float32
    scratch holds the chunk states and decays the backward reads where
    ``save`` (None on the boot path, which has none: its entering state is
    zero)."""
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
    n_scratch = p["scratch"] or (scratch_floats(B, S, H, P, N, L)
                                 if save and p["path"] == "scalar" else 0)
    scratch = torch.empty((n_scratch,), dtype=torch.float32, device=xbar.device) \
        if n_scratch else None
    if B * H == 0:
        return y, h_out, scratch
    fn = _build.function("mamba_scan", "mamba_scan", _ARGTYPES)
    err = fn(xbar.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             B, S, H, P, N, L, PB, DTYPES[xbar.dtype],
             torch.cuda.current_stream(xbar.device).cuda_stream)
    _build.check(err, "mamba_scan")
    mamba_scan.launches += 1
    mamba_scan.boot_launches += int(p["path"] == "boot")
    return y, h_out, scratch


mamba_scan.launches = 0
mamba_scan.boot_launches = 0           # of them, calls on the one-launch boot path


class MambaScan(torch.autograd.Function):
    """The scan with a gradient: the forward launches csrc/mamba_scan.cu and
    keeps its scratch (the chunk states and decays); the backward launches
    ``mamba_scan_bwd``.  CUDA tensors only (the CPU differentiates the
    plain version), no fallback."""

    @staticmethod
    def forward(ctx, xbar, loga, Bm, Cm, h0, chunk):
        check_bwd(xbar.shape[-1], Bm.shape[-1], min(chunk, xbar.shape[1]), xbar.dtype)
        y, h_out, scratch = _forward(xbar, loga, Bm, Cm, h0, chunk, save=True)
        ctx.save_for_backward(xbar, loga, Bm, Cm, h0, scratch)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_out

    @staticmethod
    def backward(ctx, dy, dh):
        xbar, loga, Bm, Cm, h0, scratch = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xbar)
        dx, dloga, dB, dC, dh0 = mamba_scan_bwd(
            xbar, loga, Bm, Cm, h0, scratch, dy, dh, chunk=ctx.chunk,
            want_dh0=ctx.needs_input_grad[4])
        return dx, dloga, dB, dC, dh0, None


# csrc/mamba_scan_bwd.cu: its limits (kMaxL, kMaxN, kMaxNP), the scalar
# bodies' threads and column tile (kThreads, kPT), the state pass's threads
# (kPassThreads), a [16][64] bf16 state block (kTileN)
BWD_MAX_L, BWD_MAX_N, BWD_MAX_NP = 128, 16, 2048
BWD_THREADS, BWD_PT, BWD_PASS_THREADS = 256, 32, 256
TILE_N = 16 * 128
_BWD_ARGTYPES = [_P] * 16 + [_I] * 7 + [_P]
_BWD_PLAN_ARGS = [_I] * 7 + [_P]


def check_bwd(P: int, N: int, L: int, dtype=torch.bfloat16):
    """Raises for a shape the backward kernels do not take: the scalar
    bodies' limits, and for bf16 the tensor-core kernels' (the forward's:
    N 8 or 16, P <= 128 and a multiple of 8); the wrappers refuse other
    dtypes themselves."""
    if L > BWD_MAX_L or N > BWD_MAX_N or N * P > BWD_MAX_NP:
        raise ValueError(f"the scan's backward takes L <= {BWD_MAX_L}, N <= {BWD_MAX_N} "
                         f"and N P <= {BWD_MAX_NP}, not P={P} N={N} L={L}")
    if dtype == torch.bfloat16 and (N not in (8, 16) or P > TC_MAX_P or P % 8):
        raise ValueError(f"the scan's bf16 backward takes N 8 or 16 and P <= {TC_MAX_P}, a "
                         f"multiple of 8, not P={P} N={N}")


def pass_blocks(NP: int) -> int:
    """Blocks of the bf16 state pass a (b, h): 1024 floats each."""
    return -(-NP // (4 * BWD_PASS_THREADS))


def bwd_plan(B: int, S: int, H: int, P: int, N: int, L: int, dtype=torch.bfloat16) -> dict:
    """The backward's four launches, as csrc/mamba_scan_bwd.cu makes them
    (its ``plan``): the body ("tc": bf16 on the tensor cores, grad_in_tc,
    pass_tc, chunk_grads_tc with two warpgroups where L > 64; "scalar":
    float32), each launch's grid, threads, dynamic shared memory
    ("dynamic", what ``mamba_scan_bwd_plan`` reports; the swizzled tiles'
    1024-byte alignment slack included) and all of it ("smem": static
    bytes for the scalar grad_in and pass), and its float32 scratch: G_c
    and the entering states, da, each head's dB and dC (bf16: da as the
    pass's shares, padded to 4 floats, and dH_c in bf16 after the states)."""
    n_chunks = -(-S // L)
    n_st, BH, n_bc = B * H * n_chunks * N * P, B * H, B * S * N
    per_chunk = (n_chunks, BH, 1)
    heads = {"name": "sum_heads", "grid": (-(-n_bc // BWD_THREADS), 1, 1),
             "threads": BWD_THREADS, "smem": 0, "dynamic": 0}
    if dtype == torch.bfloat16:
        nwg = 2 if L > 64 else 1
        rows = 64 * nwg
        ny = pass_blocks(N * P)
        dap = -(-BH * n_chunks * ny // 4) * 4
        # GinLayout: dy's two column blocks, (C o e)^T's blocks of 64 rows;
        # CgLayout: x and dy, C | B, h_{c-1} and dH_c, B^T and C^T, the vectors
        gin = 1024 + 2 * rows * 128 + nwg * 64 * 128
        cg = 1024 + 2 * 2 * rows * 128 + rows * 128 + 4 * TILE_N + 2 * nwg * TILE_N + 7 * rows * 4
        return {"body": "tc", "scratch": 2 * n_st + n_st // 2 + dap + 2 * BH * S * N,
                "kernels": [
                    {"name": f"grad_in_tc<{nwg}>", "grid": per_chunk, "threads": 128,
                     "smem": gin, "dynamic": gin},
                    {"name": "pass_tc", "grid": (BH, ny, 1), "threads": BWD_PASS_THREADS,
                     "smem": 4 * BWD_PASS_THREADS // 32, "dynamic": 0},
                    {"name": f"chunk_grads_tc<{nwg}>", "grid": per_chunk,
                     "threads": 128 * nwg, "smem": cg, "dynamic": cg},
                    heads]}
    ld = BWD_PT + 1
    chunk_smem = 4 * (5 * L + 2 * L * (N + 1) + L * L + 2 * L * ld + 2 * N * ld)
    return {"body": "scalar", "scratch": 2 * n_st + BH * n_chunks + 2 * BH * S * N,
            "kernels": [
                {"name": "grad_in", "grid": per_chunk, "threads": BWD_THREADS, "dynamic": 0,
                 "smem": 4 * (2 * BWD_MAX_L + BWD_MAX_L * (BWD_MAX_N + 1) + BWD_MAX_L * ld)},
                {"name": "pass_grads", "grid": (BH, 1, 1), "threads": BWD_THREADS,
                 "smem": 4 * BWD_THREADS // 32, "dynamic": 0},
                {"name": "chunk_grads", "grid": per_chunk, "threads": BWD_THREADS,
                 "smem": chunk_smem, "dynamic": chunk_smem},
                heads]}


def launch_plan(B: int, S: int, H: int, P: int, N: int, L: int, dtype) -> tuple:
    """(scratch floats, ((grid, threads, dynamic shared memory) of each
    launch)) as the built csrc/mamba_scan_bwd.cu plans a call
    (``mamba_scan_bwd_plan``), which ``bwd_plan`` mirrors.  Builds the
    library if needed."""
    out = (ctypes.c_longlong * 21)()
    fn = _build.function("mamba_scan_bwd", "mamba_scan_bwd_plan", _BWD_PLAN_ARGS)
    _build.check(fn(B, S, H, P, N, L, DTYPES[dtype], out), "mamba_scan_bwd_plan")
    v = list(out)
    return v[0], tuple((tuple(v[1 + 5 * i:4 + 5 * i]), v[4 + 5 * i], v[5 + 5 * i])
                       for i in range(4))


def mamba_scan_bwd(xbar, loga, Bm, Cm, h0, scratch, dy, dh, *, chunk, want_dh0=True):
    """The scan's gradients on the card: xbar, loga, Bm, Cm, h0 as the
    forward took them; scratch: the forward's (``_forward(..., save=True)``;
    None on the boot path); dy (B, S, H, P) in xbar's dtype; dh (B, H, N, P)
    float32 or None.  Returns (dx, dloga, dB, dC, dh0): dloga and dh0 float32,
    dh0 None without h0 or where not wanted."""
    B, S, H, P = xbar.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    check_bwd(P, N, L, xbar.dtype)
    boot = plan(B, S, H, P, N, L, xbar.dtype, h0 is not None)["path"] == "boot"
    if (scratch is None) != boot:
        raise ValueError("the scan's backward needs the forward's scratch (none on the "
                         "boot path)")
    dy = dy.contiguous()
    if dy.dtype != xbar.dtype or dy.shape != xbar.shape:
        raise TypeError("dy must have y's shape and dtype")
    if dh is not None:
        dh = dh.contiguous()
        if dh.dtype != torch.float32 or dh.shape != (B, H, N, P):
            raise TypeError("dh must be (B, H, N, P) float32")
    if any(t.data_ptr() % 16 for t in (xbar, Bm, Cm, dy)):
        raise ValueError("mamba_scan_bwd reads xbar, Bm, Cm and dy in 16-byte loads: "
                         "align them")
    n_chunks = -(-S // L)
    n_st = B * H * n_chunks * N * P
    st = dec = hin = None
    if scratch is not None:
        # the forward's chunk states, bf16 entering states (the bf16 body's
        # operand) and decays
        st, dec = scratch[:n_st], scratch[3 * n_st // 2:]
        if xbar.dtype == torch.bfloat16:
            hin = scratch[n_st:3 * n_st // 2]
    dx = torch.empty_like(xbar)
    dloga = torch.empty_like(loga)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    dh0 = torch.empty_like(h0) if h0 is not None and want_dh0 else None
    if B * H == 0:
        return dx, dloga, dB.zero_(), dC.zero_(), dh0
    work = torch.empty((bwd_plan(B, S, H, P, N, L, xbar.dtype)["scratch"],), dtype=torch.float32,
                       device=xbar.device)
    fn = _build.function("mamba_scan_bwd", "mamba_scan_bwd", _BWD_ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = fn(xbar.data_ptr(), loga.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), ptr(h0),
             ptr(st), ptr(hin), ptr(dec), dy.data_ptr(), ptr(dh), dx.data_ptr(), dloga.data_ptr(),
             dB.data_ptr(), dC.data_ptr(), ptr(dh0), work.data_ptr(),
             B, S, H, P, N, L, DTYPES[xbar.dtype],
             torch.cuda.current_stream(xbar.device).cuda_stream)
    _build.check(err, "mamba_scan_bwd")
    mamba_scan_bwd.launches += 1
    return dx, dloga, dB, dC, dh0


mamba_scan_bwd.launches = 0
