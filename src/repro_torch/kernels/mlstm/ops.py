"""Chunkwise mLSTM: the checked wrapper of ``csrc/mlstm.cu``.

For a CUDA tensor it launches the kernel (no fallback); for a CPU tensor it
runs the plain version in ``ref.py``."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.mlstm import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P] * 13 + [_I] * 6 + [_F, _I, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64                 # the kernels' kMaxL
MAX_HEAD_DIM = 1024            # 16 e-tiles: four warpgroups of four
COLS = 32                      # columns of C (and of v, h) per recurrent block: kCols
TILE = 64 * 64 * 2             # a swizzled 64 x 64 bf16 tile of q or k: kTile
SCORE_STAGES, BOOT_STAGES = 4, 3  # q/k tile pairs in the scores rings: kScoreStages, kBootStages
BOOT_COLS, BOOT_ETILES = 64, 4  # a boot block's columns and e-tiles: kBootF, kBootE
MAX_SMEM = 232_448             # bytes of shared memory a block may use


def _gate_smem(threads: int) -> int:
    """Static shared memory of the gates (``GateSmem``): five step vectors,
    two chunk-summary vectors of one float a thread, the carried m."""
    return 4 * (5 * MAX_CHUNK + 2 * threads + 1)


def record_floats(L: int) -> int:
    """Floats of a chunk's record (m_new, inter, w, rowsum, then att), padded
    to 16 bytes: ``record_floats`` in csrc/mlstm.cu."""
    return -(-(L * L + 4 * L) // 4) * 4


def warpgroups(dh: int):
    """(warpgroups, e-tiles each) of the bf16 recurrent block: enough
    64-row tiles of C for dh, at most four warpgroups of four
    (``launch_bf16`` in csrc/mlstm.cu)."""
    n_et = -(-dh // 64)
    return (1, 1) if n_et <= 1 else (2, 1) if n_et <= 2 else (4, -(-n_et // 4))


def plan(B: int, S: int, H: int, dh: int, L: int, dtype, has_state: bool,
         dv: int = None) -> dict:
    """The launches of one call, as csrc/mlstm.cu makes them: the path
    ("boot": bf16, no state, one chunk; "chunked": bf16 scores and
    recurrent kernels on the tensor cores; "scalar": float32) and each
    kernel's grid, threads and shared memory (static plus dynamic bytes,
    the alignment slack of the swizzled tiles included).  ``dv``: v's
    columns (default ``dh``), which the column blocks split."""
    dv = dh if dv is None else dv
    n_chunks, n_et = -(-S // L), -(-dh // 64)
    if dtype == torch.bfloat16:
        if not has_state and S <= L:
            # the e-groups' blocks of C', then one block of h per 64 columns
            return {"path": "boot", "kernels": [{
                "name": "boot_tc", "threads": 128,
                "grid": (B * H, -(-dv // BOOT_COLS), -(-n_et // BOOT_ETILES) + 1),
                "smem": 1024 + BOOT_STAGES * 2 * TILE + BOOT_COLS * 128
                + _gate_smem(128)}]}
        nwg, mt = warpgroups(dh)
        # RecLayout: the q/k rings, v^T and two chunks' v, the C^T pairs,
        # the partial sums of q C and q n, two chunks' gates, att, n
        recurrent = (1024 + nwg * 2 * 2 * TILE + COLS * 128 + 2 * 64 * COLS * 2
                     + nwg * 2 * COLS * 128
                     + 4 * ((nwg - 1) * 64 * COLS + nwg * 64 + 2 * 4 * MAX_CHUNK
                            + MAX_CHUNK * MAX_CHUNK + nwg * mt * 64))
        return {"path": "chunked", "kernels": [
            {"name": "scores_tc", "grid": (n_chunks, B * H), "threads": 128,
             "smem": 1024 + SCORE_STAGES * 2 * TILE + _gate_smem(128)},
            {"name": f"recurrent_tc<{nwg},{mt}>", "grid": (B * H, dv // COLS),
             "threads": 128 * nwg, "smem": recurrent}]}
    return {"path": "scalar", "kernels": [
        {"name": "scores_kernel", "grid": (n_chunks, B * H), "threads": 256,
         "smem": 4 * 2 * MAX_CHUNK * (32 + 1) + _gate_smem(256)},
        {"name": "recurrent_kernel", "grid": (B * H, dv // COLS), "threads": 256,
         "smem": 4 * (dh * COLS + dh + -(-L * L // 4) * 4 + L * COLS
                      + 2 * L * 32 + 4 * L)}]}


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, *, chunk, scale=1.0):
    """q, k: (B, S, H, dh) float32 or bfloat16; v: (B, S, H, dv), dv <= dh
    (a tensor-parallel rank's value columns of every head; dv = dh
    unsplit); log_i, log_f: (B, S, H) float32; state: (C (B, H, dh, dv), n
    (B, H, dh), m (B, H)) float32 or None (C = n = 0, m = -1e30); chunk:
    the chunk length L (``min(chunk, S)``, ragged tail masked); scale
    multiplies q.  Returns h (B, S, H, dv) in q's dtype and the final state
    (C, n, m), float32.  On the card,
    where grad mode is on and an input requires grad, the call goes through
    ``MLSTM`` (the same launches; its backward is ``mlstm_bwd``)."""
    if not q.is_cuda:
        return ref.mlstm_ref(q, k, v, log_i, log_f, state, chunk=chunk,
                             scale=scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (q, k, v, log_i, log_f, *(state or ()))):
        h, C, n, m = MLSTM.apply(q, k, v, log_i, log_f, *(state or (None,) * 3),
                                 chunk, scale)
        return h, (C, n, m)
    return _forward(q, k, v, log_i, log_f, state, chunk, scale)


def _forward(q, k, v, log_i, log_f, state, chunk, scale):
    """One call of csrc/mlstm.cu -> (h, (C, n, m))."""
    B, S, H, dh = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    if q.dtype not in DTYPES:
        raise TypeError(f"mlstm takes float32 or bfloat16, not {q.dtype}")
    for name, t, shape in (("k", k, q.shape), ("v", v, (B, S, H, dv))):
        if t.dtype != q.dtype or t.device != q.device or t.shape != shape:
            raise ValueError(f"{name} must match q's dtype and device, and its shape "
                             "but for v's columns")
    for name, t in (("log_i", log_i), ("log_f", log_f)):
        if t.dtype != torch.float32 or t.device != q.device \
                or t.shape != (B, S, H):
            raise TypeError(f"{name} must be (B, S, H) float32 on q's device")
    if state is not None:
        for name, t, shape in zip(("C", "n", "m"), state,
                                  ((B, H, dh, dv), (B, H, dh), (B, H))):
            if t.dtype != torch.float32 or t.device != q.device \
                    or t.shape != shape or not t.is_contiguous():
                raise TypeError(f"state {name} must be contiguous {shape} "
                                "float32 on q's device")
    if S == 0 or L > MAX_CHUNK or dh % COLS or dh > MAX_HEAD_DIM or dv % COLS \
            or not 0 < dv <= dh:
        raise ValueError(f"unsupported mlstm shape: dh={dh} dv={dv} L={L}")
    p = plan(B, S, H, dh, L, q.dtype, state is not None, dv)
    if any(kn["smem"] > MAX_SMEM for kn in p["kernels"]):
        raise ValueError(f"mlstm's shared memory exceeds the card's at dh={dh} L={L}")
    if not all(t.is_contiguous() for t in (q, k, v, log_i, log_f)):
        raise ValueError("mlstm needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm reads q, k and v in 16-byte loads: align them")
    n_chunks = -(-S // L)
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty_like(v)
    C, n, m = (torch.empty((B, H, dh, dv), **f32), torch.empty((B, H, dh), **f32),
               torch.empty((B, H), **f32))
    if B * H == 0:
        return h, (C, n, m)
    # the per-chunk records of the scores kernels (not on the boot path)
    rec = None if p["path"] == "boot" else \
        torch.empty((B * H, n_chunks, record_floats(L)), **f32)
    C0, n0, m0 = (None, None, None) if state is None else state
    fn = _build.function("mlstm", "mlstm", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(),
             log_f.data_ptr(), *(None if t is None else t.data_ptr()
                                 for t in (C0, n0, m0, rec)),
             h.data_ptr(), C.data_ptr(), n.data_ptr(),
             m.data_ptr(), B, S, H, dh, dv, L, scale, DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm")
    mlstm_chunkwise.launches += 1
    mlstm_chunkwise.boot_launches += int(p["path"] == "boot")
    return h, (C, n, m)


mlstm_chunkwise.launches = 0
mlstm_chunkwise.boot_launches = 0      # of them, calls on the boot path


class MLSTM(torch.autograd.Function):
    """The mLSTM with a gradient: the forward launches csrc/mlstm.cu and
    saves its inputs and final state; the backward launches ``mlstm_bwd``
    (which recomputes the entering states itself).  CUDA tensors only (the
    CPU differentiates the plain version), no fallback."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C0, n0, m0, chunk, scale):
        check_bwd(q.shape[-1], min(chunk, q.shape[1]), q.dtype, v.shape[-1])
        state = None if C0 is None else (C0, n0, m0)
        h, (C, n, m) = _forward(q, k, v, log_i, log_f, state, chunk, scale)
        ctx.save_for_backward(q, k, v, log_i, log_f, C0, n0, m0, C, n)
        ctx.args = (chunk, scale)
        ctx.set_materialize_grads(False)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, log_i, log_f, C0, n0, m0, C, n = ctx.saved_tensors
        chunk, scale = ctx.args
        state = None if C0 is None else (C0, n0, m0)
        if dh is None:
            dh = torch.zeros_like(v)
        dq, dk, dv, dli, dlf, dstate = mlstm_bwd(
            q, k, v, log_i, log_f, state, dh, (dC, dn, dm), (C, n), chunk=chunk,
            scale=scale, want_dstate=any(ctx.needs_input_grad[5:8]))
        return (dq, dk, dv, dli, dlf, *(dstate or (None,) * 3), None, None)


# csrc/mlstm_bwd.cu: its sweeps' block of 32 rows or columns of C and tile
# width (kCols), the scalar bodies' threads (kThreads), the per-chunk
# record's vectors (kVecs); the tensor-core sweeps' warpgroups and 64-row
# tiles each (kWg, kMt), prep_tc's ring (kPrepStages)
BWD_THREADS, BWD_COLS, BWD_VECS = 256, 32, 9
BWD_WG, BWD_MT, BWD_PREP_STAGES = 4, 4, 4
_BWD_ARGTYPES = [_P] * 23 + [_I] * 6 + [_F, _I, _P]
_BWD_PLAN_ARGS = [_I] * 7 + [_P]
HALF = 32 * 128                # a [32][64] bf16 tile: kHalf


def check_bwd(dh: int, L: int, dtype=torch.bfloat16, dv: int = None):
    """Raises for a shape the backward kernels (``dtype``'s body: the
    tensor-core one for bf16, else the scalar one) do not take; the
    wrappers refuse other dtypes themselves."""
    dv = dh if dv is None else dv
    if L > MAX_CHUNK or dh % COLS or dh > MAX_HEAD_DIM or dv % COLS or not 0 < dv <= dh:
        raise ValueError(f"unsupported mlstm backward shape: dh={dh} dv={dv} L={L}")
    p = bwd_plan(1, L, 1, dh, L, dtype, dv)
    if any(kn["smem"] > MAX_SMEM for kn in p["kernels"]):
        raise ValueError(f"unsupported mlstm backward shape: dh={dh} dv={dv} L={L}")


def cst_floats(dh: int, dtype, dv: int = None) -> int:
    """Floats of a chunk's entering C in the scratch: float32 (dh, dv) for
    the scalar bodies; for the tensor-core ones bf16 tiles of 32 rows x 64
    columns, [dh / 32][ceil(dv / 64)] of them (``cst_tc_floats``)."""
    dv = dh if dv is None else dv
    if dtype != torch.bfloat16:
        return dh * dv
    return (dh // BWD_COLS) * -(-dv // 64) * 32 * 64 // 2


def bwd_plan(B: int, S: int, H: int, dh: int, L: int, dtype=torch.bfloat16,
             dv: int = None) -> dict:
    """The backward's six launches, as csrc/mlstm_bwd.cu makes them (its
    ``plan``): the body ("tc": bf16 on the tensor cores, prep_tc, states_tc,
    rows_tc and cols_tc; "scalar": float32), each launch's grid, threads,
    dynamic shared memory ("dynamic", what ``mlstm_bwd_plan`` reports) and
    all of it ("smem": static bytes for prep, prep_tc and steps, the
    swizzled tiles' 1024-byte alignment slack included); and its float32
    scratch in ``carve``'s order: the records, the entering C and n, X's
    shares (a column block each), dw's and d inter_L's (a row block each),
    and the row blocks' shares of the final and start states' dot products.
    ``dv``: v's columns (default ``dh``): the states and column sweeps have
    a block per 32 of them, the row sweep one per 32 rows of dh."""
    dv = dh if dv is None else dv
    nc, nck, ncv, BH = -(-S // L), dh // BWD_COLS, dv // BWD_COLS, B * H
    rec = -(-(BWD_VECS * L + 3 * L * L) // 4) * 4
    scratch = BH * nc * (rec + cst_floats(dh, dtype, dv) + dh + ncv * L + nck * L + nck) \
        + 2 * BH * nck
    per_chunk, by_cols, by_rows = (nc, BH, 1), (BH, ncv, 1), (BH, nck, 1)
    steps = {"name": "steps", "grid": per_chunk, "threads": BWD_THREADS, "dynamic": 0,
             "smem": 4 * (MAX_CHUNK * (MAX_CHUNK + 1) + 3 * MAX_CHUNK)}
    gates = {"name": "gate_grads", "grid": per_chunk, "threads": MAX_CHUNK, "dynamic": 0,
             "smem": 4 * 5 * MAX_CHUNK + 8}
    if dtype == torch.bfloat16:
        wg, mt, tc = BWD_WG, BWD_MT, 128 * BWD_WG
        n_max = wg * mt * 64
        # StatesLayout: the q/k rings, v^T, two chunks' v and dh, the C^T
        # pairs, the q C partials, the q n partials, two chunks' gates, n
        states = (wg * 2 * 2 * TILE + HALF + 2 * 2 * 64 * COLS * 2 + wg * 2 * HALF
                  + 4 * ((wg - 1) * 64 * COLS + wg * 64 + 2 * 4 * MAX_CHUNK + n_max))
        # RowsLayout: the rings of v, dh and C_{c-1} tiles, dC's tiles, the
        # transposed (inter / M o Q), q and k, the partials, dS, the vectors
        rows = (wg * 2 * (2 * TILE + HALF) + wg * HALF + 3 * HALF
                + 4 * (wg - 1) * 64 * COLS + 2 * MAX_CHUNK * MAX_CHUNK
                + 4 * (4 * MAX_CHUNK + 2 * COLS + tc // 32))
        # ColsLayout: the rings of k and q tiles, dC^T's pairs, dh^T and
        # (inter / M o dh)^T, the partials, att / M, the vectors
        cols = (wg * 2 * 2 * TILE + wg * 2 * HALF + 2 * HALF + 4 * (wg - 1) * 64 * COLS
                + 2 * MAX_CHUNK * MAX_CHUNK + 4 * 3 * MAX_CHUNK)
        prep = 1024 + BWD_PREP_STAGES * 2 * TILE
        return {"body": "tc", "scratch": scratch, "kernels": [
            {"name": "prep_tc", "grid": per_chunk, "threads": 128, "dynamic": prep,
             "smem": prep + _gate_smem(128)},
            {"name": "states_tc", "grid": by_cols, "threads": tc, "dynamic": 1024 + states,
             "smem": 1024 + states},
            steps,
            {"name": "rows_tc", "grid": by_rows, "threads": tc, "dynamic": 1024 + rows,
             "smem": 1024 + rows},
            {"name": "cols_tc", "grid": by_cols, "threads": tc, "dynamic": 1024 + cols,
             "smem": 1024 + cols},
            gates]}
    ld = BWD_COLS + 1
    return {"body": "scalar", "scratch": scratch, "kernels": [
        {"name": "prep", "grid": per_chunk, "threads": BWD_THREADS, "dynamic": 0,
         "smem": 4 * 4 * MAX_CHUNK * ld + _gate_smem(BWD_THREADS)},
        {"name": "states", "grid": by_cols, "threads": BWD_THREADS,
         **dict.fromkeys(("dynamic", "smem"),
                         4 * (dh * BWD_COLS + dh + 4 * L * BWD_COLS + 2 * L))},
        steps,
        {"name": "reverse_rows", "grid": by_rows, "threads": BWD_THREADS,
         **dict.fromkeys(("dynamic", "smem"),
                         4 * (BWD_COLS * (dv + 1) + 2 * BWD_COLS + 2 * L * BWD_COLS + L * L
                              + 4 * L + 2 * L * ld + BWD_COLS * ld + BWD_THREADS // 32))},
        {"name": "reverse_cols", "grid": by_cols, "threads": BWD_THREADS,
         **dict.fromkeys(("dynamic", "smem"),
                         4 * (dh * BWD_COLS + L * L + 3 * L * BWD_COLS + 3 * L))},
        gates]}


def launch_plan(B: int, S: int, H: int, dh: int, L: int, dtype, dv: int = None) -> tuple:
    """(scratch floats, ((grid, threads, dynamic shared memory) of each
    launch)) as the built csrc/mlstm_bwd.cu plans a call
    (``mlstm_bwd_plan``), which ``bwd_plan`` mirrors.  Builds the library
    if needed."""
    out = (ctypes.c_longlong * 31)()
    fn = _build.function("mlstm_bwd", "mlstm_bwd_plan", _BWD_PLAN_ARGS)
    _build.check(fn(B, S, H, dh, dh if dv is None else dv, L, DTYPES[dtype], out),
                 "mlstm_bwd_plan")
    v = list(out)
    return v[0], tuple((tuple(v[1 + 5 * i:4 + 5 * i]), v[4 + 5 * i], v[5 + 5 * i])
                       for i in range(6))


def mlstm_bwd(q, k, v, log_i, log_f, state, dh, dstate=None, final=None, *, chunk,
              scale=1.0, want_dstate=True):
    """The mLSTM's gradients on the card: q, k, v, log_i, log_f, state as
    the forward took them; dh (h's gradient, v's shape) in q's dtype;
    dstate (dC, dn, dm), each float32 or None (zeros), or None; final: the
    forward's final (C, n), read where dC or dn is given.  Returns (dq, dk,
    dv, dlog_i, dlog_f, (dC0, dn0, dm0) or None without a state or where
    not wanted)."""
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    L = min(chunk, S)
    check_bwd(D, L, q.dtype, Dv)
    dC, dn, dm = dstate if dstate is not None else (None, None, None)
    if (dC is not None or dn is not None) and final is None:
        raise ValueError("a final-state gradient needs the forward's final state")
    dh = dh.contiguous()
    if dh.dtype != q.dtype or dh.shape != v.shape:
        raise TypeError("dh must have h's shape and dtype")
    if any(t.data_ptr() % 16 for t in (q, k, v, dh)):
        raise ValueError("mlstm_bwd reads q, k, v and dh in 16-byte loads: align them")
    grads = [None if g is None else g.contiguous() for g in (dC, dn, dm)]
    for g, shape in zip(grads, ((B, H, D, Dv), (B, H, D), (B, H))):
        if g is not None and (g.dtype != torch.float32 or g.shape != shape):
            raise TypeError(f"the final state's gradient must be {shape} float32")
    C0, n0, m0 = (None, None, None) if state is None else state
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dli, dlf = torch.empty_like(log_i), torch.empty_like(log_f)
    d0 = tuple(torch.empty_like(t) for t in state) if state is not None and want_dstate \
        else None
    if B * H == 0:
        return dq, dk, dv, dli, dlf, d0
    work = torch.empty((bwd_plan(B, S, H, D, L, q.dtype, Dv)["scratch"],), dtype=torch.float32,
                       device=q.device)
    fn = _build.function("mlstm_bwd", "mlstm_bwd", _BWD_ARGTYPES)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    Cf, nf = final if final is not None else (None, None)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_i.data_ptr(), log_f.data_ptr(),
             ptr(C0), ptr(n0), ptr(m0), ptr(Cf), ptr(nf), dh.data_ptr(),
             *(ptr(g) for g in grads), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             dli.data_ptr(), dlf.data_ptr(), *(ptr(t) for t in (d0 or (None,) * 3)),
             work.data_ptr(), B, S, H, D, Dv, L, scale, DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm_bwd")
    mlstm_bwd.launches += 1
    return dq, dk, dv, dli, dlf, d0


mlstm_bwd.launches = 0
