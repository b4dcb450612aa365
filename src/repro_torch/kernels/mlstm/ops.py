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


def plan(B: int, S: int, H: int, dh: int, L: int, dtype, has_state: bool) -> dict:
    """The launches of one call, as csrc/mlstm.cu makes them: the path
    ("boot": bf16, no state, one chunk; "chunked": bf16 scores and
    recurrent kernels on the tensor cores; "scalar": float32) and each
    kernel's grid, threads and shared memory (static plus dynamic bytes,
    the alignment slack of the swizzled tiles included)."""
    n_chunks, n_et = -(-S // L), -(-dh // 64)
    if dtype == torch.bfloat16:
        if not has_state and S <= L:
            # the e-groups' blocks of C', then one block of h per 64 columns
            return {"path": "boot", "kernels": [{
                "name": "boot_tc", "threads": 128,
                "grid": (B * H, -(-dh // BOOT_COLS), -(-n_et // BOOT_ETILES) + 1),
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
            {"name": f"recurrent_tc<{nwg},{mt}>", "grid": (B * H, dh // COLS),
             "threads": 128 * nwg, "smem": recurrent}]}
    return {"path": "scalar", "kernels": [
        {"name": "scores_kernel", "grid": (n_chunks, B * H), "threads": 256,
         "smem": 4 * 2 * MAX_CHUNK * (32 + 1) + _gate_smem(256)},
        {"name": "recurrent_kernel", "grid": (B * H, dh // COLS), "threads": 256,
         "smem": 4 * (dh * COLS + dh + -(-L * L // 4) * 4 + L * COLS
                      + 2 * L * 32 + 4 * L)}]}


def mlstm_chunkwise(q, k, v, log_i, log_f, state=None, *, chunk, scale=1.0):
    """q, k, v: (B, S, H, dh) float32 or bfloat16; log_i, log_f: (B, S, H)
    float32; state: (C (B, H, dh, dh), n (B, H, dh), m (B, H)) float32 or
    None (C = n = 0, m = -1e30); chunk: the chunk length L (``min(chunk,
    S)``, ragged tail masked); scale multiplies q.  Returns h (B, S, H, dh)
    in q's dtype and the final state (C, n, m), float32."""
    if not q.is_cuda:
        return ref.mlstm_ref(q, k, v, log_i, log_f, state, chunk=chunk,
                             scale=scale)
    _build.refuse_grad("mlstm", q, k, v, log_i, log_f, *(state or ()))
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
    if S == 0 or L > MAX_CHUNK or dh % COLS or dh > MAX_HEAD_DIM:
        raise ValueError(f"unsupported mlstm shape: dh={dh} L={L}")
    p = plan(B, S, H, dh, L, q.dtype, state is not None)
    if any(kn["smem"] > MAX_SMEM for kn in p["kernels"]):
        raise ValueError(f"mlstm's shared memory exceeds the card's at dh={dh} L={L}")
    if not all(t.is_contiguous() for t in (q, k, v, log_i, log_f)):
        raise ValueError("mlstm needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("mlstm reads q, k and v in 16-byte loads: align them")
    n_chunks = -(-S // L)
    f32 = dict(dtype=torch.float32, device=q.device)
    h = torch.empty_like(q)
    C, n, m = (torch.empty((B, H, dh, dh), **f32), torch.empty((B, H, dh), **f32),
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
             m.data_ptr(), B, S, H, dh, L, scale, DTYPES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "mlstm")
    mlstm_chunkwise.launches += 1
    mlstm_chunkwise.boot_launches += int(p["path"] == "boot")
    return h, (C, n, m)


mlstm_chunkwise.launches = 0
mlstm_chunkwise.boot_launches = 0      # of them, calls on the boot path
