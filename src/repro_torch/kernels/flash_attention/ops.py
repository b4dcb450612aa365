"""Flash attention: the checked wrappers of ``csrc/flash_attention.cu``.

``flash_attention`` is the dense entry (the function of the TPU kernel);
``paged_flash_attention`` reads K/V from the paged arena and carries the
serving path's prefill chunks and speculative verify windows;
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``) is the dense
entry's backward, which ``FlashAttention`` (an ``autograd.Function``)
launches for training.  For a CUDA tensor each launches the kernel (no
fallback; the paged entry raises where a gradient would be needed); for a
CPU tensor each runs its plain version in ``ref.py``, which autograd
differentiates."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.c_longlong * 3
_DENSE_ARGS = [_P] * 4 + [_I] * 9 + [_F, _F] \
    + [ctypes.POINTER(ctypes.c_longlong)] * 3 + [_I, _P, _P]
_BWD_ARGS = [_P] * 10 + [_I] * 8 + [_F, _F] \
    + [ctypes.POINTER(ctypes.c_longlong)] * 4 + [_I, _P]
_BWD_PLAN_ARGS = [_I] * 7 + [ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
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
    views; the output has q's layout.  On the card, where grad mode is on
    and an input requires grad, the call goes through ``FlashAttention``
    (the same launch, plus the rows' log-sum-exp that its backward kernel
    reads); otherwise it is one launch with no lse."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _dense_forward(q, k, v, causal, window, softcap, scale)[0]


def _dense_forward(q, k, v, causal, window, softcap, scale, with_lse=False):
    """One launch of the dense entry -> (out, lse or None); lse: (B, H, S)
    float32, each query row's log-sum-exp."""
    B, H, S, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    _check(q, {"k": k, "v": v}, H, Hkv, D, contiguous=False)
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape:
        raise ValueError("k / v shape does not match q")
    if v.stride() != k.stride() or any(t.stride(-1) != 1 for t in (q, k)):
        raise ValueError("k and v must share strides, each with unit stride along D")
    out = torch.empty_like(q)      # q's layout where q is a dense permutation
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    fn = _build.function("flash_attention", "flash_attention", _DENSE_ARGS)
    tq = plan(H // Hkv, D, S, q.dtype)["tq"]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, Hkv, S, Skv, D, tq, int(causal),
             window or 0, float(softcap or 0.0), float(scale),
             _bsh(q), _bsh(out), _bsh(k),
             DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
             None if lse is None else lse.data_ptr())
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def _bsh(t):
    """Strides (elements) for batch, position and head of a (B, H, S, D) view."""
    return _STRIDES(t.stride(0), t.stride(2), t.stride(1))


class FlashAttention(torch.autograd.Function):
    """The dense entry with a gradient: the forward launches the kernel
    with its lse output and saves (q, k, v, o, lse); the backward launches
    ``flash_attention_bwd``.  CUDA tensors only (the CPU differentiates the
    plain version), no fallback."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        B, H, S, D = q.shape
        check_bwd(H, k.shape[1], D, q.dtype)
        out, lse = _dense_forward(q, k, v, causal, window, softcap, scale,
                                  with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = (causal, window, softcap, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap, scale = ctx.attn
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
        return dq, dk, dv, None, None, None, None


# csrc/flash_attention_bwd.cu, float32 (scalar) body: query rows and keys
# of a tile
BWD_BQ, BWD_BK = 32, 32
# bf16 (tensor-core) bodies: keys of a dK/dV block and queries of its walk
# steps (kTile), stages of its Q/dO ring (DkdvLayout); the split rule's SMs
# and most splits (kSMs, kMaxSplits)
BWD_TILE, BWD_DKDV_STAGES = 64, 2
BWD_SMS, BWD_MAX_SPLITS = 132, 16


def bwd_smem_bytes(D: int, dtype, rows: int = None) -> dict:
    """Dynamic shared memory of the backward's dK/dV and dQ kernels, as
    ``launch_f32`` and the layouts in csrc/flash_attention_bwd.cu size
    them.  float32: K, V, Q and dO tiles of 32 rows of D + 4, the f32 dK
    and dV (or dQ) sums, P and dS tiles, lse and Delta.  bf16
    (``DkdvLayout``, ``DqLayout``, D padded to 64/128/256): the dK/dV
    block's K and V tiles, a two-stage ring of Q and dO tiles and their lse
    and Delta; the dQ block's Q and dO rows (``rows``, as ``plan`` gives
    them, in whole 64-row warpgroups; by default the most a block holds at
    D) and a ring of K and V tiles."""
    if dtype == torch.float32:
        ld = D + 4
        return {"dkdv": 4 * (2 * BWD_BK * ld + 2 * BWD_BQ * ld + 2 * BWD_BK * D
                             + 2 * BWD_BQ * BWD_BK + 2 * BWD_BQ),
                "dq": 4 * (2 * BWD_BQ * ld + 2 * BWD_BK * ld + BWD_BQ * D
                           + BWD_BQ * BWD_BK + 2 * BWD_BQ)}
    DP = padded_width(D)
    tile = BWD_TILE * DP * 2
    rows = 64 * -(-(rows or max_rows(D, dtype)) // 64)
    dq_stages = 2 if DP > 128 else 3                # DqLayout::kStages
    return {"dkdv": 1024 + 2 * tile + BWD_DKDV_STAGES * (2 * tile + 2 * BWD_TILE * 4),
            "dq": 1024 + 2 * rows * DP * 2 + dq_stages * 2 * tile}


def bwd_splits(B: int, Hkv: int, G: int, Skv: int) -> tuple:
    """(splits, heads a split) of the bf16 dK/dV walk, as ``plan_bf16``
    decides them: where B * Hkv * key tiles is under one block an SM, the
    group's query heads are split over blocks, to about four blocks an SM,
    at most 16 splits; the splits' f32 partials are then added in split
    order by a launch of their own."""
    blocks = B * Hkv * -(-Skv // BWD_TILE)
    hps = G
    if blocks < BWD_SMS:
        want = min(G, BWD_MAX_SPLITS, -(-4 * BWD_SMS // blocks))
        hps = -(-G // want)
    return -(-G // hps), hps


def bwd_plan(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int, dtype) -> dict:
    """The backward's plan: its body ("wgmma" in bf16, "scalar" in
    float32), the float32 scratch it needs (Delta, then the splits'
    partials from the next 16-byte boundary) and its launches, each with
    its grid, threads and shared memory, as csrc/flash_attention_bwd.cu
    issues them (the wrapper sizes its scratch by ``launch_plan``, the
    source's own answer; ``chip_smoke.py`` holds the two equal).  bf16: Delta; the dK/dV walk (at D > 128 twice, dV then
    dK: dK + dV in registers would need 256 a thread); the split sum where
    the walk is split (``bwd_splits``); dQ, with ``plan``'s rows."""
    G = H // Hkv
    delta = {"name": "delta_kernel", "grid": (-(-B * H * Sq // 8),), "threads": 256,
             "smem": 0}
    p = plan(G, D, Sq, dtype)
    smem = bwd_smem_bytes(D, dtype, p["rows"])
    if dtype == torch.float32:
        return {"body": "scalar", "scratch": B * H * Sq, "launches": [
            delta,
            {"name": "dkdv_kernel", "grid": (B * Hkv, -(-Skv // BWD_BK)), "threads": 256,
             "smem": smem["dkdv"]},
            {"name": "dq_kernel", "grid": (B * H, -(-Sq // BWD_BQ)), "threads": 256,
             "smem": smem["dq"]}]}
    splits, hps = bwd_splits(B, Hkv, G, Skv)
    walk = {"name": "dkdv_tc_kernel", "grid": (B * Hkv, -(-Skv // BWD_TILE), splits),
            "threads": 128, "smem": smem["dkdv"]}
    passes = [{**walk, "pass": "dv"}, {**walk, "pass": "dk"}] \
        if padded_width(D) > 128 else [{**walk, "pass": "dk+dv"}]
    n_grad = B * Hkv * Skv * D
    total = [{"name": "dkdv_sum_kernel", "grid": (-(-n_grad // 256),), "threads": 256,
              "smem": 0}] if splits > 1 else []
    dq = {"name": "dq_tc_kernel", "grid": (B * Hkv, -(-Sq // p["tq"])),
          "threads": p["threads"], "smem": smem["dq"], "tq": p["tq"]}
    scratch = (B * H * Sq + 3) // 4 * 4 + (2 * splits * n_grad if splits > 1 else 0)
    return {"body": "wgmma", "splits": splits, "heads_per_split": hps,
            "scratch": scratch, "launches": [delta, *passes, *total, dq]}


def launch_plan(B: int, H: int, Hkv: int, Sq: int, Skv: int, D: int, dtype) -> tuple:
    """(scratch floats, splits of the dK/dV walk) as the built
    csrc/flash_attention_bwd.cu plans them (``flash_attention_bwd_plan``):
    the one owner of the split rule, which ``bwd_plan`` mirrors.  Builds
    the library if needed."""
    scratch, splits = ctypes.c_longlong(), ctypes.c_int()
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd_plan", _BWD_PLAN_ARGS)
    _build.check(fn(B, H, Hkv, Sq, Skv, D, DTYPES[dtype], ctypes.byref(scratch),
                    ctypes.byref(splits)), "flash_attention_bwd_plan")
    return scratch.value, splits.value


def check_bwd(H: int, Hkv: int, D: int, dtype):
    """Raises on a head layout the backward kernel does not take: D as the
    forward; in bf16 the dQ kernel holds a group's G query heads in a block
    as the forward does (``max_rows``); the float32 body takes any G."""
    if dtype not in DTYPES:
        raise TypeError(f"flash attention's backward takes float32 or bfloat16, "
                        f"not {dtype}")
    if H % Hkv or D > MAX_HEAD_DIM or D % 8:
        raise ValueError(f"bad heads/dim: H={H} Hkv={Hkv} D={D} (D a multiple "
                         f"of 8 up to {MAX_HEAD_DIM}, H a multiple of Hkv)")
    if dtype == torch.bfloat16 and H // Hkv > max_rows(D, dtype):
        raise ValueError(f"{H // Hkv} query heads per KV head exceed the "
                         f"{max_rows(D, dtype)} rows a dQ block holds at D={D}")
    if max(bwd_smem_bytes(D, dtype).values()) > SMEM_LIMIT:
        raise ValueError(f"the backward's tiles exceed shared memory at D={D}")


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=None,
                        softcap=None, scale=None):
    """Gradients of the dense entry: q, o, do (B, H, Sq, D) and k, v (B,
    Hkv, Skv, D) as ``flash_attention`` takes them (strided views with D
    contiguous; k and v sharing strides), lse (B, H, Sq) float32 from its
    forward -> (dq, dk, dv) in q's dtype, with q's and k's layouts.  One
    call is the launches of csrc/flash_attention_bwd.cu that ``bwd_plan``
    lists (Delta, dK/dV, dQ; bf16 on the tensor cores, float32 scalar),
    counted once.  CUDA tensors only."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    check_bwd(H, Hkv, D, q.dtype)
    for name, t in (("k", k), ("v", v), ("o", o), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_cuda:
            raise ValueError(f"{name} must match q's dtype and CUDA device")
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("k / v / o / do shapes do not match q")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError("lse must be contiguous (B, H, Sq) float32 on q's device")
    if do.stride(-1) != 1:
        do = do.contiguous()
    if v.stride() != k.stride() or any(t.stride(-1) != 1 for t in (q, k, o)):
        raise ValueError("k and v must share strides; D contiguous in q, k, v, o")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.stride() != q.stride() or dk.stride() != k.stride() \
            or dv.stride() != k.stride():
        raise ValueError("q, k and v must be dense (B, H, S, D) permutations")
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    scratch = torch.empty(launch_plan(B, H, Hkv, Sq, Skv, D, q.dtype)[0],
                          dtype=torch.float32, device=q.device)
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGS)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), B, H, Hkv, Sq, Skv, D, int(causal), window or 0,
             float(softcap or 0.0), float(scale), _bsh(q), _bsh(o), _bsh(do),
             _bsh(k), DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


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
    _build.refuse_grad("paged_flash_attention", q, k_arena, v_arena)
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
flash_attention_bwd.launches = 0
