"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each against its plain PyTorch version at the shapes its paths give
it, and drives the port's serving and training paths, each at full width:

* the paged KV pool with ``gentorrent-llama3-8b`` (two layers in float32
  for token parity, all 32 layers in bf16 for the serving numbers);
* the dense slot pool with ``jamba-v0.1-52b`` (Mamba + attention + MoE)
  cut to one repeat of its 8-layer pattern (32 layers, ~104 GB in bf16, do
  not fit in 80 GB): one Mamba and one attention layer, then the whole cut
  model, in float32 against the CPU and for token parity; the cut model in
  bf16 for the serving numbers; one 2048-token prefill;
* the dense slot pool with ``xlstm-1.3b`` (mLSTM + sLSTM) at full width
  and full depth (48 layers): one mLSTM and one sLSTM layer in float32
  against the CPU; all 48 layers in float32 for token parity and in bf16
  for the serving numbers; one 2048-token prefill;
* the overlay with ``gentorrent-llama3-8b``: two model nodes on one card
  over one set of weights, each with its own paged engine, on the
  simulated network (HR-tree sync through the chunk-hash kernel, sketch
  affinity, cross-node KV page migration): two layers in float32, where
  load-only, affinity and replication routings give the same tokens, and
  all 32 layers in bf16 for the serving numbers;
* the privacy overlay around those nodes, as ``build_overlay`` wires it:
  24 users who send their prompts as S-IDA cloves over onion-routed
  proxies and get Ed25519-signed responses back: two layers in float32,
  where every signature verifies and each user gets the tokens of a
  direct ``generate``, and all 32 layers in bf16 with signing off and
  on, for what privacy costs on the host and the card;
* serving-quality verification through that overlay: the log-prob
  verifier (``LM.apply``, the flash kernel's dense entry) in float32 on
  two layers, where every token the paged path served is the verifier's
  argmax and the card equals the CPU; and all 32 layers in bf16, an
  honest and an impostor node whose committee challenges go through the
  overlay and are scored on the card for four epochs, then
  verifications per minute;
* the other model families: one repeat of each of eight configs' patterns
  at full width in float32 against the CPU (``h2o-danube-1.8b``,
  ``gemma2-9b``, ``yi-34b``, ``granite-20b``, ``dbrx-132b`` and
  ``moonshot-v1-16b-a3b`` through the paged entry points past a 4096-token
  history; ``llama-3.2-vision-11b`` and ``whisper-base`` through ``apply``,
  ``prefill(aux)``, ``decode`` and ``encode``); the six paged configs served
  in bf16 at full width (yi and dbrx cut in depth to fit the card, danube
  and gemma2 with a request past their 4096 window, danube also with
  speculation); vision at full depth and whisper served in bf16, each
  request with its own 1600 image embeddings or 1500 frames;
* training (``make_train_step``: ``lm_loss`` under autograd, the flash
  kernel's forward with its lse and its backward kernel, AdamW): one step
  of six reduced configs in float32 on the card against the CPU, where
  jamba and xlstm refuse a gradient on the card (the scan and the mLSTM
  have no backward kernel); ``gentorrent-llama3-8b`` at full width cut to
  4 layers, float32 weights and AdamW state with bf16 compute, trained for
  a few steps of B=2 x 2048 tokens.

It prints one JSON line per phase.  Every phase must pass: any failure
ends the run with a nonzero exit.  With no CUDA card it exits nonzero
before printing any result.  ``--out DIR`` also writes the long outputs
(compiler report, profile tables, tokens) there.  Weights are random, made
from ``--seed``.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # fp32 outside the tensor cores
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
# mLSTM's h in float32: a ratio whose denominator cancels, which magnifies
# the different summation order of the kernel's and cuBLAS's sums over the
# 1024-wide head; held at the JAX kernel test's 2e-4 (test_kernels.py:143)
MLSTM_TOL_H = {torch.float32: dict(atol=2e-4, rtol=2e-4),
               torch.bfloat16: TOL[torch.bfloat16]}
NAME = "gentorrent-llama3-8b"
JAMBA = "jamba-v0.1-52b"
XLSTM = "xlstm-1.3b"
BLK = 32


def emit(obj):
    print(json.dumps(obj), flush=True)


# time_ms calls whose profiler sessions all came back without a device
# event, and which were therefore timed by CUDA events (``event_ms``)
PROFILER_MISSES = []


def time_ms(fn, iters=50, warmup=5, tries=3):
    """Device time of one call of ``fn``: the summed time of every kernel
    (and copy) it runs on the card, from torch.profiler, averaged over
    ``iters`` calls.  The host's gaps between launches do not count: at
    the serving path's small shapes a kernel runs for less time than its
    Python wrapper takes to launch it, and a loop timed by CUDA events
    times the host (``event_ms``).

    The tracer now and then hands back a session with no device event at
    all (seen once on an H100 host, in the middle of a run whose other
    sessions saw theirs).  Such a session is run again, up to ``tries``
    times; if none sees the card, the call is timed by ``event_ms``, an
    upper bound on the device time, and listed in ``PROFILER_MISSES``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
        print(f"chip_smoke: the profiler saw no device time (try {attempt + 1} of "
              f"{tries})", file=sys.stderr, flush=True)
    ms = event_ms(fn, iters, warmup=0)
    PROFILER_MISSES.append(ms)
    return ms


def event_ms(fn, iters=50, warmup=5):
    """Time of one call of ``fn`` in a loop of back-to-back calls, between
    two CUDA events: the device's time or the host's, whichever is longer."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def sass_counts(name):
    """Tensor-core instructions in kernel library ``name``'s SASS, by
    function: HGMMA (wgmma) and HMMA (mma.sync), where the toolkit has
    cuobjdump."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(tool).exists():
        return "not measured: no cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
        for op in ("HGMMA", "HMMA"):
            if op in ln and fn is not None:
                counts.setdefault(fn, {}).setdefault(op, 0)
                counts[fn][op] += 1
    return counts


def _spills(reports):
    """Each kernel function whose ``-Xptxas=-v`` report shows spill
    stores or loads, with that line; empty where none spills."""
    out, fn = {}, None
    for name, text in reports.items():
        for ln in text.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for")[1].strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m and (int(m[1]) or int(m[2])):
                out[f"{name}: {fn}"] = ln.strip()
    return out


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def close(got, want, dtype, tol=None):
    """``assert_close`` at ``tol`` (default ``TOL[dtype]``); returns the
    largest absolute error and the worst ratio err / (atol + rtol *
    |want|), the share of the tolerance the worst element uses (the check
    fails above 1)."""
    tol = tol or TOL[dtype]
    got = got.float()
    torch.testing.assert_close(got, want, **tol)
    err = (got - want).abs()
    return [err.max().item(),
            (err / (tol["atol"] + tol["rtol"] * want.abs())).max().item()]


def _summary(errs):
    """max_abs_err and the worst tolerance ratio over a kernel's cases."""
    return {"max_abs_err": max(e[0] for e in errs.values()),
            "tol_ratio": max(e[1] for e in errs.values())}


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------
def _paged_inputs(gen, dev, B=4, H=32, Hkv=8, D=128, P=513, n_pg=32):
    """Arena of P pages (the engine's default at max_len=1024) and page
    tables of distinct pages per row."""
    ka = torch.randn(P, BLK, Hkv, D, generator=gen, device=dev)
    va = torch.randn(P, BLK, Hkv, D, generator=gen, device=dev)
    perm = torch.randperm(P - 1, generator=gen, device=dev)[:B * n_pg] + 1
    pt = perm.reshape(B, n_pg).to(torch.int32).contiguous()
    return ka, va, pt


def _paged_decode_bytes(lengths, H, Hkv, D, esize):
    """Bytes the paged decode call must move for these lengths: a live
    row reads its q, its visible K/V and its page ids; every row reads its
    length and writes its output (a dead row writes zeros, reads no q)."""
    lens = lengths.tolist()
    live = sum(n > 0 for n in lens)
    return (live * H * D * esize + len(lens) * H * D * esize
            + 2 * sum(lens) * Hkv * D * esize
            + 4 * sum(-(-n // BLK) for n in lens) + 4 * len(lens))


def check_paged_decode(gen, dev):
    from repro_torch.kernels.paged_decode import ops, ref
    B, H, D = 4, 32, 128
    ka, va, pt = _paged_inputs(gen, dev)
    q = torch.randn(B, H, D, generator=gen, device=dev)
    lengths = torch.tensor([1000, 517, 0, 33], dtype=torch.int32, device=dev)
    live = lengths > 0
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for window, softcap in ((None, None), (256, None), (None, 50.0), (256, 50.0)):
            kw = dict(window=window, softcap=softcap)
            x = [t.to(dtype) for t in (q, ka, va)]
            got = ops.paged_decode_attention(*x, pt, lengths, **kw)
            want = ref.paged_decode_attention_ref(*[t.float() for t in x], pt, lengths, **kw)
            torch.cuda.synchronize()
            errs[f"{str(dtype)[6:]}/w{window}/cap{softcap}"] = \
                close(got[live], want[live], dtype)
            assert not got[~live].any(), "dead row must be zeros"
    # timing at the serving dtype, no window or softcap (the model's case)
    x = [t.to(torch.bfloat16) for t in (q, ka, va)]
    ms = time_ms(lambda: ops.paged_decode_attention(*x, pt, lengths))
    ev_ms = event_ms(lambda: ops.paged_decode_attention(*x, pt, lengths))
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(*x, pt, lengths), iters=10)
    # library yardstick: the same attention as one SDPA call over the rows'
    # pages gathered densely beforehand (the gather is not timed), as
    # check_paged_flash times it; the dead row's all-masked row is garbage
    Hkv = ka.shape[2]
    kd = ref.gather_dense(x[1], pt).repeat_interleave(H // Hkv, dim=1)
    vd = ref.gather_dense(x[2], pt).repeat_interleave(H // Hkv, dim=1)
    mask = (torch.arange(kd.shape[2], device=dev)[None] < lengths[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(x[0][:, :, None], kd, vd, attn_mask=mask))
    nbytes = _paged_decode_bytes(lengths, H, Hkv, D, 2)
    visible = int(lengths.sum())
    bound_ms, bound_by = bound(nbytes, 4 * visible * H * D, torch.bfloat16)
    layouts = _paged_decode_layouts(gen, dev, lengths, errs)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_decode/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/decode_attention/paged.py:94",
            **_summary(errs), "ms": ms, "event_ms": ev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "n_splits": ops.n_splits(B, Hkv, pt.shape[1]),
            "timed_at": "B=4 H=32 Hkv=8 D=128 BLOCK=32 n_pg=32 lengths=[1000,517,0,33] bf16",
            "layouts": layouts, "errs": errs}


def _paged_decode_layouts(gen, dev, lengths, errs):
    """The paged decode at the other paged configs' head layouts (gemma2's
    D=256 with its softcap, granite's 48 query heads on one KV head, yi's
    8 a group with the padded one's query zero, as its zero ``wq`` columns
    make it, danube's D=80, dbrx, moonshot) at the serving shape's lengths
    and page table: float32 and bf16 held against the plain version (into
    ``errs``) plain, with the config's softcap, and with a 256-key window
    (shorter than the lengths, so it engages) and the softcap; bf16 timed
    with the config's softcap, as every decode of its model calls it,
    beside its bound, the plain version and SDPA."""
    from repro_torch.kernels.paged_decode import ops, ref
    live = lengths > 0
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name in PAGED_FAMILIES:
        cfg = _family(name)
        H, Hkv, D = cfg.n_heads + cfg.head_pad, cfg.n_kv_heads, cfg.d_head
        pad = cfg.head_pad // Hkv
        cap = dict(softcap=cfg.attn_softcap) if cfg.attn_softcap else {}
        ka, va, pt = _paged_inputs(gen, dev, Hkv=Hkv, D=D)
        q = torch.randn(len(lengths), H, D, generator=gen, device=dev)
        if pad:                        # the last query head of each group
            q.view(len(lengths), Hkv, H // Hkv, D)[:, :, -pad:] = 0
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, ka, va)]
            for kw in {str(k): k for k in (dict(), cap, dict(window=256, **cap))}.values():
                got = ops.paged_decode_attention(*x, pt, lengths, **kw)
                want = ref.paged_decode_attention_ref(*[t.float() for t in x], pt,
                                                      lengths, **kw)
                torch.cuda.synchronize()
                errs[f"{name}/{str(dtype)[6:]}/w{kw.get('window')}/cap{kw.get('softcap')}"] = \
                    close(got[live], want[live], dtype)
                assert not got[~live].any(), "dead row must be zeros"
        x = [t.to(torch.bfloat16) for t in (q, ka, va)]
        kd = ref.gather_dense(x[1], pt).repeat_interleave(H // Hkv, dim=1)
        vd = ref.gather_dense(x[2], pt).repeat_interleave(H // Hkv, dim=1)
        mask = (torch.arange(kd.shape[2], device=dev)[None] < lengths[:, None])[:, None, None]
        b_ms, b_by = bound(_paged_decode_bytes(lengths, H, Hkv, D, 2),
                           4 * int(lengths.sum()) * H * D, torch.bfloat16)
        scale = cap.get("softcap")
        out[name] = {"shape": f"B=4 H={H} Hkv={Hkv} D={D} n_pg=32 lengths=[1000,517,0,33] "
                              f"softcap={scale} bf16",
                     "n_splits": ops.n_splits(len(lengths), Hkv, pt.shape[1]),
                     "ms": time_ms(lambda: ops.paged_decode_attention(*x, pt, lengths, **cap)),
                     "plain_ms": time_ms(lambda: ref.paged_decode_attention_ref(
                         *x, pt, lengths, **cap), iters=10),
                     "bound_ms": b_ms, "bound_by": b_by,
                     # no PyTorch call applies the softcap: SDPA without it
                     "library_ms": time_ms(lambda: sdpa(x[0][:, :, None], kd, vd,
                                                        attn_mask=mask)),
                     "library": "SDPA" + (" without the softcap" if scale else "")}
        del ka, va, kd, vd
    return out


def _flash_case(gen, dev, C, H=32, Hkv=8, D=128):
    B = 4
    ka, va, pt = _paged_inputs(gen, dev, Hkv=Hkv, D=D)
    q = torch.randn(B, C, H, D, generator=gen, device=dev)
    if C == 32:       # prefill chunks: block-aligned starts, one dead row
        pos0 = torch.tensor([0, 256, 512, 960], dtype=torch.int32, device=dev)
        n_tok = torch.tensor([32, 32, 0, 32], dtype=torch.int32, device=dev)
    else:             # verify windows: ragged drafts, one dead row
        pos0 = torch.tensor([3, 300, 0, 1010], dtype=torch.int32, device=dev)
        n_tok = torch.tensor([5, 2, 0, 3], dtype=torch.int32, device=dev)
    return q, ka, va, pt, pos0, n_tok


def _paged_flash_cost(pos0, n_tok, C, H, Hkv, D, esize):
    """Bytes and FLOPs the paged flash call must move and do for these
    inputs.  Every row reads its active flag and writes its output (a dead
    row writes zeros and reads nothing else); a live row reads its q, its
    pos0, and K/V and page ids up to its last query position."""
    nbytes = len(pos0) * (C * H * D * esize + 4)          # out written, active read
    flops = 0
    for p, n in zip(pos0.tolist(), n_tok.tolist()):
        if n == 0:
            continue
        nbytes += C * H * D * esize + 4                    # q, pos0
        nbytes += 2 * (p + C) * Hkv * D * esize + 4 * -(-(p + C) // BLK)
        flops += 4 * H * D * sum(p + i + 1 for i in range(C))
    return nbytes, flops


def check_paged_flash(gen, dev):
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.paged_decode.ref import gather_dense
    errs = {}
    for C in (32, 5):
        q, ka, va, pt, pos0, n_tok = _flash_case(gen, dev, C)
        active = n_tok > 0
        valid = active[:, None] & (torch.arange(C, device=dev)[None] < n_tok[:, None])
        for dtype in (torch.float32, torch.bfloat16):
            for window, softcap in ((None, None), (256, None), (None, 50.0), (256, 50.0)):
                kw = dict(window=window, softcap=softcap)
                x = [t.to(dtype) for t in (q, ka, va)]
                got = ops.paged_flash_attention(*x, pt, pos0, active, **kw)
                want = ref.paged_attention_ref(*[t.float() for t in x], pt, pos0, active, **kw)
                torch.cuda.synchronize()
                errs[f"C{C}/{str(dtype)[6:]}/w{window}/cap{softcap}"] = \
                    close(got[valid], want[valid], dtype)
                assert not got[~active].any(), "dead row must be zeros"
    # timing: the prefill chunk in bf16, the model's case
    q, ka, va, pt, pos0, n_tok = _flash_case(gen, dev, 32)
    active = n_tok > 0
    x = [t.to(torch.bfloat16) for t in (q, ka, va)]
    ms = time_ms(lambda: ops.paged_flash_attention(*x, pt, pos0, active))
    ev_ms = event_ms(lambda: ops.paged_flash_attention(*x, pt, pos0, active))
    plain_ms = time_ms(lambda: ref.paged_attention_ref(*x, pt, pos0, active), iters=10)
    # library yardstick: the same attention as one SDPA call over the rows'
    # pages gathered densely beforehand (the gather is not timed)
    H, Hkv = q.shape[2], ka.shape[2]
    kd = gather_dense(x[1], pt).repeat_interleave(H // Hkv, dim=1)
    vd = gather_dense(x[2], pt).repeat_interleave(H // Hkv, dim=1)
    qd = x[0].transpose(1, 2)
    qpos = pos0[:, None] + torch.arange(32, device=dev)
    mask = (torch.arange(kd.shape[2], device=dev)[None, None] <= qpos[..., None])[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qd, kd, vd, attn_mask=mask))
    nbytes, flops = _paged_flash_cost(pos0, n_tok, 32, H, Hkv, 128, 2)
    bound_ms, bound_by = bound(nbytes, flops, torch.bfloat16)
    layouts = _paged_flash_layouts(gen, dev, errs)
    return {"name": "paged_flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            **_summary(errs), "ms": ms, "event_ms": ev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "timed_at": "B=4 C=32 H=32 Hkv=8 D=128 pos0=[0,256,512,960] active=[1,1,0,1] bf16",
            "layouts": layouts, "errs": errs}


def _paged_flash_layouts(gen, dev, errs):
    """The paged flash entry at the other paged configs' head layouts, as
    ``_paged_decode_layouts`` takes them (yi's padded query heads zero):
    prefill chunks and verify windows in float32 and bf16 held against
    the plain version (into ``errs``) plain, with the config's softcap,
    and with a 256-key window (the chunks' positions run past it) and the
    softcap; the bf16 prefill chunk timed with the config's softcap beside
    its bound, the plain version and SDPA over the pages gathered densely
    (without the softcap, which no PyTorch call applies)."""
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.kernels.paged_decode.ref import gather_dense
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name in PAGED_FAMILIES:
        cfg = _family(name)
        H, Hkv, D = cfg.n_heads + cfg.head_pad, cfg.n_kv_heads, cfg.d_head
        pad = cfg.head_pad // Hkv
        cap = dict(softcap=cfg.attn_softcap) if cfg.attn_softcap else {}
        for C in (32, 5):
            q, ka, va, pt, pos0, n_tok = _flash_case(gen, dev, C, H, Hkv, D)
            if pad:                    # the last query head of each group
                q.view(*q.shape[:2], Hkv, H // Hkv, D)[..., -pad:, :] = 0
            active = n_tok > 0
            valid = active[:, None] & (torch.arange(C, device=dev)[None] < n_tok[:, None])
            for dtype in (torch.float32, torch.bfloat16):
                x = [t.to(dtype) for t in (q, ka, va)]
                for kw in {str(k): k for k in (dict(), cap, dict(window=256, **cap))}.values():
                    got = ops.paged_flash_attention(*x, pt, pos0, active, **kw)
                    want = ref.paged_attention_ref(*[t.float() for t in x], pt, pos0, active,
                                                   **kw)
                    torch.cuda.synchronize()
                    errs[f"{name}/C{C}/{str(dtype)[6:]}/w{kw.get('window')}"
                         f"/cap{kw.get('softcap')}"] = close(got[valid], want[valid], dtype)
                    assert not got[~active].any(), "dead row must be zeros"
        # timing: a prefill chunk with the config's softcap
        q, ka, va, pt, pos0, n_tok = _flash_case(gen, dev, 32, H, Hkv, D)
        if pad:
            q.view(*q.shape[:2], Hkv, H // Hkv, D)[..., -pad:, :] = 0
        active = n_tok > 0
        x = [t.to(torch.bfloat16) for t in (q, ka, va)]
        kd = gather_dense(x[1], pt).repeat_interleave(H // Hkv, dim=1)
        vd = gather_dense(x[2], pt).repeat_interleave(H // Hkv, dim=1)
        qpos = pos0[:, None] + torch.arange(32, device=dev)
        mask = (torch.arange(kd.shape[2], device=dev)[None, None] <= qpos[..., None])[:, None]
        b_ms, b_by = bound(*_paged_flash_cost(pos0, n_tok, 32, H, Hkv, D, 2), torch.bfloat16)
        out[name] = {"shape": f"B=4 C=32 H={H} Hkv={Hkv} D={D} pos0=[0,256,512,960] "
                              f"active=[1,1,0,1] softcap={cap.get('softcap')} bf16",
                     "ms": time_ms(lambda: ops.paged_flash_attention(*x, pt, pos0, active,
                                                                     **cap)),
                     "plain_ms": time_ms(lambda: ref.paged_attention_ref(
                         *x, pt, pos0, active, **cap), iters=10),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": time_ms(lambda: sdpa(x[0].transpose(1, 2), kd, vd,
                                                        attn_mask=mask)),
                     "library": "SDPA" + (" without the softcap" if cap else "")}
        del q, ka, va, kd, vd, x
    return out


def _dense_flash_cost(B, H, Hkv, S, D, esize):
    """q read and out written, K/V read once; the causal half of QK^T and PV."""
    return (2 * (B * H * S * D + B * Hkv * S * D) * esize,
            4 * B * H * D * S * (S + 1) // 2)


def _full_flash_cost(B, H, Hkv, Sq, Skv, D, esize):
    """Non-causal: q read and out written, K/V read once; every query
    against every key in QK^T and PV."""
    return (2 * (B * H * Sq * D + B * Hkv * Skv * D) * esize, 4 * B * H * D * Sq * Skv)


# non-causal dense entries of the encoder-decoder paths: (B, H, Hkv, D, Sq,
# Skv); the first two are timed
FULL_FLASH_SHAPES = {"cross": (4, 32, 8, 128, 256, 1600),      # vision's prefill
                     "encoder": (4, 8, 8, 64, 1500, 1500),     # whisper's encoder
                     "cross_short": (2, 32, 8, 128, 24, 1600),
                     "whisper_cross": (4, 8, 8, 64, 24, 1500),
                     "whisper_cross_200": (2, 8, 8, 64, 200, 1500)}


def _full_flash(gen, dev, errs):
    """The dense entry without a causal mask and with keys of their own
    length, as ``LM.encode`` and the cross-attention layers call it: every
    ``FULL_FLASH_SHAPES`` entry in float32 and bf16 against the plain
    version (into ``errs``; softcap 50 at the vision prefill's shape too),
    the first two timed in bf16 beside their bound, the plain version and
    SDPA."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (B, H, Hkv, D, Sq, Skv) in FULL_FLASH_SHAPES.items():
        q = torch.randn(B, Sq, H, D, generator=gen, device=dev).transpose(1, 2)
        k, v = (torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).transpose(1, 2)
                for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            for softcap in ((None, 50.0) if name == "cross" else (None,)):
                kw = dict(causal=False, softcap=softcap)
                x = [t.to(dtype) for t in (q, k, v)]
                got = ops.flash_attention(*x, **kw)
                want = ref.attention_ref(*[t.float() for t in x], **kw)
                torch.cuda.synchronize()
                errs[f"{name}/B{B}/Sq{Sq}/Skv{Skv}/{str(dtype)[6:]}/cap{softcap}"] = \
                    close(got, want, dtype)
        if name not in ("cross", "encoder"):
            continue
        x = [t.to(torch.bfloat16) for t in (q, k, v)]
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in x[1:])
        b_ms, b_by = bound(*_full_flash_cost(B, H, Hkv, Sq, Skv, D, 2), torch.bfloat16)
        out[name] = {"shape": f"B={B} H={H} Hkv={Hkv} D={D} Sq={Sq} Skv={Skv} non-causal bf16",
                     "ms": time_ms(lambda: ops.flash_attention(*x, causal=False), iters=20),
                     "plain_ms": time_ms(lambda: ref.attention_ref(*x, causal=False), iters=5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": time_ms(lambda: sdpa(x[0], kr, vr), iters=20)}
    return out


def check_dense_flash(gen, dev):
    """The slot pool's prefill attention as ``full_attention`` passes it:
    (B, S, H, D) tensors viewed as (B, H, S, D).  The boot prefill's shape
    (B=1, S=8, the engine's boot, and a shorter prompt's S=5), the
    verifier's (``LM.apply`` over two challenges of 16-64 prompt and 16
    response tokens: B=2, S=48 and S=80, timed at S=80) and a long
    two-row prompt (B=2, S=1024, timed: its own launch count is 0 on the
    serving run, 1 per 2048-token prefill)."""
    from repro_torch.kernels.flash_attention import ops, ref
    H, Hkv, D = 32, 8, 128

    def inputs(B, S):
        return [torch.randn(B, S, n, D, generator=gen, device=dev).transpose(1, 2)
                for n in (H, Hkv, Hkv)]

    errs = {}
    for B, S in ((1, 8), (1, 5), (2, 48), (2, 80), (2, 1024)):
        q, k, v = inputs(B, S)
        for dtype in (torch.float32, torch.bfloat16):
            cases = ((True, None, None), (True, 256, None), (True, None, 50.0),
                     (False, None, None)) if S > 80 else ((True, None, None),)
            for causal, window, softcap in cases:
                kw = dict(causal=causal, window=window, softcap=softcap)
                x = [t.to(dtype) for t in (q, k, v)]
                got = ops.flash_attention(*x, **kw)
                want = ref.attention_ref(*[t.float() for t in x], **kw)
                torch.cuda.synchronize()
                errs[f"B{B}/S{S}/{str(dtype)[6:]}/causal{causal}/w{window}/cap{softcap}"] = \
                    close(got, want, dtype)

    def timed(B, S, iters, plain_iters):
        x = [t.to(torch.bfloat16) for t in inputs(B, S)]
        ms = time_ms(lambda: ops.flash_attention(*x), iters=iters)
        ms = (ms, event_ms(lambda: ops.flash_attention(*x), iters=iters))
        plain_ms = time_ms(lambda: ref.attention_ref(*x), iters=plain_iters)
        return x, ms, plain_ms, bound(*_dense_flash_cost(B, H, Hkv, S, D, 2), torch.bfloat16)

    B, S = 2, 1024
    x, ms, plain_ms, (bound_ms, bound_by) = timed(B, S, 20, 5)
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in x[1:])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(x[0], kr, vr, is_causal=True), iters=20)
    sx, s_ms, s_plain_ms, (s_bound_ms, _) = timed(1, 8, 50, 10)
    skr, svr = (t.repeat_interleave(H // Hkv, dim=1) for t in sx[1:])
    s_library_ms = time_ms(lambda: sdpa(sx[0], skr, svr, is_causal=True))
    vx, v_ms, v_plain_ms, (v_bound_ms, v_bound_by) = timed(2, 80, 50, 10)
    vkr, vvr = (t.repeat_interleave(H // Hkv, dim=1) for t in vx[1:])
    v_library_ms = time_ms(lambda: sdpa(vx[0], vkr, vvr, is_causal=True))
    full = _full_flash(gen, dev, errs)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            **_summary(errs), "ms": ms[0], "event_ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "timed_at": "B=2 H=32 Hkv=8 S=1024 D=128 causal bf16, (B,S,H,D) views",
            "serving": {"shape": "B=1 S=8 H=32 Hkv=8 D=128 causal bf16 (the boot prefill)",
                        "ms": s_ms[0], "event_ms": s_ms[1], "plain_ms": s_plain_ms,
                        "bound_ms": s_bound_ms, "library_ms": s_library_ms},
            "verification": {"shape": "B=2 S=80 H=32 Hkv=8 D=128 causal bf16 (the "
                                      "verifier's LM.apply over two challenges)",
                             "ms": v_ms[0], "event_ms": v_ms[1], "plain_ms": v_plain_ms,
                             "bound_ms": v_bound_ms, "bound_by": v_bound_by,
                             "library_ms": v_library_ms},
            **full, "errs": errs}


# the backward's cases: (B, H, Hkv, Sq, Skv, D, causal, window, softcap): the
# training shape, danube's D=80 under a 256-key window, gemma2's D=256 with
# its softcap 50, granite's 48 query heads on one KV head, a non-causal
# cross-attention over 1600 keys; then a softcap of 3, where it bites: at
# 50 the scores of randn inputs (about N(0, 1) after the scale) keep 1 -
# tanh^2 above 0.98, so a backward without that factor stays inside the
# bf16 gate, while at 3 it moves dK and dQ by 10-20x the gate; at D=256
# and D=128, on grids whose dK/dV walk is split (the first two) and whole.
# float32 at a quarter of the sequence
FLASH_BWD_SHAPES = {"train": (2, 32, 8, 2048, 2048, 128, True, None, None),
                    "window": (1, 32, 8, 1024, 1024, 80, True, 256, None),
                    "softcap": (1, 16, 8, 512, 512, 256, True, None, 50.0),
                    "granite": (1, 48, 1, 512, 512, 128, True, None, None),
                    "cross": (2, 32, 8, 256, 1600, 128, False, None, None),
                    "cap3_d256_split": (1, 16, 8, 384, 384, 256, True, None, 3.0),
                    "cap3_granite_split": (1, 48, 1, 512, 512, 128, True, None, 3.0),
                    "cap3_d256": (2, 16, 8, 1024, 1024, 256, True, None, 3.0),
                    "cap3_d128": (2, 32, 8, 1024, 1024, 128, True, None, 3.0)}
# each gradient's largest error relative to its largest entry
FLASH_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_bwd_cost(B, H, Hkv, Sq, Skv, D, causal, esize):
    """Bytes and FLOPs of the backward: q, o, dO, K, V (and the f32 lse)
    read once, dQ, dK, dV written once; five products of the visible
    (query, key) pairs by D (Q K^T, dO V^T, dV, dK, dQ)."""
    pairs = B * H * (Sq * (Sq + 1) // 2 if causal and Sq == Skv else Sq * Skv)
    nbytes = (4 * B * H * Sq * D + 4 * B * Hkv * Skv * D) * esize + 4 * B * H * Sq
    return nbytes, 5 * 2 * pairs * D


# the bf16 backward's timed shapes beyond the training one: granite's 48
# query heads on one KV head (the split dK/dV walk) and gemma2's D=256 with
# its softcap 50 (dV and dK walked in two passes)
FLASH_BWD_TIMED = {"granite": (2, 48, 1, 2048, 2048, 128, True, None, None),
                   "gemma2": (2, 16, 8, 2048, 2048, 256, True, None, 50.0)}


def _flash_bwd_inputs(gen, dev, B, H, Hkv, Sq, Skv, D, dtype):
    """q, k, v, dO of one backward case from randn: (B, H, S, D) views of
    (B, S, H, D) tensors."""
    q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
    k, v = (torch.randn(B, Skv, Hkv, D, generator=gen, device=dev).to(dtype)
            .transpose(1, 2) for _ in range(2))
    do = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype).transpose(1, 2)
    return q, k, v, do


def flash_bwd_case(gen, dev, shape, dtype):
    """One ``FLASH_BWD_SHAPES`` case in ``dtype`` (float32 at a quarter of
    the sequence): the forward's lse against ``lse_ref``, each gradient of
    ``flash_attention_bwd`` against ``attention_bwd_ref`` as [largest
    error, that error over the gradient's largest entry], and whether a
    second call gave the same bits."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, H, Hkv, Sq, Skv, D, causal, window, softcap = shape
    if dtype == torch.float32:
        Sq, Skv = Sq // 4, Skv // 4 if Skv == Sq else Skv
    q, k, v, do = _flash_bwd_inputs(gen, dev, B, H, Hkv, Sq, Skv, D, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = ops._dense_forward(q, k, v, causal, window, softcap, D ** -0.5, with_lse=True)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
    return {"key": f"Sq{Sq}/Skv{Skv}/D{D}/{str(dtype)[6:]}",
            "same_bits": all(torch.equal(a, b) for a, b in zip(got, again)),
            "lse_err": (lse - ref.lse_ref(q, k, **kw)).abs().max().item(),
            "errs": {g: [(a.float() - b).abs().max().item(),
                         ((a.float() - b).abs().max() / b.abs().max()).item()]
                     for g, a, b in zip(("dq", "dk", "dv"), got, want)}}


def _flash_bwd_plans_agree():
    """``ops.bwd_plan``'s scratch and splits against the built source's
    own (``ops.launch_plan``) over the head layouts of ``FLASH_BWD_SHAPES``
    and ``FLASH_BWD_TIMED`` at rows 1-8 and 1-8192 positions, both
    dtypes; returns the shapes compared."""
    from repro_torch.kernels.flash_attention import ops
    layouts = {(H, Hkv, D) for B, H, Hkv, Sq, Skv, D, *_ in
               (*FLASH_BWD_SHAPES.values(), *FLASH_BWD_TIMED.values())}
    n = 0
    for H, Hkv, D in sorted(layouts):
        for B in (1, 2, 8):
            for Sq, Skv in ((1, 1), (63, 63), (300, 300), (256, 1600), (2048, 2048),
                            (8192, 8192)):
                for dtype in (torch.float32, torch.bfloat16):
                    mirror = ops.bwd_plan(B, H, Hkv, Sq, Skv, D, dtype)
                    got = ops.launch_plan(B, H, Hkv, Sq, Skv, D, dtype)
                    assert got == (mirror["scratch"], mirror.get("splits", 1)), \
                        (B, H, Hkv, Sq, Skv, D, dtype, got, mirror)
                    n += 1
    return n


def check_flash_bwd(gen, dev):
    """Row 2b: the flash kernel's backward (``flash_attention_bwd``, after
    the forward's lse) against ``attention_bwd_ref`` at every
    ``FLASH_BWD_SHAPES`` case, f32 (the scalar body) and bf16 (the wgmma
    body), each gradient within ``FLASH_BWD_TOL`` of its largest entry, and
    a second call giving the same bits; ``bwd_plan`` equal to the source's
    plan; then timed in bf16 at the training shape, and at
    ``FLASH_BWD_TIMED``'s, each beside its bound, the plain version and the
    backward of SDPA (the backward pass alone; without the softcap, which
    SDPA does not take), with each device function's launches held to the
    plan's."""
    from repro_torch.kernels.flash_attention import ops, ref
    errs, same_bits = {}, {}
    for name, shape in FLASH_BWD_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            r = flash_bwd_case(gen, dev, shape, dtype)
            key = f"{name}/{r['key']}"
            same_bits[key] = r["same_bits"]
            assert same_bits[key], (name, dtype, "two calls differ")
            assert r["lse_err"] <= 1e-4, (name, dtype, r["lse_err"])
            for gname, (abs_err, err) in r["errs"].items():
                assert err <= FLASH_BWD_TOL[dtype], (name, dtype, gname, err)
                errs[f"{key}/{gname}"] = [abs_err, err / FLASH_BWD_TOL[dtype]]
    plans_compared = _flash_bwd_plans_agree()

    def inputs(*shape):
        return _flash_bwd_inputs(gen, dev, *shape)

    def timed(B, H, Hkv, S, Skv, D, causal, window, softcap):
        """Device ms of the kernel, its plain version and SDPA's backward at
        one bf16 shape, with the bound and the launch plan."""
        q, k, v, do = inputs(B, H, Hkv, S, Skv, D, torch.bfloat16)
        kw = dict(causal=causal, window=window, softcap=softcap)
        o, lse = ops._dense_forward(q, k, v, causal, window, softcap, D ** -0.5,
                                    with_lse=True)
        ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, do, lse, **kw), iters=5,
                     warmup=2)
        plain_ms = time_ms(lambda: ref.attention_bwd_ref(q, k, v, o, do, lse, **kw), iters=2,
                           warmup=1)
        b_ms, b_by = bound(*_flash_bwd_cost(B, H, Hkv, S, Skv, D, causal, 2), torch.bfloat16)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        x = [t.detach().repeat_interleave(H // t.shape[1], dim=1).requires_grad_(True)
             for t in (q, k, v)]
        out = sdpa(*x, is_causal=causal)
        library_ms = time_ms(lambda: torch.autograd.grad(out, x, do, retain_graph=True),
                             iters=10, warmup=2)
        fwd_ms = time_ms(lambda: ops._dense_forward(q, k, v, causal, window, softcap,
                                                    D ** -0.5, with_lse=True),
                         iters=10, warmup=2)

        def calls(n=5):
            for _ in range(n):
                ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            torch.cuda.synchronize()
        by_kernel = {f: {"ms": r["ms"] / 5, "launches": r["launches"] / 5}
                     for f, r in _bwd_kernel_ms(_device_rows(calls)).items() if r["launches"]}
        plan = ops.bwd_plan(B, H, Hkv, S, Skv, D, torch.bfloat16)
        planned = collections.Counter(k["name"] for k in plan["launches"])
        assert {f: r["launches"] for f, r in by_kernel.items()} == planned, \
            (by_kernel, planned)
        del x, out, q, k, v, do, o, lse
        launches = [[k["name"], k.get("pass"), list(k["grid"]), k["threads"], k["smem"]]
                    for k in plan["launches"]]
        return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms, "forward_with_lse_ms": fwd_ms,
                "by_kernel": by_kernel,
                "plan": {"splits": plan["splits"], "launches": launches}}

    train = timed(*FLASH_BWD_SHAPES["train"])
    others = {}
    for name, shape in FLASH_BWD_TIMED.items():
        B, H, Hkv, S, _, D, _, _, softcap = shape
        others[name] = {"shape": f"B={B} H={H} Hkv={Hkv} S={S} D={D} causal bf16"
                                 + (f" softcap {softcap}" if softcap else ""),
                        **timed(*shape)}
        _free()
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83 (backward of; "
                        "the reference differentiates its jnp attention)",
            **_summary(errs), **train,
            "timed_at": "B=2 H=32 Hkv=8 S=2048 D=128 causal bf16, (B,S,H,D) views; "
                        "library: SDPA's backward alone on H-expanded K/V",
            "timed_more": others,
            "same_bits_on_a_second_call": all(same_bits.values()),
            "plans_equal_the_source": plans_compared, "errs": errs}


def _decode_cost(lengths, H, Hkv, D, esize):
    """Bytes and FLOPs of a dense decode call: q of live rows, every row's
    output and length, and the visible K/V; QK^T and PV over it."""
    lens = lengths.tolist()
    visible = sum(lens)
    nbytes = (sum(n > 0 for n in lens) * H * D * esize + len(lens) * H * D * esize
              + 2 * visible * Hkv * D * esize + 4 * len(lens))
    return nbytes, 4 * visible * H * D


def check_dense_decode(gen, dev):
    """The slot pool's decode at the shapes the serving run gives it: the
    pool round at B=4 (lengths 1000/517/0/33, one dead row; timed) and the
    teacher-forced batch-1 decodes of a prompt (B=1 at lengths 9, 100 and
    600, 32 splits of which most are empty), all over a 1024-position
    cache."""
    from repro_torch.kernels.decode_attention import ops, ref
    H, Hkv, S, D = 32, 8, 1024, 128

    def inputs(B):
        return [torch.randn(B, *shape, generator=gen, device=dev)
                for shape in ((H, D), (S, Hkv, D), (S, Hkv, D))]

    errs = {}
    pool = torch.tensor([1000, 517, 0, 33], dtype=torch.int32, device=dev)
    cases = [(pool, inputs(4))] + [
        (torch.tensor([n], dtype=torch.int32, device=dev), inputs(1)) for n in (9, 100, 600)]
    for lengths, (q, k, v) in cases:
        live = lengths > 0
        for dtype in (torch.float32, torch.bfloat16):
            for window, softcap in ((None, None), (256, None), (None, 50.0), (256, 50.0)):
                kw = dict(window=window, softcap=softcap)
                x = [t.to(dtype) for t in (q, k, v)]
                got = ops.decode_attention(*x, lengths, **kw)
                want = ref.decode_attention_ref(*[t.float() for t in x], lengths, **kw)
                torch.cuda.synchronize()
                errs[f"len{lengths.tolist()}/{str(dtype)[6:]}/w{window}/cap{softcap}"] = \
                    close(got[live], want[live], dtype)
                assert not got[~live].any(), "dead row must be zeros"

    def timed(lengths, x):
        ms = (time_ms(lambda: ops.decode_attention(*x, lengths)),
              event_ms(lambda: ops.decode_attention(*x, lengths)))
        plain_ms = time_ms(lambda: ref.decode_attention_ref(*x, lengths), iters=10)
        return ms, plain_ms, bound(*_decode_cost(lengths, H, Hkv, D, 2), torch.bfloat16)

    lengths, x = cases[0][0], [t.to(torch.bfloat16) for t in cases[0][1]]
    B = len(lengths)
    ms, plain_ms, (bound_ms, bound_by) = timed(lengths, x)
    # library yardstick: one SDPA call over the cache expanded to (B, H, S,
    # D) with a boolean length mask (the expansion is not timed)
    kd, vd = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1) for t in x[1:])
    mask = (torch.arange(S, device=dev)[None] < lengths[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(x[0][:, :, None], kd, vd, attn_mask=mask))
    memory = _decode_memory(gen, dev, errs)
    one, sx = cases[2][0], [t.to(torch.bfloat16) for t in cases[2][1]]
    s_ms, s_plain_ms, (s_bound_ms, _) = timed(one, sx)
    skd, svd = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1) for t in sx[1:])
    smask = (torch.arange(S, device=dev)[None] < one[:, None])[:, None, None]
    s_library_ms = time_ms(lambda: sdpa(sx[0][:, :, None], skd, svd, attn_mask=smask))
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
            **_summary(errs), "ms": ms[0], "event_ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "timed_at": f"B=4 H=32 Hkv=8 S=1024 D=128 lengths=[1000,517,0,33] bf16 "
                        f"n_splits={ops.n_splits(B, Hkv, S)}",
            "serving": {"shape": f"B=1 H=32 Hkv=8 S=1024 D=128 length=100 bf16 "
                                 f"n_splits={ops.n_splits(1, Hkv, S)} (a teacher-forced "
                                 "prompt token)",
                        "ms": s_ms[0], "event_ms": s_ms[1], "plain_ms": s_plain_ms,
                        "bound_ms": s_bound_ms, "library_ms": s_library_ms},
            "memory": memory, "errs": errs}


# cross-attention decodes over a static memory, every position valid: (H,
# Hkv, D, S) of vision's 1600 image tokens (timed) and whisper's 1500 frames
DECODE_MEMORY_SHAPES = {"vision": (32, 8, 128, 1600), "whisper": (8, 8, 64, 1500)}


def _decode_memory(gen, dev, errs):
    """The dense decode as a cross-attention layer calls it: B=4 rows, each
    attending all S memory positions, float32 and bf16 against the plain
    version (into ``errs``); vision's shape timed in bf16 beside its bound,
    the plain version and SDPA."""
    from repro_torch.kernels.decode_attention import ops, ref
    B = 4
    out = {}
    for name, (H, Hkv, D, S) in DECODE_MEMORY_SHAPES.items():
        q, k, v = (torch.randn(B, *shape, generator=gen, device=dev)
                   for shape in ((H, D), (S, Hkv, D), (S, Hkv, D)))
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, k, v)]
            got = ops.decode_attention(*x, lengths)
            want = ref.decode_attention_ref(*[t.float() for t in x], lengths)
            torch.cuda.synchronize()
            errs[f"memory/{name}/S{S}/{str(dtype)[6:]}"] = close(got, want, dtype)
        if name != "vision":
            continue
        x = [t.to(torch.bfloat16) for t in (q, k, v)]
        kd, vd = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1) for t in x[1:])
        sdpa = torch.nn.functional.scaled_dot_product_attention
        b_ms, b_by = bound(*_decode_cost(lengths, H, Hkv, D, 2), torch.bfloat16)
        out = {"shape": f"B=4 H={H} Hkv={Hkv} D={D} S={S} all valid bf16 "
                        f"n_splits={ops.n_splits(B, Hkv, S)} (vision's cross-attention decode)",
               "ms": time_ms(lambda: ops.decode_attention(*x, lengths)),
               "plain_ms": time_ms(lambda: ref.decode_attention_ref(*x, lengths), iters=10),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": time_ms(lambda: sdpa(x[0][:, :, None], kd, vd))}
    return out


def _scan_cost(B, S, H, P, N, L, esize, h0=True):
    """Bytes and FLOPs of the chunked scan: xbar read and y written,
    loga (f32), B and C, h0 read (if given) and the final state written
    (f32); the
    causal (lower-triangular) C.B^T and att.xbar products, the C.h and the
    state-update products, per chunk and head."""
    nbytes = 2 * B * S * H * P * esize + 4 * B * S * H + 2 * B * S * N * esize \
        + (2 if h0 else 1) * 4 * B * H * N * P
    flops = 0
    for c in range(-(-S // L)):
        n = min(L, S - c * L)
        tri = n * (n + 1) // 2
        flops += B * H * (2 * tri * N + 2 * tri * P + 4 * n * N * P)
    return nbytes, flops


def check_mamba_scan(gen, dev):
    """The scan at the serving run's boot prefill (B=1, 8 tokens and a
    shorter 5-token prompt: one chunk of L=S, no initial state; two rows
    of 8; bf16 takes the one-launch boot path), at the full-width
    2048-token prefill's shape (64 heads of 128, N=16, L=128, 16 chunks;
    timed; bf16: chunk states, state passing, chunk outputs), and at a
    ragged tail and short chunks with a state to continue from."""
    from repro_torch.kernels.mamba_scan import ops, ref

    def inputs(B, S, H, P, N):
        return ((torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5),
                -torch.nn.functional.softplus(
                    torch.randn(B, S, H, generator=gen, device=dev)),
                torch.randn(B, S, N, generator=gen, device=dev) * 0.5,
                torch.randn(B, S, N, generator=gen, device=dev) * 0.5,
                torch.randn(B, H, N, P, generator=gen, device=dev) * 0.1)

    errs = {}
    for B, S, H, P, N, chunk, with_h0 in (
            (1, 8, 64, 128, 16, 128, False), (1, 5, 64, 128, 16, 128, False),
            (2, 8, 64, 128, 16, 128, False), (1, 2048, 64, 128, 16, 128, True),
            (2, 300, 8, 128, 16, 128, True), (2, 37, 2, 128, 8, 16, True)):
        xbar, loga, Bm, Cm, h0 = inputs(B, S, H, P, N)
        h0 = h0 if with_h0 else None
        for dtype in (torch.float32, torch.bfloat16):
            xb, bm, cm = (t.to(dtype) for t in (xbar, Bm, Cm))
            y, h = ops.mamba_scan(xb, loga, bm, cm, h0, chunk=chunk)
            wy, wh = ref.mamba_scan_ref(xb.float(), loga, bm.float(), cm.float(), h0,
                                        chunk=chunk)
            torch.cuda.synchronize()
            ey, eh = close(y, wy, dtype), close(h, wh, dtype)
            errs[f"B{B}/S{S}/H{H}/L{min(chunk, S)}/h0{with_h0}/{str(dtype)[6:]}"] = \
                [max(ey[0], eh[0]), max(ey[1], eh[1])]

    def timed(S, h0, iters, plain_iters):
        B, H, P, N, L = 1, 64, 128, 16, 128
        xbar, loga, Bm, Cm, h = inputs(B, S, H, P, N)
        h = h if h0 else None
        xb, bm, cm = (t.to(torch.bfloat16) for t in (xbar, Bm, Cm))
        ms = (time_ms(lambda: ops.mamba_scan(xb, loga, bm, cm, h, chunk=L), iters=iters),
              event_ms(lambda: ops.mamba_scan(xb, loga, bm, cm, h, chunk=L), iters=iters))
        plain_ms = time_ms(lambda: ref.mamba_scan_ref(xb, loga, bm, cm, h, chunk=L),
                           iters=plain_iters)
        return ms, plain_ms, bound(*_scan_cost(B, S, H, P, N, L, 2, h0), torch.bfloat16), \
            ops.plan(B, S, H, P, N, min(L, S), torch.bfloat16, h0)

    ms, plain_ms, (bound_ms, bound_by), p = timed(2048, True, 20, 5)
    s_ms, s_plain_ms, (s_bound_ms, _), s_p = timed(8, False, 50, 10)
    return {"name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:63",
            **_summary(errs), "ms": ms[0], "event_ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "none: no single PyTorch call computes the SSD scan",
            "timed_at": "B=1 S=2048 H=64 P=128 N=16 L=128 bf16 with h0 (16 chunks)",
            "path": [p["path"], [k["name"] for k in p["kernels"]]],
            "serving": {"shape": "B=1 S=8 H=64 P=128 N=16 L=8 bf16, no h0 (the boot prefill)",
                        "ms": s_ms[0], "event_ms": s_ms[1], "plain_ms": s_plain_ms,
                        "bound_ms": s_bound_ms,
                        "path": [s_p["path"], [k["name"] for k in s_p["kernels"]]]},
            "errs": errs}


def _mlstm_cost(B, S, H, dh, L, esize, state=True):
    """Bytes and FLOPs of the chunkwise mLSTM: q, k, v read and h written,
    the f32 gates read, the f32 start state read (if given) and the final
    state written; the causal (lower-triangular) q k^T and att v, and q C
    and the state update (dh x dh per step), per chunk and head, plus the
    q n and n products."""
    st = 4 * B * H * (dh * dh + dh + 1)
    nbytes = 4 * B * S * H * dh * esize + 2 * 4 * B * S * H + (2 if state else 1) * st
    flops = 0
    for c in range(-(-S // L)):
        n = min(L, S - c * L)
        tri = n * (n + 1) // 2
        flops += B * H * (4 * tri * dh + 4 * n * dh * dh + 4 * n * dh)
    return nbytes, flops


def check_mlstm(gen, dev):
    """The chunkwise mLSTM at xlstm-1.3b's full width (H=4, dh=1024, L=64):
    a 2048-token prefill with a start state (timed), the serving run's boot
    prefill (B=1, 8 tokens, one chunk of L=8, no state; timed), two rows of
    a 40-token boot (one chunk, no state: bf16's boot path at B=2), a
    ragged 300-token prompt with a state, two rows of 130 tokens, and the
    reduced model's width (dh=32, chunks of 16)."""
    from repro_torch.kernels.mlstm import ops, ref

    def inputs(B, S, H, dh, state):
        q = torch.randn(B, S, H, dh, generator=gen, device=dev) / dh ** 0.5
        k, v = (torch.randn(B, S, H, dh, generator=gen, device=dev) for _ in range(2))
        log_i = torch.randn(B, S, H, generator=gen, device=dev) * 2
        log_f = torch.nn.functional.logsigmoid(
            torch.randn(B, S, H, generator=gen, device=dev) + 4)
        st = None
        if state:
            st = (torch.randn(B, H, dh, dh, generator=gen, device=dev) * 0.1,
                  torch.randn(B, H, dh, generator=gen, device=dev) * 0.1,
                  torch.randn(B, H, generator=gen, device=dev))
        return q, k, v, log_i, log_f, st

    errs = {}
    for B, S, H, dh, chunk, with_state in (
            (1, 2048, 4, 1024, 64, True), (1, 8, 4, 1024, 64, False),
            (2, 40, 4, 1024, 64, False),
            (1, 300, 4, 1024, 64, True), (2, 130, 4, 1024, 64, False),
            (2, 37, 2, 32, 16, True)):
        q, k, v, log_i, log_f, st = inputs(B, S, H, dh, with_state)
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, k, v)]
            h, fin = ops.mlstm_chunkwise(*x, log_i, log_f, st, chunk=chunk)
            wh, wfin = ref.mlstm_ref(*[t.float() for t in x], log_i, log_f, st, chunk=chunk)
            torch.cuda.synchronize()
            e = [close(h, wh, dtype, MLSTM_TOL_H[dtype])] + \
                [close(a, b, dtype) for a, b in zip(fin, wfin)]
            errs[f"B{B}/S{S}/H{H}/dh{dh}/L{min(chunk, S)}/state{with_state}/{str(dtype)[6:]}"] = \
                [max(r[0] for r in e), max(r[1] for r in e)]

    def timed(S, state, iters, plain_iters):
        B, H, dh, L = 1, 4, 1024, 64
        q, k, v, log_i, log_f, st = inputs(B, S, H, dh, state)
        x = [t.to(torch.bfloat16) for t in (q, k, v)]
        ms = (time_ms(lambda: ops.mlstm_chunkwise(*x, log_i, log_f, st, chunk=L), iters=iters),
              event_ms(lambda: ops.mlstm_chunkwise(*x, log_i, log_f, st, chunk=L), iters=iters))
        plain_ms = time_ms(lambda: ref.mlstm_ref(*x, log_i, log_f, st, chunk=L),
                           iters=plain_iters)
        return ms, plain_ms, bound(*_mlstm_cost(B, S, H, dh, L, 2, state), torch.bfloat16)

    ms, plain_ms, (bound_ms, bound_by) = timed(2048, True, 10, 3)
    s_ms, s_plain_ms, (s_bound_ms, s_bound_by) = timed(8, False, 50, 10)
    return {"name": "mlstm", "route": "cuda",
            "source": "src/repro_torch/kernels/mlstm/csrc/mlstm.cu",
            "replaces": "src/repro/kernels/mlstm/kernel.py:106",
            **_summary(errs), "ms": ms[0], "event_ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library": "none: no single PyTorch call computes the mLSTM",
            "timed_at": "B=1 S=2048 H=4 dh=1024 L=64 bf16 with a start state (32 chunks)",
            "serving": {"shape": "B=1 S=8 H=4 dh=1024 L=8 bf16, no state (the boot prefill)",
                        "ms": s_ms[0], "event_ms": s_ms[1], "plain_ms": s_plain_ms,
                        "bound_ms": s_bound_ms, "bound_by": s_bound_by},
            "tol": "h in float32 at atol=rtol=2e-4 (MLSTM_TOL_H), the state at TOL",
            "errs": errs}


# The overlay phases' chunk-length array L: what the Sentry builds for system
# prompts of 128 and 256 tokens (core/sentry.build_lengths: 128, a delta of
# 8, 120), so the traffic's 256-token shared prefix ends on a chunk boundary
OVERLAY_PROMPT_LENS = (128, 256)


def _overlay_lengths():
    from repro_torch.core.sentry import build_lengths
    return build_lengths(OVERLAY_PROMPT_LENS, 8)


def check_chunk_hash(seed, dev):
    """The chunk-hash kernel against its plain version, exactly (hashes are
    integers), at three shapes: the fixed entry at B=64 prompts x S=8192,
    width 64 (a sync broadcast's 64 prompts at the 8k prompts of the JAX
    package's bench_kernels.py); the ranged entry on the overlay phases'
    prompts with their Sentry-style L (one sync broadcast, the shape the
    overlay path launches and the one the ``kernels`` line reports); and the
    ranged entry on one 600-token prompt (one ``decide()``).  Beside each
    ranged shape, ``floor_ms``: an empty kernel with its launch shape.
    Beside each shape, the host's wall time for the Python
    ``hrtree.preprocess`` loop over the same prompts (what the JAX
    package's node pays) and for the port's ``preprocess_batch`` (table,
    copies, launch and ``.cpu()``)."""
    from repro_torch import configs
    from repro_torch.core import hrtree
    from repro_torch.kernels.chunk_hash import ops, ref
    vocab = configs.get_config(NAME).vocab
    rng = np.random.default_rng(seed)
    L = _overlay_lengths()
    bits = 8

    def host_ms(fn, reps):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3

    def yardsticks(prompts, lengths, reps):
        return {"python_preprocess_ms": host_ms(
                    lambda: [hrtree.preprocess(p, lengths, bits) for p in prompts], 1),
                "preprocess_batch_ms": host_ms(
                    lambda: hrtree.preprocess_batch(prompts, lengths, bits, device=dev), reps)}

    shapes, errs = {}, {}
    # fixed entry, B=64 x S=8192
    toks = torch.from_numpy(rng.integers(0, vocab, (64, 8192)).astype(np.int32)).to(dev)
    toks[0, :64] = 2**31 - 1                  # t + 1 wraps in uint32
    for b in (4, 8, 16, 32):
        got = ops.chunk_hash_fixed(toks, 64, b)
        want = ref.chunk_hash_fixed_ref(toks, 64, b)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"fixed entry, bits={b}"
        errs[f"fixed/64x8192/w64/bits{b}"] = [(got - want).abs().max().item(), 0.0]
    # bytes: each token read once, each int64 hash written once; operations:
    # ~4 integer ops a token, against the table's non-tensor fp32 rate (it
    # has no integer rate): ~50x under the bytes, whatever the exact rate
    nbytes = toks.numel() * 4 + toks.numel() // 64 * 8
    bound_ms, bound_by = bound(nbytes, 4 * toks.numel(), torch.float32)
    rows = [t.tolist() for t in toks.cpu()]
    shapes["fixed B=64 S=8192 width=64 bits=8"] = {
        "ms": time_ms(lambda: ops.chunk_hash_fixed(toks, 64, bits)),
        "plain_ms": time_ms(lambda: ref.chunk_hash_fixed_ref(toks, 64, bits), iters=10),
        "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
        "chunks": toks.numel() // 64,
        **yardsticks(rows, [], 3)}
    # ranged entry: one sync broadcast of the overlay prompts, and one decide()
    sync = _traffic(seed, vocab)
    one = [(sync[0] + rng.integers(0, vocab, 600).tolist())[:600]]
    sync_name = f"ranged sync broadcast: {len(sync)} prompts L={L}"
    for name, prompts in ((sync_name, sync),
                          (f"ranged decide(): 1 prompt of 600 tokens L={L}", one)):
        flat, st, ln, _ = hrtree.chunk_table(prompts, L, device=dev)
        for b in (8, 32):
            got = ops.chunk_hash_ranges(flat, st, ln, b)
            want = ref.chunk_hash_ranges_ref(flat, st, ln, b)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"{name}, bits={b}"
            assert got.tolist() == [h for p in prompts
                                    for h in hrtree.preprocess(p, L, b)], f"{name} vs preprocess"
            errs[f"{name}/bits{b}"] = [(got - want).abs().max().item(), 0.0]
        nb = int(ln.sum()) * 4 + len(ln) * (8 + 8)      # + the (start, len) table
        nb_ms, nb_by = bound(nb, 4 * int(ln.sum()), torch.float32)
        shapes[name] = {
            "ms": time_ms(lambda: ops.chunk_hash_ranges(flat, st, ln, bits)),
            # an empty kernel with the same launch shape: a launch's own cost
            "floor_ms": time_ms(lambda: ops.launch_floor(len(ln), dev)),
            "plain_ms": time_ms(lambda: ref.chunk_hash_ranges_ref(flat, st, ln, bits), iters=10),
            "bytes": nb, "bound_ms": nb_ms, "bound_by": nb_by,
            "chunks": len(ln),
            "tokens_hashed": int(ln.sum()), **yardsticks(prompts, L, 20)}
    # the line's times are those of the shape the overlay path launches
    top = shapes[sync_name]
    return {"name": "chunk_hash", "route": "cuda",
            "source": "src/repro_torch/kernels/chunk_hash/csrc/chunk_hash.cu",
            "replaces": "src/repro/kernels/chunk_hash/kernel.py:59",
            **_summary(errs), "ms": top["ms"], "floor_ms": top["floor_ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None,
            "library": "none: no single PyTorch call computes the chunk hash",
            "timed_at": f"{sync_name} bits={bits} (int64 out)",
            "shapes": shapes, "tol": "exact (integers)", "errs": errs}


# --------------------------------------------------------------------------
# serving phases
# --------------------------------------------------------------------------
def _mixed_prompts(vocab):
    """tests/test_spec_decode.py::_mixed_prompts: repetitive and novel."""
    rep = [5, 9, 2, 7] * 10
    return [rep, [(37 * 1 + j) % vocab for j in range(20)], rep[:36],
            [(37 * 3 + j) % vocab for j in range(44)], [3] * 30,
            [(37 * 5 + j) % vocab for j in range(33)]]


def _serve(eng, prompts, max_new, max_active=4):
    """Submit every prompt at once and run the scheduler to the end.
    Returns (results by id, scheduler, wall seconds, and each request's
    TTFT from submit: its queue wait plus its admission prefill, up to its
    first token on the host; a request that finishes in its admission round
    has none)."""
    from repro_torch.serving.engine import Request
    from repro_torch.serving.scheduler import Scheduler
    s = Scheduler(eng, max_active=max_active)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        s.submit(Request(i, p, max_new=max_new, arrival=t0))
    ttft = {}
    for _ in range(10_000):
        if not (s.queue or s.active):
            break
        s.step()
        for sl in s.active:        # t_start: admission; sl.ttft: its prefill
            ttft.setdefault(sl.req.req_id, sl.t_start + sl.ttft - sl.req.arrival)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert not (s.queue or s.active), "scheduler did not drain in 10,000 rounds"
    return {r.req_id: r for r in s.done}, s, wall, ttft


def _wrappers():
    from repro_torch.kernels.chunk_hash import ops as ch
    from repro_torch.kernels.decode_attention import ops as dd
    from repro_torch.kernels.flash_attention import ops as f
    from repro_torch.kernels.mamba_scan import ops as m
    from repro_torch.kernels.mlstm import ops as ml
    from repro_torch.kernels.paged_decode import ops as d
    return {"paged_decode_attention": d.paged_decode_attention,
            "paged_flash_attention": f.paged_flash_attention,
            "flash_attention": f.flash_attention,
            "flash_attention_bwd": f.flash_attention_bwd,
            "decode_attention": dd.decode_attention,
            "mamba_scan": m.mamba_scan,
            "mlstm": ml.mlstm_chunkwise,
            "chunk_hash": ch.chunk_hash_ranges}


def _reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
    for name in ("mlstm", "mamba_scan"):
        _wrappers()[name].boot_launches = 0


def _launches():
    """Each wrapper's launches, and the mLSTM's and the scan's on their
    no-state boot paths (``mlstm_boot`` of ``mlstm``'s, ``mamba_scan_boot``
    of ``mamba_scan``'s)."""
    w = _wrappers()
    return {**{name: fn.launches for name, fn in w.items()},
            "mlstm_boot": w["mlstm"].boot_launches,
            "mamba_scan_boot": w["mamba_scan"].boot_launches}


def f32_parity(seed, dev):
    """Full width, 2 layers, float32: spec == non-spec tokens, prefix-hit
    rerun == cold run, and the card's logits against the plain (CPU) path."""
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine
    cfg = dataclasses.replace(configs.get_config(NAME), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = _mixed_prompts(cfg.vocab)
    _reset_launches()
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    cold, s0, _, _ = _serve(eng, prompts, 24)
    rerun, *_ = _serve(eng, prompts, 24)               # prefix-cache hits
    scfg = dataclasses.replace(cfg, spec_enabled=True, spec_k=4)
    seng = RealEngine(scfg, LM(scfg, dev), params, max_len=128, device=dev)
    spec, s1, _, _ = _serve(seng, prompts, 24)
    launches = _launches()
    tokens = {i: r.output for i, r in cold.items()}
    assert {i: r.output for i, r in spec.items()} == tokens, "spec != non-spec"
    assert {i: r.output for i, r in rerun.items()} == tokens, "prefix hit != cold"
    assert sum(r.cached_tokens for r in rerun.values()) > 0, "rerun had no hits"
    assert seng.spec_dispatches > 0, "no verify dispatch"
    assert launches["paged_decode_attention"] > 0 and launches["paged_flash_attention"] > 0
    del eng, seng

    # one prefill chunk, one decode and one verify window on the card and on
    # the CPU (plain versions) from the same weights and arena
    cpu = torch.device("cpu")
    cparams = _to(params, cpu)
    errs = {}
    arenas = {}
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, size=(2, BLK)).astype(np.int32)
    pt = np.array([[3, 5, 7, 0], [4, 6, 0, 0]], np.int32)
    calls = [("prefill_paged", (pt, tok, np.array([0, 0], np.int32))),
             ("prefill_paged", (pt, tok[::-1].copy(), np.array([32, 0], np.int32))),
             ("decode_paged", (pt, tok[:, :1].copy(), np.array([64, 32], np.int32))),
             ("verify_paged", (pt, tok[:, 3:8].copy(), np.array([65, 33], np.int32),
                               np.array([5, 2], np.int32)))]
    outs = {}
    for name, d, p in (("card", dev, params), ("cpu", cpu, cparams)):
        m = LM(cfg, d)
        arenas[name] = m.paged_arena_zeros(8, BLK)
        outs[name] = []
        for fn, args in calls:
            logits, _ = getattr(m, fn)(p, arenas[name],
                                       *[torch.tensor(a, device=d) for a in args])
            outs[name].append(logits.float().cpu())
    for (fn, _), a, b in zip(calls, outs["card"], outs["cpu"]):
        assert torch.isfinite(a).all(), f"{fn}: non-finite logits"
        if fn == "verify_paged":      # row 1 has 2 real tokens
            a, b = torch.cat([a[0], a[1, :2]]), torch.cat([b[0], b[1, :2]])
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
        errs[fn] = max(errs.get(fn, 0.0), (a - b).abs().max().item())
    return {"phase": "f32_parity", "config": f"{NAME} n_layers=2 float32",
            "reduced": ["n_layers 32 -> 2"], "spec_equals_nonspec": True,
            "prefix_hit_equals_cold": True,
            "hit_tokens": sum(r.cached_tokens for r in rerun.values()),
            "decode_calls_nonspec": s0.metrics["decode_calls"],
            "decode_calls_spec": s1.metrics["decode_calls"],
            "spec_accept_rate": s1.engine.spec_accept_rate,
            "launches": launches, "card_vs_cpu_max_abs_err": errs,
            "tol": "tokens exact; logits atol=rtol=2e-4"}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, dev) for v in tree)
    return tree.to(dev)


def _traffic(seed, vocab, n=8):
    """Prompts of 200..600 tokens; half open with one shared 256-token
    prefix (a system prompt / few-shot header)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=256).tolist()
    prompts = []
    for i in range(n):
        length = int(rng.integers(200, 601))
        body = rng.integers(0, vocab, size=length).tolist()
        prompts.append((shared + body)[:length] if i % 2 == 0 else body)
    return prompts


def _write(out, name, text):
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / name).write_text(text)


def serve_bf16(seed, dev, out):
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine
    cfg = configs.get_config(NAME)
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = _traffic(seed, cfg.vocab)
    runs = {}
    _reset_launches()
    for spec in (False, True):
        scfg = dataclasses.replace(cfg, spec_enabled=spec, spec_k=4)
        eng = RealEngine(scfg, LM(scfg, dev), params, max_len=1024, device=dev)
        torch.cuda.reset_peak_memory_stats()
        done, s, wall, ttft = _serve(eng, prompts, 64)
        gen = sum(len(r.output) for r in done.values())
        assert len(done) == len(prompts) and gen == 64 * len(prompts)
        assert len(ttft) == len(prompts)
        prefill = sorted(r.ttft for r in done.values())
        ttft = sorted(ttft.values())
        runs["spec" if spec else "nonspec"] = {
            "wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
            "ttft_s_mean": sum(ttft) / len(ttft), "ttft_s_max": ttft[-1],
            "admission_prefill_s_mean": sum(prefill) / len(prefill),
            "admission_prefill_s_max": prefill[-1],
            "prefill_dispatches": eng.prefill_dispatches,
            "prefill_tokens": eng.prefill_tokens,
            "hit_tokens": sum(r.cached_tokens for r in done.values()),
            "decode_calls": s.metrics["decode_calls"], "rounds": s.metrics["rounds"],
            "spec_accept_rate": eng.spec_accept_rate,
            "spec_dispatches": eng.spec_dispatches,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "tokens": {i: r.output for i, r in done.items()}}
        del eng
    launches = _launches()
    assert launches["paged_decode_attention"] > 0 and launches["paged_flash_attention"] > 0
    profile = _profile(cfg, params, prompts[:4], dev, out)
    same = sum(runs["spec"]["tokens"][i] == runs["nonspec"]["tokens"][i]
               for i in range(len(prompts)))
    _write(out, "serve_bf16_tokens.json", json.dumps(
        {k: v.pop("tokens") for k, v in runs.items()}))
    return {"phase": "serve_bf16", "config": f"{NAME} full (32 layers) bf16",
            "init_s": init_s, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": 64,
            "spec_rows_equal_nonspec": same, "runs": runs,
            "launches": launches, "profile": profile}, launches, params


# the device kernels behind the two paged wrappers, by demangled or mangled name
PAGED_KERNELS = {"paged_decode_attention": ("decode_kernel<__nv_bfloat16, true>",
                                            "decode_kernel<float, true>",
                                            "decode_kernelI13__nv_bfloat16Lb1E",
                                            "decode_kernelIfLb1E"),
                 "paged_flash_attention": ("tc_kernel<true", "tc_kernelILb1E",
                                           "scalar_kernel<true", "scalar_kernelILb1E")}


# ... and behind the flash kernel's dense entry
ATTN_KERNELS = {**PAGED_KERNELS, "flash_attention": ("tc_kernel<false", "tc_kernelILb0E",
                                                     "scalar_kernel<false",
                                                     "scalar_kernelILb0E")}
# the dense slot pool's two: the flash dense entry and the dense decode
DENSE_KERNELS = {"flash_attention": ATTN_KERNELS["flash_attention"],
                 "decode_attention": ("decode_kernel<__nv_bfloat16, false>",
                                      "decode_kernel<float, false>",
                                      "decode_kernelI13__nv_bfloat16Lb0E",
                                      "decode_kernelIfLb0E")}


def _paged_kernel_ms(rows, kernels=None):
    """Device ms and launches of ``kernels`` (default: the two paged
    kernels) among profile ``rows`` of (name, ms, count)."""
    out = {}
    for wrapper, keys in (kernels or PAGED_KERNELS).items():
        hit = [(ms, n) for name, ms, n in rows if any(k in name for k in keys)]
        out[wrapper] = {"ms": sum(ms for ms, _ in hit), "launches": sum(n for _, n in hit)}
    return out


def _profile(cfg, params, prompts, dev, out, fname="profile_bf16.txt", max_new=16,
             count=(), max_len=1024, num_pages=None):
    """Device time by kernel over a short non-speculative serve of
    ``prompts`` (``max_new`` new tokens each) on a new engine of
    ``max_len`` and ``num_pages`` (default: the engine's), after a warm-up
    request, the card traced alone (``_device_rows``): the device's busy
    share of the wall time, and the kernels that take it (full table under
    ``--out``); the wrappers' launches in the window, and for each key of
    ``count`` the device kernels whose names hold it."""
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import RealEngine
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=max_len, device=dev,
                     **({"num_pages": num_pages} if num_pages else {}))
    _serve(eng, prompts[:1], 2)                               # warm-up
    before = _launches()
    got = []
    rows = _device_rows(lambda: got.append(_serve(eng, prompts, max_new)))
    _, s, wall, _ = got[0]
    launches = {k: n - before[k] for k, n in _launches().items()}
    _write(out, fname, "\n".join(
        f"{ns / 1e6:12.3f} ms {n:8d}x  {k}" for k, ns, n in rows))
    busy = sum(ns for _, ns, _ in rows) / 1e9
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": (1 - busy / wall) if busy else "not measured",
            "decode_calls": s.metrics["decode_calls"],
            "prefill_dispatches": eng.prefill_dispatches,
            "paged_kernels": _paged_kernel_ms([(k, ns / 1e6, n) for k, ns, n in rows]),
            "launches": launches,
            "kernel_counts": {key: sum(n for k, _, n in rows if key in k) for key in count},
            "top": [[k, ns / 1e6, n] for k, ns, n in rows[:12]]}


# --------------------------------------------------------------------------
# the overlay path: two model nodes on one card
# --------------------------------------------------------------------------
OVERLAY_MODES = ("load_only", "affinity", "replicate")


def _overlay(cfg, params, dev, max_len, lengths=(64,), wire_mode=None):
    """Two port model nodes on one ``SimNet``, each with its own
    ``RealEngine`` (its own paged arena) over the one shared ``params``,
    and a response sink."""
    from repro_torch.core.forwarding import ForwardingConfig
    from repro_torch.models.lm import LM
    from repro_torch.net.simnet import SimNet
    from repro_torch.overlay.model_node import ModelNode
    from repro_torch.overlay.probe import ResponseSink
    from repro_torch.serving.engine import RealEngine
    net = SimNet(seed=5)
    model = LM(cfg, dev)
    nodes = [ModelNode(f"m{i}", fwd_cfg=ForwardingConfig(), chunk_lengths=lengths,
                       use_crypto=False,
                       real_engine=RealEngine(cfg, model, params, max_len=max_len, device=dev))
             for i in range(2)]
    for n in nodes:            # the tree hashes on the engine's device: the card
        assert n.hrtree.device.type == n.real_engine.device.type == torch.device(dev).type
        if wire_mode:
            n.real_engine.kv_wire_mode = wire_mode
        net.add_node(n.node_id, n)
        n.join_group(["m0", "m1"])
    sink = ResponseSink()
    net.add_node("sink", sink)
    return net, nodes, sink


def _overlay_seed(net, nodes, seed_prompt, mode, max_new):
    """The first part of the scenarios of tests/test_affinity_serving.py
    and tests/test_kv_migration.py: m0 serves ``seed_prompt``, both nodes
    broadcast their state, and m1's view of m0 is set for the routing to
    test: busy but under the affinity bound (``affinity``), under memory
    and load pressure (``replicate``: m1 will pull the prefix pages), or
    m1 routes by load alone (``load_only``: the reference's lb_only
    ablation, no HR-tree and no sketch)."""
    from repro_torch.overlay.probe import direct_payload
    nodes[0]._process(net, direct_payload("seed", seed_prompt, max_new), forwarded=True)
    net.run_until(net.t + 30)
    for n in nodes:
        n.broadcast_state(net)
    net.run_until(net.t + 5)
    view = nodes[1].peers["m0"]
    if mode == "replicate":
        view.active_requests, view.kv_pressure = 6, 0.95     # rel load 1.2
    else:
        view.active_requests = 3                              # rel load 0.6
    if mode == "load_only":
        nodes[1].fwd_mode = "lb_only"


def _overlay_inject(net, nodes, sink, prompts, max_new):
    """The second part: ``prompts`` arrive at m1 and the network runs
    until every response is in.  Returns its wall seconds (host clock,
    synchronised)."""
    from repro_torch.overlay.probe import direct_payload
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        net.call_after(0.01, nodes[1]._process, net, direct_payload(f"r{i}", p, max_new))
    net.run_until(net.t + 120)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert len(sink.got) == 1 + len(prompts), f"{len(sink.got)} responses"
    for n in nodes:
        n.real_engine.allocator.check()
    return wall


def _node_counts(nodes):
    keys = ("affinity_hits", "forwarded_out", "replicate_routes", "kv_fetches",
            "kv_fetch_piggybacks", "kv_imported_pages", "kv_fallbacks", "kv_wire_bytes",
            "kv_exports", "served")
    return {n.node_id: {**{k: n.metrics[k] for k in keys},
                        "prefill_tokens": n.real_engine.prefill_tokens,
                        "prefill_dispatches": n.real_engine.prefill_dispatches}
            for n in nodes}


def overlay_f32_parity(seed, dev):
    """The overlay scenarios of the CPU tests at full width, 2 layers,
    float32 (TF32 off): a 96-token prefix (three blocks) served on m0, three
    siblings with 8-token tails at m1, routed by load alone, by sketch
    affinity and by replication with the ``raw`` wire mode (the pages ship
    bit for bit): all three give the same tokens, and the counters are the
    CPU scenarios'.  Replication again with the default ``fp16`` wire
    mode: whether its tokens agree is reported, not required."""
    from repro_torch import configs
    from repro_torch.params import init_params
    cfg = dataclasses.replace(configs.get_config(NAME), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, 96).tolist()
    tails = rng.integers(0, cfg.vocab, (4, 8)).tolist()
    seed_prompt, prompts = shared + tails[0], [shared + t for t in tails[1:]]
    runs, counts = {}, {}
    for mode, wire in (("load_only", "raw"), ("affinity", "raw"), ("replicate", "raw"),
                       ("replicate", "fp16")):
        net, nodes, sink = _overlay(cfg, params, dev, 128, wire_mode=wire)
        _overlay_seed(net, nodes, seed_prompt, mode, 16)
        _overlay_inject(net, nodes, sink, prompts, 16)
        runs[mode, wire] = dict(sink.got)
        counts[f"{mode}/{wire}"] = c = _node_counts(nodes)
        m0, m1 = c["m0"], c["m1"]
        assert m0["prefill_tokens"] >= 104 and all(len(v) == 16 for v in sink.got.values())
        if mode == "affinity":
            assert m1["affinity_hits"] == 3 and m1["forwarded_out"] == 3, c
            assert m0["prefill_tokens"] == 104 + 3 * 8 and m1["prefill_tokens"] == 0, c
            assert m0["prefill_dispatches"] == 4 + 1, c
        elif mode == "load_only":
            assert m1["prefill_tokens"] == 3 * 104 and m1["kv_fetches"] == 0, c
        else:
            assert m1["replicate_routes"] == 3 and m1["kv_fetches"] == 1, c
            assert m1["kv_fetch_piggybacks"] == 2 and m1["kv_imported_pages"] == 3, c
            assert m1["prefill_tokens"] == 3 * 8 and m1["prefill_dispatches"] == 1, c
            assert m0["kv_exports"] == 1 and m1["kv_fallbacks"] == 0, c
        del net, nodes, sink
    raw = [runs[m, "raw"] for m in ("load_only", "affinity", "replicate")]
    assert raw[0] == raw[1] == raw[2], "raw-wire tokens differ across routings"
    return {"phase": "overlay_f32_parity", "config": f"{NAME} n_layers=2 float32",
            "reduced": ["n_layers 32 -> 2"], "routings_equal_raw": True,
            "fp16_wire_equals_raw": runs["replicate", "fp16"] == raw[0],
            "counts": counts, "tokens": raw[0]}


def _device_rows(fn):
    """Run ``fn`` under torch.profiler tracing the card only.  Returns
    (name, device ns, count) of each kernel and copy it ran, by device time.
    It sums the tracer's raw device events: building the profiler's per-op
    tables (``key_averages``) over a serving run's ~250,000 events took
    ~60 s a run on an H100 machine, and tracing the host's ops too slows
    the host that is being measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    return sorted(((name, ns, n) for name, (ns, n) in by_name.items()), key=lambda r: -r[1])


def _device_busy_s(fn, top=8, kernels=None):
    """``_device_rows`` of ``fn``, summed: the time of its kernels and
    copies on the device in seconds (0 if none seen), the ``top`` kernel
    names by device time ([name, ms, count]) and the time of ``kernels``
    (default: the two paged kernels; ``_paged_kernel_ms``)."""
    rows = _device_rows(fn)
    return (sum(ns for _, ns, _ in rows) / 1e9,
            [[name[:120], ns / 1e6, n] for name, ns, n in rows[:top]],
            _paged_kernel_ms([(name, ns / 1e6, n) for name, ns, n in rows], kernels))


def _migration_costs(cfg, params, dev, holder, handle, depth, rng, reps=5):
    """Wall milliseconds (synchronised host clock) of one page export
    (gather on the card, codec, bytes to the host) and one import (bytes to
    the card, codec, scatter) of ``depth`` pages, against a prefill of the
    same ``depth`` blocks of new tokens, each the median of ``reps``.  The
    top-level numbers are the arena's own wire mode; ``by_mode`` has the
    export and import in each of raw, fp16 and int8."""
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import RealEngine, Request

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        return (time.monotonic() - t0) * 1e3, out

    def median(fn):
        return sorted(wall(fn)[0] for _ in range(reps))[reps // 2]

    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=1024, device=dev)
    by_mode = {}
    for mode in ("raw", "fp16", "int8"):
        exp = median(lambda: holder.export_pages(handle, depth=depth, mode=mode))
        buf = holder.export_pages(handle, depth=depth, mode=mode)
        chains = [[rng.bytes(16) for _ in range(depth)] for _ in range(reps)]
        by_mode[mode] = {"export_ms": exp,
                         "import_ms": median(lambda: eng.import_pages(buf, chains.pop())),
                         "wire_bytes": sum(len(r[n]["data"]) for r in buf["layers"]
                                           for n in ("k", "v"))}
    pre = []
    for _ in range(reps):
        toks = rng.integers(0, cfg.vocab, depth * BLK).tolist()
        ms, st = wall(lambda: eng.prefill_request(Request(0, toks, max_new=1)))
        eng.release_pages(st.pages)
        pre.append(ms)
    pre.sort()
    mode = holder.kv_wire_mode
    exp, imp = by_mode[mode]["export_ms"], by_mode[mode]["import_ms"]
    page_mb = holder.page_bytes / 2**20
    return {"pages": depth, "page_bytes": holder.page_bytes, "mode": mode,
            "export_ms": exp, "import_ms": imp, "prefill_ms": pre[reps // 2],
            "export_ms_per_page": exp / depth, "import_ms_per_page": imp / depth,
            "prefill_ms_per_page": pre[reps // 2] / depth,
            "export_GiB_per_s": depth * page_mb / 1024 / (exp / 1e3),
            "by_mode": by_mode}


def overlay_serve_bf16(seed, dev, params):
    """The overlay path at full width and depth (32 layers, bf16) on
    ``serve_bf16``'s weights: two model nodes, each with its own
    ``RealEngine`` (max_len 1024, 513 pages: ~2.1 GB of arena each) over
    the one set of weights; ``serve_bf16``'s 8 requests (200-600 tokens, 4
    opening with one 256-token prefix), 64 new tokens (the node's
    ``_submit_real`` serves 16 of them, as in the reference).  A request of
    the shared prefix alone seeds m0, then the 8 requests arrive at m1.
    Three routings, each run once for its wall time and once more with
    the profiler tracing the card, for the device's idle share (of that
    run's wall time, from the arrivals at m1 to the last response).  Then
    a page export and import of the prefix's 8 pages against a prefill of
    256 new tokens."""
    from repro_torch import configs
    from repro_torch.kernels.chunk_hash import ops as hash_ops
    cfg = configs.get_config(NAME)
    prompts = _traffic(seed, cfg.vocab)
    shared = np.random.default_rng(seed).integers(0, cfg.vocab, 256).tolist()
    assert sum(p[:256] == shared for p in prompts) >= 2       # _traffic's prefix
    L = _overlay_lengths()
    depth = len(shared) // BLK
    modes, tokens = {}, {}
    _reset_launches()
    for mode in OVERLAY_MODES:
        h0 = hash_ops.chunk_hash_ranges.launches
        net, nodes, sink = _overlay(cfg, params, dev, 1024, L)
        _overlay_seed(net, nodes, shared, mode, 64)
        wall = _overlay_inject(net, nodes, sink, prompts, 64)
        launches_hash = hash_ops.chunk_hash_ranges.launches - h0
        tokens[mode] = dict(sink.got)
        gen = sum(len(v) for k, v in sink.got.items() if k != "seed")
        assert gen == 16 * len(prompts), f"{mode}: {gen} tokens"
        c = _node_counts(nodes)
        if mode == "replicate":
            holder = nodes[0].real_engine
            matched, entry = holder.prefix_cache.peek(shared)
            assert matched == len(shared) and c["m1"]["kv_imported_pages"] > 0, c
        del net, nodes, sink
        _free()
        net, nodes, sink = _overlay(cfg, params, dev, 1024, L)
        _overlay_seed(net, nodes, shared, mode, 64)
        walls = []
        busy, top, paged_ms = _device_busy_s(lambda: walls.append(
            _overlay_inject(net, nodes, sink, prompts, 64)))
        rerun_same = dict(sink.got) == tokens[mode]
        del net, nodes, sink
        _free()
        modes[mode] = {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
                       "chunk_hash_launches": launches_hash, "nodes": c,
                       "profiled_wall_s": walls[0], "device_busy_s": busy,
                       "idle_share": 1 - busy / walls[0] if busy else "not measured",
                       "top_kernels": top, "paged_kernels": paged_ms,
                       "profiled_rerun_same_tokens": rerun_same}
    launches = _launches()
    assert launches["chunk_hash"] > 0 and launches["paged_flash_attention"] > 0
    assert modes["affinity"]["nodes"]["m1"]["affinity_hits"] > 0
    assert modes["replicate"]["nodes"]["m1"]["replicate_routes"] > 0
    assert modes["load_only"]["nodes"]["m1"]["kv_fetches"] == 0
    costs = _migration_costs(cfg, params, dev, holder, entry.handle, depth,
                             np.random.default_rng(seed))
    del holder, entry
    _free()
    same = {m: sum(tokens[m][k] == tokens["load_only"][k] for k in tokens[m])
            for m in OVERLAY_MODES}
    return {"phase": "overlay_serve_bf16", "config": f"{NAME} full (32 layers) bf16, 2 nodes",
            "chunk_lengths": L, "requests": len(prompts), "max_new": 64, "served_new": 16,
            "modes": modes, "migration": costs,
            "rows_equal_load_only": same, "launches": launches}, launches


# --------------------------------------------------------------------------
# the privacy overlay: users, onion proxies, S-IDA cloves, signed responses
# --------------------------------------------------------------------------
CRYPTO_MODULES = ("ed25519", "onion", "chacha", "sida", "ida", "shamir", "gf256")
CLOVE_TYPES = ("clove_fwd", "prompt_clove", "response_clove")


def _privacy_overlay(cfg, params, dev, max_len, score_fns=None, **kw):
    """The port's ``build_overlay`` on the card (its model nodes' HR-trees
    hash there), each of its two model nodes given its own ``RealEngine``
    over the one shared ``params`` (or over ``params[i]``, given a list),
    the committee scoring with ``score_fns``; the global ``random`` (the
    nodes' sync start times) restarted first.  Returns the overlay and the
    log of what its ``SimNet`` sends: every response clove's signature by
    message, and the bytes of every clove message."""
    import random
    from repro_torch.models.lm import LM
    from repro_torch.overlay.network import OverlayConfig, build_overlay
    from repro_torch.serving.engine import RealEngine
    random.seed(0)
    ov = build_overlay(OverlayConfig(n_users=24, n_models=2, seed=0, **kw),
                       score_fns=score_fns, device=dev)
    model = LM(cfg, dev)
    for i, m in enumerate(ov.models):
        assert m.hrtree.device.type == torch.device(dev).type
        m.real_engine = RealEngine(cfg, model, params[i] if isinstance(params, list)
                                   else params, max_len=max_len, device=dev)
    log = {"sigs": {}, "clove_bytes": 0, "clove_msgs": 0}
    send, models = ov.net.send, {m.node_id for m in ov.models}

    def logged(src, dst, msg, size_bytes=1024):
        if msg.get("type") in CLOVE_TYPES:
            log["clove_bytes"] += size_bytes
            log["clove_msgs"] += 1
        if src in models and msg.get("type") == "response_clove":
            log["sigs"].setdefault(msg["msg_id"], set()).add((src, msg["sig"]))
        send(src, dst, msg, size_bytes)
    ov.net.send = logged
    return ov, log


def _privacy_send(ov, users, prompts, max_new, gap):
    """User ``users[i]`` sends ``prompts[i]`` ``gap`` simulated seconds
    after the one before; the network runs until every response is in.
    Returns the responses by request and the wall seconds (host clock,
    synchronised)."""
    got = {}
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for i, (u, p) in enumerate(zip(users, prompts)):
        user = ov.users[u]
        user.on_response = lambda _n, pl, i=i: got.setdefault(i, pl)
        ov.net.call_after(gap * i, user.send_prompt, ov.net, p, "", None, None,
                          {"max_new": max_new})
    ov.net.run_until(ov.net.t + gap * len(prompts) + 120)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert len(got) == len(prompts), f"{len(got)} of {len(prompts)} responses"
    for m in ov.models:
        m.real_engine.allocator.check()
    return got, wall


def _verify_sigs(ov, log, got):
    """How many responses carry one signature (an unsigned clove carries
    ``""``), from the model node that served them, that verifies over the
    response as it was encoded."""
    from repro_torch.core import ed25519
    from repro_torch.net.wire import packb
    pubs = {m.node_id: m.public for m in ov.models}
    ok = 0
    for resp in got.values():
        sigs = log["sigs"].get(resp["msg_id"], set())
        ok += len(sigs) == 1 and all(
            sig and node == resp["server"]
            and ed25519.verify(pubs[node], packb(resp), bytes.fromhex(sig))
            for node, sig in sigs)
    return ok


def privacy_overlay_f32_parity(seed, dev):
    """The privacy path at full width, 2 layers, float32 (TF32 off), on
    ``overlay_f32_parity``'s weights: ``build_overlay`` with 24 users and 2
    signing model nodes on the card; four users each send one prompt at
    once (two share a 64-token prefix).  Every response arrives, every
    signature verifies under its node's public key, and each user gets the
    tokens a direct ``RealEngine.generate`` of its prompt gives."""
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine, Request
    cfg = dataclasses.replace(configs.get_config(NAME), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, 64).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab, 16).tolist(),
               shared + rng.integers(0, cfg.vocab, 24).tolist(),
               rng.integers(0, cfg.vocab, 50).tolist(), rng.integers(0, cfg.vocab, 70).tolist()]
    direct = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    want = [direct.generate(Request(i, p, max_new=16)).output for i, p in enumerate(prompts)]
    del direct
    _reset_launches()
    ov, log = _privacy_overlay(cfg, params, dev, 128, use_crypto=True)
    got, wall = _privacy_send(ov, [0, 6, 12, 18], prompts, 16, 0.0)
    launches = _launches()
    verified = _verify_sigs(ov, log, got)
    assert verified == len(prompts), f"{verified} of {len(prompts)} signatures verify"
    tokens = [got[i]["output"] for i in range(len(prompts))]
    assert tokens == want, "the overlay changed a user's tokens"
    assert launches["chunk_hash"] > 0, launches
    assert launches["paged_decode_attention"] > 0 and launches["paged_flash_attention"] > 0
    return {"phase": "privacy_overlay_f32_parity", "config": f"{NAME} n_layers=2 float32",
            "reduced": ["n_layers 32 -> 2"], "users": 24, "models": 2,
            "responses": len(got), "signatures_verified": verified,
            "tokens_equal_direct_generate": True, "wall_s": wall,
            "servers": [got[i]["server"] for i in range(len(prompts))],
            "nodes": {m.node_id: {k: m.metrics[k] for k in ("served", "forwarded_out",
                                                             "cache_hits")}
                      for m in ov.models},
            "clove_bytes": log["clove_bytes"], "launches": launches,
            "tol": "tokens exact (greedy f32, TF32 off)"}


def _crypto_seconds(prof):
    """Host seconds (self time) in each of the port's crypto and S-IDA
    modules from a ``cProfile.Profile``."""
    import pstats
    out = dict.fromkeys(CRYPTO_MODULES, 0.0)
    for (path, _, _), (_, _, tottime, _, _) in pstats.Stats(prof).stats.items():
        p = Path(path)
        if p.parent.name == "core" and p.parent.parent.name == "repro_torch" \
                and p.stem in out:
            out[p.stem] += tottime
    return out


def privacy_overlay_bf16(seed, dev, params):
    """The privacy path at full width and depth (32 layers, bf16) on
    ``serve_bf16``'s weights: ``build_overlay`` with 24 users, 4 proxies
    each, S-IDA 3-of-4, sync every 2 s, and two model nodes, each with its
    own ``RealEngine`` (max_len 1024, 513 pages).  Eight users send
    ``serve_bf16``'s 8 requests 2 simulated seconds apart (64 new tokens
    asked, 16 served, as in ``overlay_serve_bf16``).  Runs with signing
    off and on, same seeds and arrivals; the signed run again with the
    profiler tracing the card (the device's idle share) and once more
    under cProfile (host seconds in the crypto and S-IDA modules)."""
    import cProfile
    from repro_torch import configs
    cfg = configs.get_config(NAME)
    prompts = _traffic(seed, cfg.vocab)
    users = [3 * i for i in range(len(prompts))]

    def build(crypto):
        return _privacy_overlay(cfg, params, dev, 1024, use_crypto=crypto, n_proxies=4,
                                sida_n=4, sida_k=3, sync_every=2.0)

    def send(ov):
        return _privacy_send(ov, users, prompts, 64, 2.0)

    runs, got = {}, {}
    _reset_launches()
    for name, crypto in (("crypto_off", False), ("crypto_on", True)):
        t0 = time.monotonic()
        ov, log = build(crypto)
        build_s = time.monotonic() - t0
        got[name], wall = send(ov)
        gen = sum(len(r["output"]) for r in got[name].values())
        assert gen == 16 * len(prompts), f"{name}: {gen} tokens"
        runs[name] = {"build_s": build_s, "wall_s": wall, "generated_tokens": gen,
                      "tokens_per_s": gen / wall, "responses": len(got[name]),
                      "signatures_verified": _verify_sigs(ov, log, got[name]),
                      "clove_bytes": log["clove_bytes"], "clove_msgs": log["clove_msgs"],
                      "nodes": {m.node_id: {k: m.metrics[k] for k in (
                          "served", "forwarded_out", "cache_hits")} for m in ov.models},
                      "served_requests": {m.node_id: sorted(
                          i for i, r in got[name].items() if r["server"] == m.node_id)
                          for m in ov.models}}
        del ov, log
        _free()
    launches = _launches()
    assert runs["crypto_on"]["signatures_verified"] == len(prompts), runs["crypto_on"]
    assert runs["crypto_off"]["signatures_verified"] == 0
    assert launches["chunk_hash"] > 0, launches
    assert launches["paged_decode_attention"] > 0 and launches["paged_flash_attention"] > 0

    ov, log = build(True)
    walls = []
    busy, top, paged_ms = _device_busy_s(lambda: walls.append(send(ov)))
    del ov, log
    _free()
    ov, log = build(True)
    prof = cProfile.Profile()
    prof.enable()
    _, cwall = send(ov)
    prof.disable()
    del ov, log
    _free()
    crypto_s = _crypto_seconds(prof)
    same = sum(got["crypto_on"][i]["output"] == got["crypto_off"][i]["output"]
               for i in range(len(prompts)))
    return {"phase": "privacy_overlay_bf16",
            "config": f"{NAME} full (32 layers) bf16, 2 nodes, 24 users",
            "requests": len(prompts), "gap_s": 2.0, "max_new": 64, "served_new": 16,
            "runs": runs, "crypto_on_over_off_wall": runs["crypto_on"]["wall_s"]
            / runs["crypto_off"]["wall_s"],
            "responses_equal_on_off": same,
            "same_servers_on_off": runs["crypto_on"]["served_requests"]
            == runs["crypto_off"]["served_requests"],
            "profiled_wall_s": walls[0][1], "device_busy_s": busy,
            "idle_share": 1 - busy / walls[0][1] if busy else "not measured",
            "top_kernels": top, "paged_kernels": paged_ms,
            "cprofile_wall_s": cwall, "crypto_host_s": crypto_s,
            "crypto_host_s_total": sum(crypto_s.values()),
            "launches": launches}, launches


# --------------------------------------------------------------------------
# serving-quality verification: the committee's challenges through the
# overlay, scored by the log-prob verifier
# --------------------------------------------------------------------------
def _teacher_argmax(verifier, prompt, response):
    """The verifier's argmax at each response position of ``prompt +
    response`` (the token greedy decoding would pick there)."""
    dev = verifier.model.device
    lp = verifier._logprobs(verifier.params, torch.tensor([prompt + response],
                                                          dtype=torch.int32, device=dev))[0]
    return lp[len(prompt) - 1:len(prompt) - 1 + len(response)].argmax(-1).tolist()


def verification_f32_parity(seed, dev):
    """The log-prob verifier (``core/verification.py`` over ``LM.apply``) at
    full width, 2 layers, float32 (TF32 off).  An honest node's paged
    engine serves four 16-64-token prompts, 16 greedy tokens each; the
    verifier on the card reads every served token as the argmax of its
    teacher-forced log-probs at that position (the flash kernel's dense
    entry against its paged entry and the paged decode, on one model);
    ``LM.apply``'s logits over two of the pairs padded into one batch, and
    every pair's log-probs, equal the CPU plain path's within 2e-4; the
    padded batch's credibilities equal the per-pair ones (rtol 2e-3, atol
    1e-4, ``tests/test_verification_batch.py``'s tolerance)."""
    from repro_torch import configs
    from repro_torch.core import verification as ver
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine
    cfg = dataclasses.replace(configs.get_config(NAME), n_layers=2,
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prompts = _random_prompts(seed, cfg.vocab, 4, 16, 64)
    _reset_launches()
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    done, *_ = _serve(eng, prompts, 16)
    pairs = [(p, done[i].output) for i, p in enumerate(prompts)]
    card = ver.VerifierModel(cfg, LM(cfg, dev), params)
    argmax_equal = [_teacher_argmax(card, p, r) == r for p, r in pairs]
    batch = ver.credibility_batch(card, pairs)
    single = [ver.credibility(card, p, r) for p, r in pairs]
    launches = _launches()
    del eng
    assert all(argmax_equal), f"served tokens that are not the verifier's argmax: {argmax_equal}"
    np.testing.assert_allclose(batch, single, rtol=2e-3, atol=1e-4)
    assert launches["flash_attention"] > 0, launches
    assert launches["paged_decode_attention"] > 0 and launches["paged_flash_attention"] > 0

    cpu = torch.device("cpu")
    host = ver.VerifierModel(cfg, LM(cfg, cpu), _to(params, cpu))
    toks = np.zeros((2, max(len(p) + len(r) for p, r in pairs[:2])), np.int32)
    for i, (p, r) in enumerate(pairs[:2]):
        toks[i, :len(p) + len(r)] = p + r
    logits = [v.model.apply(v.params, torch.from_numpy(toks).to(v.model.device)).cpu()
              for v in (card, host)]
    assert torch.isfinite(logits[0]).all()
    torch.testing.assert_close(logits[0], logits[1], atol=2e-4, rtol=2e-4)
    lp_err = 0.0
    for p, r in pairs:
        a, b = ver.response_logprobs(card, p, r), ver.response_logprobs(host, p, r)
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
        lp_err = max(lp_err, float(np.abs(a - b).max()))
    return {"phase": "verification_f32_parity", "config": f"{NAME} n_layers=2 float32",
            "reduced": ["n_layers 32 -> 2"], "pairs": len(pairs),
            "prompt_lens": [len(p) for p in prompts], "response_len": 16,
            "served_tokens_are_verifier_argmax": sum(argmax_equal),
            "apply_shape": list(logits[0].shape),
            "card_vs_cpu_max_abs_err": {"apply_logits": (logits[0] - logits[1]).abs().max().item(),
                                        "response_logprobs": lp_err},
            "credibility_batch": batch, "credibility_single": single,
            "launches": launches,
            "tol": "argmax exact; card vs CPU atol=rtol=2e-4; batch vs single "
                   "rtol=2e-3 atol=1e-4"}


def _impostor(params, gen, levels=1, noise=0.08):
    """``benchmarks/gt_model.py::_quantize`` on the port's weights: every
    leaf with ndim >= 2 rounded to ``levels`` steps of its largest
    magnitude s, plus ``noise`` * s Gaussian noise from ``gen``; other
    leaves shared.  A new tree, built a slice of rows at a time so the
    float32 temporaries stay near 1 GB."""
    if isinstance(params, dict):
        return {k: _impostor(v, gen, levels, noise) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(_impostor(v, gen, levels, noise) for v in params)
    x = params
    if x.ndim < 2:
        return x
    s = x.abs().max().float() + 1e-9
    out = torch.empty_like(x)
    step = max(1, (1 << 28) // x[0].numel())
    for i in range(0, x.shape[0], step):
        y = torch.round(x[i:i + step].float() / s * levels) / levels * s
        if noise:
            y += noise * s * torch.randn(y.shape, generator=gen, device=x.device)
        out[i:i + step] = y
    return out


def _epoch(ov, challenges, log, max_new, wait=300.0):
    """One committee epoch through the overlay: agree on ``challenges``,
    the leader sends them through its anonymous client, the network runs
    until every response is in (or ``wait`` simulated seconds pass), then
    ``run_epoch`` scores what came back.  Returns the epoch's result, the
    collected responses, the payloads the leader received and the count
    whose signature verifies, and the host seconds of each step."""
    com = ov.committee
    com.agree_challenges(challenges)
    leader = ov.verifiers[com.leader()]
    got = {}
    t0 = time.monotonic()
    leader.send_challenges(ov.net, challenges, max_new=max_new)
    on_resp = leader.client.on_response

    def record(net, payload):
        got[payload["msg_id"]] = payload
        on_resp(net, payload)
    leader.client.on_response = record
    end = ov.net.t + wait
    while leader.missing() and ov.net.t < end:
        ov.net.run_until(ov.net.t + 1.0)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    responses = leader.collect()
    res = com.run_epoch(lambda _leader, _challenges: responses)
    t2 = time.monotonic()
    return res, responses, got, _verify_sigs(ov, log, got), leader.missing(), \
        {"serve_s": t1 - t0, "epoch_s": t2 - t1}


def verification_bf16(seed, dev, params):
    """Serving-quality verification at full width and depth (32 layers,
    bf16) on ``serve_bf16``'s weights: ``build_overlay`` with 24 users, 4
    verification nodes and two signing model nodes with their own
    ``RealEngine`` (max_len 1024, 513 pages): m0 on the weights, m1 on an
    impostor copy of them (``_impostor``: the harshest step "m3" of
    ``benchmarks/gt_model.py``).  Each verification node scores with
    ``avg_credibility`` batched through ``credibility_batch`` over one
    shared ``VerifierModel`` on the honest weights.  Four epochs, each: a
    new 16-64-token challenge a node, sent by the leader through the
    overlay (16 tokens served), then ``run_epoch``.  Model nodes serve
    their challenges themselves (``fwd_mode = "none"``): a forwarded
    challenge comes back from another server and counts as missing.
    Then verifications per minute as ``benchmarks/bench_verification.py``
    measures them (16 prompts of 16 tokens, 16 greedy tokens from m0,
    scored one by one, and the same pairs in one ``credibility_batch``),
    the one-by-one window again under torch.profiler (the device's idle
    share, the dense flash entry's device time)."""
    from repro_torch import configs
    from repro_torch.core import verification as ver
    from repro_torch.core.consensus import Challenge
    from repro_torch.models.lm import LM
    cfg = configs.get_config(NAME)
    t0 = time.monotonic()
    bad = _impostor(params, torch.Generator(device=dev).manual_seed(seed + 1))
    torch.cuda.synchronize()
    impostor_s = time.monotonic() - t0
    verifier = ver.VerifierModel(cfg, LM(cfg, dev), params)
    score_s = []

    def score(pairs):
        t = time.monotonic()
        c = float(np.mean(ver.credibility_batch(verifier, pairs))) if pairs else 0.0
        score_s.append(time.monotonic() - t)
        return c

    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ov, log = _privacy_overlay(cfg, [params, bad], dev, 1024, score_fns=[score] * 4,
                               use_crypto=True, n_verifiers=4, n_proxies=4, sida_n=4,
                               sida_k=3, sync_every=2.0)
    build_s = time.monotonic() - t0
    for m in ov.models:
        m.fwd_mode = "none"
    epochs, creds, agree = [], {m.node_id: [] for m in ov.models}, []
    for e in range(4):
        prompts = _random_prompts(seed + 100 + e, cfg.vocab, len(ov.models), 16, 64)
        chs = [Challenge(m.node_id, tuple(p)) for m, p in zip(ov.models, prompts)]
        n0 = len(score_s)
        res, responses, got, verified, missing, secs = _epoch(ov, chs, log, 16)
        assert res.committed, res
        for r in responses:
            creds[r.model_node].append(res.scores[r.model_node])
            if r.model_node == "m0":
                am = _teacher_argmax(verifier, list(r.prompt), list(r.response))
                agree.append(sum(a == t for a, t in zip(am, r.response)) / len(r.response))
        epochs.append({"epoch": res.epoch, "leader": res.leader, "responses": len(responses),
                       "signatures_verified": verified, "missing": missing,
                       "credibility": res.scores, "reputations": res.reputations,
                       "score_calls": len(score_s) - n0,
                       "scoring_s": sum(score_s[n0:]), **secs,
                       "response_lens": [len(r.response) for r in responses]})
    for m in ov.models:
        m.real_engine.allocator.check()
    untrusted = sorted(ov.committee.untrusted())
    responses = sum(e["responses"] for e in epochs)
    verified = sum(e["signatures_verified"] for e in epochs)
    n_ch = 4 * len(ov.models)
    assert responses == n_ch and verified == n_ch, epochs
    mean = {n: float(np.mean(c)) for n, c in creds.items()}
    assert mean["m0"] > mean["m1"], mean

    # verifications per minute, as benchmarks/bench_verification.py: 16
    # prompts of 16 tokens with m0's 16 greedy tokens, scored one by one
    bench = _random_prompts(seed + 200, cfg.vocab, 16, 16, 16)
    done, *_ = _serve(ov.models[0].real_engine, bench, 16)
    pairs = [(p, done[i].output) for i, p in enumerate(bench)]
    ver.credibility(verifier, *pairs[0])                       # warm-up

    def one_by_one():
        return [ver.credibility(verifier, p, r) for p, r in pairs]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    singles = one_by_one()
    single_s = time.monotonic() - t0
    t0 = time.monotonic()
    batched = ver.credibility_batch(verifier, pairs)
    batch_s = time.monotonic() - t0
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    np.testing.assert_allclose(batched, singles, rtol=2e-3, atol=1e-4)
    walls = []

    def traced():
        t = time.monotonic()
        one_by_one()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t)
    busy, top, attn = _device_busy_s(traced, kernels=ATTN_KERNELS)
    del ov, log, bad
    _free()
    return {"phase": "verification_bf16",
            "config": f"{NAME} full (32 layers) bf16, m0 honest, m1 impostor "
                      "(levels=1, noise=0.08), 4 verifiers, 24 users",
            "impostor_s": impostor_s, "build_s": build_s, "epochs": epochs,
            "challenges": n_ch, "responses": responses, "signatures_verified": verified,
            "mean_credibility": mean, "untrusted": untrusted,
            "honest_argmax_agree_share_bf16": agree,
            "scoring_s_per_epoch": [e["scoring_s"] for e in epochs],
            "max_memory_allocated": peak,
            "verifications_per_min": {"one_by_one": len(pairs) / single_s * 60,
                                      "batched": len(pairs) / batch_s * 60,
                                      "pairs": len(pairs), "prompt_tokens": 16,
                                      "response_tokens": 16, "one_by_one_s": single_s,
                                      "batched_s": batch_s},
            "scoring_window": {"wall_s": walls[0], "device_busy_s": busy,
                               "idle_share": 1 - busy / walls[0] if busy else "not measured",
                               "attention_kernels": attn, "top_kernels": top},
            "launches": launches,
            "note": "random weights: absolute credibilities and the 0.4 trust "
                    "threshold mean nothing here; only honest > impostor is gated"}, launches


def _free():
    gc.collect()
    torch.cuda.empty_cache()


JAMBA_CUT = ["n_layers 32 -> 8: one repeat of the 8-layer pattern (1 attention, "
             "7 Mamba, 4 MoE and 4 dense FFNs at full width); 32 layers are "
             "~104 GB in bf16 and do not fit in 80 GB"]


def _jamba(**kw):
    from repro_torch import configs
    cfg = configs.get_config(JAMBA)
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern), **kw)


@torch.inference_mode()
def jamba_layer_parity(seed, dev):
    """One Mamba layer (pattern position 0) and the attention layer
    (position 4) of jamba at full width in float32, on the card and on the
    CPU (plain versions): ``layer_prefill`` over 8 tokens (the engine's
    boot prefill) and over 300 tokens, each followed by 4 ``layer_decode``
    steps; outputs and caches within 2e-4."""
    from repro_torch.models import lm
    from repro_torch.params import init_params
    base = _jamba()
    cfg = dataclasses.replace(base, n_layers=2, pattern=(base.pattern[0], base.pattern[4]),
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    blocks = [lm._layer_slice(b, 0) for b in params["blocks"]]
    del params
    rng = np.random.default_rng(seed)
    B, max_len, d = 2, 512, cfg.d_model
    lens = (8, 300)
    x0 = {S: rng.normal(size=(B, S, d)).astype(np.float32) for S in lens}
    xs = rng.normal(size=(4, B, 1, d)).astype(np.float32)
    outs = {}
    _reset_launches()
    for name, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        res = []
        for spec, p in zip(cfg.pattern, blocks):
            p = _to(p, dv)
            for S in lens:
                x, cache = lm.layer_prefill(cfg, spec, p, torch.from_numpy(x0[S]).to(dv),
                                            torch.arange(S, device=dv), max_len)
                res.append((f"{spec.mixer}/S{S}/prefill", x))
                pos = torch.full((B,), S, dtype=torch.int32, device=dv)
                for t in range(4):
                    y = lm.layer_decode(cfg, spec, p, torch.from_numpy(xs[t]).to(dv), pos,
                                        cache)
                    res.append((f"{spec.mixer}/S{S}/decode", y))
                    pos = pos + 1
                res += [(f"{spec.mixer}/S{S}/cache_{n}", c) for n, c in cache.items()]
        outs[name] = [(k, v.float().cpu()) for k, v in res]
        if name == "card":
            launches = _launches()
    assert launches["mamba_scan"] == 2 and launches["flash_attention"] == 2
    assert launches["decode_attention"] == 8
    errs = {}
    for (k, a), (_, b) in zip(outs["card"], outs["cpu"]):
        assert torch.isfinite(a).all(), f"{k}: non-finite"
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4, msg=k)
        errs[k] = max(errs.get(k, 0.0), (a - b).abs().max().item())
    return {"phase": "jamba_layer_parity", "config": f"{JAMBA} layers 0 (mamba) and 4 (attn), "
            "full width, float32", "tokens": list(lens), "decode_steps": 4,
            "card_launches": launches, "card_vs_cpu_max_abs_err": errs,
            "tol": "atol=rtol=2e-4"}


def _random_prompts(seed, vocab, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))).tolist()
            for _ in range(n)]


def jamba_f32_parity(seed, dev):
    """``tests/test_batched_decode.py::test_batched_matches_sequential_recurrent``
    at full width: the cut jamba in float32 (~53 GB of weights), the slot
    pool (max_active=2) against sequential ``generate``, 3 prompts of 40
    tokens, 8 new tokens each."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine, Request
    cfg = _jamba(dtype="float32", param_dtype="float32")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = _random_prompts(seed, cfg.vocab, 3, 40, 40)
    _reset_launches()
    seq = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    ref = {i: seq.generate(Request(i, p, max_new=8)).output for i, p in enumerate(prompts)}
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    done, s, wall, _ = _serve(eng, prompts, 8, max_active=2)
    launches = _launches()
    out = {i: r.output for i, r in done.items()}
    assert not eng.paged and out == ref, "slot pool != sequential"
    assert eng.batched_traces == 1, "pool decode saw more than one shape"
    assert all(launches[k] > 0 for k in ("decode_attention", "mamba_scan", "flash_attention"))
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    return {"phase": "jamba_f32_parity", "config": f"{JAMBA} float32", "reduced": JAMBA_CUT,
            "weight_bytes": weights, "init_s": init_s, "pool_equals_sequential": True,
            "batched_traces": eng.batched_traces, "metrics": s.metrics,
            "launches": launches, "tokens": out}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# the bf16 scan's device kernels (csrc/mamba_scan.cu): the chunk kernels and
# the state pass
SCAN_KERNELS = ("chunk_tc", "pass_states")


def jamba_serve_bf16(seed, dev, out):
    """The cut jamba in bf16 (~26.5 GB) served from the dense slot pool:
    8 requests of 64-192 random tokens, 32 new tokens each, 4 slots; then
    one 2048-token ``LM.prefill`` (the scan at L=128 over 16 chunks)."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine
    cfg = _jamba()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = _random_prompts(seed, cfg.vocab, 8, 64, 192)
    _reset_launches()
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=1024, device=dev)
    torch.cuda.reset_peak_memory_stats()
    done, s, wall, ttft = _serve(eng, prompts, 32)
    launches = _launches()
    gen = sum(len(r.output) for r in done.values())
    assert not eng.paged and len(done) == len(prompts) and gen == 32 * len(prompts)
    assert len(ttft) == len(prompts)
    assert all(launches[k] > 0 for k in ("decode_attention", "mamba_scan", "flash_attention"))
    assert launches["mamba_scan_boot"] == launches["mamba_scan"], "boot prefills: the boot path"
    prefill = sorted(r.ttft for r in done.values())
    ttft = sorted(ttft.values())
    run = {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
           "prompt_tokens": sum(len(p) for p in prompts),
           "ttft_s_mean": sum(ttft) / len(ttft), "ttft_s_max": ttft[-1],
           "admission_prefill_s_mean": sum(prefill) / len(prefill),
           "admission_prefill_s_max": prefill[-1],
           "decode_calls": s.metrics["decode_calls"], "rounds": s.metrics["rounds"],
           "batched_traces": eng.batched_traces,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "pool_kv_bytes": s.kv_bytes_in_use()}
    _write(out, "jamba_bf16_tokens.json", json.dumps({i: r.output for i, r in done.items()}))
    del eng, s, done
    # the profiler's post-processing grows with the events: a window of two
    # prompts cut to 24 tokens (~39 decodes), not the whole 173 and 183
    # (~349 decodes, ~4 minutes of post-processing on an H100 machine)
    profile = _profile(cfg, params, [p[:24] for p in prompts[:2]], dev, out,
                       "profile_jamba_bf16.txt", 8, count=SCAN_KERNELS)
    scan_calls = profile["launches"]["mamba_scan"]
    profile["scan_device_kernels_a_call"] = sum(
        profile["kernel_counts"].values()) / scan_calls if scan_calls else "not measured"
    assert scan_calls > 0 and profile["scan_device_kernels_a_call"] == 1, \
        "the serving scan calls are one device kernel each (the boot path)"

    # one long prompt through the normal prefill entry point
    model = LM(cfg, dev)
    tok = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, size=(1, 2048)).astype(np.int32)).to(dev)
    model.prefill(params, tok[:, :256], max_len=2048)           # warm-up
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = model.prefill(params, tok, max_len=2048)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    long_launches = _launches()
    assert logits.shape == (1, cfg.padded_vocab) and torch.isfinite(logits[:, :cfg.vocab]).all()
    assert long_launches["mamba_scan"] == 7 and long_launches["flash_attention"] == 1
    return {"phase": "jamba_serve_bf16", "config": f"{JAMBA} bf16", "reduced": JAMBA_CUT,
            "init_s": init_s, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": 32, "max_active": 4,
            "run": run, "launches": launches, "profile": profile,
            "prefill_2048": {"seconds": prefill_s, "launches": long_launches,
                             "tokens_per_s": 2048 / prefill_s}}, launches


def _xlstm(**kw):
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(XLSTM), **kw)


@torch.inference_mode()
def xlstm_layer_parity(seed, dev):
    """One mLSTM layer (pattern position 0) and the sLSTM layer (position
    7) of xlstm at full width in float32, on the card and on the CPU (plain
    versions): ``layer_prefill`` over 8 tokens (the engine's boot prefill)
    and over 300 tokens (four chunks of 64 and a ragged one), each followed
    by 4 ``layer_decode`` steps; outputs and caches within 2e-4."""
    from repro_torch.models import lm
    from repro_torch.params import init_params
    base = _xlstm()
    cfg = dataclasses.replace(base, n_layers=2, pattern=(base.pattern[0], base.pattern[7]),
                              dtype="float32", param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    blocks = [lm._layer_slice(b, 0) for b in params["blocks"]]
    del params
    rng = np.random.default_rng(seed)
    B, d = 2, cfg.d_model
    lens = (8, 300)
    x0 = {S: rng.normal(size=(B, S, d)).astype(np.float32) for S in lens}
    xs = rng.normal(size=(4, B, 1, d)).astype(np.float32)
    outs = {}
    _reset_launches()
    for name, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        res = []
        for spec, p in zip(cfg.pattern, blocks):
            p = _to(p, dv)
            for S in lens:
                x, cache = lm.layer_prefill(cfg, spec, p, torch.from_numpy(x0[S]).to(dv),
                                            torch.arange(S, device=dv), S + 4)
                res.append((f"{spec.mixer}/S{S}/prefill", x))
                pos = torch.full((B,), S, dtype=torch.int32, device=dv)
                for t in range(4):
                    y = lm.layer_decode(cfg, spec, p, torch.from_numpy(xs[t]).to(dv), pos,
                                        cache)
                    res.append((f"{spec.mixer}/S{S}/decode", y))
                    pos = pos + 1
                res += [(f"{spec.mixer}/S{S}/cache_{n}", c) for n, c in cache.items()]
        outs[name] = [(k, v.float().cpu()) for k, v in res]
        if name == "card":
            launches = _launches()
    assert launches["mlstm"] == 2, launches
    errs = {}
    for (k, a), (_, b) in zip(outs["card"], outs["cpu"]):
        assert torch.isfinite(a).all(), f"{k}: non-finite"
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4, msg=k)
        errs[k] = max(errs.get(k, 0.0), (a - b).abs().max().item())
    return {"phase": "xlstm_layer_parity", "config": f"{XLSTM} layers 0 (mlstm) and 7 "
            "(slstm), full width, float32", "tokens": list(lens), "decode_steps": 4,
            "card_launches": launches, "card_vs_cpu_max_abs_err": errs,
            "tol": "atol=rtol=2e-4"}


def xlstm_f32_parity(seed, dev):
    """``tests/test_batched_decode.py::test_batched_matches_sequential_recurrent``
    for xlstm at full width and depth: all 48 layers in float32 (~11.2 GB
    of weights), the slot pool (max_active=2) against sequential
    ``generate``, 3 prompts of 40 tokens, 8 new tokens each."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine, Request
    cfg = _xlstm(dtype="float32", param_dtype="float32")
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = _random_prompts(seed, cfg.vocab, 3, 40, 40)
    _reset_launches()
    seq = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    ref = {i: seq.generate(Request(i, p, max_new=8)).output for i, p in enumerate(prompts)}
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=128, device=dev)
    done, s, wall, _ = _serve(eng, prompts, 8, max_active=2)
    launches = _launches()
    out = {i: r.output for i, r in done.items()}
    assert not eng.paged and out == ref, "slot pool != sequential"
    assert eng.batched_traces == 1, "pool decode saw more than one shape"
    assert launches["mlstm"] > 0
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    return {"phase": "xlstm_f32_parity", "config": f"{XLSTM} float32, all 48 layers",
            "reduced": [], "weight_bytes": weights, "init_s": init_s,
            "pool_equals_sequential": True, "batched_traces": eng.batched_traces,
            "pool_state_bytes": s.kv_bytes_in_use(), "metrics": s.metrics,
            "launches": launches, "tokens": out}


XLSTM_PROMPTS = (16, 48)       # prompt lengths, jamba's (64, 192) cut
XLSTM_CUT = ["prompts 64-192 -> 16-48 tokens (jamba's traffic, cut): a teacher-forced "
             "prompt token is a ~2,400-launch decode, ~0.1 s of host time on an H100 "
             "machine, so jamba's 1,146 prompt tokens took 125 s to serve"]


def xlstm_serve_bf16(seed, dev, out):
    """xlstm in bf16 (~5.6 GB), all 48 layers, served from the dense slot
    pool: 8 requests of ``XLSTM_PROMPTS`` random tokens (jamba's traffic
    with its 64-192 cut to 16-48: ``XLSTM_CUT``), 32 new tokens each, 4
    slots; then one 2048-token ``LM.prefill`` (the mLSTM kernel over 32
    chunks in each of the 42 mLSTM layers)."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.serving.engine import RealEngine
    cfg = _xlstm()
    t0 = time.monotonic()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = _random_prompts(seed, cfg.vocab, 8, *XLSTM_PROMPTS)
    _reset_launches()
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=1024, device=dev)
    torch.cuda.reset_peak_memory_stats()
    done, s, wall, ttft = _serve(eng, prompts, 32)
    launches = _launches()
    gen = sum(len(r.output) for r in done.values())
    assert not eng.paged and len(done) == len(prompts) and gen == 32 * len(prompts)
    assert len(ttft) == len(prompts) and launches["mlstm"] > 0
    assert launches["mlstm_boot"] > 0, "the boot prefills took the mLSTM's boot path"
    prefill = sorted(r.ttft for r in done.values())
    ttft = sorted(ttft.values())
    run = {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
           "prompt_tokens": sum(len(p) for p in prompts),
           "ttft_s_mean": sum(ttft) / len(ttft), "ttft_s_max": ttft[-1],
           "admission_prefill_s_mean": sum(prefill) / len(prefill),
           "admission_prefill_s_max": prefill[-1],
           "decode_calls": s.metrics["decode_calls"], "rounds": s.metrics["rounds"],
           "batched_traces": eng.batched_traces,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "pool_state_bytes": s.kv_bytes_in_use()}
    _write(out, "xlstm_bf16_tokens.json", json.dumps({i: r.output for i, r in done.items()}))
    del eng, s, done
    # a shorter window than jamba's (~19 decodes): a decode here is ~8,400
    # aten calls, and the profiler's post-processing grows with them
    profile = _profile(cfg, params, [p[:16] for p in prompts[:2]], dev, out,
                       "profile_xlstm_bf16.txt", 4)

    # one long prompt through the normal prefill entry point
    model = LM(cfg, dev)
    tok = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, size=(1, 2048)).astype(np.int32)).to(dev)
    model.prefill(params, tok[:, :256], max_len=2048)           # warm-up
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = model.prefill(params, tok, max_len=2048)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    long_launches = _launches()
    assert logits.shape == (1, cfg.padded_vocab) and torch.isfinite(logits[:, :cfg.vocab]).all()
    assert long_launches["mlstm"] == cfg.n_repeats * sum(
        sp.mixer == "mlstm" for sp in cfg.pattern)                # 42
    return {"phase": "xlstm_serve_bf16", "config": f"{XLSTM} bf16, all 48 layers",
            "reduced": XLSTM_CUT, "init_s": init_s, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "max_new": 32, "max_active": 4,
            "run": run, "launches": launches, "profile": profile,
            "prefill_2048": {"seconds": prefill_s, "launches": long_launches,
                             "tokens_per_s": 2048 / prefill_s}}, launches


# --------------------------------------------------------------------------
# the other model families: six decoder-only configs on the paged pool, and
# the encoder and cross-attention of whisper and vision
# --------------------------------------------------------------------------
PAGED_FAMILIES = ("h2o-danube-1.8b", "gemma2-9b", "yi-34b", "granite-20b", "dbrx-132b",
                  "moonshot-v1-16b-a3b")
ENCDEC = ("llama-3.2-vision-11b", "whisper-base")
# depth cuts of the bf16 serving runs, where the weights and the arena
# would pass ~70 GB of the card's 80 (bf16 weights at full depth: yi ~69 GB,
# dbrx ~264 GB); every width is the published one
FAMILY_CUTS = {"yi-34b": (48, "n_layers 60 -> 48: 60 layers are ~69 GB of bf16 weights, "
                               "~73 GB with the arena"),
               "dbrx-132b": (8, "n_layers 40 -> 8: 40 layers are ~264 GB of bf16 weights "
                                "(16 experts of 3 x 6144 x 10752 a layer)")}
LONG_PROMPT = 4600        # danube's and gemma2's extra request: past their 4096 window


def _family(name, **kw):
    from repro_torch import configs
    return dataclasses.replace(configs.get_config(name), **kw)


def _weight_bytes(params):
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def _close_cpu(card, cpu, name, errs):
    """Card logits against the CPU's within 2e-4; the largest error into
    ``errs[name]``."""
    card, cpu = card.float().cpu(), cpu.float().cpu()
    assert torch.isfinite(card).all(), f"{name}: non-finite logits"
    torch.testing.assert_close(card, cpu, atol=2e-4, rtol=2e-4, msg=name)
    errs[name] = max(errs.get(name, 0.0), (card - cpu).abs().max().item())


def _paged_family_parity(name, seed, dev):
    """One repeat of a paged config's pattern at full width in float32 on
    the card and on the CPU (plain versions), from the same weights and
    the same arena: two rows whose first 4096 positions hold random K/V
    (so a 4096 window leaves some out), then f32_parity's calls past them:
    two prefill chunks (the second with a dead row), a decode and a verify
    window; logits within 2e-4."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    cfg = _family(name, n_layers=len(_family(name).pattern), dtype="float32",
                  param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cpu = torch.device("cpu")
    cparams = _to(params, cpu)
    rng = np.random.default_rng(seed)
    hist = 4096
    n_pg = hist // BLK + 4
    pt = np.stack([np.arange(1, n_pg + 1), np.arange(n_pg + 1, 2 * n_pg + 1)]).astype(np.int32)
    shape = (cfg.n_repeats, 2 * n_pg + 1, BLK, cfg.n_kv_heads, cfg.d_head)
    history = [{n: rng.standard_normal(shape, dtype=np.float32) for n in ("k", "v")}
               for _ in cfg.pattern]
    tok = rng.integers(0, cfg.vocab, size=(2, BLK)).astype(np.int32)
    calls = [("prefill_paged", (pt, tok, np.array([hist, hist], np.int32)), {}),
             ("prefill_paged", (pt, tok[::-1].copy(), np.array([hist + 32, hist], np.int32)),
              {"active": np.array([True, False])}),
             ("decode_paged", (pt, tok[:, :1].copy(), np.array([hist + 64, hist + 32], np.int32)),
              {}),
             ("verify_paged", (pt, tok[:, 3:8].copy(), np.array([hist + 65, hist + 33], np.int32),
                               np.array([5, 2], np.int32)), {})]
    outs = {}
    for side, d, p in (("card", dev, params), ("cpu", cpu, cparams)):
        m = LM(cfg, d)
        arena = tuple({n: torch.tensor(a, device=d) for n, a in layer.items()}
                      for layer in history)
        if side == "card":
            _reset_launches()
        outs[side] = []
        for fn, args, kw in calls:
            logits, _ = getattr(m, fn)(p, arena, *[torch.tensor(a, device=d) for a in args],
                                       **{k: torch.tensor(v, device=d) for k, v in kw.items()})
            outs[side].append(logits.float().cpu())
        if side == "card":
            launches = _launches()
        del arena
    assert launches["paged_flash_attention"] == 3 * cfg.n_layers
    assert launches["paged_decode_attention"] == cfg.n_layers
    errs = {}
    for (fn, _, kw), a, b in zip(calls, outs["card"], outs["cpu"]):
        if "active" in kw:                                 # row 1 is dead
            a, b = a[:1], b[:1]
        if fn == "verify_paged":                           # row 1 has 2 real tokens
            a, b = torch.cat([a[0], a[1, :2]]), torch.cat([b[0], b[1, :2]])
        _close_cpu(a, b, fn, errs)
    del params, cparams
    _free()
    return {"layers": cfg.n_layers, "history": hist, "card_launches": launches,
            "card_vs_cpu_max_abs_err": errs}


def _aux(cfg, rng, B, T=None):
    """The stub frontends' output: whisper's frames (T of them), vision's
    1600 image embeddings; standard normal, float32."""
    if cfg.is_encdec:
        return {"frames": rng.standard_normal((B, T, cfg.d_model), dtype=np.float32)}
    return {"image_embeds": rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model),
                                                dtype=np.float32)}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _greedy(model, params, prompts, aux, max_new, max_len):
    """Each prompt's own ``prefill(aux)`` (its time to the first token on
    the host), then one batched ``decode`` a step for ``max_new`` greedy
    tokens over a slot pool of the prompts' caches.  Returns the tokens
    (B, max_new), the prefill seconds per prompt and the decode seconds."""
    from repro_torch.models import lm
    dev = model.device
    B = len(prompts)
    T = next(iter(aux.values())).shape[1]           # frames or image tokens
    pool = model.cache_zeros(B, max_len, T_mem=T)
    tok = torch.empty((B, 1), dtype=torch.int32, device=dev)
    prefill_s = []
    for i, p in enumerate(prompts):
        _sync(dev)
        t0 = time.monotonic()
        logits, cache = model.prefill(params, torch.tensor([p], device=dev),
                                      aux={k: v[i:i + 1] for k, v in aux.items()},
                                      max_len=max_len)
        tok[i, 0] = logits[0].argmax()
        _sync(dev)
        prefill_s.append(time.monotonic() - t0)
        lm.cache_slot_write(pool, cache, i)
        del cache
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    out = [tok.clone()]
    t0 = time.monotonic()
    for _ in range(max_new - 1):
        logits, pool = model.decode(params, pool, tok, pos)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    _sync(dev)
    return torch.cat(out, dim=1).cpu(), prefill_s, time.monotonic() - t0


def _encdec_family_parity(name, seed, dev):
    """One repeat of vision's or whisper's pattern at full width in float32
    (whisper with all 6 encoder layers over 1500 frames; vision with 1600
    image embeddings), on the card and on the CPU from the same weights and
    ``aux``: ``apply``, ``prefill(aux)`` and two ``decode`` steps, and
    ``encode``; logits within 2e-4; then 8 greedy tokens for two prompts,
    equal."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    cfg = _family(name, n_layers=len(_family(name).pattern), dtype="float32",
                  param_dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    cpu = torch.device("cpu")
    cparams = _to(params, cpu)
    rng = np.random.default_rng(seed)
    B, S = 2, 40
    tok = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    aux = _aux(cfg, rng, B, 1500)
    prompts = [tok[0, :16].tolist(), tok[1, :11].tolist()]
    outs, greedy = {}, {}
    for side, d, p in (("card", dev, params), ("cpu", cpu, cparams)):
        m = LM(cfg, d)
        a = {k: torch.from_numpy(v).to(d) for k, v in aux.items()}
        t = torch.from_numpy(tok).to(d)
        if side == "card":
            _reset_launches()
        res = [("apply", m.apply(p, t, aux=a))]
        logits, cache = m.prefill(p, t[:, :S - 2], aux=a, max_len=S + 8)
        res.append(("prefill", logits))
        for i in range(S - 2, S):
            logits, cache = m.decode(p, cache, t[:, i:i + 1],
                                     torch.full((B,), i, dtype=torch.int32, device=d))
            res.append(("decode", logits))
        if cfg.is_encdec:
            res.append(("encode", m.encode(p, a["frames"])))
        if side == "card":
            launches = _launches()
        outs[side] = [(k, v.float().cpu()) for k, v in res]
        greedy[side] = _greedy(m, p, prompts, a, 8, 32)[0]
        del cache, a
    assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0
    errs = {}
    for (k, a), (_, b) in zip(outs["card"], outs["cpu"]):
        _close_cpu(a, b, k, errs)
    assert torch.equal(greedy["card"], greedy["cpu"]), "f32 greedy tokens: card != CPU"
    del params, cparams
    _free()
    return {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
            "memory": 1500 if cfg.is_encdec else cfg.n_image_tokens,
            "card_launches": launches, "card_vs_cpu_max_abs_err": errs,
            "greedy_tokens_equal": True, "greedy_tokens": greedy["card"].tolist()}


@torch.inference_mode()
def families_f32_parity(seed, dev):
    """The eight configs beside llama, jamba and xlstm, one repeat of each
    pattern at full width in float32 (TF32 off), on the card against the
    CPU's plain path: the six paged configs through ``prefill_paged`` /
    ``decode_paged`` / ``verify_paged``, vision and whisper through
    ``apply`` / ``prefill(aux)`` / ``decode`` (and ``encode``)."""
    out = {}
    for name in PAGED_FAMILIES:
        out[name] = _paged_family_parity(name, seed, dev)
    for name in ENCDEC:
        out[name] = _encdec_family_parity(name, seed, dev)
    return {"phase": "families_f32_parity", "configs": out,
            "reduced": ["n_layers: one repeat of each pattern (whisper: its 6 encoder "
                        "layers whole)"],
            "tol": "logits atol=rtol=2e-4; greedy tokens exact"}


def _family_serve(cfg, params, prompts, dev, max_len, out, name, max_new=32, profile=True):
    """``_serve`` on a new engine (after a warm-up request of a prompt no
    other shares): its tokens, wall, TTFT, engine counters and the
    wrappers' launches; then, with ``profile``, ``_profile``'s traced
    window on another new engine of the same pages, the first 4 prompts
    with 8 new tokens each: the device's idle share there, its top kernels
    and the paged kernels' device time and launches.  Tracing the whole
    runs (gemma2's alone launched over 400,000 kernels) took ~140 s of
    post-processing beside their 93 s of serving on an H100 machine."""
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import RealEngine
    num_pages = 1 + 8 * -(-max_len // BLK)
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=max_len, num_pages=num_pages,
                     device=dev)
    _serve(eng, [[1, 2, 3] * 11], 2)        # warm-up, sharing no prefix
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    done, s, wall, ttft = _serve(eng, prompts, max_new)
    launches = _launches()
    gen = sum(len(r.output) for r in done.values())
    assert len(done) == len(prompts) and gen == max_new * len(prompts)
    assert launches["paged_decode_attention"] > 0 and launches["paged_flash_attention"] > 0
    prefill = sorted(r.ttft for r in done.values())
    ttft = sorted(ttft.values())
    run = {"wall_s": wall, "generated_tokens": gen, "tokens_per_s": gen / wall,
           "ttft_s_mean": sum(ttft) / len(ttft), "ttft_s_max": ttft[-1],
           "admission_prefill_s_mean": sum(prefill) / len(prefill),
           "admission_prefill_s_max": prefill[-1],
           "prefill_dispatches": eng.prefill_dispatches, "prefill_tokens": eng.prefill_tokens,
           "hit_tokens": sum(r.cached_tokens for r in done.values()),
           "decode_calls": s.metrics["decode_calls"], "rounds": s.metrics["rounds"],
           "spec_accept_rate": eng.spec_accept_rate, "spec_dispatches": eng.spec_dispatches,
           "launches": launches, "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "tokens": {i: r.output for i, r in done.items()}}
    if profile:
        del eng, s, done
        _free()
        run["profile"] = {"window": "the first 4 requests, 8 new tokens each, on a new engine",
                          **_profile(cfg, params, prompts[:4], dev, out,
                                     f"profile_{name}_bf16.txt", 8, max_len=max_len,
                                     num_pages=num_pages)}
    return run


def families_serve_bf16(seed, dev, out):
    """The six paged configs served at full width in bf16 (random weights
    from ``seed``; depth cut only as ``FAMILY_CUTS`` says), one at a time
    through ``RealEngine`` + ``Scheduler``: ``serve_bf16``'s 8 requests
    (200-600 tokens, 4 opening with one 256-token prefix), 32 new tokens,
    4 slots, then a traced window for the device's idle share and the
    paged kernels' time (``_family_serve``); danube and gemma2 add one request of
    ``LONG_PROMPT`` tokens (max_len 4736), so their 4096 window engages,
    and danube runs again with speculation (spec_k=4).  Returns the line
    and the wrappers' launches summed over the configs."""
    from repro_torch.params import init_params
    runs, total = {}, {}
    for name in PAGED_FAMILIES:
        cut = FAMILY_CUTS.get(name)
        cfg = _family(name, **({"n_layers": cut[0]} if cut else {}))
        t_config = t0 = time.monotonic()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        prompts = _traffic(seed, cfg.vocab)
        long = any(s.window for s in cfg.pattern)
        if long:
            prompts.append(np.random.default_rng(seed + 1).integers(
                0, cfg.vocab, LONG_PROMPT).tolist())
        max_len = 4736 if long else 1024
        r = {"layers": cfg.n_layers, "reduced": [cut[1]] if cut else [],
             "weight_bytes": _weight_bytes(params), "init_s": init_s,
             "prompt_lens": [len(p) for p in prompts], "max_len": max_len}
        r["run"] = _family_serve(cfg, params, prompts, dev, max_len, out, name)
        for k, n in r["run"]["launches"].items():
            total[k] = total.get(k, 0) + n
        tokens = {"nonspec": r["run"].pop("tokens")}
        if name == "h2o-danube-1.8b":
            scfg = dataclasses.replace(cfg, spec_enabled=True, spec_k=4)
            r["spec"] = _family_serve(scfg, params, prompts, dev, max_len, out, name,
                                      profile=False)
            assert r["spec"]["spec_dispatches"] > 0
            for k, n in r["spec"]["launches"].items():
                total[k] = total.get(k, 0) + n
            tokens["spec"] = r["spec"].pop("tokens")
            r["spec_rows_equal_nonspec"] = sum(tokens["spec"][i] == tokens["nonspec"][i]
                                               for i in tokens["spec"])
        _write(out, f"serve_{name}_tokens.json", json.dumps(tokens))
        runs[name] = r
        del params
        _free()
        r["seconds"] = time.monotonic() - t_config
    return {"phase": "families_serve_bf16", "requests": 8, "max_new": 32, "max_active": 4,
            "long_prompt": LONG_PROMPT, "configs": runs, "launches": total}, total


def encdec_serve_bf16(seed, dev, out):
    """Vision at full width and depth (40 layers) and whisper at full size
    in bf16, random weights from ``seed``: B=4 requests, each with its own
    memory (vision: 1600 image embeddings; whisper: 1500 frames, 30 s of
    audio after the stub frontend's 2x downsampling), prompts of 64-256
    (vision) or 4-64 (whisper) tokens, each prefilled alone through
    ``LM.prefill(aux)``, then 32 greedy tokens a row through batched
    ``LM.decode`` over a slot pool of their caches; a shorter window
    traced (kernel activity only) for the device's idle share.  Whisper's
    encoder is also timed alone at B=4.  Gates: finite logits, every
    step's token in the vocab."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    runs, total = {}, {}
    for name, (lo, hi) in zip(ENCDEC, ((64, 256), (4, 64))):
        cfg = _family(name)
        t0 = time.monotonic()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev,
                             dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        rng = np.random.default_rng(seed)
        prompts = _random_prompts(seed, cfg.vocab, 4, lo, hi)
        aux = {k: torch.from_numpy(v).to(dev, torch.bfloat16)
               for k, v in _aux(cfg, rng, 4, 1500).items()}
        model = LM(cfg, dev)
        max_len = max(len(p) for p in prompts) + 32
        _greedy(model, params, [prompts[0][:8]], {k: v[:1] for k, v in aux.items()}, 2,
                max_len)                                              # warm-up
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        toks, prefill_s, decode_s = _greedy(model, params, prompts, aux, 32, max_len)
        wall = time.monotonic() - t0
        launches = _launches()
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        assert launches["flash_attention"] > 0 and launches["decode_attention"] > 0
        assert ((toks >= 0) & (toks < cfg.vocab)).all()
        logits = model.apply(params, torch.tensor([prompts[0]], device=dev),
                             aux={k: v[:1] for k, v in aux.items()})
        assert torch.isfinite(logits[..., :cfg.vocab]).all(), f"{name}: non-finite logits"
        # the device's idle share over a window: 4 prefills of ``lo``
        # tokens and 8 tokens a row
        window = []

        def traced():
            t0 = time.monotonic()
            _greedy(model, params, [p[:lo] for p in prompts], aux, 8, max_len)
            window.append(time.monotonic() - t0)
        busy, top, kernels = _device_busy_s(traced, kernels=DENSE_KERNELS)
        r = {"layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
             "weight_bytes": _weight_bytes(params), "init_s": init_s,
             "prompt_lens": [len(p) for p in prompts],
             "memory": "1500 frames" if cfg.is_encdec else f"{cfg.n_image_tokens} image tokens",
             "wall_s": wall, "generated_tokens": toks.numel(),
             "tokens_per_s": toks.numel() / wall,
             "prefill_s": prefill_s, "prefill_s_mean": sum(prefill_s) / len(prefill_s),
             "decode_s": decode_s, "decode_tokens_per_s": 4 * 31 / decode_s,
             "launches": launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated(),
             "profile": {"window": f"4 prompts of {lo} tokens, 8 new each",
                         "wall_s": window[0], "device_busy_s": busy,
                         "idle_share": 1 - busy / window[0] if busy else "not measured",
                         "attention_kernels": kernels, "top_kernels": top}}
        if cfg.is_encdec:
            frames = aux["frames"]
            model.encode(params, frames)                              # warm-up
            torch.cuda.synchronize()
            t0 = time.monotonic()
            model.encode(params, frames)
            torch.cuda.synchronize()
            r["encoder_s"] = time.monotonic() - t0
            r["encoder_device_ms"] = time_ms(lambda: model.encode(params, frames), iters=5)
        _write(out, f"serve_{name}_tokens.json", json.dumps(toks.tolist()))
        runs[name] = r
        del params, aux, model
        _free()
    return {"phase": "encdec_serve_bf16", "requests": 4, "max_new": 32, "configs": runs,
            "launches": total}, total


# --------------------------------------------------------------------------
# the training path: lm_loss, autograd through the flash kernel's backward,
# AdamW (training/train_step.py)
# --------------------------------------------------------------------------
TRAIN_PARITY = (NAME, "h2o-danube-1.8b", "gemma2-9b", "moonshot-v1-16b-a3b", "whisper-base",
                "llama-3.2-vision-11b")
TRAIN_REFUSED = (JAMBA, XLSTM)    # the scan and the mLSTM have no backward kernel
# flash kernel device functions behind the bf16 training step: the dense
# entry's forward bodies and the backward's bf16 kernels (Delta; dK/dV, the
# split sum and dQ on wgmma)
FLASH_BWD_KERNELS = ("delta_kernel", "dkdv_tc_kernel", "dkdv_sum_kernel", "dq_tc_kernel")
TRAIN_KERNELS = {"flash_attention": DENSE_KERNELS["flash_attention"],
                 "flash_attention_bwd": FLASH_BWD_KERNELS}


def _bwd_kernel_ms(rows):
    """Device ms and launches of each of the backward's device functions
    among ``_device_rows`` rows of (name, ns, count)."""
    return _paged_kernel_ms([(k, ns / 1e6, n) for k, ns, n in rows],
                            {f: (f + "<", f + "I", f + "(") for f in FLASH_BWD_KERNELS})


TRAIN_CUT = ["n_layers 32 -> 4: 4 layers are ~1.92 B parameters, ~31 GB of float32 "
             "weights, gradients and AdamW state; 32 layers would need ~128 GB"]


def _train_batch(cfg, seed, B, S, dev):
    """A batch of ``MarkovCorpus(cfg.vocab, seed=0)`` (``batches`` seeded
    ``seed``), with the stub frontends' frames or image embeddings."""
    from repro_torch.training.data import MarkovCorpus
    b = next(MarkovCorpus(cfg.vocab, seed=0).batches(B, S, 1, seed=seed))
    if cfg.is_encdec or cfg.n_image_tokens:
        b.update(_aux(cfg, np.random.default_rng(seed), B, T=40))
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def train_f32_parity(seed, dev):
    """One ``make_train_step`` step on the card against the same step on
    the CPU (plain versions), float32 with TF32 off, for the reduced
    ``TRAIN_PARITY`` configs (llama; danube's window; gemma2's softcaps;
    moonshot's MoE aux loss; whisper's encoder over 40 frames; vision's
    image embeddings), weights from ``init_params`` seeded ``seed``: the
    loss, the gradient norm and every updated parameter within 2e-4, and
    the flash kernel's forward and backward launched on the card.  Then
    jamba's and xlstm's ``lm_loss`` on the card refuse a gradient (the
    scan and the mLSTM have no backward kernel)."""
    from repro_torch import configs
    from repro_torch.models.lm import LM, lm_loss
    from repro_torch.params import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    cpu = torch.device("cpu")
    runs = {}
    for name in TRAIN_PARITY:
        cfg = configs.get_config(name).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(seed), cpu)
        res = {}
        for side, d in (("card", dev), ("cpu", cpu)):
            step = make_train_step(cfg, LM(cfg, d), adamw)
            p = _to(params, d)
            if side == "card":
                _reset_launches()
            new, _, m = step(p, opt.init_state(p), _train_batch(cfg, seed, 2, 48, d))
            _sync(d)
            if side == "card":
                launches = _launches()
            res[side] = ([m["loss"].cpu(), m["grad_norm"].cpu()]
                         + [t.float().cpu() for t in _leaves(new)])
        errs = {}
        for i, (a, b) in enumerate(zip(res["card"], res["cpu"])):
            _close_cpu(a, b, "loss" if i == 0 else "grad_norm" if i == 1 else "params", errs)
        # every decoder layer of these configs attends; remat runs each
        # decoder layer's forward twice, the encoder (outside it) once
        n_enc = cfg.n_enc_layers if cfg.is_encdec else 0
        assert launches["flash_attention_bwd"] == cfg.n_layers + n_enc, (name, launches)
        assert launches["flash_attention"] == 2 * cfg.n_layers + n_enc, (name, launches)
        runs[name] = {"loss": res["card"][0].item(), "grad_norm": res["card"][1].item(),
                      "card_vs_cpu_max_abs_err": errs,
                      "launches": {k: launches[k] for k in TRAIN_KERNELS}}
    refused = {}
    for name in TRAIN_REFUSED:
        cfg = configs.get_config(name).reduced()
        p = opt.tree_map(lambda t: t.requires_grad_(True),
                         init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev))
        b = _train_batch(cfg, seed, 2, 48, dev)
        try:
            lm_loss(cfg, LM(cfg, dev), p, b["tokens"], b["labels"])
        except RuntimeError as e:
            refused[name] = str(e)
        assert name in refused and "has no backward kernel" in refused[name], name
    return {"phase": "train_f32_parity", "configs": runs, "refused_on_card": refused,
            "tol": "atol=rtol=2e-4, card vs CPU"}


def train_bf16(seed, dev, out):
    """``gentorrent-llama3-8b`` at full width (d_model 4096, 32/8 heads,
    d_ff 14336, vocab 128256) cut to 4 layers (``TRAIN_CUT``), trained by
    ``make_train_step``: float32 weights and AdamW state, bf16 compute,
    remat on, B=2 S=2048 from ``MarkovCorpus(vocab, seed=0)``.
    One warm-up step, 5 timed steps (synchronised host clock), then one
    step traced on the card alone for its idle share and the flash
    kernel's forward and backward device time and launches.  Every loss
    must be finite.  Returns (line, the wrappers' launches over the timed
    steps)."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    cfg = _family(NAME, n_layers=4)
    assert cfg.compute_dtype == torch.bfloat16 and cfg.params_dtype == torch.float32
    B, S = 2, 2048
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    n_params = sum(t.numel() for t in _leaves(params))
    state = opt.init_state(params)
    step = make_train_step(cfg, LM(cfg, dev), opt.AdamWConfig(lr=3e-4, warmup_steps=2,
                                                              total_steps=10))
    batches = [_train_batch(cfg, 100 + i, B, S, dev) for i in range(7)]
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    params, state, m = step(params, state, batches[0])             # warm-up
    losses.append(m["loss"].item())
    _reset_launches()
    for b in batches[1:6]:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        secs.append(time.monotonic() - t0)
        losses.append(m["loss"].item())
    launches = _launches()
    peak = torch.cuda.max_memory_allocated(dev)
    before = _launches()
    got = []

    def traced():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got.append(step(params, state, batches[6]))
        torch.cuda.synchronize()
        got.append(time.monotonic() - t0)
    rows = _device_rows(traced)
    (_, _, m), wall = got
    losses.append(m["loss"].item())
    traced_launches = {k: n - before[k] for k, n in _launches().items()}
    _write(out, "profile_train_bf16.txt", "\n".join(
        f"{ns / 1e6:12.3f} ms {n:8d}x  {k}" for k, ns, n in rows))
    busy = sum(ns for _, ns, _ in rows) / 1e9
    assert all(np.isfinite(losses)), losses
    mean_s = sum(secs) / len(secs)
    del got, m, params, state, batches
    return {"phase": "train_bf16", "config": NAME, "reduced": TRAIN_CUT,
            "params": n_params, "batch": B, "seq": S, "remat": "full",
            "losses": losses, "step_s": secs, "mean_step_s": mean_s,
            "tokens_per_s": B * S / mean_s, "peak_device_bytes": peak,
            "traced_step": {"wall_s": wall, "device_busy_s": busy,
                            "idle_share": 1 - busy / wall if busy else "not measured",
                            "kernels": _paged_kernel_ms(
                                [(k, ns / 1e6, n) for k, ns, n in rows], TRAIN_KERNELS),
                            "backward_by_kernel": _bwd_kernel_ms(rows),
                            "launches": {k: traced_launches[k] for k in TRAIN_KERNELS},
                            "top": [[k[:120], ns / 1e6, n] for k, ns, n in rows[:10]]},
            "launches": {k: launches[k] for k in TRAIN_KERNELS}}, launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the long outputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA card")
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    reports = _build.build_all()
    build_s = time.monotonic() - t0
    _write(args.out, "ptxas.txt", "\n".join(f"== {k}\n{v}" for k, v in reports.items()))
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports),
          "ptxas": [ln.strip() for v in reports.values() for ln in v.splitlines()
                    if "Used" in ln or "Compiling entry" in ln],
          "tensor_core_sass": {name: sass_counts(name)
                               for name in ("flash_attention", "flash_attention_bwd", "mlstm",
                                            "mamba_scan")},
          "spills": _spills(reports)})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = [check_paged_decode(gen, dev), check_paged_flash(gen, dev),
               check_dense_flash(gen, dev), check_flash_bwd(gen, dev),
               check_dense_decode(gen, dev), check_mamba_scan(gen, dev), check_mlstm(gen, dev),
               check_chunk_hash(args.seed, dev)]
    emit({"phase": "kernels", "tol": {"float32": "atol=rtol=2e-5; mlstm's h 2e-4 "
                                                 "(its denominator cancels)",
                                      "bfloat16": "atol=rtol=2e-2 vs f32 plain on bf16 inputs",
                                      "flash_attention_bwd": "each gradient's max error within "
                                                             "2e-5 (f32) or 2e-2 (bf16) of its "
                                                             "largest entry",
                                      "chunk_hash": "exact"},
          "errs": "per case [max abs error, worst err / (atol + rtol * |plain|)]",
          "timed_by_events": len(PROFILER_MISSES), "kernels": kernels})
    _free()

    # the paged pool's path (llama): its launches count the paged kernels
    emit(f32_parity(args.seed, dev))
    _free()
    emit(overlay_f32_parity(args.seed, dev))
    _free()
    emit(privacy_overlay_f32_parity(args.seed, dev))
    _free()
    line, paged_launches, params = serve_bf16(args.seed, dev, args.out)
    emit(line)
    _free()
    # the overlay path on the same weights: its launches count the chunk hash
    line, overlay_launches = overlay_serve_bf16(args.seed, dev, params)
    emit(line)
    _free()
    # the privacy path on the same weights: users, onion proxies, signing
    line, _ = privacy_overlay_bf16(args.seed, dev, params)
    emit(line)
    _free()
    # serving-quality verification: the log-prob verifier (the flash
    # kernel's dense entry) over the committee's challenges
    emit(verification_f32_parity(args.seed, dev))
    _free()
    line, verification_launches = verification_bf16(args.seed, dev, params)
    emit(line)
    del params
    _free()

    # the dense slot pool's path (jamba): the dense decode, the scan and
    # the flash kernel's dense entry
    emit(jamba_layer_parity(args.seed, dev))
    _free()
    emit(jamba_f32_parity(args.seed, dev))
    _free()
    line, dense_launches = jamba_serve_bf16(args.seed, dev, args.out)
    emit(line)
    _free()

    # the dense slot pool's recurrent path (xlstm): the mLSTM kernel
    emit(xlstm_layer_parity(args.seed, dev))
    _free()
    emit(xlstm_f32_parity(args.seed, dev))
    _free()
    line, xlstm_launches = xlstm_serve_bf16(args.seed, dev, args.out)
    emit(line)
    _free()

    # the other families: six decoder-only configs on the paged pool (both
    # paged kernels), and the encoder and cross-attention of vision and
    # whisper (the flash kernel's dense entry and the dense decode)
    emit(families_f32_parity(args.seed, dev))
    _free()
    line, family_launches = families_serve_bf16(args.seed, dev, args.out)
    emit(line)
    _free()
    line, encdec_launches = encdec_serve_bf16(args.seed, dev, args.out)
    emit(line)
    _free()

    # the training path: the flash kernel's dense entry forward (with its
    # lse) and its backward kernel, under autograd and AdamW
    emit(train_f32_parity(args.seed, dev))
    _free()
    line, train_launches = train_bf16(args.seed, dev, args.out)
    emit(line)
    _free()

    # each kernel's launches on every path that runs it
    paths = {"paged_decode_attention": {"llama": paged_launches, "families": family_launches},
             "paged_flash_attention": {"llama": paged_launches, "families": family_launches},
             "flash_attention": {"jamba": dense_launches,
                                 "verification": verification_launches,
                                 "encdec": encdec_launches, "training": train_launches},
             "flash_attention_bwd": {"training": train_launches},
             "decode_attention": {"jamba": dense_launches, "encdec": encdec_launches},
             "mamba_scan": {"jamba": dense_launches}, "mlstm": {"xlstm": xlstm_launches},
             "chunk_hash": {"overlay": overlay_launches}}
    for k in kernels:
        k.pop("errs")
        k.pop("library", None)
        k.pop("tol", None)
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths[k["name"]].items()}
        k["launches"] = sum(k["launches_by_path"].values())
    # a time_ms that fell back to CUDA events timed the host's gaps too
    emit({"phase": "timing", "timed_by_events": len(PROFILER_MISSES)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
