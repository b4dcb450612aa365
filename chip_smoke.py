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
  kernel's forward with its lse and its backward kernel, the scan's and
  the mLSTM's backward kernels, AdamW): one step of eight reduced configs
  in float32 on the card against the CPU, jamba and xlstm among them;
  float32 weights and AdamW state with bf16 compute, a few steps each of
  ``gentorrent-llama3-8b`` at full width cut to 4 layers (B=2 x 2048
  tokens), ``jamba-v0.1-52b`` at full width cut to its first (Mamba)
  layer (B=2 x 2048) and ``xlstm-1.3b`` at full width and depth (B=2 x
  512);
* distribution: the sharded train step (DTensor params and AdamW state,
  each layer's weights gathered before use) on a one-rank NCCL group over a
  (data=1, model=1) mesh, one float32 step against the unsharded step bit
  for bit, then the llama training run above through it; the dry-run of
  one 16 x 16 cell (a fake process group of 256 ranks) on this host; and
  tensor-parallel compute over 'model' at the production mesh's extent 16:
  one full-width layer each of ``gentorrent-llama3-8b``, ``granite-20b``,
  ``gemma2-9b`` and ``moonshot-v1-16b-a3b``, its 16 ranks' local attention
  (both flash kernels on each rank's heads) and FFN run one after another
  on the card and summed, and of ``jamba-v0.1-52b``'s Mamba mixer and
  ``xlstm-1.3b``'s mLSTM, whose ranks meet inside the mixer, and its sLSTM
  at extents 16 (its FFN whole on every rank) and 2 (its FFN split),
  against the unsharded layer in float32 and bf16;
* the examples: each twin of ``examples/`` (``torch_quickstart``,
  ``torch_serve_overlay``, ``torch_train_100m``,
  ``torch_dishonest_detection``) through its own ``main`` on the card at
  the reference example's size, held to the same twin's run on the CPU
  (dishonest_detection's committee epochs over the card's own trained
  weights).

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
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

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
# event or were not whole (``_whole``), and which were therefore timed by CUDA
# events (``event_ms``)
PROFILER_MISSES = []
# Every profiler session is bracketed (``_traced``): the card idles
# TRACE_PAD_S seconds at each end, TRACE_LEAD marker kernels
# (``torch.cuda._sleep``, TRACE_MARK in the name), TRACE_GAP_S apart, run
# before the traced work and one just after it.  The tracer has been seen
# to leave out the first records of a session (on an H100 host: a
# backward's first three kernels of twenty; in serving runs, every marker
# of a lead launched back to back), so the lead absorbs such a loss and
# shows it.  Each session that lost a marker is listed here as (lead
# markers kept, end markers kept); one that kept no lead marker or not the
# end one may have lost traced work, and is run again where its work may
# run again.
TRACE_PAD_S = 0.05
TRACE_LEAD = 8
TRACE_GAP_S = 0.002
TRACE_MARK = "spin_kernel"
TRACE_LOSSES = []


def _whole(lead, end):
    """Whether a session kept a lead marker and the end one: the tracer
    then lost nothing of the work between them."""
    return lead >= 1 and end == 1


def _traced(fn):
    """Run ``fn`` once under torch.profiler tracing the card only, between
    the pads and markers above.  Returns {name: (device ns, count)} of each
    kernel and copy ``fn`` ran, and whether the session is ``_whole``.  It
    reads the tracer's raw device events: building the profiler's per-op
    tables (``key_averages``) over a serving run's ~250,000 events took
    ~60 s a run on an H100 machine, and tracing the host's ops too slows
    the host that is being measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        for _ in range(TRACE_LEAD):
            torch.cuda._sleep(1000)
            time.sleep(TRACE_GAP_S)
        fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    by_name, marks, first, last = {}, [], None, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        if TRACE_MARK in e.name():
            marks.append(e.start_ns())
            continue
        first = e.start_ns() if first is None else min(first, e.start_ns())
        last = e.start_ns() if last is None else max(last, e.start_ns())
        ns, n = by_name.get(e.name(), (0, 0))
        by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    if first is None:                   # no work traced: count the markers only
        lead, end = len(marks) - min(len(marks), 1), min(len(marks), 1)
    else:
        lead, end = sum(m < first for m in marks), sum(m > last for m in marks)
    if (lead, end) != (TRACE_LEAD, 1):
        TRACE_LOSSES.append((lead, end))
        print(f"chip_smoke: a traced session kept {lead} of {TRACE_LEAD} lead markers and "
              f"{end} of 1 end marker", file=sys.stderr, flush=True)
    return by_name, _whole(lead, end)


def time_ms(fn, iters=50, warmup=5, tries=3):
    """Device time of one call of ``fn``: the summed time of every kernel
    (and copy) it runs on the card, from torch.profiler, averaged over
    ``iters`` calls.  The host's gaps between launches do not count: at
    the serving path's small shapes a kernel runs for less time than its
    Python wrapper takes to launch it, and a loop timed by CUDA events
    times the host (``event_ms``).

    The tracer now and then hands back a session with no device event at
    all (seen once on an H100 host, in the middle of a run whose other
    sessions saw theirs), or one that is not ``_whole``.  Such a session is
    run again, up to ``tries`` times; if none is whole, the call is timed by
    ``event_ms``, an upper bound on the device time, and listed in
    ``PROFILER_MISSES``."""
    def loop():
        for _ in range(iters):
            fn()
    for _ in range(warmup):
        fn()
    for attempt in range(tries):
        by_name, whole = _traced(loop)
        ns = sum(t for t, _ in by_name.values())
        if ns > 0 and whole:
            return ns / iters / 1e6
        print(f"chip_smoke: the profiler saw {ns} ns of device time (try {attempt + 1} of "
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
    serving run, 1 per 2048-token prefill); then one rank's heads at model
    extent 16 (``_flash_tp_fwd``)."""
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
    tp_layouts = _flash_tp_fwd(gen, dev, errs)
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
            **full, "tp_layouts": tp_layouts, "errs": errs}


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
               (*FLASH_BWD_SHAPES.values(), *FLASH_BWD_TIMED.values())} \
        | {(H, Hkv, D) for H, Hkv, D, _ in TP_LAYOUTS.values()}
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
    plan's; then ``_flash_tp_bwd``'s local layouts."""
    errs, same_bits = {}, {}
    for name, shape in FLASH_BWD_SHAPES.items():
        _flash_bwd_checked(gen, dev, name, shape, errs, same_bits)
    plans_compared = _flash_bwd_plans_agree()
    train = _flash_bwd_timed(gen, dev, *FLASH_BWD_SHAPES["train"])
    others = {}
    for name, shape in FLASH_BWD_TIMED.items():
        B, H, Hkv, S, _, D, _, _, softcap = shape
        others[name] = {"shape": f"B={B} H={H} Hkv={Hkv} S={S} D={D} causal bf16"
                                 + (f" softcap {softcap}" if softcap else ""),
                        **_flash_bwd_timed(gen, dev, *shape)}
        _free()
    tp_layouts = _flash_tp_bwd(gen, dev, errs)
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83 (backward of; "
                        "the reference differentiates its jnp attention)",
            **_summary(errs), **train,
            "timed_at": "B=2 H=32 Hkv=8 S=2048 D=128 causal bf16, (B,S,H,D) views; "
                        "library: SDPA's backward alone on H-expanded K/V",
            "timed_more": others, "tp_layouts": tp_layouts,
            "same_bits_on_a_second_call": all(same_bits.values()),
            "plans_equal_the_source": plans_compared, "errs": errs}


def _flash_bwd_checked(gen, dev, name, shape, errs, same_bits):
    """One backward case in f32 and bf16 (``flash_bwd_case``), each
    gradient within ``FLASH_BWD_TOL`` of its largest entry and a second
    call giving the same bits (asserted), into ``errs`` / ``same_bits``."""
    for dtype in (torch.float32, torch.bfloat16):
        r = flash_bwd_case(gen, dev, shape, dtype)
        key = f"{name}/{r['key']}"
        same_bits[key] = r["same_bits"]
        assert same_bits[key], (name, dtype, "two calls differ")
        assert r["lse_err"] <= 1e-4, (name, dtype, r["lse_err"])
        for gname, (abs_err, err) in r["errs"].items():
            assert err <= FLASH_BWD_TOL[dtype], (name, dtype, gname, err)
            errs[f"{key}/{gname}"] = [abs_err, err / FLASH_BWD_TOL[dtype]]


def _flash_bwd_timed(gen, dev, B, H, Hkv, S, Skv, D, causal, window, softcap):
    """Device ms of the backward kernel, its plain version and SDPA's
    backward at one bf16 shape, with the bound and the launch plan (each
    device function's launches held to the plan's)."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, do = _flash_bwd_inputs(gen, dev, B, H, Hkv, S, Skv, D, torch.bfloat16)
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
                 for f, r in _bwd_kernel_ms(_device_rows(calls, tries=5)).items()
                 if r["launches"]}
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


# the flash kernels on one rank's heads at model extent 16, the production
# mesh's (tensor-parallel compute over 'model', distributed/tensor_parallel.py):
# (H, Hkv, D, softcap) of the rank's query and KV heads
TP_LAYOUTS = {"llama": (2, 1, 128, None),     # llama, danube, vision, jamba's attention
              "granite": (3, 1, 128, None),   # granite; dbrx (inside a group of 6)
              "gemma2": (1, 1, 256, 50.0),
              "moonshot": (1, 1, 128, None)}  # KV heads on 'model'
TP_B, TP_S = 1, 2048                          # the tp_emulated_bf16 phase's tokens


def _flash_tp_fwd(gen, dev, errs):
    """The dense entry at each ``TP_LAYOUTS`` layout, B=1 S=2048 causal
    (with the layout's softcap): float32 and bf16 against the plain
    version (into ``errs``), bf16 timed beside its bound, the plain
    version and SDPA (on K/V expanded to the query heads; without the
    softcap, which SDPA does not take)."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (H, Hkv, D, softcap) in TP_LAYOUTS.items():
        q = torch.randn(TP_B, TP_S, H, D, generator=gen, device=dev).transpose(1, 2)
        k, v = (torch.randn(TP_B, TP_S, Hkv, D, generator=gen, device=dev).transpose(1, 2)
                for _ in range(2))
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (q, k, v)]
            got = ops.flash_attention(*x, softcap=softcap)
            want = ref.attention_ref(*[t.float() for t in x], softcap=softcap)
            torch.cuda.synchronize()
            errs[f"tp_{name}/H{H}/Hkv{Hkv}/D{D}/{str(dtype)[6:]}/cap{softcap}"] = \
                close(got, want, dtype)
        x = [t.to(torch.bfloat16) for t in (q, k, v)]
        kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in x[1:])
        b_ms, b_by = bound(*_dense_flash_cost(TP_B, H, Hkv, TP_S, D, 2), torch.bfloat16)
        out[name] = {"shape": f"B={TP_B} H={H} Hkv={Hkv} S={TP_S} D={D} causal bf16"
                              + (f" softcap {softcap}" if softcap else ""),
                     "ms": time_ms(lambda: ops.flash_attention(*x, softcap=softcap), iters=20),
                     "plain_ms": time_ms(lambda: ref.attention_ref(*x, softcap=softcap),
                                         iters=5),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": time_ms(lambda: sdpa(x[0], kr, vr, is_causal=True),
                                           iters=20)}
    return out


def _flash_tp_bwd(gen, dev, errs):
    """The backward at each ``TP_LAYOUTS`` layout, B=1 S=2048 causal:
    float32 (at a quarter of the sequence) and bf16 against the plain
    version (``_flash_bwd_checked``, into ``errs``), bf16 timed
    (``_flash_bwd_timed``)."""
    out, same_bits = {}, {}
    for name, (H, Hkv, D, softcap) in TP_LAYOUTS.items():
        shape = (TP_B, H, Hkv, TP_S, TP_S, D, True, None, softcap)
        _flash_bwd_checked(gen, dev, f"tp_{name}", shape, errs, same_bits)
        out[name] = {"shape": f"B={TP_B} H={H} Hkv={Hkv} S={TP_S} D={D} causal bf16"
                              + (f" softcap {softcap}" if softcap else ""),
                     **_flash_bwd_timed(gen, dev, *shape)}
        _free()
    return out


def check_flash_tp_layouts(gen, dev):
    """Both flash kernels at ``TP_LAYOUTS`` alone (the ``distributed``
    group of ``scripts/phases.py``): ``_flash_tp_fwd`` and
    ``_flash_tp_bwd`` with their error summaries."""
    fwd_errs, bwd_errs = {}, {}
    fwd = _flash_tp_fwd(gen, dev, fwd_errs)
    bwd = _flash_tp_bwd(gen, dev, bwd_errs)
    return {"flash_attention": {**_summary(fwd_errs), "tp_layouts": fwd},
            "flash_attention_bwd": {**_summary(bwd_errs), "tp_layouts": bwd}}


def check_recurrent_tp_layouts(gen, dev):
    """The scan and the mLSTM, forward and backward, at one rank's share
    under tensor parallelism (``TP_SCAN``, ``TP_MLSTM``) alone (the
    ``distributed`` group of ``scripts/phases.py``), with their error
    summaries."""
    errs = {k: {} for k in ("mamba_scan", "mamba_scan_bwd", "mlstm", "mlstm_bwd")}
    same_bits, f64 = {}, {}
    out = {"mamba_scan": _scan_tp_fwd(gen, dev, errs["mamba_scan"]),
           "mamba_scan_bwd": _scan_tp_bwd(gen, dev, errs["mamba_scan_bwd"], same_bits),
           "mlstm": _mlstm_tp_fwd(gen, dev, errs["mlstm"]),
           "mlstm_bwd": _mlstm_tp_bwd(gen, dev, errs["mlstm_bwd"], same_bits, f64)}
    return {k: {**_summary(errs[k]), "tp_layouts": v,
                **({"same_bits_on_a_second_call": all(same_bits.values())}
                   if k.endswith("_bwd") else {})} for k, v in out.items()}


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
    tp_layouts = _scan_tp_fwd(gen, dev, errs)
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
            "tp_layouts": tp_layouts, "errs": errs}


# the recurrent kernels on one rank's share at model extent 16 (the
# Mamba mixer's and the mLSTM's split, distributed/tensor_parallel.py):
# the SSD scan on (H, P, N) = 4 of jamba's 64 heads, the mLSTM on dv of
# xlstm's 1024 value columns of each of its 4 heads (64 at 16 ranks; 256,
# a rank's share at 4, beside it), B=1 S=2048 without a state
TP_SCAN = {"jamba": (4, 128, 16)}
TP_MLSTM = {"xlstm": 64, "xlstm_at_4": 256}


def _scan_tp_fwd(gen, dev, errs):
    """The scan at each ``TP_SCAN`` layout, B=1 S=2048 L=128 without h0
    (the training step's): float32 and bf16 against the plain version (into
    ``errs``), bf16 timed beside its bound and the plain version."""
    from repro_torch.kernels.mamba_scan import ops, ref
    out = {}
    for name, (H, P, N) in TP_SCAN.items():
        B, S, L = TP_B, TP_S, 128
        x, loga, Bm, Cm, _ = _scan_inputs(gen, dev, B, S, H, P, N, False)
        for dtype in (torch.float32, torch.bfloat16):
            xb, bm, cm = (t.to(dtype) for t in (x, Bm, Cm))
            y, h = ops.mamba_scan(xb, loga, bm, cm, chunk=L)
            wy, wh = ref.mamba_scan_ref(xb.float(), loga, bm.float(), cm.float(), chunk=L)
            torch.cuda.synchronize()
            ey, eh = close(y, wy, dtype), close(h, wh, dtype)
            errs[f"tp_{name}/B{B}/S{S}/H{H}/L{L}/{str(dtype)[6:]}"] = \
                [max(ey[0], eh[0]), max(ey[1], eh[1])]
        xb, bm, cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
        b_ms, b_by = bound(*_scan_cost(B, S, H, P, N, L, 2, False), torch.bfloat16)
        out[name] = {"shape": f"B={B} S={S} H={H} P={P} N={N} L={L} bf16, no h0",
                     "ms": time_ms(lambda: ops.mamba_scan(xb, loga, bm, cm, chunk=L), iters=20),
                     "plain_ms": time_ms(lambda: ref.mamba_scan_ref(xb, loga, bm, cm, chunk=L),
                                         iters=5),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return out


def _mlstm_cost(B, S, H, dh, L, esize, state=True, dv=None):
    """Bytes and FLOPs of the chunkwise mLSTM: q, k (dh columns), v (dv,
    default dh) read and h (dv) written, the f32 gates read, the f32 start
    state read (if given) and the final state written; the causal
    (lower-triangular) q k^T and att v, and q C and the state update (dh x
    dv per step), per chunk and head, plus the q n and n products."""
    dv = dh if dv is None else dv
    st = 4 * B * H * (dh * dv + dh + 1)
    nbytes = 2 * B * S * H * (dh + dv) * esize + 2 * 4 * B * S * H + (2 if state else 1) * st
    flops = 0
    for c in range(-(-S // L)):
        n = min(L, S - c * L)
        tri = n * (n + 1) // 2
        flops += B * H * (2 * tri * (dh + dv) + 4 * n * dh * dv + 4 * n * dh)
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
    tp_layouts = _mlstm_tp_fwd(gen, dev, errs)
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
            "tp_layouts": tp_layouts,
            "tol": "h in float32 at atol=rtol=2e-4 (MLSTM_TOL_H), the state at TOL",
            "errs": errs}


def _mlstm_tp_fwd(gen, dev, errs):
    """The mLSTM at each ``TP_MLSTM`` share of v's columns (q and k whole:
    H=4 dh=1024), B=1 S=2048 L=64 without a state (the training step's)
    and, at 64 columns, 300 steps with a start state: float32 and bf16
    against the plain version (into ``errs``), bf16 at 2048 steps timed
    beside its bound and the plain version."""
    from repro_torch.kernels.mlstm import ops, ref
    out = {}
    H, dh, L = 4, 1024, 64
    for name, dv in TP_MLSTM.items():
        for S, state in ((TP_S, False), (300, True))[:2 if dv == 64 else 1]:
            q, k, v, log_i, log_f, st = _mlstm_inputs(gen, dev, TP_B, S, H, dh, state, dv=dv)
            for dtype in (torch.float32, torch.bfloat16):
                x = [t.to(dtype) for t in (q, k, v)]
                h, fin = ops.mlstm_chunkwise(*x, log_i, log_f, st, chunk=L)
                wh, wfin = ref.mlstm_ref(*[t.float() for t in x], log_i, log_f, st, chunk=L)
                torch.cuda.synchronize()
                e = [close(h, wh, dtype, MLSTM_TOL_H[dtype])] + \
                    [close(a, b, dtype) for a, b in zip(fin, wfin)]
                errs[f"tp_{name}/B{TP_B}/S{S}/H{H}/dh{dh}/dv{dv}/state{state}/"
                     f"{str(dtype)[6:]}"] = [max(r[0] for r in e), max(r[1] for r in e)]
        q, k, v, log_i, log_f, _ = _mlstm_inputs(gen, dev, TP_B, TP_S, H, dh, False, dv=dv)
        x = [t.to(torch.bfloat16) for t in (q, k, v)]
        b_ms, b_by = bound(*_mlstm_cost(TP_B, TP_S, H, dh, L, 2, False, dv), torch.bfloat16)
        out[name] = {"shape": f"B={TP_B} S={TP_S} H={H} dh={dh} dv={dv} L={L} bf16, no state",
                     "ms": time_ms(lambda: ops.mlstm_chunkwise(*x, log_i, log_f, chunk=L),
                                   iters=10),
                     "plain_ms": time_ms(lambda: ref.mlstm_ref(*x, log_i, log_f, chunk=L),
                                         iters=3),
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return out


# the backward kernels' gate: each gradient's largest error within these
# shares of its largest entry (row 2b's rule).  The mLSTM's float32
# gradients are held at its forward's h gate, 2e-4 (MLSTM_TOL_H): they
# pass through the same denominator, whose cancellation magnifies the
# order of the sums over dh = 1024 (``check_mlstm_bwd`` records how far
# the float32 plain version itself is from a float64 one)
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MLSTM_BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _rel_err(a, b):
    """The largest error of ``a`` against ``b`` over b's largest entry."""
    b = b.float()
    return ((a.float() - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _grad_errs(got, want, dtype, key, errs, tol=BWD_TOL):
    """Each gradient of ``got`` against ``want`` (name -> tensor): [largest
    error, that error over the gradient's largest entry / tol], asserted
    within 1; every gradient finite."""
    for name, a in got.items():
        b = want[name].float()
        assert torch.isfinite(a).all(), (key, name)
        err = (a.float() - b).abs().max()
        share = _rel_err(a, b) / tol[dtype]
        assert share <= 1, (key, name, err.item(), share)
        errs[f"{key}/{name}"] = [err.item(), share]


def _scan_inputs(gen, dev, B, S, H, P, N, h0, deep=False):
    """The scan's inputs as ``check_mamba_scan`` draws them; ``deep`` puts a
    summed log decay below -200 in the first chunk (loga = -25 on its
    first 9 steps)."""
    x = torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5
    loga = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev))
    if deep:
        loga[:, :9] = -25.0
    Bm, Cm = (torch.randn(B, S, N, generator=gen, device=dev) * 0.5 for _ in range(2))
    return x, loga, Bm, Cm, (torch.randn(B, H, N, P, generator=gen, device=dev) * 0.1
                             if h0 else None)


def _scan_bwd_cost(B, S, H, P, N, L, esize, h0=True):
    """Bytes and FLOPs of the scan's backward: x and dy read, dx written; B,
    C read and dB, dC written; loga read and dloga written; the forward's
    saved chunk states read; with h0 the state's gradient in and h0's out.
    Per chunk and head: datt = dy x^T and att^T dy over the causal pairs
    and P, C B^T (recomputed) with dC and dB over the pairs and N, and the
    four N P state products (G, B dH, x dH^T, dy h^T)."""
    n_chunks = -(-S // L)
    nbytes = 3 * B * S * H * P * esize + 4 * B * S * N * esize + 8 * B * S * H \
        + 4 * B * H * n_chunks * N * P + (3 * 4 * B * H * N * P if h0 else 0)
    flops = 0
    for c in range(n_chunks):
        n = min(L, S - c * L)
        tri = n * (n + 1) // 2
        flops += B * H * 2 * (2 * tri * P + 3 * tri * N + 4 * n * N * P)
    return nbytes, flops


# the scan backward's cases: (B, S, H, P, N, L, h0 and the final state's
# gradient, a chunk whose summed loga is below -200)
SCAN_BWD_CASES = {"train": (2, 2048, 64, 128, 16, 128, False, False),
                  "ragged_h0": (2, 300, 8, 128, 16, 128, True, False),
                  "deep": (2, 37, 2, 128, 8, 16, True, True),
                  "boot": (2, 8, 64, 128, 16, 128, False, False),
                  "ragged": (2, 2000, 64, 128, 16, 128, False, False)}
# cases of the bf16 body only: the boot path, and the training shape with a
# ragged last chunk (80 steps)
SCAN_BWD_BF16_ONLY = ("boot", "ragged")


def check_mamba_scan_bwd(gen, dev):
    """Row 4b: the scan's backward (``MambaScan``: the forward's scratch,
    then ``mamba_scan_bwd``) against autograd of the plain version on the
    same inputs (float32 copies of the bf16 ones), every gradient of x,
    loga, B, C and h0 within ``BWD_TOL`` of its largest entry: at jamba's
    training shape (B=2 S=2048 H=64 P=128 N=16 L=128, no h0, dy only), at
    a ragged shape with h0 and the final state's gradient, with a chunk
    whose summed loga is below -200, on bf16's boot path (one chunk, no
    h0) and at the training shape with a ragged last chunk (bf16); f32 (the
    scalar bodies) and bf16 (the tensor-core ones); a second call gives the
    same bits; ``bwd_plan`` equal to the source's plan at every case.
    Timed in bf16 at the training shape beside its bound and the plain
    version's backward, with each launch's device time (also printed on a
    line of its own, ``mamba_scan_bwd_launches``)."""
    from repro_torch.kernels.mamba_scan import ops
    errs, same_bits = {}, {}
    cases = SCAN_BWD_CASES
    for name, case in cases.items():
        dtypes = (torch.bfloat16,) if name in SCAN_BWD_BF16_ONLY \
            else (torch.float32, torch.bfloat16)
        _scan_bwd_checked(gen, dev, name, case, dtypes, errs, same_bits)
        _free()

    B, S, H, P, N, L = cases["train"][:6]
    timed = _scan_bwd_timed(gen, dev, B, S, H, P, N, L, by_kernel=True)
    emit({"phase": "mamba_scan_bwd_launches", "shape": f"B={B} S={S} H={H} P={P} N={N} "
          f"L={L} bf16", "card": smi_line(), "ms": timed["ms"], "by_kernel": timed["by_kernel"]})
    tp_layouts = _scan_tp_bwd(gen, dev, errs, same_bits)
    plans = _bwd_plans_agree(ops, [(*c[:6], {}) for c in cases.values()]
                             + [(TP_B, TP_S, *hpn, 128, {}) for hpn in TP_SCAN.values()])
    plan = ops.bwd_plan(B, S, H, P, N, L, torch.bfloat16)
    return {"name": "mamba_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu",
            "replaces": "src/repro/kernels/mamba_scan/kernel.py:63 (backward of; the "
                        "reference differentiates its jnp chunked scan)",
            **_summary(errs), **timed,
            "library": "none: no single PyTorch call computes the SSD scan's backward",
            "timed_at": "B=2 S=2048 H=64 P=128 N=16 L=128 bf16, no h0 (jamba's training "
                        "shape, 16 chunks); plain: autograd of the f32 plain version's "
                        "backward alone",
            "plan": [[k["name"], list(k["grid"]), k["threads"], k["smem"]]
                     for k in plan["kernels"]],
            "plans_equal_the_source": plans, "tp_layouts": tp_layouts,
            "same_bits_on_a_second_call": all(same_bits.values()), "errs": errs}


def _scan_bwd_checked(gen, dev, name, case, dtypes, errs, same_bits):
    """One ``SCAN_BWD_CASES``-shaped case of ``check_mamba_scan_bwd`` in
    each of ``dtypes``: every gradient against the plain version's (into
    ``errs``), the backward alone twice from one forward (into
    ``same_bits``)."""
    from repro_torch.kernels.mamba_scan import ops, ref
    B, S, H, P, N, L, with_h0, deep = case
    x, loga, Bm, Cm, h0 = _scan_inputs(gen, dev, B, S, H, P, N, with_h0, deep)
    for dtype in dtypes:
        xb, bm, cm = (t.to(dtype) for t in (x, Bm, Cm))
        dy = torch.randn(B, S, H, P, generator=gen, device=dev).to(dtype)
        dh = torch.randn(B, H, N, P, generator=gen, device=dev) if with_h0 else None
        leaves = [t.clone().requires_grad_(True) for t in (xb, loga, bm, cm)]
        h0l = h0.clone().requires_grad_(True) if with_h0 else None
        y, h = ops.mamba_scan(*leaves, h0l, chunk=L)
        outs = (y, h) if with_h0 else (y,)
        grads = (dy, dh) if with_h0 else (dy,)
        got = torch.autograd.grad(outs, leaves + ([h0l] if with_h0 else []), grads)
        plain_in = [t.detach().float().requires_grad_(True) for t in leaves] \
            + ([h0.clone().requires_grad_(True)] if with_h0 else [])
        py, ph = ref.mamba_scan_ref(*plain_in[:4], plain_in[4] if with_h0 else None,
                                    chunk=L)
        want = torch.autograd.grad((py, ph) if with_h0 else (py,), plain_in,
                                   (dy.float(), dh) if with_h0 else (dy.float(),))
        names = ("dx", "dloga", "dB", "dC", "dh0")
        key = f"{name}/B{B}/S{S}/H{H}/L{min(L, S)}/{str(dtype)[6:]}"
        _grad_errs(dict(zip(names, got)), dict(zip(names, want)), dtype, key, errs)
        # the backward alone, twice from one forward: the same bits
        _, _, scratch = ops._forward(xb, loga, bm, cm, h0, L, save=True)
        a = ops.mamba_scan_bwd(xb, loga, bm, cm, h0, scratch, dy, dh, chunk=L)
        b = ops.mamba_scan_bwd(xb, loga, bm, cm, h0, scratch, dy, dh, chunk=L)
        torch.cuda.synchronize()
        same_bits[key] = all(torch.equal(u, v) for u, v in zip(a, b) if u is not None)
        assert same_bits[key], (key, "two calls differ")
        del leaves, got, want, plain_in, py, ph, y, h, a, b, scratch


def _scan_bwd_timed(gen, dev, B, S, H, P, N, L, by_kernel=False):
    """The scan's bf16 backward alone (no h0, dy only) timed beside its
    bound and autograd of the f32 plain version's backward; with
    ``by_kernel``, each launch's device time (``_bwd_by_kernel``)."""
    from repro_torch.kernels.mamba_scan import ops, ref
    x, loga, Bm, Cm, _ = _scan_inputs(gen, dev, B, S, H, P, N, False)
    xb, bm, cm = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    dy = torch.randn(B, S, H, P, generator=gen, device=dev).to(torch.bfloat16)
    _, _, scratch = ops._forward(xb, loga, bm, cm, None, L, save=True)

    def call():
        return ops.mamba_scan_bwd(xb, loga, bm, cm, None, scratch, dy, None, chunk=L)
    out = {"ms": time_ms(call, iters=5, warmup=2)}
    if by_kernel:
        out["by_kernel"] = _bwd_by_kernel(call, ops.bwd_plan(B, S, H, P, N, L, torch.bfloat16),
                                          SCAN_BWD_KERNELS)
    plain_in = [t.detach().float().requires_grad_(True) for t in (xb, loga, bm, cm)]
    py, _ = ref.mamba_scan_ref(*plain_in, chunk=L)
    dyf = dy.float()
    out["plain_ms"] = time_ms(lambda: torch.autograd.grad(py, plain_in, dyf, retain_graph=True),
                              iters=2, warmup=1)
    b_ms, b_by = bound(*_scan_bwd_cost(B, S, H, P, N, L, 2, False), torch.bfloat16)
    return {**out, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _scan_tp_bwd(gen, dev, errs, same_bits):
    """The scan's backward at each ``TP_SCAN`` layout, B=1 S=2048 L=128
    without h0 (the training step's): float32 and bf16 against the plain
    version, twice the same bits (``_scan_bwd_checked``), bf16 timed
    (``_scan_bwd_timed``)."""
    out = {}
    for name, (H, P, N) in TP_SCAN.items():
        case = (TP_B, TP_S, H, P, N, 128, False, False)
        _scan_bwd_checked(gen, dev, f"tp_{name}", case, (torch.float32, torch.bfloat16), errs,
                          same_bits)
        out[name] = {"shape": f"B={TP_B} S={TP_S} H={H} P={P} N={N} L=128 bf16, no h0",
                     **_scan_bwd_timed(gen, dev, TP_B, TP_S, H, P, N, 128)}
        _free()
    return out


def _bwd_by_kernel(call, plan, fns, n=3):
    """Device ms and launches a call of each device function behind
    ``call`` (a backward at one shape), over ``n`` traced calls; each of
    ``plan``'s launches seen once a call."""
    def calls():
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    got = {f: {"ms": r["ms"] / n, "launches": r["launches"] / n}
           for f, r in _bwd_kernel_ms(_device_rows(calls, tries=5), fns).items()}
    planned = [k["name"].split("<")[0] for k in plan["kernels"]]
    assert sorted(f for f, r in got.items() if r["launches"]) == sorted(planned), (got, planned)
    assert all(r["launches"] == 1 for f, r in got.items() if f in planned), got
    return {f: got[f] for f in planned}


def _bwd_plans_agree(ops, shapes):
    """``ops.bwd_plan``'s launches (grid, threads, dynamic shared memory)
    and scratch against the built source's own (``ops.launch_plan``) at
    each shape (the arguments of ``bwd_plan`` before the dtype, its chunk
    cut to the length, then a dict of its keyword arguments), both dtypes;
    returns the number compared."""
    n = 0
    for shape in shapes:
        *head, L, kw = shape
        L = min(L, head[1])
        for dtype in (torch.float32, torch.bfloat16):
            mirror = ops.bwd_plan(*head, L, dtype, **kw)
            want = (mirror["scratch"], tuple((k["grid"], k["threads"], k["dynamic"])
                                             for k in mirror["kernels"]))
            got = ops.launch_plan(*head, L, dtype, **kw)
            assert got == want, (shape, dtype, got, want)
            n += 1
    return n


def _mlstm_bwd_cost(B, S, H, dh, L, esize, dv=None):
    """Bytes and FLOPs of the mLSTM's backward on the training path (no
    state): q, k (dh columns), v and h's gradient (dv, default dh) read,
    dq, dk, dv written; the f32 gates read and their gradients written.
    Per chunk and head the five dh x dv products (q C for dh . num, the
    carried dC, dk's dC v, dq's C dnum, dv's k dC) and five over the
    causal pairs (q k^T, dS q and dS k over dh; dh v^T and att^T dnum
    over dv)."""
    dv = dh if dv is None else dv
    nbytes = (4 * dh + 3 * dv) * B * S * H * esize + 16 * B * S * H
    flops = 0
    for c in range(-(-S // L)):
        n = min(L, S - c * L)
        tri = n * (n + 1) // 2
        flops += B * H * 2 * (5 * n * dh * dv + tri * (3 * dh + 2 * dv))
    return nbytes, flops


def _mlstm_inputs(gen, dev, B, S, H, dh, state, small_q=False, dv=None):
    """``check_mlstm``'s distributions; ``small_q`` scales q by 1e-3, so
    that exp(-m_new) beats |den| on many steps (the other branch of the
    denominator); ``dv``: v's (and C's) columns, default dh."""
    dv = dh if dv is None else dv
    q = torch.randn(B, S, H, dh, generator=gen, device=dev) / dh ** 0.5
    if small_q:
        q = q * 1e-3
    k = torch.randn(B, S, H, dh, generator=gen, device=dev)
    v = torch.randn(B, S, H, dv, generator=gen, device=dev)
    log_i = torch.randn(B, S, H, generator=gen, device=dev) * 2
    log_f = torch.nn.functional.logsigmoid(torch.randn(B, S, H, generator=gen, device=dev) + 4)
    st = None
    if state:
        st = (torch.randn(B, H, dh, dv, generator=gen, device=dev) * 0.1,
              torch.randn(B, H, dh, generator=gen, device=dev) * 0.1,
              torch.randn(B, H, generator=gen, device=dev))
    return q, k, v, log_i, log_f, st


# the mLSTM backward's cases: (B, S, H, dh, L, a start state and the final
# state's gradient, q scaled by 1e-3); ``_mlstm_tp_bwd`` adds v's columns
MLSTM_BWD_CASES = {"train": (2, 1024, 4, 1024, 64, False, False),
                   "ragged_state": (1, 300, 4, 1024, 64, True, False),
                   "floor": (2, 37, 2, 32, 16, True, True),
                   "reduced": (2, 48, 4, 32, 64, False, False),
                   "ragged": (2, 1000, 4, 1024, 64, False, False)}
# cases of the bf16 body only: the training shape with a ragged last chunk
# (40 steps)
MLSTM_BWD_BF16_ONLY = ("ragged",)


def check_mlstm_bwd(gen, dev):
    """Row 5b: the mLSTM's backward (``MLSTM``, ``mlstm_bwd``) against
    autograd of the plain version on the same inputs (float32 copies of the
    bf16 ones), every gradient of q, k, v, log i, log f and the start state
    within ``MLSTM_BWD_TOL`` of its largest entry (in float32 also the
    kernel's and the plain version's distance from a float64 run of the
    plain version, ``f64``): at xlstm-1.3b's training shape
    (B=2 S=1024 H=4 dh=1024 L=64, no state, dh only), at a ragged shape with
    a start state and the final state's gradient, with q scaled down so
    that exp(-m_new) wins the denominator on many steps, at the reduced
    width (dh=32) and at the training shape with a ragged last chunk
    (bf16); f32 (the scalar bodies) and bf16 (the tensor-core ones); a
    second call gives the same bits; ``bwd_plan`` equal to the source's
    plan at every case.  Timed in bf16 at the training shape beside its
    bound and the plain version's backward, with each launch's device time
    (also printed on a line of its own, ``mlstm_bwd_launches``)."""
    from repro_torch.kernels.mlstm import ops
    errs, same_bits, f64 = {}, {}, {}
    cases = MLSTM_BWD_CASES
    for name, case in cases.items():
        dtypes = (torch.bfloat16,) if name in MLSTM_BWD_BF16_ONLY \
            else (torch.float32, torch.bfloat16)
        _mlstm_bwd_checked(gen, dev, name, case, dtypes, errs, same_bits, f64)
        _free()

    B, S, H, dh, L = cases["train"][:5]
    timed = _mlstm_bwd_timed(gen, dev, B, S, H, dh, L, by_kernel=True)
    emit({"phase": "mlstm_bwd_launches", "shape": f"B={B} S={S} H={H} dh={dh} L={L} bf16",
          "card": smi_line(), "ms": timed["ms"], "by_kernel": timed["by_kernel"]})
    tp_layouts = _mlstm_tp_bwd(gen, dev, errs, same_bits, f64)
    plans = _bwd_plans_agree(ops, [(*c[:5], {}) for c in cases.values()]
                             + [(TP_B, TP_S, 4, 1024, 64, {"dv": dv}) for dv in TP_MLSTM.values()])
    plan = ops.bwd_plan(B, S, H, dh, L, torch.bfloat16)
    return {"name": "mlstm_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/mlstm/csrc/mlstm_bwd.cu",
            "replaces": "src/repro/kernels/mlstm/kernel.py:106 (backward of; the "
                        "reference differentiates its jnp chunkwise mLSTM)",
            **_summary(errs), **timed,
            "library": "none: no single PyTorch call computes the mLSTM's backward",
            "timed_at": "B=2 S=1024 H=4 dh=1024 L=64 bf16, no state (xlstm-1.3b's training "
                        "shape, 16 chunks); plain: autograd of the f32 plain version's "
                        "backward alone",
            "plan": [[k["name"], list(k["grid"]), k["threads"], k["smem"]]
                     for k in plan["kernels"]],
            "plans_equal_the_source": plans, "tp_layouts": tp_layouts,
            "scratch_bytes": 4 * plan["scratch"],
            "same_bits_on_a_second_call": all(same_bits.values()),
            "f32_vs_float64": {k: max(v.items(), key=lambda kv: kv[1]["kernel"])
                               for k, v in f64.items()}, "errs": errs}


def _mlstm_bwd_checked(gen, dev, name, case, dtypes, errs, same_bits, f64):
    """One ``MLSTM_BWD_CASES``-shaped case of ``check_mlstm_bwd`` (with v's
    columns dv as an eighth entry, default dh) in each of ``dtypes``:
    every gradient against the plain version's (into ``errs``; in float32
    also both against a float64 run, into ``f64``), the backward alone
    twice (into ``same_bits``)."""
    from repro_torch.kernels.mlstm import ops, ref
    B, S, H, dh, L, with_state, small_q = case[:7]
    dv = case[7] if len(case) > 7 else dh
    q, k, v, log_i, log_f, st = _mlstm_inputs(gen, dev, B, S, H, dh, with_state, small_q, dv)
    for dtype in dtypes:
        x = [t.to(dtype) for t in (q, k, v)]
        dh_ = torch.randn(B, S, H, dv, generator=gen, device=dev).to(dtype)
        dst = tuple(torch.randn_like(t) for t in st) if with_state else None
        leaves = [t.clone().requires_grad_(True) for t in (*x, log_i, log_f)]
        sl = [t.clone().requires_grad_(True) for t in st] if with_state else []
        h, fin = ops.mlstm_chunkwise(*leaves, tuple(sl) if sl else None, chunk=L)
        outs, gr = ((h, *fin), (dh_, *dst)) if with_state else ((h,), (dh_,))
        got = torch.autograd.grad(outs, leaves + sl, gr)
        plain_in = [t.detach().float().requires_grad_(True) for t in leaves] \
            + [t.detach().clone().requires_grad_(True) for t in sl]
        ph, pfin = ref.mlstm_ref(*plain_in[:5], tuple(plain_in[5:]) if sl else None,
                                 chunk=L)
        pouts = (ph, *pfin) if with_state else (ph,)
        pgr = (dh_.float(), *dst) if with_state else (dh_.float(),)
        want = torch.autograd.grad(pouts, plain_in, pgr)
        names = ("dq", "dk", "dv", "dlog_i", "dlog_f", "dC0", "dn0", "dm0")
        cols = f"/dv{dv}" if dv != dh else ""
        key = f"{name}/B{B}/S{S}/H{H}/dh{dh}{cols}/L{min(L, S)}/{str(dtype)[6:]}"
        _grad_errs(dict(zip(names, got)), dict(zip(names, want)), dtype, key, errs,
                   MLSTM_BWD_TOL)
        if dtype == torch.float32:
            in64 = [t.detach().double().requires_grad_(True) for t in plain_in]
            ph64, pfin64 = ref.mlstm_ref(*in64[:5], tuple(in64[5:]) if sl else None,
                                         chunk=L)
            want64 = torch.autograd.grad((ph64, *pfin64) if with_state else (ph64,),
                                         in64, tuple(g.double() for g in pgr))
            f64[key] = {n: {"kernel": _rel_err(a, w), "plain_f32": _rel_err(b, w)}
                        for n, a, b, w in zip(names, got, want, want64)}
            del in64, ph64, pfin64, want64
        a = ops.mlstm_bwd(*x, log_i, log_f, st, dh_, dst, fin[:2], chunk=L)
        b = ops.mlstm_bwd(*x, log_i, log_f, st, dh_, dst, fin[:2], chunk=L)
        torch.cuda.synchronize()
        flat = lambda r: [*r[:5], *(r[5] or ())]  # noqa: E731
        same_bits[key] = all(torch.equal(u, w) for u, w in zip(flat(a), flat(b)))
        assert same_bits[key], (key, "two calls differ")
        del leaves, sl, got, want, plain_in, ph, pfin, h, fin, a, b


def _mlstm_bwd_timed(gen, dev, B, S, H, dh, L, dv=None, by_kernel=False):
    """The mLSTM's bf16 backward alone (no state, h's gradient only; v's
    columns ``dv``, default dh) timed beside its bound and autograd of the
    f32 plain version's backward; with ``by_kernel``, each launch's device
    time (``_bwd_by_kernel``)."""
    from repro_torch.kernels.mlstm import ops, ref
    dv = dh if dv is None else dv
    q, k, v, log_i, log_f, _ = _mlstm_inputs(gen, dev, B, S, H, dh, False, dv=dv)
    x = [t.to(torch.bfloat16) for t in (q, k, v)]
    dh_ = torch.randn(B, S, H, dv, generator=gen, device=dev).to(torch.bfloat16)

    def call():
        return ops.mlstm_bwd(*x, log_i, log_f, None, dh_, chunk=L)
    out = {"ms": time_ms(call, iters=5, warmup=2)}
    if by_kernel:
        out["by_kernel"] = _bwd_by_kernel(call, ops.bwd_plan(B, S, H, dh, L, torch.bfloat16, dv),
                                          MLSTM_BWD_KERNELS)
    plain_in = [t.detach().float().requires_grad_(True) for t in (*x, log_i, log_f)]
    ph, _ = ref.mlstm_ref(*plain_in, chunk=L)
    dhf = dh_.float()
    out["plain_ms"] = time_ms(lambda: torch.autograd.grad(ph, plain_in, dhf, retain_graph=True),
                              iters=2, warmup=1)
    b_ms, b_by = bound(*_mlstm_bwd_cost(B, S, H, dh, L, 2, dv), torch.bfloat16)
    return {**out, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _mlstm_tp_bwd(gen, dev, errs, same_bits, f64):
    """The mLSTM's backward at each ``TP_MLSTM`` share of v's columns (H=4
    dh=1024), B=1 S=2048 L=64 without a state (the training step's) and,
    at 64 columns, 300 steps with a start state and the final state's
    gradient: float32 and bf16 against the plain version, twice the same
    bits (``_mlstm_bwd_checked``); bf16 at 2048 steps timed
    (``_mlstm_bwd_timed``)."""
    out = {}
    for name, dv in TP_MLSTM.items():
        cases = [(TP_B, TP_S, 4, 1024, 64, False, False, dv)]
        if dv == 64:
            cases.append((TP_B, 300, 4, 1024, 64, True, False, dv))
        for case in cases:
            _mlstm_bwd_checked(gen, dev, f"tp_{name}", case, (torch.float32, torch.bfloat16),
                               errs, same_bits, f64)
            _free()
        out[name] = {"shape": f"B={TP_B} S={TP_S} H=4 dh=1024 dv={dv} L=64 bf16, no state",
                     **_mlstm_bwd_timed(gen, dev, TP_B, TP_S, 4, 1024, 64, dv)}
        _free()
    return out


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
            "mamba_scan_bwd": m.mamba_scan_bwd,
            "mlstm": ml.mlstm_chunkwise,
            "mlstm_bwd": ml.mlstm_bwd,
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


def _device_rows(fn, tries=1):
    """Run ``fn`` under torch.profiler tracing the card only (``_traced``).
    Returns (name, device ns, count) of each kernel and copy it ran, by
    device time.  A session that is not whole is run again, up to ``tries``
    times, for an ``fn`` that may run again."""
    for _ in range(tries):
        by_name, whole = _traced(fn)
        if whole:
            break
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


def _close_cpu(card, cpu, name, errs, leaf_share=0.0):
    """Card logits against the CPU's within 2e-4 (atol: ``leaf_share`` of
    the CPU tensor's largest entry where that is more); the largest error
    into ``errs[name]``."""
    card, cpu = card.float().cpu(), cpu.float().cpu()
    assert torch.isfinite(card).all(), f"{name}: non-finite logits"
    atol = max(2e-4, leaf_share * cpu.abs().max().item()) if cpu.numel() else 2e-4
    torch.testing.assert_close(card, cpu, atol=atol, rtol=2e-4, msg=name)
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
                "llama-3.2-vision-11b", JAMBA, XLSTM)
# xlstm's updated weights, card vs CPU: atol 3e-3 of each leaf's largest
# entry where that is more than 2e-4 (the leaf-max rule of
# tests/test_torch_training.py ``_atol_of_max``).  AdamW's first step moves
# a weight by about lr sign(g), so gradient entries whose float32 rounding
# is comparable to them move it by up to 2 lr: a float32 step on the CPU is
# up to 8e-4 of a leaf's max (1.4e-4) from a float64 one on reduced xlstm
# (scripts/train_f32_drift.py), and the card's 2.7e-4 from the CPU's
XLSTM_PARAM_SHARE = 3e-3
# device functions behind the bf16 training steps: the flash kernel's dense
# entry and its backward's bf16 kernels (Delta; dK/dV, the split sum and dQ
# on wgmma), the scan's and the mLSTM's bf16 forwards and their backwards'
# bf16 bodies (on wgmma but the pass, the heads' sum, steps and gate_grads)
FLASH_BWD_KERNELS = ("delta_kernel", "dkdv_tc_kernel", "dkdv_sum_kernel", "dq_tc_kernel")
SCAN_BWD_KERNELS = ("grad_in_tc", "pass_tc", "chunk_grads_tc", "sum_heads")
MLSTM_BWD_KERNELS = ("prep_tc", "states_tc", "steps", "rows_tc", "cols_tc", "gate_grads")


def _fn_keys(fns):
    """Name fragments of device functions ``fns`` in a profile, demangled
    (``::f<``, ``::f(``) or mangled (``<len>fI``, ``<len>fE``), so that
    ``states`` does not also match ``pass_states``."""
    return tuple(k for f in fns for k in (f"::{f}<", f"::{f}(", f"{len(f)}{f}I",
                                          f"{len(f)}{f}E"))


TRAIN_KERNELS = {"flash_attention": DENSE_KERNELS["flash_attention"],
                 "flash_attention_bwd": FLASH_BWD_KERNELS,
                 "mamba_scan": ("chunk_tc", "pass_states"),
                 "mamba_scan_bwd": _fn_keys(SCAN_BWD_KERNELS),
                 "mlstm": ("scores_tc", "recurrent_tc"),
                 "mlstm_bwd": _fn_keys(MLSTM_BWD_KERNELS)}


BWD_FN_KEYS = {**{f: (f + "<", f + "I", f + "(") for f in FLASH_BWD_KERNELS},
               **{f: _fn_keys((f,)) for f in SCAN_BWD_KERNELS + MLSTM_BWD_KERNELS}}


def _bwd_kernel_ms(rows, fns=FLASH_BWD_KERNELS):
    """Device ms and launches of each of a backward's device functions
    among ``_device_rows`` rows of (name, ns, count)."""
    return _paged_kernel_ms([(k, ns / 1e6, n) for k, ns, n in rows],
                            {f: BWD_FN_KEYS[f] for f in fns})


TRAIN_CUT = ["n_layers 32 -> 4: 4 layers are ~1.92 B parameters, ~31 GB of float32 "
             "weights, gradients and AdamW state; 32 layers would need ~128 GB"]
JAMBA_TRAIN_CUT = ["n_layers 32 -> 1: position 0 of the pattern (Mamba + a dense FFN, "
                   "~0.81 B parameters, ~13 GB of float32 weights, gradients and AdamW "
                   "state); two layers add position 1's 16-expert MoE, ~3.7 B parameters, "
                   "~60 GB before activations, no margin on 80 GB"]


def _mixers(cfg):
    """Decoder layers of each mixer ("attn", "cross_attn", "mamba",
    "mlstm", "slstm")."""
    out = collections.Counter(sp.mixer for sp in cfg.pattern)
    return {k: n * cfg.n_repeats for k, n in out.items()}


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
    image embeddings; jamba's Mamba layers, MoE and attention; xlstm's
    mLSTM and sLSTM layers), weights from ``init_params`` seeded ``seed``:
    the loss, the gradient norm and every updated parameter within 2e-4,
    and each kernel of the step launched on the card as full remat runs
    it: a decoder layer's forward twice and its backward once (the flash
    kernel's for attention, the scan's for Mamba, the mLSTM's for mLSTM),
    the encoder's forward once."""
    from repro_torch import configs
    from repro_torch.models.lm import LM
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
            _close_cpu(a, b, "loss" if i == 0 else "grad_norm" if i == 1 else "params", errs,
                       XLSTM_PARAM_SHARE if name == XLSTM and i > 1 else 0.0)
        # remat runs each decoder layer's forward twice, the encoder
        # (outside it) once; each layer's backward once
        n_enc = cfg.n_enc_layers if cfg.is_encdec else 0
        mix = _mixers(cfg)
        n_attn = mix.get("attn", 0) + mix.get("cross_attn", 0)
        want = {"flash_attention": 2 * n_attn + n_enc, "flash_attention_bwd": n_attn + n_enc,
                "mamba_scan": 2 * mix.get("mamba", 0), "mamba_scan_bwd": mix.get("mamba", 0),
                "mlstm": 2 * mix.get("mlstm", 0), "mlstm_bwd": mix.get("mlstm", 0)}
        assert {k: launches[k] for k in want} == want, (name, launches, want)
        runs[name] = {"loss": res["card"][0].item(), "grad_norm": res["card"][1].item(),
                      "card_vs_cpu_max_abs_err": errs,
                      "launches": {k: launches[k] for k in TRAIN_KERNELS}}
    return {"phase": "train_f32_parity", "configs": runs,
            "tol": "atol=rtol=2e-4, card vs CPU"}


def _sharded_setup(cfg, model, adamw, mesh, params, batches):
    """``make_sharded_train_step`` over ``mesh`` with ``params`` and each
    batch distributed in the sharding rules' placements: (step, params,
    AdamW state, batches)."""
    from repro_torch.distributed import sharded_step, sharding
    params = sharding.distribute(params, sharding.param_shardings(cfg, params, mesh, True))
    batches = [sharding.distribute(b, sharding.input_shardings(cfg, b, mesh)) for b in batches]
    return (sharded_step.make_sharded_train_step(cfg, model, adamw, mesh), params,
            sharded_step.init_state(params), batches)


def _train_run(cfg, seed, dev, out, B, S, n_timed, fname, kernels, mesh=None):
    """``make_train_step`` on ``cfg`` (float32 weights and AdamW state, its
    compute dtype, remat on) over batches of ``MarkovCorpus(vocab,
    seed=0)``: one warm-up step, ``n_timed`` timed steps (synchronised host
    clock), then one step traced on the card alone (``fname`` under
    ``out``) for its idle share and the device time and launches of
    ``kernels`` (wrapper -> name fragments).  With ``mesh``, the sharded
    step (``_sharded_setup``) in its place.  Every loss must be finite.
    Returns (the measurements, the wrappers' launches over the timed
    steps)."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    assert cfg.compute_dtype == torch.bfloat16 and cfg.params_dtype == torch.float32
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    n_params = sum(t.numel() for t in _leaves(params))
    adamw = opt.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    batches = [_train_batch(cfg, 100 + i, B, S, dev) for i in range(n_timed + 2)]
    if mesh is None:
        state = opt.init_state(params)
        step = make_train_step(cfg, LM(cfg, dev), adamw)
    else:
        step, params, state, batches = _sharded_setup(cfg, LM(cfg, dev), adamw, mesh,
                                                      params, batches)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    params, state, m = step(params, state, batches[0])             # warm-up
    losses.append(m["loss"].item())
    _reset_launches()
    for b in batches[1:-1]:
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
        got.append(step(params, state, batches[-1]))
        torch.cuda.synchronize()
        got.append(time.monotonic() - t0)
    rows = _device_rows(traced)
    (_, _, m), wall = got
    losses.append(m["loss"].item())
    traced_launches = {k: n - before[k] for k, n in _launches().items()}
    _write(out, fname, "\n".join(f"{ns / 1e6:12.3f} ms {n:8d}x  {k}" for k, ns, n in rows))
    busy = sum(ns for _, ns, _ in rows) / 1e9
    assert all(np.isfinite(losses)), losses
    mean_s = sum(secs) / len(secs)
    del got, m, params, state, batches
    return {"params": n_params, "batch": B, "seq": S, "remat": "full",
            "losses": losses, "step_s": secs, "mean_step_s": mean_s,
            "tokens_per_s": B * S / mean_s, "peak_device_bytes": peak,
            "traced_step": {"wall_s": wall, "device_busy_s": busy,
                            "idle_share": 1 - busy / wall if busy else "not measured",
                            "kernels": _paged_kernel_ms(
                                [(k, ns / 1e6, n) for k, ns, n in rows], kernels),
                            "launches": {k: traced_launches[k] for k in kernels},
                            "top": [[k[:120], ns / 1e6, n] for k, ns, n in rows[:10]]},
            "launches": {k: launches[k] for k in kernels}}, launches, rows


def train_bf16(seed, dev, out):
    """``gentorrent-llama3-8b`` at full width (d_model 4096, 32/8 heads,
    d_ff 14336, vocab 128256) cut to 4 layers (``TRAIN_CUT``), trained by
    ``make_train_step`` (``_train_run``): B=2 S=2048, 5 timed steps, one
    traced, with the flash kernel's forward and backward device time and
    launches.  Returns (line, the wrappers' launches over the timed
    steps)."""
    kernels = {k: TRAIN_KERNELS[k] for k in ("flash_attention", "flash_attention_bwd")}
    run, launches, rows = _train_run(_family(NAME, n_layers=4), seed, dev, out, 2, 2048, 5,
                                     "profile_train_bf16.txt", kernels)
    run["traced_step"]["backward_by_kernel"] = _bwd_kernel_ms(rows)
    return {"phase": "train_bf16", "config": NAME, "reduced": TRAIN_CUT, **run}, launches


def train_jamba_bf16(seed, dev, out):
    """``jamba-v0.1-52b`` at full width (d_model 4096, 64 Mamba heads of
    128, N=16, chunks of 128, vocab 65536) cut to its first layer
    (``JAMBA_TRAIN_CUT``), trained by ``make_train_step`` (``_train_run``):
    B=2 S=2048 (16 chunks), 3 timed steps, one traced, with the scan's
    forward and backward kernels' device time and launches (the backward
    per device function).  Returns (line, launches)."""
    from repro_torch import configs
    full = configs.get_config(JAMBA)
    cfg = dataclasses.replace(full, n_layers=1, pattern=full.pattern[:1])
    assert _mixers(cfg) == {"mamba": 1}
    kernels = {k: TRAIN_KERNELS[k] for k in ("mamba_scan", "mamba_scan_bwd")}
    run, launches, rows = _train_run(cfg, seed, dev, out, 2, 2048, 3,
                                     "profile_train_jamba_bf16.txt", kernels)
    assert run["launches"] == {"mamba_scan": 2 * 3, "mamba_scan_bwd": 3}, run["launches"]
    run["traced_step"]["backward_by_kernel"] = _bwd_kernel_ms(rows, SCAN_BWD_KERNELS)
    return {"phase": "train_jamba_bf16", "config": JAMBA, "reduced": JAMBA_TRAIN_CUT,
            **run}, launches


XLSTM_TRAIN_CUT = ["seq 1024 -> 512 (8 mLSTM chunks): the 6 sLSTM layers run their "
                   "per-step loop on the host, forward, remat forward and backward, and at "
                   "S=1024 the phase took 148 s (over the ~90 s it may take)"]


def train_xlstm_bf16(seed, dev, out):
    """``xlstm-1.3b`` at full width and depth (48 layers: 42 mLSTM with
    heads of 1024, 6 sLSTM; ~2.8 B parameters, ~45 GB of float32 weights,
    gradients and AdamW state), trained by ``make_train_step``
    (``_train_run``): B=2 S=512 (``XLSTM_TRAIN_CUT``), 3 timed steps, one
    traced, with the mLSTM's forward and backward kernels' device time and
    launches (the backward per device function).  Returns (line,
    launches)."""
    cfg = _xlstm()
    mix = _mixers(cfg)
    assert mix == {"mlstm": 42, "slstm": 6}, mix
    kernels = {k: TRAIN_KERNELS[k] for k in ("mlstm", "mlstm_bwd")}
    run, launches, rows = _train_run(cfg, seed, dev, out, 2, 512, 3,
                                     "profile_train_xlstm_bf16.txt", kernels)
    assert run["launches"] == {"mlstm": 2 * 42 * 3, "mlstm_bwd": 42 * 3}, run["launches"]
    run["traced_step"]["backward_by_kernel"] = _bwd_kernel_ms(rows, MLSTM_BWD_KERNELS)
    return {"phase": "train_xlstm_bf16", "config": XLSTM, "reduced": XLSTM_TRAIN_CUT,
            **run}, launches


SHARDED_F32 = dict(n_layers=2, B=2, S=256)


def _nccl_group(tmp):
    """A one-rank NCCL process group on this card, met through a file store
    in ``tmp`` (no network)."""
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))


def _sharded_f32_check(seed, dev, mesh):
    """One ``make_sharded_train_step`` step on a (data=1, model=1) mesh
    against one ``make_train_step`` step, both on the card, float32 with
    TF32 off, llama at full width cut to 2 layers, from the same weights
    and batch: the loss and every leaf of params, mu and nu within 2e-5 of
    the leaf's largest entry; whether every bit is equal."""
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    n, B, S = SHARDED_F32["n_layers"], SHARDED_F32["B"], SHARDED_F32["S"]
    cfg = _family(NAME, n_layers=n, dtype="float32")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    batch = _train_batch(cfg, 7, B, S, dev)
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    p1, s1, m1 = make_train_step(cfg, LM(cfg, dev), adamw)(params, opt.init_state(params),
                                                           batch)
    want = [m1["loss"]] + _leaves(p1) + _leaves(s1["mu"]) + _leaves(s1["nu"])
    del p1, s1
    step, p, st, (b,) = _sharded_setup(cfg, LM(cfg, dev), adamw, mesh, params, [batch])
    p2, s2, m2 = step(p, st, b)
    got = [m2["loss"]] + [t.to_local() for t in _leaves(p2) + _leaves(s2["mu"])
                          + _leaves(s2["nu"])]
    torch.cuda.synchronize()
    worst, same = 0.0, True
    for a, w in zip(got, want):
        err = (a - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        assert err <= 2e-5, (err, tuple(w.shape))
        worst = max(worst, err)
        same &= bool(torch.equal(a, w))
    return {"config": NAME, "layers": n, "batch": B, "seq": S, "leaves": len(want) - 1,
            "loss": m2["loss"].item(), "loss_unsharded": m1["loss"].item(),
            "max_err_of_leaf_max": worst, "bit_identical": same,
            "tol": "2e-5 of each leaf's largest entry (loss, params, mu, nu)"}


def _dryrun_on_this_host():
    """``python -m repro_torch.launch.dryrun`` of the 16 x 16 decode_32k
    cell of llama in a subprocess (a fake process group of 256 ranks, meta
    tensors; this host has no JAX): its status and per-device counts."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", NAME,
                            "--shape", "decode_32k", "--out", tmp, "--force"],
                           capture_output=True, text=True, timeout=300, cwd=ROOT,
                           env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        secs = time.monotonic() - t0
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[0])
    assert rec["status"] == "ok" and rec["n_devices"] == 256, rec
    return {"cell": f"{NAME} decode_32k pod16x16", "status": rec["status"],
            "n_devices": rec["n_devices"], "seconds": secs,
            "flops_per_dev": rec["flops_per_dev"], "bytes_per_dev": rec["bytes_per_dev"],
            "coll_eff_bytes_per_dev": rec["coll_eff_bytes_per_dev"],
            "roofline": rec["roofline"]}


def train_sharded_bf16(seed, dev, out):
    """The sharded train step (``distributed/sharded_step.py``: params and
    AdamW state as DTensors, each layer's weights gathered before use, the
    batch split over the DP ranks) on a one-rank NCCL group over a (data=1,
    model=1) mesh: ``_sharded_f32_check``, then ``train_bf16``'s run (llama
    cut to 4 layers, B=2 S=2048, f32 weights and AdamW state, remat) with
    3 timed steps and one traced, its flash launches a step asserted equal
    to ``train_bf16``'s (8 forward with remat, 4 backward); then the
    dry-run of one 16 x 16 cell on this host.  A failed NCCL start, gather
    or launch fails the phase; the unsharded step never stands in.
    Returns (line, the wrappers' launches over the timed steps)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        _nccl_group(tmp)
        backend = dist.get_backend()
        try:
            assert dist.get_world_size() == 1
            mesh = make_host_mesh(1)
            f32 = _sharded_f32_check(seed, dev, mesh)
            _free()
            kernels = {k: TRAIN_KERNELS[k] for k in ("flash_attention", "flash_attention_bwd")}
            n_timed = 3
            run, launches, rows = _train_run(_family(NAME, n_layers=4), seed, dev, out, 2,
                                             2048, n_timed, "profile_train_sharded_bf16.txt",
                                             kernels, mesh=mesh)
        finally:
            dist.destroy_process_group()
    want = {"flash_attention": 2 * 4 * n_timed, "flash_attention_bwd": 4 * n_timed}
    assert run["launches"] == want, (run["launches"], want)
    run["traced_step"]["backward_by_kernel"] = _bwd_kernel_ms(rows)
    dry = _dryrun_on_this_host()
    return {"phase": "train_sharded_bf16", "config": NAME, "reduced": TRAIN_CUT,
            "mesh": mesh.shape, "backend": backend, "f32_check": f32, **run,
            "launches_per_step": {k: v // n_timed for k, v in run["launches"].items()},
            "dryrun": dry, "nvidia_smi": smi_line(), "seconds": time.monotonic() - t0}, launches


# tp_emulated_bf16: one full-width layer of each, at the production mesh's
# model extent, its ranks emulated on this card
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd")
TP_EXTENT = 16


class TpEntry(NamedTuple):
    """A layer of ``tp_emulated_bf16``: its config, its TP_LAYOUTS, TP_SCAN
    or TP_MLSTM entry (the sLSTM's: none), its mixer's kernels, its pattern
    position, the model extent its ranks are emulated at, and its tokens."""
    config: str
    layout: str
    kernels: tuple
    position: int = 0
    extent: int = TP_EXTENT
    seq: int = TP_S


# xlstm's sLSTM (pattern position 7) at 16, where its FFN (2730 columns) is
# whole on every rank, and at 2, where the FFN splits (1365 a rank); S cut
# to 128: the sLSTM is a host loop of S steps, each a gather of h among the
# emulated ranks, and at S=512 the two entries took 293 s of this script's
# 1200 (on an H100 host; 16 emulated ranks ~30 s a forward and backward)
TP_SLSTM_S = 128
TP_CONFIGS = {NAME: TpEntry(NAME, "llama", FLASH_KERNELS),
              "granite-20b": TpEntry("granite-20b", "granite", FLASH_KERNELS),
              "gemma2-9b": TpEntry("gemma2-9b", "gemma2", FLASH_KERNELS),
              "moonshot-v1-16b-a3b": TpEntry("moonshot-v1-16b-a3b", "moonshot", FLASH_KERNELS),
              "jamba-v0.1-52b": TpEntry("jamba-v0.1-52b", "jamba",
                                        ("mamba_scan", "mamba_scan_bwd")),
              "xlstm-1.3b": TpEntry("xlstm-1.3b", "xlstm", ("mlstm", "mlstm_bwd")),
              "xlstm-1.3b slstm x16": TpEntry("xlstm-1.3b", "xlstm_slstm", (), 7, 16,
                                              TP_SLSTM_S),
              "xlstm-1.3b slstm x2": TpEntry("xlstm-1.3b", "xlstm_slstm", (), 7, 2,
                                             TP_SLSTM_S)}
# the bf16 gate of xlstm's split mLSTM sublayer, against the float32 and
# the unsharded bf16 sublayers (every other sublayer: 2e-2).  The unsharded
# bf16 mLSTM is itself 3.387e-2 from the float32 one (x's gradient); the
# split's worst readings on an H100 (seed 0) are 3.914e-2 (x's gradient,
# vs float32) and 1.480e-2 (w_q's, vs the unsharded bf16)
TP_MLSTM_BF16_GATE = 4e-2


def _tp_parts(cfg):
    """The sublayers of pattern position 0 (the phase cuts a recurrent
    config's pattern to the position it runs: xlstm's 0 or 7): its mixer,
    then its FFN unless it has none (xlstm's layers)."""
    return ("mixer",) if cfg.pattern[0].ffn == "none" else ("mixer", "ffn")


def _tp_sublayer(cfg, part, q, h, extent=None):
    """One sublayer of pattern position 0 (the phase cuts a recurrent
    config's pattern to the position it runs) on its normed input ``h``:
    ``part`` "mixer" (the attention, the Mamba mixer, the mLSTM or the
    sLSTM with its FFN) or "ffn" (the dense or MoE FFN), of ``q`` (the
    layer's ``q[part]``),
    whole, or with ``extent`` model ranks emulated
    (``tensor_parallel.emulate``): each rank on its shards
    (``shard_params``), one at a time (the recurrent mixers' ranks meeting
    at their collectives), their partial sums and their input's gradients
    summed in float32 as the collectives sum them."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import lm, moe
    spec = cfg.pattern[0]

    def run(q, h):
        if part == "mixer" and spec.mixer == "attn":
            return lm._self_attention(cfg, spec, q, h,
                                      torch.arange(h.shape[1], device=h.device))[0]
        if part == "mixer":
            return lm._RECURRENT[spec.mixer].forward(cfg, q, h)
        return lm.ffn_forward(cfg, q, h) if spec.ffn == "dense" else moe.moe_ffn(cfg, q, h)
    if extent is None:
        return run(q, h)
    return tp.emulate(lambda r, h: run(tp.shard_params(cfg, q, r, extent), h), extent, h)


def _tp_layer(cfg, p, x, extent=None):
    """Pattern position 0's layer (its mixer, then a dense or MoE FFN or
    none): ``layer_forward_full`` whole, or each sublayer's ranks emulated
    (``_tp_sublayer``), the norms and residuals as the layer has them."""
    from repro_torch.models import common, lm
    if extent is None:
        return lm.layer_forward_full(cfg, cfg.pattern[0], p, x,
                                     torch.arange(x.shape[1], device=x.device))
    a = _tp_sublayer(cfg, "mixer", p["mixer"], common.apply_norm(cfg, p["norm1"], x), extent)
    if cfg.double_norm:
        a = common.apply_norm(cfg, p["norm1b"], a)
    x = x + a
    if "ffn" not in _tp_parts(cfg):
        return x
    f = _tp_sublayer(cfg, "ffn", p["ffn"], common.apply_norm(cfg, p["norm2"], x), extent)
    if cfg.double_norm:
        f = common.apply_norm(cfg, p["norm2b"], f)
    return x + f


def _fresh(tree, contiguous=False):
    """New leaves that need a gradient, copies (or contiguous copies) of
    ``tree``'s."""
    from repro_torch.distributed.sharding import tree_map_with_path
    return tree_map_with_path(lambda _, t: (t.detach().contiguous() if contiguous
                                            else t.detach().clone()).requires_grad_(True),
                              tree)


def _tp_grads(cfg, p, x, dy, extent):
    """(output, the gradients of every leaf of ``p`` and of ``x``) of
    ``_tp_layer`` on fresh copies of them, against ``dy``."""
    pc = _fresh(p)
    leaves = _leaves(pc)
    xc = x.detach().clone().requires_grad_(True)
    out = _tp_layer(cfg, pc, xc, extent)
    (out.float() * dy).sum().backward()
    return out.detach(), [t.grad for t in leaves] + [xc.grad]


def _tp_sublayer_grads(cfg, part, p, inp, dy, extent):
    """(output, the gradients of every leaf of ``p[part]`` and of ``inp``)
    of one sublayer of pattern position 0 on fresh copies of them, against
    ``dy``: ``_tp_sublayer`` on ``inp``, its normed input, whole or with
    ``extent`` model ranks emulated."""
    pc = _fresh(p[part])
    xc = inp.detach().clone().requires_grad_(True)
    out = _tp_sublayer(cfg, part, pc, xc, extent)
    (out.float() * dy).sum().backward()
    return out.detach(), [t.grad for t in _leaves(pc)] + [xc.grad]


def _tp_rank_ms(cfg, p, x, dy, r, extent=TP_EXTENT, iters=5, warmup=2, tries=3):
    """Device ms of the layer's sublayers forward and backward: rank
    ``r``'s of ``extent`` alone (its shards contiguous, as a rank holds
    them), the whole layer's (``r`` None), or every rank's emulated
    together (``r`` "all": a recurrent mixer's rank meets the others inside
    its sublayer, so it runs only beside them)."""
    from repro_torch.distributed import constraints
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import common
    emulated = extent if r == "all" else None
    p = _fresh(p if r in (None, "all") else tp.shard_params(cfg, p, r, extent),
               contiguous=True)
    parts = _tp_parts(cfg)
    hs = [common.apply_norm(cfg, p[n], x).detach().requires_grad_(True)
          for n in ("norm1", "norm2")[:len(parts)]]

    def step():
        outs = [_tp_sublayer(cfg, part, p[part], h, emulated) for part, h in zip(parts, hs)]
        torch.autograd.backward(outs, [dy.to(o.dtype) for o in outs])
    if r in (None, "all"):
        return time_ms(step, iters=iters, warmup=warmup, tries=tries)
    with constraints.model_shards(None, r, extent):
        return time_ms(step, iters=iters, warmup=warmup, tries=tries)


def _leaf_names(tree, prefix=""):
    """The names of ``_leaves(tree)``, in its order ("ffn/w_up", ...)."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}{k}/")]
    if isinstance(tree, tuple):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _max_errs(got, want):
    """Each tensor's largest error over its largest entry."""
    return [(a.float() - w.float()).abs().max().item() / max(w.float().abs().max().item(), 1e-30)
            for a, w in zip(got, want)]


def _tp_share(cfg, extent=TP_EXTENT):
    """What one of ``extent`` model ranks computes of pattern position 0's
    mixer."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.models import mamba, xlstm
    mixer = cfg.pattern[0].mixer
    if mixer == "mamba":
        H = mamba.dims(cfg)[1]
        return {"mamba_heads": [H // extent, H], "split": tp.mixer_splits(cfg, mixer, extent)}
    if mixer == "mlstm":
        dh = xlstm.mlstm_dims(cfg)[2]
        return {"mlstm_value_columns": [dh // extent, dh],
                "split": tp.mixer_splits(cfg, mixer, extent)}
    if mixer == "slstm":
        d, _, dh = xlstm.slstm_dims(cfg)
        ff = int(cfg.xlstm.proj_factor_slstm * d)
        return {"slstm_columns": [dh // extent, dh],
                "ffn_columns": [ff // extent if tp.splits(ff, extent) else ff, ff],
                "split": tp.mixer_splits(cfg, mixer, extent)}
    lay = tp.head_layout(cfg, 0, extent)
    return {"rank_heads": [lay.nq, lay.nkv], "kv_split": lay.kv_split}


def tp_emulated_bf16(seed, dev, out):
    """Tensor-parallel compute over 'model' at the production mesh's extent
    16, on one card: for each ``TP_CONFIGS`` entry one full-width layer
    (pattern position 0: attention on 16 ranks' local heads through both
    flash kernels, then its dense FFN on 16 ranks' columns and rows of
    ``d_ff``, or moonshot's 64 experts, 4 a rank; jamba's Mamba mixer on 4
    of its 64 heads a rank through the scan and its backward, then its
    dense FFN; xlstm's mLSTM on 64 of each head's 1024 value columns a
    rank, q and k whole, through the mLSTM and its backward; xlstm's sLSTM,
    position 7, on 32 of each head's 512 columns a rank with its FFN whole
    on every rank, and at extent 2 on 256 columns with its FFN's 2730
    columns split, S=128), B=1 S=2048,
    the ranks' local sublayers run one at a time (a recurrent mixer's
    ranks meet at its collectives inside the sublayer), their outputs and
    their inputs' gradients summed in float32 as the collectives sum them
    (``_tp_layer``).  The output and every gradient (the ranks' shards'
    gradients land in their whole leaves: concatenated, or summed where a
    rank reads a part of a whole leaf; and the input's) are held, each
    tensor's largest error against its largest entry, to the unsharded
    layer on the same weights and the same bf16-rounded input: in float32
    (TF32 off) the whole layer within 2e-5 of the float32 layer (the
    mLSTM's within 2e-4, its gradients' gate: its h's denominator cancels);
    with bf16 compute each sublayer (the mixer, the FFN, each on the input
    the unsharded bf16 layer gives it) within the bf16 gate, 2e-2, of the
    float32 sublayer (as a bf16 kernel is held to its float32 plain
    version) and of the bf16 sublayer; xlstm's mLSTM within
    ``TP_MLSTM_BF16_GATE``, 4e-2 (the unsharded bf16 mLSTM is itself 3.4%
    from the float32 one in x's gradient).  Then each rank's device ms of its
    sublayers forward and backward beside the whole layer's (a recurrent
    mixer's ranks: all of them together, and their mean).  Returns (line,
    the wrappers' launches over the phase)."""
    from repro_torch.models import common, lm
    from repro_torch.params import init_params
    t0 = time.monotonic()
    _reset_launches()
    cfgs, launches_by_layout = {}, {}
    for name, (config, layout, kernel_names, position, extent, seq) in TP_CONFIGS.items():
        before = _launches()
        pattern = _family(config).pattern
        recurrent = pattern[position].mixer != "attn"
        # a recurrent config's pattern cut to the position it runs (jamba's
        # other seven hold four MoE layers of 2.8e9 weights each)
        cfg16 = _family(config, n_layers=1, pattern=pattern[position:position + 1],
                        dtype="bfloat16") if recurrent \
            else _family(config, n_layers=len(pattern), dtype="bfloat16")
        cfg32 = dataclasses.replace(cfg16, dtype="float32")
        params = init_params(cfg16, torch.Generator(device=dev).manual_seed(seed), dev)
        p = _fresh(lm._layer_slice(params["blocks"][0], 0))
        del params
        _free()
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        x = torch.randn(TP_B, seq, cfg16.d_model, generator=g, device=dev).to(torch.bfloat16)
        dy = torch.randn(TP_B, seq, cfg16.d_model, generator=g, device=dev)
        gate32 = MLSTM_BWD_TOL[torch.float32] if cfg16.pattern[0].mixer == "mlstm" \
            else FLASH_BWD_TOL[torch.float32]
        want32 = _tp_grads(cfg32, p, x.float(), dy, None)
        got32 = _tp_grads(cfg32, p, x.float(), dy, extent)
        torch.cuda.synchronize()
        errs32 = _max_errs([got32[0], *got32[1]], [want32[0], *want32[1]])
        assert max(errs32) <= gate32, (name, "float32", errs32)
        del got32
        _free()
        # bf16, sublayer by sublayer on the inputs the whole bf16 layer
        # gives them: a layer-level bf16 comparison would see MoE routing
        # flip on the ulps by which the attention's sum differs
        with torch.no_grad():
            inputs = {"mixer": common.apply_norm(cfg16, p["norm1"], x)}
            if "ffn" in _tp_parts(cfg16):
                a = _tp_sublayer(cfg16, "mixer", p["mixer"], inputs["mixer"])
                if cfg16.double_norm:
                    a = common.apply_norm(cfg16, p["norm1b"], a)
                inputs["ffn"] = common.apply_norm(cfg16, p["norm2"], x + a)
        tol = FLASH_BWD_TOL[torch.bfloat16]
        row = {"leaves": len(want32[1]) - 1,
               "float32": {"out": errs32[0], "grads": max(errs32[1:]), "gate": gate32,
                           "held": "the whole layer against the whole float32 layer",
                           "by_tensor": dict(zip(["out", *_leaf_names(p), "x"], errs32))},
               "errs": "each tensor's largest error over its largest entry"}
        del want32
        _free()
        for part, inp in inputs.items():
            want = _tp_sublayer_grads(cfg32, part, p, inp.float(), dy, None)
            whole = _tp_sublayer_grads(cfg16, part, p, inp, dy, None)
            got = _tp_sublayer_grads(cfg16, part, p, inp, dy, extent)
            torch.cuda.synchronize()
            e32 = _max_errs([got[0], *got[1]], [want[0], *want[1]])
            e16 = _max_errs([got[0], *got[1]], [whole[0], *whole[1]])
            w16 = _max_errs([whole[0], *whole[1]], [want[0], *want[1]])
            gate16 = TP_MLSTM_BF16_GATE if part == "mixer" and \
                cfg16.pattern[0].mixer == "mlstm" else tol
            row[f"bfloat16_{part}"] = {"out": e32[0], "grads": max(e32[1:]),
                                       "out_vs_bf16_unsharded": e16[0],
                                       "grads_vs_bf16_unsharded": max(e16[1:]),
                                       "bf16_unsharded_out": w16[0],
                                       "bf16_unsharded_grads": max(w16[1:]),
                                       "gate": gate16,
                                       "by_tensor": {"names": ["out", *_leaf_names(p[part]), "x"],
                                                     "vs_f32": e32, "vs_bf16_unsharded": e16,
                                                     "bf16_unsharded_vs_f32": w16}}
            del want, whole, got
            _free()
        print(f"chip_smoke: tp_emulated_bf16 {name}: {json.dumps(row)}", file=sys.stderr,
              flush=True)
        for part in inputs:
            r = row[f"bfloat16_{part}"]
            assert max(r["by_tensor"]["vs_f32"]) <= r["gate"] and \
                max(r["by_tensor"]["vs_bf16_unsharded"]) <= r["gate"], (name, part, r)
        # the sLSTM launches ~60 kernels a step and rank, forward and
        # backward: one traced call (its shapes ran above), two sessions at
        # most (at S=2048 a session of 16 ranks' events lost its lead
        # markers each time, and three sessions a call took minutes)
        iters = (1, 0, 2) if cfg16.pattern[0].mixer == "slstm" else (5, 2, 3)
        whole_ms = _tp_rank_ms(cfg16, p, x, dy, None, extent, *iters)
        if recurrent:
            all_ms = _tp_rank_ms(cfg16, p, x, dy, "all", extent, *iters)
            row["device_ms"] = {"whole_layer": whole_ms, "all_ranks_emulated": all_ms,
                                "rank_mean": all_ms / extent,
                                "note": "bf16 sublayers forward and backward; a recurrent "
                                        "mixer's rank runs only beside the others, so the "
                                        "ranks are timed together"}
        else:
            rank_ms = [_tp_rank_ms(cfg16, p, x, dy, r, extent) for r in range(extent)]
            row["device_ms"] = {"whole_layer": whole_ms, "ranks": rank_ms,
                                "sum_of_ranks": sum(rank_ms),
                                "note": "bf16 attention and FFN forward and backward"}
        del p, x, dy
        _free()
        after = _launches()
        if kernel_names:
            launches_by_layout[layout] = {k: after[k] - before[k] for k in kernel_names}
        cfgs[name] = {"layout": layout, "position": position, "extent": extent, "seq": seq,
                      **_tp_share(cfg16, extent), **row}
    launches = _launches()
    for layout, n in launches_by_layout.items():
        # each dtype: the whole layer once and its 16 ranks' shares
        assert all(v >= 2 * (1 + TP_EXTENT) for v in n.values()), (layout, n)
    assert set(launches_by_layout["xlstm"]) == {"mlstm", "mlstm_bwd"}, launches_by_layout
    return {"phase": "tp_emulated_bf16", "extent": TP_EXTENT, "batch": TP_B, "seq": TP_S,
            "reduced": ["n_layers -> 1 (pattern position 0 of each config; gemma2's "
                        "pattern of 2 built, its first layer run; jamba's and xlstm's "
                        "patterns cut to their first position, xlstm's to position 7 "
                        "for its sLSTM entries)",
                        f"seq {TP_S} -> {TP_SLSTM_S} for the sLSTM entries (a host loop "
                        "of S steps, each a gather of h among the emulated ranks: at 512 "
                        "the two entries took 293 s of this script's 1200)"],
            "configs": cfgs, "launches_by_layout": launches_by_layout,
            "nvidia_smi": smi_line(), "seconds": time.monotonic() - t0}, launches


# --------------------------------------------------------------------------
# the examples' twins (examples/torch_*.py) through their own main()
# --------------------------------------------------------------------------
EXAMPLE_KERNELS = ("paged_decode_attention", "paged_flash_attention", "flash_attention",
                   "flash_attention_bwd", "decode_attention", "chunk_hash")
TRAIN_EXAMPLE_STEPS = 10       # losses of a training card run held to a CPU run
EXAMPLE_LOSS_TOL = dict(atol=0, rtol=1e-5)
DISHONEST_REP_ATOL = 1e-5      # the reputations, card vs CPU on the card's weights


def _example(name):
    """``examples/<name>.py`` (a twin: it imports ``repro_torch`` only)."""
    import importlib
    where = str(ROOT / "examples")
    if where not in sys.path:
        sys.path.insert(0, where)
    return importlib.import_module(name)


def _run_example(fn, seed, dev):
    """``fn()`` with ``os.urandom`` and the global ``random`` restarted
    from ``seed`` (the overlay's path ids and the nodes' first sync
    delays).  Returns (its printed lines, what it returned, wall seconds
    to the end of its device work)."""
    import contextlib
    import io
    import random
    real = os.urandom
    os.urandom = random.Random(seed).randbytes
    random.seed(seed)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            t0 = time.monotonic()
            got = fn()
            _sync(dev)
            wall = time.monotonic() - t0
    finally:
        os.urandom = real
    return buf.getvalue().splitlines(), got, wall


def examples(seed, dev, out):
    """Each twin of ``examples/`` through its own ``main([... "--device",
    "cuda"])``, at the sizes the reference examples define: quickstart (a
    ``RealEngine`` on the reduced llama: the paged flash entry and the
    paged decode; the overlay's HR-trees: the chunk hash), serve_overlay at
    its 150 requests (the chunk hash), train_100m's 200 steps (the flash
    kernel's forward with its lse and its backward) and
    dishonest_detection (the GT model's training, its greedy responses on
    the flash kernel's dense entry and the dense decode, the verifier's
    ``LM.apply``).  The counts are zeroed before the card runs and read
    after them.  Then the CPU runs they are held to, float32 with TF32 off:
    quickstart's tokens, cached tokens, responses, served counts, cache
    hits and hit rates equal; serve_overlay's report lines equal (the
    chunk hash is exact, the simulation seeded); train_100m's and the GT
    model's first ``TRAIN_EXAMPLE_STEPS`` losses within
    ``EXAMPLE_LOSS_TOL`` of a CPU run of that many steps from the same
    weights; dishonest_detection's committee epochs run again on the CPU
    over the card's trained and degraded weights: every greedy response
    equal and every reputation within ``DISHONEST_REP_ATOL``.  The card's
    dishonest_detection also passes its own asserts (the cheater
    untrusted, the honest node trusted)."""
    from repro_torch.models.lm import LM
    from repro_torch.training.optimizer import tree_map
    import tempfile
    t_phase = time.monotonic()
    cuda, cpu = ["--device", dev.type], ["--device", "cpu"]
    ckpt = Path(tempfile.mkdtemp(prefix="examples_ckpt_"))
    runs = {
        "quickstart": lambda d: _example("torch_quickstart").main(d),
        "serve_overlay": lambda d: _example("torch_serve_overlay").main(d),
        "train_100m": lambda d, steps=None: _example("torch_train_100m").main(
            [*(["--steps", str(steps)] if steps else []),
             "--ckpt-dir", str(ckpt / ("cpu" if steps else "card")), *d]),
        "dishonest_detection": lambda d: _example("torch_dishonest_detection").main(d),
    }
    card, wall, launches, by_example = {}, {}, collections.Counter(), {}
    try:
        _reset_launches()
        for name, run in runs.items():
            before = _launches()
            card[name] = _run_example(lambda run=run: run(cuda), seed, dev)
            wall[name] = card[name][2]
            after = _launches()
            by_example[name] = {k: after[k] - before[k] for k in EXAMPLE_KERNELS
                                if after[k] > before[k]}
        launches.update(_launches())
        cpu_dev = torch.device("cpu")
        host = {name: _run_example(lambda run=runs[name]: run(cpu), seed, cpu_dev)
                for name in ("quickstart", "serve_overlay")}
        host["train_100m"] = _run_example(
            lambda: runs["train_100m"](cpu, steps=TRAIN_EXAMPLE_STEPS), seed, cpu_dev)
        gt = _example("torch_gt_model")
        host["gt_model"] = _run_example(
            lambda: gt.trained_gt(steps=TRAIN_EXAMPLE_STEPS, device=cpu_dev), seed, cpu_dev)
        dd = card["dishonest_detection"][1]
        cfg = gt.gt_config()
        host["dishonest_detection"] = _run_example(
            lambda: _example("torch_dishonest_detection").detect(
                cfg, LM(cfg, device=cpu_dev), tree_map(torch.Tensor.cpu, dd["params"]),
                tree_map(torch.Tensor.cpu, dd["bad_params"]), dd["corpus"]), seed, cpu_dev)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    _write(out, "examples.txt", "\n".join(
        f"== {name} ({side})\n" + "\n".join(runs_[name][0])
        for side, runs_ in (("card", card), ("cpu", host)) for name in runs_) + "\n")
    assert card["quickstart"][1] == host["quickstart"][1], \
        (card["quickstart"][1], host["quickstart"][1])
    assert card["quickstart"][0] == host["quickstart"][0]
    assert card["serve_overlay"][0] == host["serve_overlay"][0], \
        (card["serve_overlay"][0], host["serve_overlay"][0])
    got = card["train_100m"][1]["losses"][:TRAIN_EXAMPLE_STEPS]
    want = host["train_100m"][1]["losses"]
    np.testing.assert_allclose(got, want, **EXAMPLE_LOSS_TOL)
    assert card["train_100m"][0][0] == host["train_100m"][0][0]     # the param count
    dishonest, dd_cpu = card["dishonest_detection"][1], host["dishonest_detection"][1]
    assert dishonest["untrusted"] == ["cheating-node"], dishonest["untrusted"]
    gt_got = dishonest["losses"][:TRAIN_EXAMPLE_STEPS]
    gt_want = host["gt_model"][1][4]
    np.testing.assert_allclose(gt_got, gt_want, **EXAMPLE_LOSS_TOL)
    mismatched = [(c, h) for c, h in zip(dishonest["responses"], dd_cpu["responses"]) if c != h]
    assert len(dishonest["responses"]) == len(dd_cpu["responses"]) and not mismatched, \
        mismatched[:2]
    assert [sorted(r) for r in dishonest["reputations"]] == \
        [sorted(r) for r in dd_cpu["reputations"]]
    rep_err = max(abs(c[n] - h[n]) for c, h in zip(dishonest["reputations"],
                                                     dd_cpu["reputations"]) for n in c)
    assert rep_err <= DISHONEST_REP_ATOL, rep_err
    missed = [k for k in ("flash_attention", "flash_attention_bwd", "decode_attention")
              if k not in by_example["dishonest_detection"]]
    assert not missed, f"dishonest_detection launched no {missed}"
    missing = [k for k in EXAMPLE_KERNELS if not launches[k]]
    assert not missing, f"the examples launched no {missing}"
    train = card["train_100m"][1]
    return {"phase": "examples", "nvidia_smi": smi_line(),
            "seconds": time.monotonic() - t_phase,
            "wall_s": wall, "cpu_wall_s": {k: v[2] for k, v in host.items()},
            "quickstart": {k: card["quickstart"][1][k] for k in (
                "cached_tokens", "responses", "served", "cache_hits", "token_hit_rates")},
            "serve_overlay": card["serve_overlay"][0],
            "train_100m": {"n_params_printed": train["n_params"], "steps": len(train["losses"]),
                           "first_loss": train["first_loss"], "final_loss": train["final_loss"],
                           "tokens_per_s": train["tokens_per_s"],
                           "card_vs_cpu_max_abs_err": float(np.max(np.abs(
                               np.subtract(got, want))))},
            "dishonest_detection": {"reputations": dishonest["reputations"],
                                    "untrusted": dishonest["untrusted"],
                                    "responses": len(dishonest["responses"]),
                                    "gt_loss_card_vs_cpu_max_abs_err": float(np.max(np.abs(
                                        np.subtract(gt_got, gt_want)))),
                                    "reputation_card_vs_cpu_max_abs_err": rep_err},
            "tol": {"quickstart": "equal (tokens, cached tokens, responses, served, hits, "
                                  "hit rates)",
                    "serve_overlay": "report lines equal",
                    "train_100m": f"first {TRAIN_EXAMPLE_STEPS} losses rtol=1e-5 vs CPU",
                    "dishonest_detection": f"GT's first {TRAIN_EXAMPLE_STEPS} losses rtol=1e-5 "
                                           "vs CPU; on the card's weights, responses equal "
                                           f"and reputations atol={DISHONEST_REP_ATOL} vs CPU"},
            "launches_by_example": by_example,
            "launches": {k: launches[k] for k in EXAMPLE_KERNELS}}, launches


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
                                            "mlstm_bwd", "mamba_scan", "mamba_scan_bwd")},
          "spills": _spills(reports)})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = [check_paged_decode(gen, dev), check_paged_flash(gen, dev),
               check_dense_flash(gen, dev), check_flash_bwd(gen, dev),
               check_dense_decode(gen, dev), check_mamba_scan(gen, dev),
               check_mamba_scan_bwd(gen, dev), check_mlstm(gen, dev), check_mlstm_bwd(gen, dev),
               check_chunk_hash(args.seed, dev)]
    emit({"phase": "kernels", "tol": {"float32": "atol=rtol=2e-5; mlstm's h 2e-4 "
                                                 "(its denominator cancels)",
                                      "bfloat16": "atol=rtol=2e-2 vs f32 plain on bf16 inputs",
                                      "backward kernels": "each gradient's max error within "
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
    # lse), the scan and the mLSTM, and their backward kernels, under
    # autograd and AdamW
    emit(train_f32_parity(args.seed, dev))
    _free()
    train_launches = collections.Counter()
    for phase in (train_bf16, train_jamba_bf16, train_xlstm_bf16):
        line, launches = phase(args.seed, dev, args.out)
        emit(line)
        train_launches.update(launches)
        del line
        _free()
    # the sharded train step (DTensor state, gathers, NCCL) over one rank,
    # and the dry-run of a 16 x 16 cell on this host
    line, sharded_launches = train_sharded_bf16(args.seed, dev, args.out)
    emit(line)
    _free()
    # tensor-parallel compute over 'model': 16 ranks' local heads, d_ff,
    # experts, Mamba heads and mLSTM value columns of a full-width layer,
    # emulated on this card
    tp_line, tp_launches = tp_emulated_bf16(args.seed, dev, args.out)
    emit(tp_line)
    _free()
    # the examples' twins through their own main(): the paged kernels and
    # the chunk hash (quickstart, serve_overlay), the flash kernel's
    # forward and backward (train_100m, the GT model's training), its dense
    # entry and the dense decode (dishonest_detection's responses and
    # verifier)
    line, example_launches = examples(args.seed, dev, args.out)
    emit(line)
    _free()

    # each kernel's launches on every path that runs it
    paths = {"paged_decode_attention": {"llama": paged_launches, "families": family_launches,
                                        "examples": example_launches},
             "paged_flash_attention": {"llama": paged_launches, "families": family_launches,
                                       "examples": example_launches},
             "flash_attention": {"jamba": dense_launches,
                                 "verification": verification_launches,
                                 "encdec": encdec_launches, "training": train_launches,
                                 "sharded": sharded_launches, "tp_emulated": tp_launches,
                                 "examples": example_launches},
             "flash_attention_bwd": {"training": train_launches, "sharded": sharded_launches,
                                     "tp_emulated": tp_launches, "examples": example_launches},
             "decode_attention": {"jamba": dense_launches, "encdec": encdec_launches,
                                  "examples": example_launches},
             "mamba_scan": {"jamba": dense_launches, "training": train_launches,
                            "tp_emulated": tp_launches},
             "mamba_scan_bwd": {"training": train_launches, "tp_emulated": tp_launches},
             "mlstm": {"xlstm": xlstm_launches, "training": train_launches,
                       "tp_emulated": tp_launches},
             "mlstm_bwd": {"training": train_launches, "tp_emulated": tp_launches},
             "chunk_hash": {"overlay": overlay_launches, "examples": example_launches}}
    for k in kernels:
        k.pop("errs")
        k.pop("library", None)
        k.pop("tol", None)
        k["launches_by_path"] = {p: n[k["name"]] for p, n in paths[k["name"]].items()}
        k["launches"] = sum(k["launches_by_path"].values())
        for layout, case in k.get("tp_layouts", {}).items():
            # a share no config of tp_emulated_bf16 runs (xlstm_at_4) counts 0
            case["launches_tp_emulated"] = \
                tp_line["launches_by_layout"].get(layout, {}).get(k["name"], 0)
    # a time_ms that fell back to CUDA events timed the host's gaps too
    # traced sessions that lost a marker, and those of them that may have
    # lost traced work (no lead marker or no end marker kept)
    emit({"phase": "timing", "timed_by_events": len(PROFILER_MISSES),
          "traces_short_of_a_marker": len(TRACE_LOSSES),
          "traces_not_whole": sum(not _whole(*x) for x in TRACE_LOSSES),
          "lead_markers_lost": sorted(TRACE_LEAD - lead for lead, _ in TRACE_LOSSES)})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
