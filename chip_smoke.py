"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``,
holds each against its plain PyTorch version at the serving path's shapes,
serves ``gentorrent-llama3-8b`` through the port's scheduler (full width:
two layers in float32 for token parity, all 32 layers in bf16 for the
serving numbers) and prints one JSON line per phase.  Every phase must
pass: any failure ends the run with a nonzero exit.  With no CUDA card it
exits nonzero before printing any result.  ``--out DIR`` also writes the
long outputs (compiler report, profile table, tokens) there.  Weights are
random, made from ``--seed``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
NAME = "gentorrent-llama3-8b"
BLK = 32


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
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


def bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
            torch.testing.assert_close(got.float()[live], want[live], **TOL[dtype])
            assert not got[~live].any(), "dead row must be zeros"
            errs[f"{str(dtype)[6:]}/w{window}/cap{softcap}"] = \
                (got.float()[live] - want[live]).abs().max().item()
    # timing at the serving dtype, no window or softcap (the model's case)
    x = [t.to(torch.bfloat16) for t in (q, ka, va)]
    ms = time_ms(lambda: ops.paged_decode_attention(*x, pt, lengths))
    plain_ms = time_ms(lambda: ref.paged_decode_attention_ref(*x, pt, lengths), iters=10)
    nbytes = _paged_decode_bytes(lengths, H, ka.shape[2], D, 2)
    visible = int(lengths.sum())
    bound_ms, bound_by = bound(nbytes, 4 * visible * H * D, torch.bfloat16)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/paged_decode/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/decode_attention/paged.py:94",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "shape": "B=4 H=32 Hkv=8 D=128 BLOCK=32 n_pg=32 lengths=[1000,517,0,33] bf16",
            "errs": errs}


def _flash_case(gen, dev, C):
    B, H, D = 4, 32, 128
    ka, va, pt = _paged_inputs(gen, dev)
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
                torch.testing.assert_close(got.float()[valid], want[valid], **TOL[dtype])
                assert not got[~active].any(), "dead row must be zeros"
                errs[f"C{C}/{str(dtype)[6:]}/w{window}/cap{softcap}"] = \
                    (got.float()[valid] - want[valid]).abs().max().item()
    # timing: the prefill chunk in bf16, the model's case
    q, ka, va, pt, pos0, n_tok = _flash_case(gen, dev, 32)
    active = n_tok > 0
    x = [t.to(torch.bfloat16) for t in (q, ka, va)]
    ms = time_ms(lambda: ops.paged_flash_attention(*x, pt, pos0, active))
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
    return {"name": "paged_flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "shape": "B=4 C=32 H=32 Hkv=8 D=128 pos0=[0,256,512,960] active=[1,1,0,1] bf16",
            "errs": errs}


def check_dense_flash(gen, dev):
    from repro_torch.kernels.flash_attention import ops, ref
    B, H, Hkv, S, D = 2, 32, 8, 1024, 128
    q = torch.randn(B, H, S, D, generator=gen, device=dev)
    k = torch.randn(B, Hkv, S, D, generator=gen, device=dev)
    v = torch.randn(B, Hkv, S, D, generator=gen, device=dev)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal, window, softcap in ((True, None, None), (True, 256, None),
                                        (True, None, 50.0), (False, None, None)):
            kw = dict(causal=causal, window=window, softcap=softcap)
            x = [t.to(dtype) for t in (q, k, v)]
            got = ops.flash_attention(*x, **kw)
            want = ref.attention_ref(*[t.float() for t in x], **kw)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want, **TOL[dtype])
            errs[f"{str(dtype)[6:]}/causal{causal}/w{window}/cap{softcap}"] = \
                (got.float() - want).abs().max().item()
    x = [t.to(torch.bfloat16) for t in (q, k, v)]
    ms = time_ms(lambda: ops.flash_attention(*x), iters=20)
    plain_ms = time_ms(lambda: ref.attention_ref(*x), iters=5)
    kr, vr = (t.repeat_interleave(H // Hkv, dim=1) for t in x[1:])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(x[0], kr, vr, is_causal=True), iters=20)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * Hkv * S * D)
    bound_ms, bound_by = bound(nbytes, 4 * B * H * D * S * (S + 1) // 2, torch.bfloat16)
    return {"name": "flash_attention (dense entry, not on the serving path)",
            "max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "shape": "B=2 H=32 Hkv=8 S=1024 D=128 causal bf16", "errs": errs}


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


def _reset_launches():
    from repro_torch.kernels.flash_attention import ops as f
    from repro_torch.kernels.paged_decode import ops as d
    for fn in (d.paged_decode_attention, f.paged_flash_attention, f.flash_attention):
        fn.launches = 0


def _launches():
    from repro_torch.kernels.flash_attention import ops as f
    from repro_torch.kernels.paged_decode import ops as d
    return {"paged_decode_attention": d.paged_decode_attention.launches,
            "paged_flash_attention": f.paged_flash_attention.launches,
            "flash_attention": f.flash_attention.launches}


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
            "launches": launches, "profile": profile}, launches


def _profile(cfg, params, prompts, dev, out):
    """Device time by kernel over a short non-speculative serve (4
    requests, 16 new tokens each): the device's busy share of the wall
    time, and the kernels that take it (full table under ``--out``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import RealEngine
    eng = RealEngine(cfg, LM(cfg, dev), params, max_len=1024, device=dev)
    _serve(eng, prompts[:1], 2)                               # warm-up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, s, wall, _ = _serve(eng, prompts, 16)
    # device-side events only: a CPU op also reports the time of the
    # kernels it launched, which would count them twice
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    _write(out, "profile_bf16.txt", "\n".join(
        f"{us / 1e3:12.3f} ms {n:8d}x  {k}" for us, k, n in rows))
    busy = sum(us for us, _, _ in rows) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": (1 - busy / wall) if busy else "not measured",
            "decode_calls": s.metrics["decode_calls"],
            "prefill_dispatches": eng.prefill_dispatches,
            "top": [[k, us / 1e3, n] for us, k, n in rows[:12]]}


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
                    if "Used" in ln]})

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = [check_paged_decode(gen, dev), check_paged_flash(gen, dev)]
    dense = check_dense_flash(gen, dev)
    emit({"phase": "kernels", "tol": {"float32": "atol=rtol=2e-5",
                                      "bfloat16": "atol=rtol=2e-2 vs f32 plain on bf16 inputs"},
          "kernels": kernels, "dense_flash": dense})

    emit(f32_parity(args.seed, dev))
    torch.cuda.empty_cache()

    line, launches = serve_bf16(args.seed, dev, args.out)
    emit(line)

    for k in kernels:
        k.pop("errs")
        k.pop("shape")
        k["launches"] = launches[k["name"]]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
