"""One run of one cell: set-up, the window, the metrics, the check.

Set-up draws the weights from the seed, warms every shape the window uses
on a small engine, sizes the KV arena to the memory left, builds the
engine and the scheduler (with the spans, in a traced run), makes the
mix, and fills the prefix cache with the mix's shared prefixes where the
mix asks for it.  The loop (``loops/<loop>.py``) then drives the
scheduler; its lead-in counts as set-up.  Once the window has closed,
the readers (``metrics/<name>.py``) take the metrics, the device's peak
memory is read, the program's state is freed and the check runs.
"""
from __future__ import annotations

import gc
import sys
from types import SimpleNamespace

import torch

from harness import check, program, readers, served, spec, traffic, weights
from harness.spans import Spans
from harness.trace import DeviceTrace


def fill_prefixes(sched_served, mix) -> None:
    """Every shared prefix of the mix through the scheduler once (one token
    served), so the prefix cache holds each before the first request."""
    sched = sched_served.sched
    n = len(mix.prefix_lens)
    for pid in range(n):
        sched.submit(program.request(-1 - pid, mix.prefix_tokens(pid), 1))
    target = len(sched.done) + n
    while len(sched.done) < target:
        sched.step()


def build(c, port, seed: int, seconds: float, trace: bool, device, w=None, act=None):
    """Set-up of one run of cell ``c``: weights (drawn into ``w`` where
    given), warm-up (skipped where ``act``, its peak, is given), arena,
    engine, scheduler, mix and prefix fill."""
    node, mix_conf = c.config["node"], c.traffic
    cfg = program.arch_config(c.config["name"], port)
    w = weights.draw(port, seed, device, dtype=cfg.compute_dtype, out=w)
    if act is None:
        act = program.warm_up(cfg, w, node, device, port["vocab"])
    pages = program.arena_pages(cfg, node, device, act)
    print(f"portbench: weights {weights.nbytes(w)} B, warm-up peak {act} B over them, "
          f"{pages} pages of {program.page_bytes(cfg)} B", file=sys.stderr, flush=True)
    spans = Spans(device.type == "cuda") if trace else None
    model = program.LM(cfg, device)
    if spans:
        spans.install_model(model)
    eng = program.engine(cfg, model, w, node, pages, device)
    if spans:
        spans.install_engine(eng)
    sched = program.scheduler(eng, node)
    sv = served.Served(sched)
    mix = traffic.Mix(mix_conf, port["vocab"], seed, traffic.requests_needed(mix_conf, seconds))
    if (mix_conf.get("prefixes") or {}).get("prefill_in_setup"):
        fill_prefixes(sv, mix)
    return SimpleNamespace(cfg=cfg, w=w, act=act, spans=spans, eng=eng, sched=sched, sv=sv,
                           mix=mix)


def drive(b, c, seconds: float, tracer=None) -> dict:
    """The cell's loop over a built run; the window's bounds and counts."""
    ctx = SimpleNamespace(served=b.sv, mix=b.mix, traffic=c.traffic, seconds=seconds,
                          begin=tracer.start if tracer else (lambda: None),
                          snapshot=lambda: served.counters(b.eng, b.sched))
    win = spec.loop(c.bench_dir, c.traffic["loop"]).run(ctx)
    win["at_exit"] = served.counters(b.eng, b.sched)
    return win


def free(cuda: bool):
    """Release the program's state (the engine and its prefix cache hold
    each other, so only the collector frees them)."""
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()


def tails(rec):
    """The window's host-clock distributions on standard error: the
    median and the tails of time to first token and of token gaps."""
    qs = (50, 80, 90, 95, 99)
    ttft, gaps = readers.ttft_s(rec), readers.token_gaps_s(rec)
    print(f"portbench: {len(ttft)} due, {readers.tokens_in_window(rec)} tokens; ttft s "
          + " ".join(f"p{q} {served.pct(ttft, q)}" for q in qs) + f"; {len(gaps)} gaps, ms "
          + " ".join(f"p{q} {1e3 * (served.pct(gaps, q) or 0.0)}" for q in qs),
          file=sys.stderr, flush=True)


def served_requests(sv, t0: float) -> list:
    """(prompt, tokens served, admitted in the window) of every traffic
    request with a token: finished, or active at the close with the tokens
    it has so far.  A request was admitted in the window where its first
    token came after ``t0``."""
    return [(r.prompt, list(r.out), r.times[0] >= t0) for r in sv.reqs.values() if r.out]


def arena(eng, sv) -> dict:
    """The KV arena's pages and the most of them in use after any step (live
    requests' and the prefix cache's)."""
    pages = eng.allocator.num_pages - 1
    return {"pages": pages, "peak_pages_used": sv.peak_pages,
            "filled_share": sv.peak_pages / pages}


def run(root, name: str, seed: int, seconds: float, trace: bool, device, t_process: float,
        bench_dir=spec.HERE) -> dict:
    """Returns {"line": the result's fields but ``correct`` and the check,
    "check": {name: [number, limit]}, "correct": bool, ...}."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    c = spec.cell(root, name, bench_dir)
    port = c.config["port"]
    b = build(c, port, seed, seconds, trace, device)
    tracer = DeviceTrace() if trace and cuda else None
    win = drive(b, c, seconds, tracer)
    if tracer:
        tracer.stop()
    if cuda:
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if b.spans:
        b.spans.resolve()
    rec = served.Record(t0=win["t0"], t_end=win["t_end"], t_exit=win["t_exit"],
                        setup_s=win["t0"] - t_process, served=b.sv,
                        counters=(win["at_t0"], win["at_exit"]), port=port,
                        node=c.config["node"], traffic=c.traffic, spans=b.spans,
                        trace=tracer.window(win["t0"], win["t_exit"]) if tracer else None)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = spec.metric_reader(c.bench_dir, m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"attempted": len(rec.due_in_window()), "failed": 0, "metrics": metrics,
            "device": {"platform": "gpu" if cuda else "cpu",
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": peak}}
    if rec.trace:
        line["device"]["busy_s"] = rec.trace["busy_s"]
        line["device"]["window_s"] = rec.trace["window_s"]
        line["breakdown"] = breakdown(rec)

    tails(rec)
    fill = arena(b.eng, b.sv)

    # the check, on the program's served requests, with its state freed
    sv = b.sv
    requests = served_requests(sv, win["t0"])
    short = short_answers(sv)
    w = b.w
    del b, sv, rec, tracer
    free(cuda)
    pairs = check.sample(requests, seed, c.check["sample_tokens"])
    got = check.compare(spec.reference(c.bench_dir, c.config["reference"]), port, w, pairs)
    got["short_answers"] = short
    numbers, correct = check.verdict(got, c.check["limits"])
    return {"line": line, "check": numbers, "correct": correct, "arena": fill,
            "served": len(requests), "scored": {k: got[k] for k in (
                "scored_tokens", "late_tokens")}}


def short_answers(sv) -> int:
    """Finished requests whose answer is not the length they asked for."""
    return sum(len(sv.reqs[i].result.output) != sv.reqs[i].max_new for i in sv.finished)


def breakdown(rec) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps by what the host was doing in them."""
    ops = sorted(rec.trace["by_name"].items(), key=lambda kv: -kv[1])[:10]
    phases = []                     # (entry, exit, label), inner spans last
    phases += [(a, b, "harness: waiting for the next arrival") for a, b in rec.served.sleeps]
    phases += [(a, b, "Scheduler.step, outside the model calls") for a, b in rec.served.steps]
    for name, label in (("prefill_requests", "RealEngine.prefill_requests, between chunks"),
                        ("prefill_paged", "LM.prefill_paged, launching"),
                        ("decode_paged", "LM.decode_paged, launching")):
        phases += [(c.t0, c.t1, label) for c in rec.spans.calls[name]]

    def label(t):
        hit = "harness: between steps"
        for a, b, what in phases:
            if a <= t <= b:
                hit = what
        return hit
    return {"device_ops": [[k[:160], v] for k, v in ops],
            "idle_gaps": [[label(start + n / 2), n] for start, n in rec.trace["gaps"][:10]]}
