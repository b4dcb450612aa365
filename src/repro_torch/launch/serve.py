"""Serving driver: a GenTorrent overlay serving a workload on the
simulated network (port of ``repro/launch/serve.py``, with its own copy of
the simulation loop of ``benchmarks/serving_sim.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 100 --rate 2 \\
        --workload Mixed --mode full [--device cuda]

Eight model nodes in two hardware tiers (hw 4 and hw 8, as the paper's
testbed) serve a workload's Poisson arrivals in one of three modes:

  full     HR-tree forwarding + load balancing  (GenTorrent)
  lb_only  load balancing only
  none     no overlay forwarding

The model nodes run the port's ``LatencyEngine``; their HR-trees hash on
``--device`` (the chunk-hash kernel on the card, its plain version on the
CPU).  Python's global ``random`` (the nodes' first sync delay) is seeded
from the run's seed before the overlay is built, so a run repeats.
"""
from __future__ import annotations

import argparse
import json
import random

import numpy as np

from repro_torch.overlay.network import OverlayConfig, build_overlay
from repro_torch.training.data import (CODING, LONGQA, TOOLUSE, MixedWorkload,
                                       WorkloadGen, poisson_arrivals)

WORKLOADS = {
    "ToolUse": lambda seed: WorkloadGen(TOOLUSE, seed=seed),
    "Coding": lambda seed: WorkloadGen(CODING, seed=seed),
    "LongQA": lambda seed: WorkloadGen(LONGQA, seed=seed),
    "Mixed": lambda seed: MixedWorkload(seed=seed),
}
MODES = ("full", "lb_only", "none")


def run_serving_sim(workload: str, mode: str, rate: float,
                    n_requests: int = 120, seed: int = 0,
                    n_users: int = 24, n_models: int = 8,
                    window_s: float = 0.0, device="cuda") -> dict:
    """Avg / P99 latency, TTFT, cache hits and throughput of one run.
    ``window_s`` > 0: completions within a fixed window after the first
    arrival (the saturated regime); otherwise the run goes to completion."""
    random.seed(seed)
    ov = build_overlay(OverlayConfig(
        n_users=n_users, n_models=n_models, use_crypto=False, seed=seed,
        sync_every=5.0,
        # per-node cache holds ~8 ToolUse-sized prefixes: the group's
        # aggregate capacity covers the working set only when HR-tree
        # affinity routing specializes the nodes (paper §3.3)
        cache_bytes=64 << 20,
        hw_scores=[4, 4, 4, 4, 8, 8, 8, 8]), device=device)
    for m in ov.models:
        m.fwd_mode = mode
    gen = WORKLOADS[workload](seed + 1)
    arrivals = poisson_arrivals(rate, n_requests, seed=seed + 2, t0=ov.net.t + 1.0)
    done = []

    def cb(_net, payload):
        done.append(payload)

    rng = np.random.default_rng(seed + 3)
    for t, _ in zip(arrivals, range(n_requests)):
        q = gen.sample()
        u = ov.users[int(rng.integers(0, n_users))]
        u.on_response = cb

        def fire(u=u, q=q):
            u.send_prompt(ov.net, q.tokens, session=f"s{q.prefix_id}",
                          extra_meta={"max_new": q.max_new})

        ov.net.call_at(t, fire)
    if window_s > 0:
        ov.net.run_until(arrivals[0] + window_s)
    else:
        ov.net.run_until(arrivals[-1] + 600)

    ttfts, totals, served, hits = [], [], 0, 0
    cached_t, prompt_t = 0, 0
    for m in ov.models:
        ttfts += m.metrics["ttft"]
        totals += m.metrics["total"]
        served += m.metrics["served"]
        hits += m.metrics["cache_hits"]
        cached_t += m.metrics["cached_tokens"]
        prompt_t += m.metrics["prompt_tokens"]
    out_tokens = sum(len(p.get("output", [])) for p in done)
    span = window_s if window_s > 0 else ov.net.t - arrivals[0]
    return {
        "workload": workload, "mode": mode, "rate": rate,
        "completed": len(done), "served": served,
        "avg_latency_s": float(np.mean(totals)) if totals else None,
        "p99_latency_s": float(np.percentile(totals, 99)) if totals else None,
        "ttft_s": float(np.mean(ttfts)) if ttfts else None,
        "cache_hit_decisions": hits,
        "token_hit_rate": cached_t / prompt_t if prompt_t else 0.0,
        "throughput_tok_s": out_tokens / span if span > 0 else 0.0,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--workload", default="Mixed", choices=list(WORKLOADS))
    ap.add_argument("--mode", default="full", choices=MODES,
                    help="overlay forwarding mode (Fig 16 ablation)")
    ap.add_argument("--models", type=int, default=8)
    ap.add_argument("--users", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="where the nodes' HR-trees hash (cuda or cpu)")
    args = ap.parse_args()
    out = run_serving_sim(args.workload, args.mode, args.rate,
                          n_requests=args.requests, n_users=args.users,
                          n_models=args.models, device=args.device)
    print(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    main()
