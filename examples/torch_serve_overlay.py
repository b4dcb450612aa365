"""End-to-end serving example on the PyTorch/CUDA port: a full GenTorrent
deployment under a realistic batched workload, the paper's §5 testbed in
miniature.

8 model nodes on two hardware tiers, 32 users, verification committee of 4
running Tendermint-style epochs with VRF leader election, ToolUse/Mixed
workloads at a Poisson rate, churn on the user population.

The twin of ``examples/serve_overlay.py``, through ``repro_torch`` alone:
the model nodes' HR-trees hash on ``--device`` (the chunk-hash kernel on
the card).

    PYTHONPATH=src python examples/torch_serve_overlay.py [--requests 150] [--device cpu]
"""
import argparse
from collections import Counter

import numpy as np

from repro_torch import require_device
from repro_torch.core.consensus import Challenge, SignedResponse
from repro_torch.net.simnet import ChurnProcess
from repro_torch.overlay.network import OverlayConfig, build_overlay
from repro_torch.training.data import MixedWorkload, poisson_arrivals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--device", default="cuda",
                    help="where the model nodes' HR-trees hash (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    # score_fns: committee members score by response plausibility; the
    # simulation's model nodes echo deterministic outputs, so the committee
    # sees consistent scores (real-LLM scoring: torch_dishonest_detection)
    def score_fn(pairs):
        return float(np.mean([0.85 if len(r) > 0 else 0.0
                              for _, r in pairs]))

    ov = build_overlay(
        OverlayConfig(n_users=32, n_models=8, use_crypto=False, seed=0,
                      hw_scores=[4, 4, 4, 4, 8, 8, 8, 8]),
        score_fns=[score_fn] * 4, device=dev)
    net = ov.net

    # --- workload ---
    gen = MixedWorkload(seed=1)
    arrivals = poisson_arrivals(args.rate, args.requests, seed=2, t0=10.0)
    done = []
    rng = np.random.default_rng(3)
    for t in arrivals:
        q = gen.sample()
        u = ov.users[int(rng.integers(0, len(ov.users)))]
        u.on_response = lambda _n, p: done.append(p)
        net.call_at(t, lambda u=u, q=q: u.send_prompt(
            net, q.tokens, session=f"s{q.prefix_id}",
            extra_meta={"max_new": q.max_new}))

    # --- churn on half the user population ---
    churn = ChurnProcess(net, [u.node_id for u in ov.users[16:]],
                         rate_per_min=6, seed=4)
    churn.start()

    # --- verification epochs in the background ---
    committee = ov.committee
    epoch_results = []

    def run_epoch():
        prompts = [tuple(int(x) for x in rng.integers(0, 1000, 12))
                   for _ in ov.models]
        committee.agree_challenges(
            [Challenge(m.node_id, p) for m, p in zip(ov.models, prompts)])

        def collect(leader_ix, challenges):
            return [SignedResponse(c.model_node, c.prompt,
                                   tuple(range(8)), b"", True)
                    for c in challenges]

        epoch_results.append(committee.run_epoch(collect))
        net.call_after(30.0, run_epoch)

    net.call_after(15.0, run_epoch)
    net.run_until(arrivals[-1] + 300)

    # --- report ---
    served = Counter()
    ttfts, totals = [], []
    for m in ov.models:
        served[m.node_id] = m.metrics["served"]
        ttfts += m.metrics["ttft"]
        totals += m.metrics["total"]
    lines = [
        f"completed {len(done)}/{args.requests} requests",
        f"served spread: {dict(served)}",
        f"TTFT avg {np.mean(ttfts):.2f}s p99 {np.percentile(ttfts, 99):.2f}s"
        f" | total avg {np.mean(totals):.2f}s",
        f"HR-tree cache-affinity decisions: "
        f"{sum(m.metrics['cache_hits'] for m in ov.models)}",
        f"verification epochs committed: "
        f"{sum(1 for e in epoch_results if e.committed)}/{len(epoch_results)}",
        f"reputations: { {k: round(v.score, 3) for k, v in committee.reputation.nodes.items()} }",
    ]
    print("\n".join(lines))
    assert len(done) >= args.requests * 0.8
    return {"lines": lines, "completed": len(done)}


if __name__ == "__main__":
    main()
