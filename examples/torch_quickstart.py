"""Quickstart on the PyTorch/CUDA port: the GenTorrent pipeline in one file.

1. build a tiny LM and a serving engine (the thing every model node runs)
2. wrap it in a decentralized overlay: users, relays, model nodes
3. send anonymous prompts through onion paths as S-IDA cloves
4. watch HR-tree forwarding route shared-prefix requests to cache holders

The twin of ``examples/quickstart.py``, through ``repro_torch`` alone.  On
the card the engine prefills on the flash kernel's paged entry and decodes
on the paged decode kernel, and the model nodes' HR-trees hash on the
chunk-hash kernel.  The weights are drawn on the CPU from a generator
seeded 0 and moved to ``--device``, so a run on the card starts from the
CPU run's weights.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch import configs, require_device
from repro_torch.models.lm import LM
from repro_torch.overlay.network import OverlayConfig, build_overlay
from repro_torch.params import init_params
from repro_torch.serving.engine import RealEngine, Request
from repro_torch.training.optimizer import tree_map


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine and the HR-trees run (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    # ---- 1. a model node's serving engine (tiny config, real model)
    cfg = configs.get_config("gentorrent-llama3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = RealEngine(cfg, LM(cfg, device=dev), tree_map(lambda t: t.to(dev), params),
                        max_len=256, device=dev)
    r1 = engine.generate(Request(1, list(range(40)), max_new=8))
    r2 = engine.generate(Request(2, list(range(40)) + [7, 8], max_new=8))
    print(f"[engine] generated {len(r1.output)} tokens; "
          f"second request reused {r2.cached_tokens} cached prefix tokens")

    # ---- 2-4. the overlay
    ov = build_overlay(OverlayConfig(n_users=24, n_models=4,
                                     use_crypto=False, seed=0), device=dev)
    shared_prefix = list(range(200))          # e.g. a common system prompt
    responses = []
    for i in range(6):
        u = ov.users[i]
        u.on_response = lambda _n, p: responses.append(p)
        # staggered so HR-tree state sync (5s period) can propagate
        ov.net.call_at(6.0 + 6.0 * i, lambda u=u, i=i: u.send_prompt(
            ov.net, shared_prefix + [1000 + i] * 50,
            session=f"user{i}", extra_meta={"max_new": 16}))
    ov.net.run_until(120.0)

    served = {m.node_id: m.metrics["served"] for m in ov.models}
    hits = sum(m.metrics["cache_hits"] for m in ov.models)
    rates = [round(m.engine.prefix_cache.token_hit_rate, 2) for m in ov.models]
    print(f"[overlay] {len(responses)}/6 responses received anonymously")
    print(f"[overlay] served per node: {served}; HR-tree cache hits: {hits}")
    print(f"[overlay] token hit rates: {rates}")
    assert len(responses) == 6
    return {"tokens": [r1.output, r2.output],
            "cached_tokens": [r1.cached_tokens, r2.cached_tokens],
            "responses": len(responses), "served": served, "cache_hits": hits,
            "token_hit_rates": rates}


if __name__ == "__main__":
    main()
