"""A dishonest model node gets caught on the PyTorch/CUDA port: the §3.4
verification pipeline end to end with REAL models.

One node claims to serve the GT model but actually runs a degraded
(harshly quantized) copy to save resources.  The committee's challenge
prompts, indistinguishable from user traffic, are answered by the
impostor model; token-level PPL scoring against each verifier's local GT
copy drives its reputation below the 0.4 trust threshold within a few
epochs (paper Fig 12).

The twin of ``examples/dishonest_detection.py``, through ``repro_torch``
and ``torch_gt_model`` (beside this file) alone.  On the card the GT
model trains on the flash kernel's forward and backward, the greedy
responses run the flash kernel's dense entry and the dense decode, and
the verifier's ``LM.apply`` the flash kernel's dense entry.

    PYTHONPATH=src python examples/torch_dishonest_detection.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

from repro_torch import require_device  # noqa: E402
from repro_torch.core.consensus import (Challenge, SignedResponse,  # noqa: E402
                                        VerificationCommittee)
from repro_torch.core.reputation import ReputationConfig  # noqa: E402
from repro_torch.core.verification import VerifierModel, credibility  # noqa: E402
from torch_gt_model import greedy, impostors, trained_gt  # noqa: E402


def detect(cfg, model, params, bad_params, corpus, epochs=8):
    """The committee's ``epochs`` epochs over an honest node that serves
    ``params`` and a cheater that serves ``bad_params``, four verifiers
    scoring against ``params``.  Prints a line an epoch; returns each
    committed epoch's reputations, each challenge's (node, prompt,
    response) in order, and the set of untrusted nodes."""
    # 4 verification nodes, each with its own GT copy (here: same weights)
    verifier = VerifierModel(cfg, model, params)

    def score_fn(pairs):
        return float(np.mean([credibility(verifier, p, r)
                              for p, r in pairs]))

    committee = VerificationCommittee(
        4, [score_fn] * 4, rep_cfg=ReputationConfig(gamma=1 / 5))

    node_params = {"honest-node": params, "cheating-node": bad_params}
    rng = np.random.default_rng(0)
    reputations, responses = [], []
    print(f"{'epoch':>5} {'leader':>6} {'honest':>8} {'cheater':>8}")
    for epoch in range(epochs):
        prompts = {}
        for node in node_params:
            prompts[node] = tuple(
                corpus.sample(1, 16, rng)[0, :16].tolist())
        committee.agree_challenges(
            [Challenge(n, p) for n, p in prompts.items()])

        def collect(leader_ix, challenges):
            out = []
            for c in challenges:
                # the model node cannot tell this prompt is a challenge:
                # it answers with whatever model it actually runs
                resp = greedy(model, node_params[c.model_node],
                              list(c.prompt), n=12)
                responses.append((c.model_node, c.prompt, tuple(resp)))
                out.append(SignedResponse(c.model_node, c.prompt,
                                          tuple(resp), b"", True))
            return out

        res = committee.run_epoch(collect)
        if res.committed:
            reputations.append(dict(res.reputations))
            print(f"{epoch:>5} {res.leader:>6} "
                  f"{res.reputations.get('honest-node', 0):>8.3f} "
                  f"{res.reputations.get('cheating-node', 0):>8.3f}")
    return {"reputations": reputations, "responses": responses,
            "untrusted": committee.untrusted()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the models train, answer and verify (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    print("training tiny GT model (stand-in for Llama-3.1-8B)...")
    cfg, model, params, corpus, losses = trained_gt(device=dev)
    bad_params = impostors(params)["m3"]    # harsh quantization + noise
    out = detect(cfg, model, params, bad_params, corpus)

    untrusted = out["untrusted"]
    print(f"\nuntrusted nodes: {untrusted}")
    assert "cheating-node" in untrusted, "the impostor must be caught"
    assert "honest-node" not in untrusted
    print("=> the cheating node was detected and marked untrusted")
    return {**out, "untrusted": sorted(untrusted), "losses": losses,
            "params": params, "bad_params": bad_params, "corpus": corpus}


if __name__ == "__main__":
    main()
