"""Token-level probabilistic verification (Algorithm 3, Fig 8); own copy
of ``repro/core/verification.py``.

A verification node holds its own copy of the served LLM (a port ``LM``
and its weights).  Given a challenge prompt and a model node's response,
it teacher-forces the concatenated sequence through its local model ONCE
(``LM.apply``; on the card its attention is the flash kernel's dense
entry) and reads the probability its reference model assigns to every
response token: the per-token loop of Algorithm 3 is one forward pass.

credibility C = 1 / PPL,  PPL = exp(-(1/n) * sum_i log p(t_i | t_<i)).

The positions and tokens to read are worked out on the host in numpy, as
the reference does (so an empty prompt reads position -1, which wraps to
the last one, as numpy indexing wraps it); only the read values leave the
device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class VerifierModel:
    cfg: object
    model: object       # a repro_torch.models.lm.LM
    params: object

    def _logprobs(self, params, tokens):
        """(B, S) int32 tokens -> (B, S, V) float32 log-probabilities, with
        no autograd graph (``LM.apply`` is graded where grad mode is on)."""
        with torch.no_grad():
            logits = self.model.apply(params, tokens)
            return torch.log_softmax(logits.float(), dim=-1)


EPS_PROB = 1e-8  # Algorithm 3's small constant for unmatched tokens


def _read(verifier: VerifierModel, toks: np.ndarray, rows) -> list:
    """One forward of ``toks`` (B, S); for each (prompt length, response)
    of ``rows``, the clamped log p of its response tokens (host numpy)."""
    lp = verifier._logprobs(verifier.params, torch.from_numpy(toks).to(
        verifier.model.device))
    S = toks.shape[1]
    b, idx, tok = [], [], []
    for i, (n0, r) in enumerate(rows):
        pos = np.arange(n0 - 1, n0 - 1 + len(r))
        idx.append(np.where(pos < 0, pos + S, pos))     # numpy's wrap of -1
        b.append(np.full(len(r), i))
        tok.append(np.asarray(r, np.int64))
    dev = lp.device
    vals = lp[torch.from_numpy(np.concatenate(b)).to(dev),
              torch.from_numpy(np.concatenate(idx)).to(dev),
              torch.from_numpy(np.concatenate(tok)).to(dev)].cpu().numpy()
    return [np.maximum(v, np.log(EPS_PROB))
            for v in np.split(vals, np.cumsum([len(r) for _, r in rows])[:-1])]


def response_logprobs(verifier: VerifierModel, prompt: list[int],
                      response: list[int]) -> np.ndarray:
    """log p(response_i | prompt, response_<i) under the local model."""
    toks = np.asarray([list(prompt) + list(response)], np.int32)
    return _read(verifier, toks, [(len(prompt), list(response))])[0]


def credibility(verifier: VerifierModel, prompt: list[int],
                response: list[int]) -> float:
    """Normalized perplexity 1/PPL in (0, 1]."""
    if not response:
        return 0.0
    lp = response_logprobs(verifier, prompt, response)
    ppl = float(np.exp(-lp.mean()))
    return 1.0 / ppl


def avg_credibility(verifier: VerifierModel, pairs) -> float:
    """C(T): average over the epoch's (prompt, response) challenges."""
    vals = [credibility(verifier, p, r) for p, r in pairs]
    return float(np.mean(vals)) if vals else 0.0


def credibility_batch(verifier: VerifierModel, pairs) -> list[float]:
    """Batched scoring: the challenges right-padded with token 0 into one
    (B, S) forward pass, each row read from its prompt's last position on
    (the padding is never read).  Equal to per-pair ``credibility``."""
    if not pairs:
        return []
    seqs = [list(p) + list(r) for p, r in pairs]
    toks = np.zeros((len(pairs), max(len(s) for s in seqs)), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    vals = _read(verifier, toks, [(len(p), list(r)) for p, r in pairs])
    return [float(1.0 / np.exp(-v.mean())) if len(r) else 0.0
            for v, (_, r) in zip(vals, pairs)]
