"""Data pipelines (port of ``repro/training/data.py``, numpy only, the
same numbers for the same seeds): the synthetic LM corpus training samples
from, and the paper's serving workload generators (§5.1), matched on
published statistics.

Training corpus: a mixture of order-2 Markov chains over the vocab — cheap
to sample, learnable by tiny models (the verification benches need a GT
model that is *meaningfully better* than truncated/quantized impostors).

Serving workloads (dataset stand-ins):
  ToolUse  — Zipf-1.1 over shared tool-instruction prefixes, ~7.2k-token
             prompts, 100-token outputs
  Coding   — Zipf-0.8, ~1.8k-token prompts, minimal prefix overlap,
             1000-token outputs
  LongQA   — Zipf-0.6 over long documents (~11k tokens), 100-token outputs
  Mixed    — 3:6:1 blend (ToolUse:Coding:LongQA), per the paper
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


# --------------------------------------------------------------------------
# Training corpus
# --------------------------------------------------------------------------

class MarkovCorpus:
    """Order-1 Markov chain with sparse transitions (structured synthetic).

    Entropy floor ~= ln(branching) + noise*ln(vocab): branching=2/noise=0.02
    gives PPL ~2 for a converged model — low enough that greedy responses
    score high normalized perplexity (the Fig 11 regime)."""

    def __init__(self, vocab: int, seed: int = 0, branching: int = 4,
                 noise: float = 0.1):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.branching = branching
        self.noise = noise
        self._next = self.rng.integers(
            0, vocab, size=(vocab, branching)).astype(np.int32)

    def sample(self, batch: int, seq_len: int,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self.rng
        out = np.empty((batch, seq_len + 1), np.int32)
        cur = rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len + 1):
            out[:, t] = cur
            pick = rng.integers(0, self.branching, size=batch)
            nxt = self._next[cur, pick]
            noisy = rng.random(batch) < self.noise
            nxt = np.where(noisy, rng.integers(0, self.vocab, batch), nxt)
            cur = nxt
        return out

    def batches(self, batch: int, seq_len: int, steps: int,
                seed: int = 1) -> Iterator[dict]:
        rng = np.random.default_rng(seed)
        for _ in range(steps):
            seqs = self.sample(batch, seq_len, rng)
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


# --------------------------------------------------------------------------
# Serving workloads
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    n_prefixes: int          # library of shared prefixes (tools / docs)
    zipf_a: float            # zipf exponent for prefix popularity
    prefix_len_mean: int
    suffix_len_mean: int
    output_cap: int


TOOLUSE = WorkloadSpec("ToolUse", 64, 1.1, 6400, 800, 100)
CODING = WorkloadSpec("Coding", 512, 0.8, 200, 1600, 1000)
LONGQA = WorkloadSpec("LongQA", 32, 0.6, 10400, 600, 100)


def _zipf_choice(rng, n: int, a: float) -> int:
    w = 1.0 / np.power(np.arange(1, n + 1), a)
    w /= w.sum()
    return int(rng.choice(n, p=w))


@dataclass
class Query:
    tokens: list
    prefix_id: int
    workload: str
    max_new: int
    session: Optional[str] = None


class WorkloadGen:
    def __init__(self, spec: WorkloadSpec, vocab: int = 32_000,
                 seed: int = 0, scale: float = 1.0):
        """scale < 1 shrinks token counts for real-engine (CPU) runs."""
        self.spec = spec
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.scale = scale
        base = np.random.default_rng(seed + 1)
        self._prefixes = []
        for i in range(spec.n_prefixes):
            ln = max(8, int(base.normal(spec.prefix_len_mean,
                                        spec.prefix_len_mean * 0.2) * scale))
            self._prefixes.append(
                base.integers(2, vocab, size=ln).astype(int).tolist())

    def sample(self) -> Query:
        s = self.spec
        pid = _zipf_choice(self.rng, s.n_prefixes, s.zipf_a)
        sl = max(4, int(self.rng.normal(s.suffix_len_mean,
                                        s.suffix_len_mean * 0.3) * self.scale))
        suffix = self.rng.integers(2, self.vocab, size=sl).astype(int).tolist()
        out_cap = max(4, int(s.output_cap * min(self.scale * 4, 1.0)))
        return Query(self._prefixes[pid] + suffix, pid, s.name, out_cap)


class MixedWorkload:
    """ToolUse : Coding : LongQA = 3 : 6 : 1 (paper §5.1)."""

    def __init__(self, vocab: int = 32_000, seed: int = 0,
                 scale: float = 1.0):
        self.gens = [WorkloadGen(TOOLUSE, vocab, seed, scale),
                     WorkloadGen(CODING, vocab, seed + 1, scale),
                     WorkloadGen(LONGQA, vocab, seed + 2, scale)]
        self.weights = np.array([3, 6, 1], float)
        self.weights /= self.weights.sum()
        self.rng = np.random.default_rng(seed + 3)

    def sample(self) -> Query:
        g = self.gens[int(self.rng.choice(3, p=self.weights))]
        return g.sample()


def poisson_arrivals(rate_per_s: float, n: int, seed: int = 0,
                     t0: float = 0.0) -> list[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return (t0 + np.cumsum(gaps)).tolist()
