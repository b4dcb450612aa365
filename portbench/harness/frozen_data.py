"""Frozen copy of the paper's serving workload generators (§5.1) as the
port had them: ``WorkloadSpec``, the ToolUse / Coding / LongQA specs,
``_zipf_choice``, ``Query``, ``WorkloadGen`` and ``poisson_arrivals``, copied
unchanged from ``src/repro_torch/training/data.py`` (repository state of
commit 7c02fe2).  The benchmark keeps its own copy so that no later change
to the program moves the yardstick; ``harness/traffic.py`` draws every
mix from these numbers and functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


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


def poisson_arrivals(rate_per_s: float, n: int, seed: int = 0,
                     t0: float = 0.0) -> list[float]:
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_per_s, size=n)
    return (t0 + np.cumsum(gaps)).tolist()
