"""The one traffic generator: reads a mix's parameters (``traffic/<mix>.json``)
and makes its requests.

Sizes come from the mix's own ``shape_seed``, so every run of a mix replays
the same schedule of sizes and arrivals: which shared prefix each request
opens with (Zipf over the library, ``frozen_data._zipf_choice``), its
suffix and answer lengths, and its due time
(``frozen_data.poisson_arrivals``).  The run's ``--seed`` draws every
token, and shuffles a closed loop's first wave among its clients.  Token
ids are drawn from [2, vocab): 0 and 1 never occur in a prompt.

A length spec is ``{"dist": "uniform", "min", "max"}``, ``{"dist":
"normal", "mean", "std", "min"[, "max"]}`` or ``{"dist": "lognormal",
"median", "sigma", "min", "max"}``: whole numbers, clipped to the range.
``max_total`` clips each suffix so that prompt plus answer fit.  A closed
loop's ``first_wave`` gives its first ``count`` requests answers drawn
from the residual of the answer distribution (what is left of a request
met at a random time), so a run starts near its steady state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from harness import frozen_data


@dataclass
class Shape:
    prefix: int        # index into the prefix library (-1: none)
    suffix: int        # tokens after the prefix
    answer: int        # tokens to serve
    due: float         # seconds after the schedule's start (open loop)


def draw_lengths(spec: dict, rng, n: int) -> np.ndarray:
    kind = spec["dist"]
    if kind == "uniform":
        x = rng.integers(spec["min"], spec["max"] + 1, size=n)
    elif kind == "normal":
        x = np.rint(rng.normal(spec["mean"], spec["std"], size=n))
    elif kind == "lognormal":
        x = np.rint(spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n)))
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(x, spec["min"], spec.get("max", np.inf)).astype(np.int64)


def residual_lengths(spec: dict, rng, n: int) -> np.ndarray:
    """What remains of a uniform answer met at a random point of a steady
    stream: density proportional to P(answer >= r), r in [1, max]."""
    if spec["dist"] != "uniform":
        raise ValueError("a residual first wave needs a uniform answer")
    lo, hi = spec["min"], spec["max"]
    r = np.arange(1, hi + 1)
    w = np.clip((hi - r + 1) / (hi - lo + 1), 0.0, 1.0)
    return rng.choice(r, size=n, p=w / w.sum()).astype(np.int64)


class Mix:
    """A traffic mix for one run: ``shapes`` (fixed by the mix), the prefix
    library's and every request's tokens (from the run's seed)."""

    def __init__(self, mix: dict, vocab: int, seed: int, n: int, salt: int = 0):
        """``salt``: other suffix tokens for the same prefixes (the knee
        sweep's later rates)."""
        self.mix, self.vocab, self.seed, self.salt = mix, vocab, seed, salt
        # one stream per quantity: a longer schedule extends each, unchanged
        rng = [np.random.default_rng([mix["shape_seed"], k]) for k in range(5)]
        pre = mix.get("prefixes")
        self.prefix_lens = (draw_lengths(pre["length"], rng[0], pre["count"]).tolist()
                            if pre else [])
        pids = ([frozen_data._zipf_choice(rng[1], pre["count"], pre["zipf_a"])
                 for _ in range(n)] if pre else [-1] * n)
        suffix = draw_lengths(mix["suffix"], rng[2], n)
        answer = draw_lengths(mix["answer"], rng[3], n)
        wave = mix.get("first_wave")
        if wave:
            answer[:wave["count"]] = residual_lengths(mix["answer"], rng[4], wave["count"])
        arr = mix["arrivals"]
        due = (frozen_data.poisson_arrivals(arr["rate_per_s"], n, seed=mix["shape_seed"])
               if arr["kind"] == "poisson" else [0.0] * n)
        order = list(range(n))
        if wave:
            order[:wave["count"]] = np.random.default_rng([seed, 0]).permutation(
                wave["count"]).tolist()
        self.shapes = []
        for i, j in enumerate(order):
            pl = self.prefix_lens[pids[j]] if pids[j] >= 0 else 0
            sl = int(suffix[j])
            if "max_total" in mix:
                sl = max(1, min(sl, mix["max_total"] - int(answer[j]) - pl))
            self.shapes.append(Shape(int(pids[j]), sl, int(answer[j]), float(due[i])))
        self._prefix_tokens = {}

    def prefix_tokens(self, pid: int) -> list:
        if pid not in self._prefix_tokens:
            rng = np.random.default_rng([self.seed, 1, pid])
            self._prefix_tokens[pid] = rng.integers(
                2, self.vocab, size=self.prefix_lens[pid]).tolist()
        return self._prefix_tokens[pid]

    def prompt(self, i: int) -> list:
        """Request ``i``'s prompt: its prefix, then its own suffix."""
        s = self.shapes[i]
        rng = np.random.default_rng([self.seed, 2, i] + ([self.salt] if self.salt else []))
        own = rng.integers(2, self.vocab, size=s.suffix).tolist()
        return (self.prefix_tokens(s.prefix) if s.prefix >= 0 else []) + own


def requests_needed(mix: dict, seconds: float) -> int:
    """Schedule length: every arrival of the lead-in and the window, with
    room, or a closed loop's clients and room for its completions."""
    arr = mix["arrivals"]
    if arr["kind"] == "poisson":
        return int(arr["rate_per_s"] * (mix.get("lead_in_s", 0.0) + seconds) * 1.5) + 64
    return arr["clients"] + 4096
