"""Sentry: derives the chunk-length array L from detected common system
prompts (Appendix A3).

Collect incoming requests, find frequent shared prefixes (a counting trie
over token ids, sampled), take the distinct common-prefix lengths
S = s_1 < s_2 < ... < s_n, and build

    l_1      = s_1
    l_{2i}   = delta
    l_{2i+1} = s_{i+1} - s_i - delta

so each detected system prompt ends exactly at a chunk boundary, separated
by a small delta chunk — the first HR-tree levels then route on shared
system prompts (cache affinity), per the paper.  Refreshed every
``refresh_every`` requests (10,000 in the paper's evaluation).
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Sequence


@dataclass
class SentryConfig:
    delta: int = 8
    min_support: int = 8          # occurrences before a prefix is "common"
    min_len: int = 16             # ignore very short common prefixes
    max_probe: int = 4096         # cap prefix scan length
    probe_stride: int = 16        # granularity of prefix-length probing
    refresh_every: int = 10_000
    max_prompts: int = 8          # n distinct system prompts tracked


class Sentry:
    def __init__(self, cfg: SentryConfig = SentryConfig()):
        self.cfg = cfg
        self._buffer: list[tuple] = []
        self._count = 0
        self.lengths: list[int] = []      # the array L

    def observe(self, tokens: Sequence[int]):
        self._count += 1
        if len(self._buffer) < 4096:
            self._buffer.append(tuple(tokens[: self.cfg.max_probe]))
        if self._count % self.cfg.refresh_every == 0:
            self.refresh()

    def refresh(self):
        self.lengths = build_lengths(self.detect_prompt_lengths(),
                                     self.cfg.delta)
        self._buffer.clear()

    def detect_prompt_lengths(self) -> list[int]:
        """Distinct common-prefix lengths, ascending."""
        cfg = self.cfg
        if len(self._buffer) < cfg.min_support:
            return []
        found = {}
        # probe prefix lengths at stride granularity
        for ln in range(cfg.min_len, cfg.max_probe + 1, cfg.probe_stride):
            c = Counter(t[:ln] for t in self._buffer if len(t) >= ln)
            for prefix, cnt in c.items():
                if cnt >= cfg.min_support:
                    found[prefix[: cfg.min_len]] = max(
                        found.get(prefix[: cfg.min_len], 0), ln)
        lengths = sorted(set(found.values()))
        return lengths[: cfg.max_prompts]


def build_lengths(s: Sequence[int], delta: int) -> list[int]:
    """The paper's equations (A3): [s1, d, s2-s1-d, d, s3-s2-d, ...]."""
    s = [x for x in sorted(set(s)) if x > 0]
    if not s:
        return []
    L = [s[0]]
    for prev, cur in zip(s, s[1:]):
        gap = cur - prev - delta
        if gap <= 0:      # prompts closer than delta: merge boundaries
            L.append(cur - prev)
            continue
        L.extend([delta, gap])
    return L
