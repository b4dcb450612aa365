"""Reputation scores with sliding-window punishment (§3.4).

  R(T) = alpha * R(T-1) + beta * C(T)                     (normal)
  R(T) = alpha * R(T-1) + (W+1)/(W + c/gamma + 2) * C(T)  (punished)

punishment applies when the fraction of abnormal C(T) values
(C < tau_abnormal) in the last W epochs exceeds gamma.  Paper settings:
alpha=0.4, beta=0.6, W=5, gamma=1/5, untrusted below 0.4.

Own copy of ``repro/core/reputation.py``, byte for byte in what it computes.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class ReputationConfig:
    alpha: float = 0.4
    beta: float = 0.6
    window: int = 5
    gamma: float = 1.0 / 5.0
    tau_abnormal: float = 0.35     # C(T) below this counts as abnormal
    untrusted_below: float = 0.4
    initial: float = 0.6


@dataclass
class ReputationState:
    score: float
    history: deque = field(default_factory=lambda: deque(maxlen=64))

    def is_trusted(self, cfg: ReputationConfig) -> bool:
        return self.score >= cfg.untrusted_below


class ReputationTracker:
    def __init__(self, cfg: ReputationConfig = ReputationConfig()):
        self.cfg = cfg
        self.nodes: dict = {}

    def get(self, node_id) -> ReputationState:
        if node_id not in self.nodes:
            self.nodes[node_id] = ReputationState(self.cfg.initial)
        return self.nodes[node_id]

    def update(self, node_id, c_t: float) -> float:
        """Apply one epoch's average challenge score C(T)."""
        cfg = self.cfg
        st = self.get(node_id)
        st.history.append(c_t)
        recent = list(st.history)[-cfg.window:]
        c_abn = sum(1 for v in recent if v < cfg.tau_abnormal)
        frac = c_abn / cfg.window
        if frac > cfg.gamma:
            w = cfg.window
            weight = (w + 1) / (w + c_abn / cfg.gamma + 2)
            st.score = cfg.alpha * st.score + weight * c_t
        else:
            st.score = cfg.alpha * st.score + cfg.beta * c_t
        st.score = min(max(st.score, 0.0), 1.0)
        return st.score

    def trusted(self) -> set:
        return {n for n, st in self.nodes.items()
                if st.is_trusted(self.cfg)}
