"""Tendermint-style verification epochs (§3.4).

Committee of N = 3f+1 verification nodes.  Per epoch e_i:
  - leader L_i chosen verifiably from the previous epoch's commit hash (VRF)
  - the (model-node, challenge-prompt) list M_i was agreed at the END of
    e_{i-1} (prevents a malicious leader from skipping/SWAPPING prompts)
  - L_i sends challenges through the anonymous overlay (model nodes cannot
    distinguish them from user traffic), collects signed responses,
    broadcasts them
  - every member independently recomputes credibility with its LOCAL model,
    compares to the leader's proposal (negligible-variance check), then
    two-phase votes (pre-vote / pre-commit, each needing > 2/3)
  - mismatched prompts / bad signatures abort the epoch (new leader next)
  - "invalid response from x" only damages x if > 1/3 of members confirm

The machinery is deterministic and in-process (the paper uses Tendermint as
a black box); Byzantine member behaviors are injectable for tests.

Own copy of ``repro/core/consensus.py``, byte for byte in what it computes.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import vrf
from repro_torch.core.reputation import ReputationConfig, ReputationTracker


@dataclass
class Challenge:
    model_node: object
    prompt: tuple           # token ids


@dataclass
class SignedResponse:
    model_node: object
    prompt: tuple
    response: tuple         # token ids
    signature: bytes        # model node's signature over (prompt, response)
    valid_sig: bool = True


@dataclass
class EpochResult:
    epoch: int
    leader: int
    committed: bool
    scores: dict = field(default_factory=dict)       # node -> C(T)
    reputations: dict = field(default_factory=dict)  # node -> R(T)
    aborted_reason: str = ""


def score_close(a: float, b: float, tol: float = 5e-2) -> bool:
    """"Negligible variance" acceptance between members' local scores."""
    return abs(a - b) <= tol


class VerificationCommittee:
    """n member slots; member i scores via score_fns[i] (its local LLM)."""

    def __init__(self, n_members: int, score_fns: list,
                 rep_cfg: ReputationConfig = ReputationConfig(),
                 byzantine: Optional[set] = None, vote_tol: float = 5e-2):
        assert n_members >= 4, "BFT needs n >= 3f+1 >= 4"
        assert len(score_fns) == n_members
        self.n = n_members
        self.f = (n_members - 1) // 3
        self.score_fns = score_fns
        self.reputation = ReputationTracker(rep_cfg)
        self.byzantine = byzantine or set()
        self.vote_tol = vote_tol
        self.commit_hash = b"genesis"
        self.epoch = 0
        self.pending: list[Challenge] = []   # agreed M_i for this epoch
        self.log: list[EpochResult] = []

    # ---- leader election (VRF over previous commit hash) ----
    def leader(self) -> int:
        return vrf.leader_index([self.commit_hash], self.n)

    def agree_challenges(self, challenges: list[Challenge]):
        """End-of-previous-epoch agreement on M_i (no duplicate prompts
        across model nodes — anti-collusion/replay, §3.4)."""
        prompts = [c.prompt for c in challenges]
        assert len(set(prompts)) == len(prompts), \
            "challenge prompts must be unique per model node"
        self.pending = list(challenges)

    # ---- one epoch ----
    def run_epoch(self, collect_fn: Callable[[int, list], list]
                  ) -> EpochResult:
        """collect_fn(leader_ix, challenges) -> list[SignedResponse]
        (the leader querying model nodes through the anonymous overlay)."""
        self.epoch += 1
        ldr = self.leader()
        challenges = self.pending
        res = EpochResult(self.epoch, ldr, committed=False)
        responses = collect_fn(ldr, challenges)

        # integrity check by every member: prompts match the agreed list,
        # signatures verify
        agreed = {c.model_node: c.prompt for c in challenges}
        for r in responses:
            if r.model_node not in agreed or agreed[r.model_node] != r.prompt:
                res.aborted_reason = f"prompt mismatch for {r.model_node}"
                self._abort()
                self.log.append(res)
                return res
            if not r.valid_sig:
                res.aborted_reason = f"bad signature from {r.model_node}"
                self._abort()
                self.log.append(res)
                return res

        # leader proposal: per-node scores (leader may be byzantine)
        by_node: dict = {}
        for r in responses:
            by_node.setdefault(r.model_node, []).append(r)
        proposal = {}
        for node, rs in by_node.items():
            pairs = [(list(r.prompt), list(r.response)) for r in rs]
            c = self.score_fns[ldr](pairs)
            if ldr in self.byzantine:
                c = 1.0 - c  # byzantine leader proposes garbage
            proposal[node] = c

        # pre-vote: each member recomputes locally and compares
        prevotes = 0
        for m in range(self.n):
            if m in self.byzantine:
                continue  # byzantine members withhold votes
            ok = True
            for node, rs in by_node.items():
                pairs = [(list(r.prompt), list(r.response)) for r in rs]
                mine = self.score_fns[m](pairs)
                if not score_close(mine, proposal[node], self.vote_tol):
                    ok = False
                    break
            prevotes += 1 if ok else 0
        if prevotes * 3 <= 2 * self.n:
            res.aborted_reason = (f"pre-vote failed ({prevotes}/{self.n})")
            self._abort()
            self.log.append(res)
            return res

        # pre-commit mirrors pre-vote for honest members
        precommits = self.n - len(self.byzantine)
        if precommits * 3 <= 2 * self.n:
            res.aborted_reason = "pre-commit failed"
            self._abort()
            self.log.append(res)
            return res

        # commit: apply reputation updates
        for node, c in proposal.items():
            res.scores[node] = c
            res.reputations[node] = self.reputation.update(node, c)
        res.committed = True
        self.commit_hash = hashlib.sha256(
            self.commit_hash
            + json.dumps({str(k): round(v, 6)
                          for k, v in sorted(res.scores.items(),
                                             key=lambda kv: str(kv[0]))
                          }).encode()).digest()
        self.log.append(res)
        return res

    def _abort(self):
        # rotate leadership: fold the failed epoch into the hash chain
        self.commit_hash = hashlib.sha256(
            self.commit_hash + b"abort" + bytes([self.epoch % 256])).digest()

    def untrusted(self) -> set:
        cfg = self.reputation.cfg
        return {n for n, st in self.reputation.nodes.items()
                if st.score < cfg.untrusted_below}
