"""Verification node: committee member that challenges model nodes through
the anonymous overlay (§3.4).

Each verification node owns (a) a local copy of the served LLM for scoring
(core/verification.py), (b) an anonymous client (a UserNode) so its
challenge prompts are indistinguishable from user traffic, and (c) a seat
in the VerificationCommittee (core/consensus.py).  Own copy of
``repro/overlay/verification_node.py``; the scorer is any callable.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable

from repro_torch.core import ed25519
from repro_torch.core.consensus import Challenge, SignedResponse
from repro_torch.overlay.user_node import UserNode


@dataclass
class ChallengeOutcome:
    model_node: object
    prompt: tuple
    response: tuple
    signature: bytes = b""
    received: bool = False


class VerificationNode:
    def __init__(self, node_id, score_fn: Callable, rng=None,
                 use_crypto: bool = True):
        self.node_id = node_id
        self.score_fn = score_fn            # pairs -> C in [0,1]
        self.key = ed25519.SigningKey() if use_crypto else None
        self.client = UserNode(f"{node_id}:anon", rng=rng,
                               use_crypto=use_crypto)
        self.rng = rng or random.Random(0)
        self._outcomes: dict = {}

    # the anonymous client doubles as this node's network presence
    def on_message(self, net, src, msg):
        self.client.on_message(net, src, msg)

    def send_challenges(self, net, challenges: list[Challenge],
                        max_new: int = 16):
        """Leader duty: fire the agreed challenge prompts through the
        anonymous overlay, collect responses via the client callback."""
        self._outcomes = {
            c.model_node: ChallengeOutcome(c.model_node, c.prompt, ())
            for c in challenges}

        def on_resp(_net, payload):
            node = payload["server"]
            oc = self._outcomes.get(node)
            if oc is not None and tuple(payload["prompt"]) == oc.prompt:
                oc.response = tuple(payload["output"])
                oc.received = True

        self.client.on_response = on_resp
        for c in challenges:
            self.client.send_prompt(net, list(c.prompt),
                                    model_id=c.model_node,
                                    extra_meta={"max_new": max_new})

    def collect(self) -> list[SignedResponse]:
        out = []
        for oc in self._outcomes.values():
            if oc.received:
                out.append(SignedResponse(oc.model_node, oc.prompt,
                                          oc.response, oc.signature, True))
        return out

    def missing(self) -> list:
        return [oc.model_node for oc in self._outcomes.values()
                if not oc.received]
