"""Minimal overlay endpoints for driving model nodes directly on a SimNet
(port of ``repro/overlay/probe.py``).

``ResponseSink`` stands in for the user's proxy path: register it under a
node id, point request payloads' ``reply`` route at it, and read recovered
outputs by msg_id.
"""
from __future__ import annotations

from repro_torch.core import sida
from repro_torch.net.wire import unpackb


class ResponseSink:
    """Collects single-clove responses (n=1, k=1 S-IDA) by msg_id."""

    def __init__(self):
        self.got = {}

    def on_message(self, net, src, msg):
        payload = unpackb(sida.recover([sida.Clove.decode(msg["clove"])]))
        self.got[payload["msg_id"]] = payload["output"]


def direct_payload(msg_id, toks, max_new: int = 4,
                   sink_id="sink") -> dict:
    """Request payload for ModelNode._process with replies routed to a
    ``ResponseSink`` registered as ``sink_id`` (single reply path -> the
    model node emits one k=1 clove straight to the sink)."""
    return {"prompt": list(toks), "msg_id": msg_id, "session": None,
            "max_new": max_new, "reply": [(sink_id, "00")]}
