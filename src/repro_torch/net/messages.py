"""Wire message schema + msgpack framing.

Every overlay message is a dict with a ``type`` field; this module is the
single source of truth for the schema (the simnet passes dicts in-process;
the TCP transport frames them with a length-prefixed msgpack encoding).
Own copy of ``repro/net/messages.py``: the framing goes over the port's
``wire`` codec, so a frame is byte-identical to the reference's without
``msgpack`` installed.
"""
from __future__ import annotations

import struct
from typing import Iterator

from repro_torch.net.wire import packb, unpackb

# message types and their required fields
SCHEMA = {
    "onion_create": ("blob",),
    "onion_create_fast": ("path_id", "chain", "origin", "hop"),
    "proxy_ack": ("path_id",),
    "clove_fwd": ("path_id", "dest_model", "clove", "msg_key"),
    "prompt_clove": ("clove", "proxy"),
    "response_clove": ("path_id",),
    "fwd_request": ("payload",),
    "hr_sync": ("from", "paths", "active", "hw"),
    # cross-node KV page migration (overlay/replicator.py): a node routed
    # a request with a fetch hint pulls the prefix pages from their
    # holder instead of re-prefilling them.
    #   kv_fetch   chains: list of BLOCK-chain digests (bytes), depth:
    #              how many leading blocks the fetcher wants
    #   kv_pages   ok: False = refusal (entry evicted / holder under
    #              pressure); True replies stream the msgpacked page
    #              buffer in ``total`` chunks of ``data`` bytes covering
    #              ``depth`` blocks (may be shallower than requested)
    "kv_fetch": ("from", "fetch_id", "chains", "depth"),
    "kv_pages": ("from", "fetch_id", "ok"),
}

# optional fields, (name -> accepted types) per message type: absent on
# older nodes, so validate() only type-checks them when present.  hr_sync
# carries the serving-pressure + prefix-affinity state the forwarding
# layer consumes:
#   kv_usage     int    prefix-cache bytes in use
#   kv_pressure  float  paged-arena fraction in use (0..1)
#   spec_accept_rate float  speculative-draft accept fraction (0..1)
#   sketch       bytes  core/forwarding.PrefixSketch over the node's
#                       cached block-chain digests (any ladder size)
# fwd_request may carry a replicate fetch hint (core/forwarding.decide):
#   kv_holder    the vetoed sketch holder to pull prefix pages from
#   kv_depth     int    hit depth in blocks
OPTIONAL = {
    "hr_sync": {"kv_usage": int, "kv_pressure": (int, float),
                "spec_accept_rate": (int, float),
                "sketch": (bytes, bytearray)},
    "fwd_request": {"kv_holder": (str, bytes, int), "kv_depth": int},
    "kv_pages": {"seq": int, "total": int, "depth": int,
                 "data": (bytes, bytearray)},
}


def validate(msg: dict) -> bool:
    t = msg.get("type")
    if t not in SCHEMA:
        return False
    if not all(f in msg for f in SCHEMA[t]):
        return False
    for f, typ in OPTIONAL.get(t, {}).items():
        if f in msg and msg[f] is not None and not isinstance(msg[f], typ):
            return False
    return True


def encode(msg: dict) -> bytes:
    body = packb(msg)
    return struct.pack("<I", len(body)) + body


class Decoder:
    """Incremental length-prefixed decoder for a TCP byte stream."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> Iterator[dict]:
        self._buf.extend(data)
        while len(self._buf) >= 4:
            (n,) = struct.unpack("<I", self._buf[:4])
            if len(self._buf) < 4 + n:
                return
            body = bytes(self._buf[4:4 + n])
            del self._buf[:4 + n]
            yield unpackb(body)
