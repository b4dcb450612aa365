"""Onion proxy establishment + lightweight path forwarding (§3.2, Fig 2).

Establishment uses public-key crypto (X25519 + ChaCha20 layered boxes, one
ephemeral key per hop — telescoping like Tor but single-pass since the
establishment message is short and retries are cheap, per the paper).
Every relay on the path stores {path_id: (predecessor, successor)}; later
prompt/response cloves carry only the path_id in their header — NO
public-key operations on the data path (requirement 3).

Path IDs differ per path, so colluding relays on different paths of the
same user cannot link them (§3.2 security argument).

Own copy of ``repro/core/onion.py``, byte for byte in what it computes.
"""
from __future__ import annotations

import hashlib
import os
import struct
from dataclasses import dataclass, field

from repro_torch.core import chacha, ed25519


@dataclass
class RelayState:
    """What one relay stores per path."""
    routes: dict = field(default_factory=dict)  # path_id -> (pred, succ)

    def install(self, path_id: bytes, pred, succ):
        self.routes[path_id] = (pred, succ)

    def next_hop(self, path_id: bytes, from_node):
        ent = self.routes.get(path_id)
        if ent is None:
            return None
        pred, succ = ent
        return succ if from_node == pred else pred

    def drop_path(self, path_id: bytes):
        self.routes.pop(path_id, None)


def _box(payload: bytes, pk: bytes) -> bytes:
    """X25519 ephemeral box: eph_pub || ChaCha20(shared, payload)."""
    esk, epub = ed25519.dh_keypair()
    shared = ed25519.dh_shared(esk, pk)
    return epub + chacha.encrypt(payload, shared)


def _unbox(blob: bytes, sk: bytes) -> bytes:
    epub, body = blob[:32], blob[32:]
    shared = ed25519.dh_shared(sk, epub)
    return chacha.decrypt(body, shared)


def make_path_id(user_pub: bytes, proxy_pub: bytes, nonce: bytes) -> bytes:
    """Paper: hash of the user and the last node on the path (+ nonce so
    multiple paths to the same proxy stay unlinkable)."""
    return hashlib.sha256(b"path:" + user_pub + proxy_pub + nonce).digest()[:16]


def build_establishment(user_id, user_pub: bytes, hops: list) -> tuple:
    """hops: [(node_id, dh_pub)] of length l (last = proxy).

    Returns (path_id, first_hop_id, onion_blob).  Layer i decrypts to
    (path_id, pred_i, succ_i, inner); the proxy's layer has succ = None and
    a PROXY-ACK marker."""
    nonce = os.urandom(8)
    path_id = make_path_id(user_pub, hops[-1][1], nonce)
    ids = [user_id] + [h[0] for h in hops]
    blob = b"PROXY" + nonce + user_pub
    for i in range(len(hops) - 1, -1, -1):
        pred = _encode_id(ids[i])
        succ = _encode_id(ids[i + 2]) if i + 2 <= len(hops) else b""
        inner = struct.pack("<16sHH", path_id, len(pred), len(succ)) + \
            pred + succ + blob
        blob = _box(inner, hops[i][1])
    return path_id, hops[0][0], blob


def peel_establishment(blob: bytes, dh_sk: bytes):
    """One relay peels its layer.  Returns (path_id, pred_id, succ_id|None,
    inner_blob|None, proxy_payload|None)."""
    inner = _unbox(blob, dh_sk)
    path_id, lp, ls = struct.unpack("<16sHH", inner[:20])
    off = 20
    pred = _decode_id(inner[off:off + lp])
    off += lp
    succ = _decode_id(inner[off:off + ls]) if ls else None
    off += ls
    rest = inner[off:]
    if succ is None and rest.startswith(b"PROXY"):
        return path_id, pred, None, None, rest[5:]
    return path_id, pred, succ, rest, None


def _encode_id(x) -> bytes:
    if isinstance(x, bytes):
        return b"B" + x
    if isinstance(x, int):
        return b"I" + struct.pack("<q", x)
    return b"S" + str(x).encode()


def _decode_id(b: bytes):
    tag, body = b[:1], b[1:]
    if tag == b"B":
        return body
    if tag == b"I":
        return struct.unpack("<q", body)[0]
    return body.decode()
