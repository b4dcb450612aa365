"""User node: onion proxy establishment + S-IDA clove messaging + relay
duty + session affinity (§3.2, Figs 2-4).

Every user node is also a relay for others (RelayState).  Data-path
messages carry only a path_id — no public-key crypto on relays.  Own copy
of ``repro/overlay/user_node.py``: payloads go over the port's wire codec
(byte-identical to msgpack), and the affinity digest is the port's prefix
cache's.
"""
from __future__ import annotations

import itertools
import os
import random
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import ed25519, onion, sida
from repro_torch.net.wire import packb, unpackb
from repro_torch.serving.prefix_cache import BLOCK, _chain_hashes

PATH_LEN = 3          # Tor-calibrated 3 hops (paper §3.2)


@dataclass
class ProxyPath:
    path_id: bytes
    first_hop: object
    proxy_id: object
    relays: tuple = ()
    established: bool = False


@dataclass
class PendingMsg:
    cloves: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)
    done: bool = False


class UserNode:
    def __init__(self, node_id, rng: Optional[random.Random] = None,
                 n_proxies: int = 4, sida_n: int = 4, sida_k: int = 3,
                 use_crypto: bool = True):
        self.node_id = node_id
        self.rng = rng or random.Random(hash(node_id) & 0xFFFF)
        self.n_proxies = n_proxies
        self.sida_n = sida_n
        self.sida_k = sida_k
        self.use_crypto = use_crypto
        if use_crypto:
            self.sign_key = ed25519.SigningKey()
            self.dh_sk, self.dh_pub = ed25519.dh_keypair()
        else:  # fast mode for large simulations: identity still unique
            self.sign_key = None
            self.dh_sk = self.dh_pub = os.urandom(32)
        self.relay = onion.RelayState()
        self.paths: list[ProxyPath] = []
        self.user_list: list = []         # NodeRecord of peers
        self.model_list: list = []
        self._inbox: dict = {}            # msg_id -> PendingMsg
        self._msg_ids = itertools.count()
        self.sessions: dict = {}          # session -> model node id
        # client-side prefix affinity: leading-block chain digest of a
        # served prompt -> the model node that served it.  Re-sending a
        # prompt that shares its first BLOCK goes straight to the likely
        # prefix holder, saving the forward hop the group-side sketch
        # routing would otherwise spend re-routing it.
        self._prefix_servers: "dict[bytes, object]" = {}
        self.prefix_affinity_cap = 64     # LRU bound on remembered digests
        self.on_response: Optional[Callable] = None
        self.stats = {"sent": 0, "recovered": 0, "failed": 0}

    # ------------------------------------------------------------------
    # bootstrap
    # ------------------------------------------------------------------
    def load_lists(self, user_list, model_list, committee_pubs=None):
        if committee_pubs is not None and self.use_crypto:
            assert user_list.verify(committee_pubs), "bad user list signature"
            assert model_list.verify(committee_pubs), "bad model list sig"
        self.user_list = list(user_list.records)
        self.model_list = list(model_list.records)

    def establish_proxies(self, net, n: Optional[int] = None):
        """Build N proxies over 3-hop onion paths (Fig 2)."""
        want = n or self.n_proxies
        peers = [r for r in self.user_list if r.node_id != self.node_id]
        used: set = set()
        for _ in range(want):
            if len(peers) < PATH_LEN:
                break
            # relay-disjoint paths while the pool allows: one relay failure
            # must cost at most one path (path-diversity requirement 4)
            avail = [r for r in peers if r.node_id not in used]
            pool = avail if len(avail) >= PATH_LEN else peers
            hops = self.rng.sample(pool, PATH_LEN)
            used.update(r.node_id for r in hops)
            if self.use_crypto:
                hop_keys = [(r.node_id, r.dh_pub) for r in hops]
                pid, first, blob = onion.build_establishment(
                    self.node_id, self.dh_pub, hop_keys)
                msg = {"type": "onion_create", "blob": blob}
            else:  # plaintext establishment for scale sims (same topology)
                pid = os.urandom(16)
                chain = [r.node_id for r in hops]
                msg = {"type": "onion_create_fast", "path_id": pid,
                       "chain": chain, "origin": self.node_id, "hop": 0}
                first = chain[0]
            self.paths.append(ProxyPath(pid, first, hops[-1].node_id,
                                        tuple(r.node_id for r in hops)))
            net.send(self.node_id, first, msg, size_bytes=512)

    def live_paths(self) -> list:
        return [p for p in self.paths if p.established]

    def maintain(self, net):
        """Proxy refresh (paper §5.2: re-discover proxies periodically).
        Drops paths through nodes known dead, tops back up to n_proxies."""
        self.paths = [p for p in self.paths
                      if all(net.alive(r) for r in p.relays)]
        missing = self.n_proxies - len(self.live_paths())
        if missing > 0:
            self.establish_proxies(net, n=missing)

    # ------------------------------------------------------------------
    # sending prompts (Fig 3)
    # ------------------------------------------------------------------
    def send_prompt(self, net, prompt_tokens, llm: str = "",
                    session: Optional[str] = None,
                    model_id=None, extra_meta: Optional[dict] = None):
        paths = self.live_paths()
        if len(paths) < self.sida_n:
            self.stats["failed"] += 1
            return None
        chosen = self._pick_disjoint(paths, self.sida_n)
        if model_id is None:
            if session is not None and session in self.sessions:
                model_id = self.sessions[session]   # session affinity
            else:
                model_id = self._affinity_entry(prompt_tokens, llm)
            if model_id is None:
                cands = [r for r in self.model_list
                         if (not llm or r.llm == llm)]
                model_id = self.rng.choice(cands).node_id
        msg_id = f"{self.node_id}:{next(self._msg_ids)}"
        payload = {
            "prompt": list(map(int, prompt_tokens)),
            "msg_id": msg_id,
            "session": session,
            "llm": llm,
            # reply routing: proxy ids + path ids (revealed only to the
            # model node once it holds >= k cloves)
            "reply": [(p.proxy_id, p.path_id.hex()) for p in chosen],
        }
        if extra_meta:
            payload.update(extra_meta)
        blob = _encode(payload)
        cloves = sida.make_cloves(blob, self.sida_n, self.sida_k)
        # random bucket key so concurrent requests at a model node cannot
        # mix cloves; carries no sender identity
        msg_key = os.urandom(8).hex()
        for p, c in zip(chosen, cloves):
            net.send(self.node_id, _route_next(self, p.path_id),
                     {"type": "clove_fwd", "path_id": p.path_id.hex(),
                      "dest_model": model_id, "clove": c.encode(),
                      "msg_key": msg_key, "dir": "out"},
                     size_bytes=len(c.frag) + 128)
        self.stats["sent"] += 1
        return msg_id

    def _affinity_entry(self, tokens, llm: str):
        """Entry node remembered for this prompt's leading block, if it is
        still in the model list (None -> caller falls back to random)."""
        dg = _leading_digest(tokens)
        target = self._prefix_servers.get(dg) if dg else None
        if target is None:
            return None
        if any(r.node_id == target and (not llm or r.llm == llm)
               for r in self.model_list):
            return target
        self._prefix_servers.pop(dg, None)       # server left the overlay
        return None

    def _learn_prefix_server(self, payload: dict):
        dg = _leading_digest(payload.get("prompt") or [])
        if dg is None or payload.get("server") is None:
            return
        self._prefix_servers.pop(dg, None)       # refresh LRU position
        self._prefix_servers[dg] = payload["server"]
        while len(self._prefix_servers) > self.prefix_affinity_cap:
            self._prefix_servers.pop(next(iter(self._prefix_servers)))

    def _pick_disjoint(self, paths: list, n: int) -> list:
        """Greedy relay-disjoint path selection: a single relay failure
        should cost at most one clove (the point of path diversity)."""
        order = self.rng.sample(paths, len(paths))
        chosen, used = [], set()
        for p in order:
            if not (set(p.relays) & used):
                chosen.append(p)
                used |= set(p.relays)
            if len(chosen) == n:
                return chosen
        for p in order:  # fill remaining slots even if overlapping
            if p not in chosen:
                chosen.append(p)
            if len(chosen) == n:
                break
        return chosen

    # ------------------------------------------------------------------
    # message handling (relay + endpoint duties)
    # ------------------------------------------------------------------
    def on_message(self, net, src, msg):
        mt = msg["type"]
        if mt == "onion_create":
            self._handle_onion_create(net, src, msg)
        elif mt == "onion_create_fast":
            self._handle_onion_create_fast(net, src, msg)
        elif mt == "proxy_ack":
            for p in self.paths:
                if p.path_id.hex() == msg["path_id"]:
                    p.established = True
        elif mt == "clove_fwd":
            self._relay_clove(net, src, msg)
        elif mt == "response_clove":
            self._handle_response_clove(net, src, msg)

    def _handle_onion_create(self, net, src, msg):
        try:
            pid, pred, succ, inner, payload = onion.peel_establishment(
                msg["blob"], self.dh_sk)
        except Exception:
            return
        self.relay.install(pid, pred, succ)
        if succ is None:
            # we are the proxy: ack travels the reverse path
            net.send(self.node_id, pred,
                     {"type": "response_clove", "path_id": pid.hex(),
                      "ack": True}, 64)
        else:
            net.send(self.node_id, succ, {"type": "onion_create",
                                          "blob": inner}, len(inner))

    def _handle_onion_create_fast(self, net, src, msg):
        pid = msg["path_id"]
        chain = msg["chain"]
        hop = msg["hop"]
        pred = msg["origin"] if hop == 0 else chain[hop - 1]
        succ = chain[hop + 1] if hop + 1 < len(chain) else None
        self.relay.install(pid, pred, succ)
        if succ is None:
            net.send(self.node_id, pred,
                     {"type": "response_clove", "path_id": pid.hex(),
                      "ack": True}, 64)
        else:
            net.send(self.node_id, succ, {**msg, "hop": hop + 1}, 256)

    def _relay_clove(self, net, src, msg):
        pid = bytes.fromhex(msg["path_id"])
        nxt = self.relay.next_hop(pid, src)
        if nxt is None:
            # we are the proxy for this path: hand to the model node
            net.send(self.node_id, msg["dest_model"],
                     {"type": "prompt_clove", "clove": msg["clove"],
                      "msg_key": msg.get("msg_key"),
                      "proxy": self.node_id},
                     size_bytes=len(msg["clove"]) + 64)
        else:
            net.send(self.node_id, nxt, msg,
                     size_bytes=len(msg["clove"]) + 64)

    def _handle_response_clove(self, net, src, msg):
        pid = bytes.fromhex(msg["path_id"])
        if msg.get("ack"):
            route = self.relay.next_hop(pid, src)
            if route is not None:
                net.send(self.node_id, route, msg, 64)
                return
            for p in self.paths:
                if p.path_id == pid:
                    p.established = True
            return
        nxt = self.relay.next_hop(pid, src)
        if nxt is not None and not any(p.path_id == pid for p in self.paths):
            net.send(self.node_id, nxt, msg,
                     size_bytes=len(msg["clove"]) + 64)
            return
        # we are the requesting user: collect cloves
        clove = sida.Clove.decode(msg["clove"])
        msg_id = msg["msg_id"]
        pend = self._inbox.setdefault(msg_id, PendingMsg())
        if pend.done:
            return
        pend.cloves[clove.index] = clove
        if len(pend.cloves) >= clove.k:
            try:
                blob = sida.recover(list(pend.cloves.values()))
            except Exception:
                return
            pend.done = True
            payload = _decode(blob)
            self.stats["recovered"] += 1
            if payload.get("session"):
                self.sessions[payload["session"]] = payload["server"]
            self._learn_prefix_server(payload)
            if self.on_response:
                self.on_response(net, payload)


def _leading_digest(tokens):
    """Chain digest of the first BLOCK of ``tokens`` (None if shorter) —
    the key under which a user remembers which model node served a
    prompt family.  Same digest function the serving caches index by;
    only the first block is hashed, since deeper digests are unused."""
    h = _chain_hashes(tokens[:BLOCK])
    return h[0] if h else None


def _route_next(user: "UserNode", path_id: bytes):
    nxt = user.relay.next_hop(path_id, None)
    if nxt is not None:
        return nxt
    for p in user.paths:
        if p.path_id == path_id:
            return p.first_hop
    raise KeyError("unknown path")


def _encode(obj) -> bytes:
    return packb(obj)


def _decode(blob: bytes):
    return unpackb(blob)
