"""Pull-based cross-node KV page replication (the overlay half of page
migration; the arena half is serving/engine.export_pages/import_pages).
Own copy of ``repro/overlay/replicator.py`` on the port's wire codec.

When ``decide()`` finds the deepest prefix holder vetoed by memory or
load pressure it routes the request to a peer that CAN host it, with a
fetch hint naming the holder and hit depth.  This module is that peer's
state machine: it sends one ``kv_fetch`` (digest chain + depth) per
distinct prefix, reassembles the holder's chunked ``kv_pages`` stream,
imports the pages, and only then serves the request — which now admits
with a local prefix hit and zero prefill dispatches for the replicated
blocks.  Requests for a prefix whose fetch is already in flight piggyback
on it instead of fetching again.

Replication is an optimization, never a correctness dependency: a
refusal (holder evicted the entry, or is under its own export-pressure
gate), an ``OutOfPages`` on import, or a timeout all fall back to plain
prefill of the same request.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.net.wire import unpackb
from repro_torch.serving.page_pool import OutOfPages
from repro_torch.serving.prefix_cache import _chain_hashes


@dataclass
class _Fetch:
    chains: list               # leading digests, chains[i] keys blocks 0..i
    depth: int                 # blocks requested
    holder: object
    waiters: list = field(default_factory=list)   # payloads served on finish
    chunks: dict = field(default_factory=dict)    # seq -> bytes
    total: int = -1
    done: bool = False


class Replicator:
    def __init__(self, node, timeout_s: float = 30.0):
        self.node = node
        self.timeout_s = timeout_s
        self._fid = itertools.count(1)
        self._fetches: dict = {}       # fetch_id -> _Fetch
        self._by_key: dict = {}        # chain digest -> in-flight fetch_id

    # ------------------------------------------------------------------
    def request(self, net, payload: dict, holder, depth: int) -> bool:
        """Pull ``depth`` blocks of the request's prefix from ``holder``
        before serving.  Returns True when this state machine took the
        request (it WILL be served on completion or fallback); False when
        there is nothing to fetch — caller serves immediately."""
        node = self.node
        eng = node.real_engine
        if eng is None or not getattr(eng, "paged", False):
            return False
        toks = [int(t) for t in payload["prompt"]]
        depth = min(int(depth), len(toks) // eng.block)
        if depth < 1 or holder == node.node_id:
            return False
        prefix = toks[:depth * eng.block]
        matched, _ = eng.prefix_cache.peek(prefix)
        if matched >= depth * eng.block:
            return False               # an earlier fetch already landed it
        chains = _chain_hashes(prefix, eng.block)[:depth]
        # dedupe across DEPTHS too: every depth of an in-flight fetch is
        # keyed, so a deeper or shallower hint for the same prefix
        # piggybacks (deepest shared digest wins) instead of re-shipping
        # the pages the first fetch already has on the wire
        for c in reversed(chains):
            fid = self._by_key.get(c)
            if fid is not None and fid in self._fetches:
                self._fetches[fid].waiters.append(payload)
                node.metrics["kv_fetch_piggybacks"] += 1
                self._park(1)
                return True
        fid = next(self._fid)
        self._fetches[fid] = _Fetch(chains, depth, holder, [payload])
        for c in chains:
            self._by_key[c] = fid
        node.metrics["kv_fetches"] += 1
        self._park(1)
        net.send(node.node_id, holder,
                 {"type": "kv_fetch", "from": node.node_id,
                  "fetch_id": fid, "chains": chains, "depth": depth},
                 size_bytes=64 + 16 * len(chains))
        net.call_after(self.timeout_s, self._timeout, net, fid)
        return True

    def _park(self, n: int):
        """Count parked requests as active load: a fetch window can span
        seconds, and an hr_sync broadcasting active=0 meanwhile would
        keep attracting siblings onto the very node that is still
        waiting for the pages (the burst the load veto exists to stop).
        ``_serve`` re-increments when the waiter actually admits."""
        node = self.node
        node.active_requests = max(0, node.active_requests + n)
        me = node.peers.get(node.node_id)
        if me is not None:
            me.active_requests = node.active_requests

    # ------------------------------------------------------------------
    def on_pages(self, net, msg: dict):
        """One ``kv_pages`` chunk (or refusal) from the holder."""
        f = self._fetches.get(msg["fetch_id"])
        if f is None or f.done:
            return                     # late chunk after timeout/refusal
        node = self.node
        if not msg.get("ok"):
            node.metrics["kv_refusals"] += 1
            self._finish(net, msg["fetch_id"], imported=False)
            return
        f.chunks[int(msg["seq"])] = bytes(msg["data"])
        f.total = int(msg["total"])
        node.metrics["kv_wire_bytes"] += len(msg["data"])
        if len(f.chunks) < f.total:
            return
        # what a peer's bytes or a full arena can cause — OutOfPages, a
        # truncated/garbled blob from a byzantine or version-skewed holder,
        # a shape mismatch — degrades to plain prefill (import_pages
        # releases its pages on the way out); a device fault propagates
        try:
            buf = unpackb(b"".join(f.chunks[i] for i in range(f.total)))
            # the holder may cover fewer blocks than requested (partial
            # eviction since the sketch broadcast): import what arrived
            depth = min(int(msg.get("depth", f.depth)), f.depth)
            n_pages = int(buf["n_pages"])
            self.node.real_engine.import_pages(buf, f.chains[:depth])
        except (OutOfPages, ValueError, KeyError, TypeError):
            node.metrics["kv_import_failures"] += 1
            self._finish(net, msg["fetch_id"], imported=False)
            return
        node.metrics["kv_imported_pages"] += n_pages
        self._finish(net, msg["fetch_id"], imported=True)

    # ------------------------------------------------------------------
    def _timeout(self, net, fid: int):
        f = self._fetches.get(fid)
        if f is not None and not f.done:
            self.node.metrics["kv_timeouts"] += 1
            self._finish(net, fid, imported=False)

    def _finish(self, net, fid: int, imported: bool):
        f = self._fetches.pop(fid)
        f.done = True
        for c in f.chains:
            if self._by_key.get(c) == fid:
                self._by_key.pop(c)
        if not imported:
            self.node.metrics["kv_fallbacks"] += len(f.waiters)
        self._park(-len(f.waiters))    # _serve re-counts each admission
        for payload in f.waiters:      # admission now aliases the
            self.node._serve(net, payload)   # imported pages (or prefills)
