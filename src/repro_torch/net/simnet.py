"""Deterministic discrete-event network simulator (own copy of
``repro/net/simnet.py``).

The paper's testbed injects 100 ms of synthetic delay per packet on a real
cloud; we reproduce that regime deterministically: every node is an object
with ``on_message(net, src, msg)``, links have latency + bandwidth, nodes
can churn (``ChurnProcess``: leave and rejoin).  Time is simulated
seconds; the same overlay code also runs over the localhost TCP transport
(``net/tcp.py``).  A message's delay includes its size over the
bandwidth, so the size of what the overlay sends sets the order of
events.
"""
from __future__ import annotations

import heapq
import itertools
import random
from dataclasses import dataclass, field
from typing import Callable


@dataclass(order=True)
class _Event:
    t: float
    seq: int
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())


class SimNet:
    def __init__(self, default_latency: float = 0.1,
                 bandwidth_bps: float = 1e9, seed: int = 0):
        self.t = 0.0
        self._heap: list[_Event] = []
        self._seq = itertools.count()
        self.nodes: dict = {}
        self.default_latency = default_latency
        self.bandwidth = bandwidth_bps
        self.latency_overrides: dict = {}     # (src,dst) -> seconds
        self.rng = random.Random(seed)
        self.delivered = 0
        self.dropped = 0

    # ---- topology ----
    def add_node(self, node_id, handler):
        self.nodes[node_id] = handler

    def remove_node(self, node_id):
        self.nodes.pop(node_id, None)

    def alive(self, node_id) -> bool:
        return node_id in self.nodes

    def latency(self, src, dst) -> float:
        return self.latency_overrides.get((src, dst), self.default_latency)

    # ---- events ----
    def call_at(self, t: float, fn, *args):
        heapq.heappush(self._heap, _Event(t, next(self._seq), fn, args))

    def call_after(self, dt: float, fn, *args):
        self.call_at(self.t + dt, fn, *args)

    def send(self, src, dst, msg, size_bytes: int = 1024):
        """Schedule delivery of msg to dst's handler."""
        if dst not in self.nodes:
            self.dropped += 1
            return
        delay = self.latency(src, dst) + size_bytes / self.bandwidth
        self.call_after(delay, self._deliver, src, dst, msg)

    def _deliver(self, src, dst, msg):
        h = self.nodes.get(dst)
        if h is None:
            self.dropped += 1
            return
        self.delivered += 1
        h.on_message(self, src, msg)

    # ---- run loop ----
    def run_until(self, t_end: float):
        while self._heap and self._heap[0].t <= t_end:
            ev = heapq.heappop(self._heap)
            self.t = ev.t
            ev.fn(*ev.args)
        self.t = max(self.t, t_end)

    def run(self, max_events: int = 10_000_000):
        n = 0
        while self._heap and n < max_events:
            ev = heapq.heappop(self._heap)
            self.t = ev.t
            ev.fn(*ev.args)
            n += 1


class ChurnProcess:
    """Poisson churn: random user nodes leave / (re)join at ``rate`` per min."""

    def __init__(self, net: SimNet, pool: list, rate_per_min: float,
                 on_leave=None, on_join=None, seed: int = 1):
        self.net = net
        self.pool = pool
        self.rate = rate_per_min / 60.0
        self.rng = random.Random(seed)
        self.on_leave = on_leave
        self.on_join = on_join
        self.offline: dict = {}      # node_id -> saved handler

    def start(self):
        self.net.call_after(self._next_dt(), self._tick)

    def _next_dt(self) -> float:
        return self.rng.expovariate(self.rate) if self.rate > 0 else 1e18

    def _tick(self):
        if self.offline and self.rng.random() < 0.5:
            nid = self.rng.choice(list(self.offline))
            handler = self.offline.pop(nid)
            self.net.add_node(nid, handler)   # node rejoins the overlay
            if self.on_join:
                self.on_join(nid)
        elif self.pool:
            nid = self.pool[self.rng.randrange(len(self.pool))]
            if self.net.alive(nid):
                handler = self.net.nodes[nid]
                self.net.remove_node(nid)
                self.offline[nid] = handler
                if self.on_leave:
                    self.on_leave(nid)
        self.net.call_after(self._next_dt(), self._tick)
