"""Model node: serving engine + HR-tree state sync + overlay forwarding
(§3.3, Fig 5) + signed responses (§3.4); port of
``repro/overlay/model_node.py``, same behaviour, with the hooks of the
dishonest-node experiments: ``behaviour`` (``honest``, ``swap_model`` or
``drop``: a ``drop`` node observes a prompt and never answers it;
``swap_model`` is a label only, as in the reference, and serves honestly)
and ``respond_fn`` (tokens -> output tokens, in place of the engine: a
node that answers with another model).

On receiving >= k prompt cloves it recovers the request, runs Algorithm 2
(sketch affinity or replication, else HR-tree match -> cache-affinity
pick, else least-relative-load), serves or forwards, and returns the
response as S-IDA cloves through the user's proxies, each clove carrying
the node's Ed25519 signature over the encoded response when
``use_crypto`` is on (the default).  Every ``sync_every`` sim-seconds it
broadcasts its cached-prefix hash paths, its prefix sketch and its load
to the group.  A real engine serves through the port's
batched ``Scheduler``; the node's HR-tree hashes prompts on the engine's
device (the chunk-hash kernel on the card), or on ``device`` when no real
engine is attached.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import ed25519, hrtree, sentry, sida
from repro_torch.core.forwarding import ForwardingConfig, PeerInfo, decide
from repro_torch.net.wire import packb, unpackb
from repro_torch.overlay.replicator import Replicator
from repro_torch.serving.engine import LatencyEngine, LatencyEngineConfig, Request
from repro_torch.serving.page_pool import PagedHandle
from repro_torch.serving.scheduler import Scheduler


@dataclass
class PendingRequest:
    cloves: dict = field(default_factory=dict)
    done: bool = False


class ModelNode:
    def __init__(self, node_id, llm: str = "llm", hw_score: float = 5.0,
                 engine: Optional[LatencyEngine] = None,
                 fwd_cfg: ForwardingConfig = ForwardingConfig(),
                 chunk_lengths=(64,), sync_every: float = 5.0,
                 real_engine=None, use_crypto: bool = True,
                 behaviour: str = "honest", kv_chunk_bytes: int = 1 << 16,
                 kv_fetch_timeout: float = 30.0, device="cuda"):
        self.node_id = node_id
        self.llm = llm
        self.hw_score = hw_score
        self.engine = engine or LatencyEngine(
            LatencyEngineConfig(hw_score=hw_score))
        self.real_engine = real_engine      # optional port RealEngine
        # real-engine requests go through the slot-pool batched scheduler:
        # submitted at admission (_serve), drained at completion (_finish),
        # so requests overlapping on the sim clock share decode dispatches
        self._real_sched = None
        self._real_rid = itertools.count(1)
        self._rid_by_msg: dict = {}
        self._real_results: dict = {}
        self.fwd_cfg = fwd_cfg
        self.sync_every = sync_every
        self.use_crypto = use_crypto
        self.behaviour = behaviour          # honest | swap_model | drop
        # ablations (Fig 16): full = HR-tree + load balance, lb_only = load
        # balance without the HR-tree, none = always serve locally
        self.fwd_mode = "full"
        if use_crypto:
            self.sign_key = ed25519.SigningKey()
            self.public = self.sign_key.public
        else:
            self.sign_key, self.public = None, bytes(32)
        self.sentry = sentry.Sentry()
        self.lengths = list(chunk_lengths)
        self.hrtree = hrtree.HRTree(
            self.lengths,
            device=real_engine.device if real_engine is not None else device)
        self.peers: dict = {}               # node_id -> PeerInfo
        self.group: list = []               # group member ids
        self._pending: dict = {}
        self._recent_prompts: list = []     # token streams for sync
        self.active_requests = 0
        self.metrics = {"served": 0, "forwarded_in": 0, "forwarded_out": 0,
                        "cache_hits": 0, "affinity_hits": 0,
                        "ttft": [], "total": [],
                        "cached_tokens": 0, "prompt_tokens": 0,
                        # cross-node KV page migration
                        "replicate_routes": 0,     # decide() chose replicate
                        "kv_fetches": 0,           # kv_fetch messages sent
                        "kv_fetch_piggybacks": 0,  # requests joining a fetch
                        "kv_imported_pages": 0,
                        "kv_refusals": 0,          # holder said no
                        "kv_import_failures": 0,   # local OutOfPages
                        "kv_timeouts": 0,
                        "kv_fallbacks": 0,         # requests that prefilled
                        "kv_wire_bytes": 0,        # payload bytes received
                        "kv_exports": 0,           # fetches served as holder
                        "kv_export_refused": 0}
        self.kv_chunk_bytes = kv_chunk_bytes
        self.replicator = Replicator(self, timeout_s=kv_fetch_timeout)
        self.respond_fn = None              # (tokens)->(out_tokens) override

    # ------------------------------------------------------------------
    def join_group(self, members: list):
        self.group = [m for m in members]
        for m in self.group:
            if m != self.node_id:
                self.peers.setdefault(m, PeerInfo(m))
        self.peers[self.node_id] = PeerInfo(self.node_id, self.hw_score)

    def start(self, net):
        net.call_after(self.sync_every * (0.5 + random.random() * 0.5),
                       self._sync_tick, net)

    # ------------------------------------------------------------------
    # state synchronization (§3.3)
    # ------------------------------------------------------------------
    def _sync_tick(self, net):
        self.broadcast_state(net)
        net.call_after(self.sync_every, self._sync_tick, net)

    def broadcast_state(self, net):
        # every recent prompt hashed in one launch on the tree's device
        paths = [h for h in hrtree.preprocess_batch(
            self._recent_prompts[-64:], self.lengths, device=self.hrtree.device) if h]
        sketch = self._prefix_sketch()
        msg = {"type": "hr_sync", "from": self.node_id,
               "paths": paths,
               "active": self.active_requests,
               "hw": self.hw_score,
               "kv_usage": self.engine.prefix_cache.used_bytes
               if self.engine else 0,
               # paged real engine: free-page pressure (fraction of the KV
               # arena in use) — a truer admission signal than slot count,
               # since memory, not rows, is what blocks admission
               "kv_pressure": self._kv_pressure(),
               # speculative-decode accept rate of this node's engine
               "spec_accept_rate": self._spec_accept_rate(),
               # block-digest bloom over the serving cache: peers route
               # sibling requests to the deepest sketch hit (prefix
               # affinity) instead of re-prefilling on a load-picked node
               "sketch": sketch}
        size = 32 + sum(len(p) for p in paths) + len(sketch)
        for m in self.group:
            if m != self.node_id:
                net.send(self.node_id, m, msg, size_bytes=size)
        # local view of self
        self.hrtree.merge_paths(paths, self.node_id)
        me = self.peers[self.node_id]
        me.active_requests = self.active_requests
        me.hw_score = self.hw_score
        me.kv_pressure = self._kv_pressure()
        me.spec_accept_rate = self._spec_accept_rate()
        me.prefix_sketch = sketch

    def _prefix_sketch(self) -> bytes:
        """Serialized PrefixSketch over the serving prefix cache.  A real
        engine's cache is the physical truth (its pages are what admission
        aliases); the latency model's cache mirrors served prompts."""
        pc = (self.real_engine.prefix_cache if self.real_engine is not None
              else self.engine.prefix_cache if self.engine else None)
        return pc.sketch_bytes() if pc is not None else b""

    def _kv_pressure(self) -> float:
        """Fraction of the paged KV arena in use (0 when no paged real
        engine is attached — the latency model has no physical pool)."""
        eng = self.real_engine
        if eng is None or not getattr(eng, "paged", False):
            return 0.0
        alloc = eng.allocator
        return alloc.used_count / max(1, alloc.num_pages - 1)

    def _spec_accept_rate(self) -> float:
        """Speculative-draft accept fraction of the attached real engine
        (0 when there is none, or it has not drafted yet)."""
        eng = self.real_engine
        if eng is None:
            return 0.0
        return getattr(eng, "spec_accept_rate", 0.0)

    def _handle_sync(self, net, msg):
        nid = msg["from"]
        p = self.peers.setdefault(nid, PeerInfo(nid))
        p.active_requests = msg["active"]
        p.hw_score = msg["hw"]
        p.kv_usage = msg.get("kv_usage", 0)
        p.kv_pressure = msg.get("kv_pressure", 0.0)
        p.spec_accept_rate = msg.get("spec_accept_rate", 0.0)
        p.prefix_sketch = msg.get("sketch") or None
        self.hrtree.merge_paths(msg["paths"], nid)

    # ------------------------------------------------------------------
    # cross-node KV page migration: holder side
    # ------------------------------------------------------------------
    def _handle_kv_fetch(self, net, msg):
        """A peer asks for the prefix pages behind a digest chain.

        Serve the deepest covered prefix as a chunked ``kv_pages`` stream
        (export is read-only: refcounts and LRU order are untouched, so
        shipping never blocks local serving).  Refuse when the entry was
        evicted since the sketch broadcast that attracted the fetch, or
        when this node's own arena pressure says the entry is about to go
        — the fetcher then falls back to plain prefill."""
        src, fid = msg["from"], msg["fetch_id"]
        eng = self.real_engine
        chains = [bytes(c) for c in msg["chains"]]
        depth = min(int(msg["depth"]), len(chains))
        entry, d_cov = None, 0
        if (eng is not None and getattr(eng, "paged", False)
                and self._kv_pressure() <= self.fwd_cfg.export_pressure_max):
            for d in range(depth, 0, -1):
                e = eng.prefix_cache.entry_by_chain(chains[d - 1])
                if (e is not None and isinstance(e.handle, PagedHandle)
                        and e.length >= d * eng.block
                        and len(e.handle.pages) >= d):
                    entry, d_cov = e, d
                    break
        if entry is None:
            self.metrics["kv_export_refused"] += 1
            net.send(self.node_id, src,
                     {"type": "kv_pages", "from": self.node_id,
                      "fetch_id": fid, "ok": False}, size_bytes=64)
            return
        blob = packb(eng.export_pages(entry.handle, depth=d_cov))
        step = max(1, int(self.kv_chunk_bytes))
        chunks = [blob[i:i + step] for i in range(0, len(blob), step)]
        for seq, data in enumerate(chunks):
            net.send(self.node_id, src,
                     {"type": "kv_pages", "from": self.node_id,
                      "fetch_id": fid, "ok": True, "seq": seq,
                      "total": len(chunks), "depth": d_cov, "data": data},
                     size_bytes=len(data) + 96)
        self.metrics["kv_exports"] += 1

    # ------------------------------------------------------------------
    # request path
    # ------------------------------------------------------------------
    def on_message(self, net, src, msg):
        mt = msg["type"]
        if mt == "prompt_clove":
            self._handle_clove(net, msg)
        elif mt == "hr_sync":
            self._handle_sync(net, msg)
        elif mt == "fwd_request":
            self.metrics["forwarded_in"] += 1
            hint = None
            if msg.get("kv_holder") is not None and msg.get("kv_depth"):
                hint = (msg["kv_holder"], int(msg["kv_depth"]))
            self._process(net, unpackb(msg["payload"]), forwarded=True,
                          fetch_hint=hint)
        elif mt == "kv_fetch":
            self._handle_kv_fetch(net, msg)
        elif mt == "kv_pages":
            self.replicator.on_pages(net, msg)

    def _handle_clove(self, net, msg):
        clove = sida.Clove.decode(msg["clove"])
        # cloves of one message share identical metadata once decoded, so
        # the pending buckets are keyed by the proxy-announced message
        # digest when present, else by (n, k, fragment length)
        key = msg.get("msg_key") or (clove.n, clove.k, len(clove.frag))
        pend = self._pending.setdefault(key, PendingRequest())
        if pend.done:
            return
        pend.cloves[clove.index] = clove
        if len(pend.cloves) >= clove.k:
            try:
                blob = sida.recover(list(pend.cloves.values()))
            except Exception:
                return
            pend.done = True
            self._process(net, unpackb(blob))

    def _process(self, net, payload: dict, forwarded: bool = False,
                 fetch_hint=None):
        """``fetch_hint`` = (holder_id, depth): pull that many blocks of
        prefix pages from the holder before serving (set by a replicate-
        routed fwd_request, or locally when decide() picks self as the
        replication target)."""
        tokens = payload["prompt"]
        self.sentry.observe(tokens)
        if self.behaviour == "drop":
            return
        if not forwarded and self.fwd_mode != "none":
            if self.fwd_mode == "full":
                tree, cfg = self.hrtree, self.fwd_cfg
            else:   # lb_only ablation: no HR-tree AND no sketch affinity
                tree = hrtree.HRTree(self.lengths, device=self.hrtree.device)
                cfg = dataclasses.replace(self.fwd_cfg, affinity=False)
            d = decide(cfg, tree, self.peers, tokens,
                       self_id=self.node_id,
                       n_out=int(payload.get("max_new", 64)))
            if d.reason in ("cache_hit", "affinity"):
                self.metrics["cache_hits"] += 1
            if d.reason == "affinity":
                self.metrics["affinity_hits"] += 1
            if d.reason == "replicate":
                self.metrics["replicate_routes"] += 1
                fetch_hint = (d.fetch_from, d.depth)
            if d.target is not None and d.target != self.node_id:
                self.metrics["forwarded_out"] += 1
                # optimistic load echo: count the in-flight forward against
                # the target's stale sync view so back-to-back arrivals
                # between sync ticks don't all herd onto the same peer
                # (the next hr_sync overwrites this with ground truth)
                if d.target in self.peers:
                    self.peers[d.target].active_requests += 1
                msg = {"type": "fwd_request", "payload": packb(payload)}
                if d.reason == "replicate":
                    msg["kv_holder"] = d.fetch_from
                    msg["kv_depth"] = int(d.depth)
                net.send(self.node_id, d.target, msg,
                         size_bytes=len(tokens) * 2 + 128)
                return
        if fetch_hint is not None and self.replicator.request(
                net, payload, fetch_hint[0], fetch_hint[1]):
            return      # served once the pages land (or the fetch fails)
        self._serve(net, payload)

    def _serve(self, net, payload: dict):
        tokens = payload["prompt"]
        max_new = int(payload.get("max_new", 64))
        now = net.t
        self.active_requests += 1
        self.peers[self.node_id].active_requests = self.active_requests
        self.metrics["served"] += 1
        matched, _ = self.engine.prefix_cache.match(tokens)
        ttft, total = self.engine.service_times(
            len(tokens), matched, max_new, now)
        self.metrics["ttft"].append(ttft)
        self.metrics["total"].append(total)
        self.metrics["cached_tokens"] += matched
        self.metrics["prompt_tokens"] += len(tokens)
        self.engine.prefix_cache.insert(tokens, handle=None,
                                        nbytes=len(tokens) * 1024)
        self._recent_prompts.append(list(tokens))
        if len(self._recent_prompts) > 512:
            self._recent_prompts = self._recent_prompts[-256:]
        if self.real_engine is not None and self.respond_fn is None:
            self._submit_real(payload, max_new)
        net.call_after(total, self._finish, net, payload, max_new)

    # ---- real-engine path: slot-pool continuous batching ----
    def _submit_real(self, payload: dict, n_out: int):
        if self._real_sched is None:
            self._real_sched = Scheduler(self.real_engine, max_active=4)
        rid = next(self._real_rid)
        self._rid_by_msg[payload["msg_id"]] = rid
        self._real_sched.submit(
            Request(rid, payload["prompt"], max_new=min(n_out, 16)))

    def _drain_real(self, rid: int) -> list:
        sched = self._real_sched
        while rid not in self._real_results and (sched.queue or sched.active):
            sched.step()
            for r in sched.done:
                self._real_results[r.req_id] = r.output
            sched.done.clear()
        return self._real_results.pop(rid, [])

    def _finish(self, net, payload: dict, n_out: int):
        self.active_requests = max(0, self.active_requests - 1)
        self.peers[self.node_id].active_requests = self.active_requests
        rid = self._rid_by_msg.pop(payload["msg_id"], None)
        if self.respond_fn is not None:
            if rid is not None:     # set while in flight: retire the engine's
                self._drain_real(rid)           # request so it cannot linger
            out = list(self.respond_fn(payload["prompt"]))
        elif self.real_engine is not None:
            if rid is None:         # unset while in flight: the engine serves it now
                self._submit_real(payload, n_out)
                rid = self._rid_by_msg.pop(payload["msg_id"])
            out = self._drain_real(rid)
        else:
            out = [int(x) % 1000 for x in range(n_out)]
        resp = {"msg_id": payload["msg_id"],
                "session": payload.get("session"),
                "server": self.node_id,
                "output": out,
                "prompt": payload["prompt"]}  # echoed (anti-counterfeit §4.4)
        blob = packb(resp)
        if self.use_crypto and self.sign_key is not None:
            resp_sig = self.sign_key.sign(blob)
        else:
            resp_sig = b""
        reply = payload.get("reply", [])
        n = max(len(reply), 1)
        k = max(1, min(len(reply), n - 1)) if n > 1 else 1
        cloves = sida.make_cloves(blob, n, k) if reply else []
        for (proxy_id, pid_hex), c in zip(reply, cloves):
            net.send(self.node_id, proxy_id,
                     {"type": "response_clove", "path_id": pid_hex,
                      "clove": c.encode(), "msg_id": payload["msg_id"],
                      "sig": resp_sig.hex()},
                     size_bytes=len(c.frag) + 96)
