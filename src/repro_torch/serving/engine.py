"""Per-node LLM serving engines (port of ``repro/serving/engine.py``).

``RealEngine`` serves a port model; ``LatencyEngine`` is the reference's
calibrated cost model on the simulated clock, which a ``ModelNode`` keeps
for its service times.

A pure-attention model is served from a node-wide per-layer page arena
(``models/lm.py`` ``paged_arena_zeros``) plus per-request page tables: a
prefix-cache hit *aliases* the holder's pages with a refcount bump
(``serving/page_pool``) instead of copying KV, so admission is O(suffix)
and KV memory scales with live tokens.  A model with recurrent mixers
(Mamba), or any model with ``paged=False``, keeps the dense path: a
request's state is a batch-1 dense cache (``LM.prefill`` / ``LM.decode``),
admitted by a short boot prefill and a teacher-forced decode per prompt
token, and the scheduler's pool is one dense cache with a row per slot.
Arena and caches are updated in place by every dispatch, so a prefix-cache
entry is decoded from a copy and never changes.  Pages migrate between
nodes through ``export_pages`` (a read-only gather into a wire buffer) and
``import_pages`` (a scatter, in place, into freshly allocated pages).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.models.lm import arena_gather_pages, arena_scatter_pages, cache_copy
from repro_torch.serving.page_pool import OutOfPages, PageAllocator, PagedHandle
from repro_torch.serving.prefix_cache import BLOCK, PrefixCache
from repro_torch.training.compression import compress_kv_blocks, decompress_kv_blocks


@dataclass
class Request:
    req_id: int
    tokens: list
    max_new: int = 32
    eos_id: int = -1
    session: Optional[str] = None
    arrival: float = 0.0


@dataclass
class Result:
    req_id: int
    output: list
    ttft: float = 0.0
    total: float = 0.0
    cached_tokens: int = 0
    prompt_tokens: int = 0


class NgramDrafter:
    """Self-speculative prompt-lookup drafter (no draft model).

    Indexes every n-gram (n <= ``max_n``) of a request's prompt plus its
    committed generation, mapping it to the position right after its most
    recent occurrence that has a continuation.  ``draft(k)`` matches the
    longest indexed suffix of the context and proposes the k tokens that
    followed it last time; deterministic, so speculative decode stays
    token-identical to greedy decoding (drafts are accepted only when they
    equal the model's own argmax)."""

    __slots__ = ("tokens", "index", "max_n")

    def __init__(self, tokens, max_n: int = 3):
        self.tokens: list = []
        self.index: dict = {}
        self.max_n = max_n
        self.extend(tokens)

    def extend(self, toks):
        """Append committed tokens, indexing n-grams as they gain a
        continuation."""
        for t in toks:
            pos = len(self.tokens)
            for n in range(1, self.max_n + 1):
                if pos >= n:
                    self.index[tuple(self.tokens[pos - n:pos])] = pos
            self.tokens.append(int(t))

    def draft(self, k: int) -> list:
        """Up to ``k`` proposed continuation tokens (empty on no match)."""
        if k <= 0:
            return []
        for n in range(min(self.max_n, len(self.tokens)), 0, -1):
            cont = self.index.get(tuple(self.tokens[-n:]))
            if cont is not None:
                return self.tokens[cont:cont + k]
        return []


@dataclass
class PrefillState:
    """Slot-ready request state positioned at ``pos`` with the logits of
    the last prompt token (a (1, padded_vocab) device tensor).  Dense
    engines carry a batch-1 cache in ``cache``; paged engines carry the
    request's physical pages in ``pages`` (the KV lives in the arena)."""
    logits: torch.Tensor
    pos: int
    matched: int        # prefix-cache tokens reused
    pages: Optional[list] = None
    cache: object = None


class RealEngine:
    def __init__(self, cfg, model, params, cache_bytes: int = 1 << 30,
                 max_len: int = 1024, paged: Optional[bool] = None,
                 num_pages: Optional[int] = None, device="cuda"):
        self.device = require_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model on {model.device}, engine on {self.device}")
        self.cfg = cfg
        self.model = model
        self.params = params
        self.max_len = max_len
        self.prefix_cache = PrefixCache(cache_bytes)
        # partial-prefix reuse needs a slot per position (attention KV); a
        # recurrent state summarises the whole stream and cannot be cut
        self.partial_reuse = all(s.mixer == "attn" for s in cfg.pattern)
        self.batched_traces = 0           # input shapes seen by the pool decode
        self.batched_prefill_traces = 0   # ... by batched admission prefill
        self.prefill_dispatches = 0       # prefill_paged calls issued
        self.prefill_tokens = 0           # real (non-pad) tokens prefilled
        self.spec_traces = 0      # input shapes seen by the batched verify
        self.spec_dispatches = 0  # verify_paged dispatches issued
        self.spec_tokens = 0      # tokens committed by verify rounds
        self.spec_drafted = 0     # draft tokens proposed
        self.spec_accepted = 0    # draft tokens accepted (== model argmax)
        self.spec_draftless_rounds = 0  # rounds served by the one-token
                                        # pool decode (no slot drafted)
        # cross-node KV page migration counters (overlay Replicator)
        self.kv_exported_pages = 0   # pages shipped to fetching peers
        self.kv_imported_pages = 0   # pages scattered in from peers
        self.kv_export_events = 0
        self.kv_import_events = 0
        # wire codec for exported pages: fp16 halves f32 arenas; 16-bit
        # (bf16) arenas ship raw, where a cast to fp16 would save nothing
        # and overflow |v| > 65504 to inf
        self.kv_wire_mode = "fp16" if cfg.compute_dtype.itemsize == 4 else "raw"
        self.paged = (model.supports_paging() if paged is None
                      else bool(paged) and model.supports_paging())
        # speculation rolls back by position: paged pool only
        self.spec = bool(self.paged and cfg.spec_enabled and cfg.spec_k > 0)
        self.block = BLOCK
        # the scheduler (and dispatch-count tests) treat "the one batched
        # decode" under one name in both modes, as in the reference
        if not self.paged:
            self._decode_batched = self._traced("batched_traces",
                                                model.decode)
            return
        self.max_pages = -(-max_len // BLOCK)     # table width (ceil)
        # page 0 is scratch; the default arena fits ~16 max_len streams
        self.num_pages = num_pages or (1 + 16 * self.max_pages)
        self.allocator = PageAllocator(self.num_pages)
        self.arena = model.paged_arena_zeros(self.num_pages, BLOCK)
        self.page_bytes = sum(
            x.shape[0] * BLOCK * x.shape[3] * x.shape[4] * x.element_size()
            for layer in self.arena for x in layer.values())
        self.prefix_cache.on_release = \
            lambda h: self.allocator.decref(h.pages)

        self._prefill_paged = model.prefill_paged
        self._decode_paged = model.decode_paged
        self._prefill_paged_batched = self._traced("batched_prefill_traces",
                                                   model.prefill_paged)
        self._verify_paged_batched = self._traced("spec_traces",
                                                  model.verify_paged)
        self._decode_batched = self._traced("batched_traces",
                                            model.decode_paged)

    def _traced(self, counter: str, fn):
        """``fn`` counting, in ``counter``, the distinct input-shape
        signatures it is called with: the reference counts one jit trace
        per signature, so its "exactly one trace" checks carry over."""
        seen = set()

        def call(params, arena, *args):
            sig = tuple((tuple(a.shape), a.dtype) for a in args)
            if sig not in seen:
                seen.add(sig)
                setattr(self, counter, getattr(self, counter) + 1)
            return fn(params, arena, *args)
        return call

    @staticmethod
    def _cache_nbytes(cache) -> int:
        return sum(t.numel() * t.element_size()
                   for layer in cache for t in layer.values())

    def _query_paged(self, params, arena, pt, tok, pos):
        logits, _ = self.model.decode_paged(params, arena, pt, tok, pos,
                                            write=False)
        return logits

    def to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array as a new tensor on the engine's device."""
        return torch.tensor(a, device=self.device)

    @property
    def spec_accept_rate(self) -> float:
        """Fraction of proposed draft tokens the model accepted."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    # ------------------------------------------------------------------
    # page management (host side)
    # ------------------------------------------------------------------
    def alloc_pages(self, n: int = 1) -> list:
        """Allocate ``n`` pages, evicting LRU prefix-cache entries under
        pressure (their pages free once no live request aliases them)."""
        while True:
            try:
                return self.allocator.alloc(n)
            except OutOfPages:
                if not self.prefix_cache.pop_lru():
                    raise

    def release_pages(self, pages):
        self.allocator.decref(pages)

    def ensure_page_for(self, pages: list, pos: int):
        """Grow ``pages`` so the block holding position ``pos`` exists."""
        while len(pages) <= pos // self.block:
            pages.extend(self.alloc_pages(1))

    def page_table_row(self, pages) -> np.ndarray:
        """(1, max_pages) int32 page-table row; unallocated logical blocks
        point at the scratch page 0 and are masked by position."""
        row = np.zeros((1, self.max_pages), np.int32)
        row[0, :len(pages)] = pages
        return row

    def insert_prefix(self, full_tokens, pages):
        """Zero-copy prefix-cache insert: the entry holds page ids (one
        extra reference each), never KV bytes."""
        n_cov = len(full_tokens) // self.block
        if not n_cov:
            return
        covered = list(pages[:n_cov])
        self.allocator.incref(covered)
        handle = PagedHandle(tuple(covered), n_cov * self.block)
        self.prefix_cache.insert(full_tokens, handle, n_cov * self.page_bytes)

    def live_kv_bytes(self) -> int:
        """Physical KV footprint: pages in use x bytes per page (aliased
        pages counted once)."""
        return self.allocator.used_count * self.page_bytes

    # ------------------------------------------------------------------
    # cross-node page migration (overlay kv_fetch / kv_pages)
    # ------------------------------------------------------------------
    def export_pages(self, handle: PagedHandle, depth: Optional[int] = None,
                     mode: Optional[str] = None) -> dict:
        """Gather the first ``depth`` pages of a prefix entry out of the
        arena into a host-side wire buffer of bytes and ints (``mode``: the
        codec, ``kv_wire_mode`` by default), which the overlay msgpacks and
        chunks.  Read-only: no page is written and no refcount moves, so
        the holder keeps serving from (and may later evict) the same pages
        while a copy ships."""
        if not self.paged:
            raise ValueError("page export requires the paged pool")
        if depth is not None:
            handle = handle.prefix(depth, self.block)
        pages = list(handle.pages)
        if not pages:
            raise ValueError("empty page export")
        mode = mode or self.kv_wire_mode
        layers = [{n: compress_kv_blocks(layer[n], mode) for n in ("k", "v")}
                  for layer in arena_gather_pages(self.arena, pages)]
        self.kv_exported_pages += len(pages)
        self.kv_export_events += 1
        return {"n_pages": len(pages), "mode": mode, "layers": layers}

    def import_pages(self, buf: dict, chains: list) -> PagedHandle:
        """Allocate local pages, scatter a peer's exported K/V blocks into
        them, and register the prefix in the prefix cache under its BLOCK
        chain digests (``chains[i]`` keys blocks 0..i): the next admission
        aliases it as if this node had prefilled it.  Raises
        ``OutOfPages`` when the arena cannot host the pages even after LRU
        eviction, and ``ValueError``, ``KeyError`` or ``TypeError`` for a
        malformed buffer; either way the pages it allocated are released
        and the allocator is as before."""
        if not self.paged:
            raise ValueError("page import requires the paged pool")
        n = int(buf["n_pages"])
        chains = list(chains)[:n]
        if n < 1 or len(chains) < n:
            raise ValueError(f"import of {n} pages with {len(chains)} "
                             f"chain digests")
        pages = self.alloc_pages(n)
        try:
            blocks = tuple({name: decompress_kv_blocks(layer[name], self.cfg.compute_dtype,
                                                       self.device)
                            for name in ("k", "v")} for layer in buf["layers"])
            arena_scatter_pages(self.arena, pages, blocks)
        except BaseException:
            self.allocator.decref(pages)     # released, never registered
            raise
        handle = PagedHandle(tuple(pages), n * self.block)
        # the pages' initial reference becomes the cache entry's (its
        # on_release decref balances the alloc above)
        self.prefix_cache.insert_chains(chains, handle, n * self.page_bytes)
        self.kv_imported_pages += n
        self.kv_import_events += 1
        return handle

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def prefill_request(self, req: Request) -> PrefillState:
        """Prefix-cache match + prefill of the uncached suffix, shared by
        ``generate`` and the scheduler's admission.  Paged engines alias a
        hit's pages and chunk-prefill the suffix; dense engines boot-prefill
        up to 8 tokens (or start from a copy of a hit's cache) and decode
        the rest of the prompt teacher-forced, one token per dispatch."""
        if not self.paged:
            return self._prefill_request_dense(req)
        toks = [int(t) for t in req.tokens]
        matched, pages = self._match_and_alias(toks)
        try:
            pos, logits_last = self._prefill_chunks(toks, pages, matched)
        except BaseException:
            if pages:                # release aliased + fresh references
                self.allocator.decref(pages)
            raise
        if logits_last is None:
            logits_last = self._replay_last_token(toks, pages, pos)
        return PrefillState(logits_last, pos, matched, pages=pages)

    def _tok(self, t) -> torch.Tensor:
        return self.to_device(np.array([[t]], np.int32))

    def _pos(self, p) -> torch.Tensor:
        return self.to_device(np.array([p], np.int32))

    def _prefill_request_dense(self, req: Request) -> PrefillState:
        toks = [int(t) for t in req.tokens]
        matched, entry = self.prefix_cache.match(toks)
        if entry is not None and matched >= 8 and self.partial_reuse:
            # decoding writes in place: never into the cached entry
            cache, pos, suffix = cache_copy(entry.handle), matched, toks[matched:]
        else:
            matched = 0
            boot = max(1, min(len(toks), 8))
            _, cache = self.model.prefill(
                self.params, self.to_device(np.array([toks[:boot]], np.int32)),
                max_len=self.max_len)
            pos, suffix = boot, toks[boot:]
        logits = None
        for t in suffix:              # teacher-forced decode of the suffix
            logits, cache = self.model.decode(self.params, cache,
                                              self._tok(t), self._pos(pos))
            pos += 1
        if logits is None:            # fully cached: replay the last token
            logits, cache = self.model.decode(self.params, cache,
                                              self._tok(toks[-1]),
                                              self._pos(pos - 1))
        return PrefillState(logits, pos, matched, cache=cache)

    def _match_and_alias(self, toks: list) -> tuple[int, list]:
        """Prefix-cache match + zero-copy alias of the hit's pages:
        ``matched`` block-aligned tokens reused by reference."""
        matched, entry = self.prefix_cache.match(toks)
        if (entry is not None and isinstance(entry.handle, PagedHandle)
                and matched >= self.block):
            shared = list(entry.handle.pages[:matched // self.block])
            self.allocator.incref(shared)        # zero-copy alias
            return matched, shared
        return 0, []

    def _replay_last_token(self, toks, pages, pos):
        """Block-aligned prompt fully cached: query-only replay of the last
        token; aliased pages are never written."""
        return self._query_paged(
            self.params, self.arena, self.to_device(self.page_table_row(pages)),
            self.to_device(np.array([[toks[-1]]], np.int32)),
            self.to_device(np.array([pos - 1], np.int32)))

    def _prefill_chunks(self, toks, pages, pos):
        blk = self.block
        logits_last = None
        while pos < len(toks):
            pages.extend(self.alloc_pages(1))
            # pad tail of the last partial chunk: pad logits are ignored
            # and pad K/V is overwritten before any position mask shows it
            chunk = toks[pos:pos + blk]
            buf = np.zeros((1, blk), np.int32)
            buf[0, :len(chunk)] = chunk
            logits, self.arena = self._prefill_paged(
                self.params, self.arena,
                self.to_device(self.page_table_row(pages)),
                self.to_device(buf), self.to_device(np.array([pos], np.int32)))
            self.prefill_dispatches += 1
            self.prefill_tokens += len(chunk)
            logits_last = logits[:, len(chunk) - 1]
            pos += len(chunk)
        return pos, logits_last

    def prefill_requests(self, reqs: list, batch: Optional[int] = None
                         ) -> list:
        """Batched admission: every request's divergence suffix marches
        through ONE shared BLOCK-chunk grid — one ``prefill_paged`` dispatch
        per chunk step over a fixed ``batch``-row grid, rows whose suffix
        ended masked — so K co-routed siblings cost max(chunks) dispatches
        instead of sum(chunks).  Fully cached rows skip the grid and replay
        their last token query-only.  One ``PrefillState`` per request, in
        input order."""
        if not reqs:
            return []
        B = batch or len(reqs)
        if len(reqs) > B:
            raise ValueError(f"{len(reqs)} requests for a {B}-row grid")
        blk = self.block
        rows = []
        try:
            for req in reqs:
                toks = [int(t) for t in req.tokens]
                matched, pages = self._match_and_alias(toks)
                rows.append({"toks": toks, "pages": pages, "pos": matched,
                             "matched": matched, "logits": None})
            n_steps = max((len(r["toks"]) - r["pos"] + blk - 1) // blk
                          for r in rows)
            for _ in range(n_steps):
                tok = np.zeros((B, blk), np.int32)
                pos0 = np.zeros((B,), np.int32)
                act = np.zeros((B,), bool)
                ptab = np.zeros((B, self.max_pages), np.int32)
                ends = []                    # rows finishing this step
                for i, r in enumerate(rows):
                    if r["pos"] >= len(r["toks"]):
                        continue             # suffix done: masked this step
                    r["pages"].extend(self.alloc_pages(1))
                    chunk = r["toks"][r["pos"]:r["pos"] + blk]
                    tok[i, :len(chunk)] = chunk
                    pos0[i] = r["pos"]
                    act[i] = True
                    ptab[i, :len(r["pages"])] = r["pages"]
                    if r["pos"] + len(chunk) >= len(r["toks"]):
                        ends.append((i, len(chunk)))
                    r["pos"] += len(chunk)
                    self.prefill_tokens += len(chunk)
                logits, self.arena = self._prefill_paged_batched(
                    self.params, self.arena, self.to_device(ptab),
                    self.to_device(tok), self.to_device(pos0),
                    self.to_device(act))
                self.prefill_dispatches += 1
                for i, off in ends:
                    rows[i]["logits"] = logits[i:i + 1, off - 1]
        except BaseException:
            for r in rows:           # release aliased + fresh references
                if r["pages"]:
                    self.allocator.decref(r["pages"])
            raise
        out = []
        for r in rows:
            if r["logits"] is None:  # full block-aligned hit
                r["logits"] = self._replay_last_token(
                    r["toks"], r["pages"], r["pos"])
            out.append(PrefillState(r["logits"], r["pos"], r["matched"],
                                    pages=r["pages"]))
        return out

    # ------------------------------------------------------------------
    # sequential generation
    # ------------------------------------------------------------------
    def generate(self, req: Request) -> Result:
        """One-slot sequential greedy decode."""
        if not self.paged:
            return self._generate_dense(req)
        t0 = time.monotonic()
        st = self.prefill_request(req)
        pages, logits, pos = st.pages, st.logits, st.pos
        ttft = time.monotonic() - t0
        out = []
        try:
            for _ in range(req.max_new):
                nxt = int(logits[0].argmax())
                out.append(nxt)
                if nxt == req.eos_id or pos >= self.max_len - 1:
                    break
                self.ensure_page_for(pages, pos)
                logits, self.arena = self._decode_paged(
                    self.params, self.arena,
                    self.to_device(self.page_table_row(pages)),
                    self.to_device(np.array([[nxt]], np.int32)),
                    self.to_device(np.array([pos], np.int32)))
                pos += 1
            # pos counts exactly the tokens whose KV is in the pages
            full = ([int(t) for t in req.tokens] + out)[:pos]
            self.insert_prefix(full, pages)  # zero-copy (page refs)
        finally:
            self.release_pages(pages)        # request's own reference
        return Result(req.req_id, out, ttft=ttft,
                      total=time.monotonic() - t0,
                      cached_tokens=st.matched,
                      prompt_tokens=len(req.tokens))

    def _generate_dense(self, req: Request) -> Result:
        t0 = time.monotonic()
        st = self.prefill_request(req)
        cache, logits, pos = st.cache, st.logits, st.pos
        ttft = time.monotonic() - t0
        out = []
        for _ in range(req.max_new):
            nxt = int(logits[0].argmax())
            out.append(nxt)
            if nxt == req.eos_id or pos >= self.max_len - 1:
                break
            logits, cache = self.model.decode(self.params, cache,
                                              self._tok(nxt), self._pos(pos))
            pos += 1
        # pos counts exactly the tokens whose state is in the cache
        full = ([int(t) for t in req.tokens] + out)[:pos]
        self.prefix_cache.insert(full, cache, self._cache_nbytes(cache))
        return Result(req.req_id, out, ttft=ttft,
                      total=time.monotonic() - t0,
                      cached_tokens=st.matched,
                      prompt_tokens=len(req.tokens))


@dataclass
class LatencyEngineConfig:
    prefill_tps: float = 8_000.0     # prompt tokens/s (single request)
    decode_tps: float = 60.0         # generated tokens/s per request
    batch_slots: int = 8             # continuous-batching concurrency
    overhead_s: float = 0.02
    hw_score: float = 5.0            # the paper's 1..10 capacity score


class LatencyEngine:
    """Deterministic continuous-batching cost model on the simnet clock
    (plain Python, the reference's numbers to the bit).

    ``service_times`` returns (ttft, completion offset) given the current
    queue state; slot release is the caller's: the model node schedules
    the completion."""

    def __init__(self, ecfg: LatencyEngineConfig,
                 cache_bytes: int = 1 << 28):
        self.ecfg = ecfg
        self.prefix_cache = PrefixCache(cache_bytes)
        self.busy: list[float] = []       # completion times of active slots

    def service_times(self, n_prompt: int, n_cached: int, n_out: int,
                      now: float) -> tuple[float, float]:
        e = self.ecfg
        scale = e.hw_score / 5.0
        # slot admission: wait for a free slot if all are busy
        self.busy = [t for t in self.busy if t > now]
        if len(self.busy) >= e.batch_slots:
            start = sorted(self.busy)[len(self.busy) - e.batch_slots]
        else:
            start = now
        # batching interference: decode tps degrades with occupancy
        occupancy = min(len(self.busy) + 1, e.batch_slots)
        interference = 1.0 + 0.15 * (occupancy - 1)
        t_prefill = (n_prompt - n_cached) / (e.prefill_tps * scale)
        t_decode = n_out * interference / (e.decode_tps * scale)
        ttft = (start - now) + e.overhead_s + t_prefill
        total = ttft + t_decode
        self.busy.append(now + total)
        return ttft, total
