"""Continuous-batching scheduler over the paged KV pool or the dense slot
pool (port of ``repro/serving/scheduler.py``).

With a paged engine the pool is a host-side ``(max_active, max_pages)``
page-table array over the engine's node-wide arena, and every ``step()``
admits queued requests into all free slots through one shared-grid
``prefill_paged`` dispatch stream.  With a dense engine (recurrent mixers,
or ``paged=False``) the pool is one dense cache ``cache_zeros(max_active,
max_len)``, allocated once: each admission prefills one request and copies
its batch-1 cache into a free row, and a finished row is copied out for the
prefix cache.  Either way a round then issues ONE batched dispatch for the
whole pool: the one-token decode, or with speculation on (paged only), the
``(max_active, spec_k+1)`` verify window.  Dead rows are masked.  Greedy
argmax runs on the device; each dispatch's tokens cross to the host with
one ``.cpu()``.

Admission prefers the longest prefix-cache match, probed read-only with
``PrefixCache.peek`` once at submit time.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.models.lm import cache_slot_read, cache_slot_write
from repro_torch.serving.engine import NgramDrafter, RealEngine, Request, Result


@dataclass
class _Slot:
    req: Request
    pos: int
    out: list = field(default_factory=list)
    t_start: float = 0.0
    ttft: float = 0.0
    cached_tokens: int = 0
    pages: list = field(default_factory=list)   # paged engines only
    drafter: object = None                      # NgramDrafter (spec mode)


@dataclass
class _Queued:
    req: Request
    hint: int           # block-aligned prefix-cache match length at submit


class Scheduler:
    """Runs on the engine's device."""

    def __init__(self, engine: RealEngine, max_active: int = 4,
                 prefer_cache_hits: bool = True):
        self.engine = engine
        self.max_active = max_active
        self.prefer_cache_hits = prefer_cache_hits
        self.queue: collections.deque = collections.deque()
        self.slots: list[Optional[_Slot]] = [None] * max_active
        self.done: list[Result] = []
        self.metrics = {"admitted": 0, "completed": 0, "queue_peak": 0,
                        "decode_calls": 0, "rounds": 0}
        self.spec = engine.spec
        self._spec_w = engine.cfg.spec_k + 1 if self.spec else 1
        # greedy next token of every slot, on the host (the reference keeps
        # the slots' logits and argmaxes them at the start of each round)
        self._next = np.zeros((max_active,), np.int64)
        if engine.paged:
            # page-table pool: 0 = scratch page (inactive / unallocated)
            self._ptab = np.zeros((max_active, engine.max_pages), np.int32)
            self._cache = None
        else:
            # dense pool: one batched cache for the engine's max_len
            self._ptab = None
            self._cache = engine.model.cache_zeros(max_active, engine.max_len)

    @property
    def active(self) -> list:
        return [s for s in self.slots if s is not None]

    def submit(self, req: Request):
        hint = 0
        if self.prefer_cache_hits:
            hint, _ = self.engine.prefix_cache.peek(
                [int(t) for t in req.tokens])
        self.queue.append(_Queued(req, hint))
        self.metrics["queue_peak"] = max(self.metrics["queue_peak"],
                                         len(self.queue))

    # ------------------------------------------------------------------
    def _pick_request(self) -> Request:
        ix = 0
        if self.prefer_cache_hits and len(self.queue) > 1:
            best, best_len = 0, -1
            for i, q in enumerate(self.queue):
                if q.hint > best_len:
                    best, best_len = i, q.hint
            ix = best
        q = self.queue[ix]
        del self.queue[ix]
        return q.req

    def _admit_one(self):
        """Dense admission of one request into the first free row."""
        free = next(i for i, s in enumerate(self.slots) if s is None)
        req = self._pick_request()
        t0 = time.monotonic()
        st = self.engine.prefill_request(req)
        cache_slot_write(self._cache, st.cache, free)
        self._next[free] = self._argmax([st.logits])[0]
        self.slots[free] = _Slot(req, st.pos, t_start=t0,
                                 ttft=time.monotonic() - t0,
                                 cached_tokens=st.matched)
        self.metrics["admitted"] += 1

    def _admit_batch(self):
        """Drain the queue into every free slot through ONE batched
        ``prefill_paged`` dispatch stream (engine.prefill_requests)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        picked = []
        for slot in free:
            if not self.queue:
                break
            picked.append((slot, self._pick_request()))
        if not picked:
            return
        t0 = time.monotonic()
        states = self.engine.prefill_requests(
            [req for _, req in picked], batch=self.max_active)
        first = self._argmax([st.logits for st in states])
        ttft = time.monotonic() - t0
        for (slot, req), st, tok in zip(picked, states, first):
            self._ptab[slot, :] = 0
            self._ptab[slot, :len(st.pages)] = st.pages
            self._next[slot] = tok
            self.slots[slot] = _Slot(req, st.pos, t_start=t0, ttft=ttft,
                                     cached_tokens=st.matched,
                                     pages=st.pages,
                                     drafter=self._new_drafter(req))
            self.metrics["admitted"] += 1

    @staticmethod
    def _argmax(logits: list) -> np.ndarray:
        """Greedy tokens of device logits, brought to the host at once."""
        return torch.cat(logits).argmax(-1).cpu().numpy()

    def _new_drafter(self, req: Request):
        return NgramDrafter(req.tokens) if self.spec else None

    # ------------------------------------------------------------------
    def step(self):
        """One continuous-batching round: admit into free slots, then ONE
        batched dispatch for every still-active slot."""
        if self.engine.paged:
            self._admit_batch()
        else:
            while self.queue and any(s is None for s in self.slots):
                self._admit_one()
        active_ix = [i for i, s in enumerate(self.slots) if s is not None]
        if not active_ix:
            return
        self.metrics["rounds"] += 1
        nxt = self._next.copy()
        finished, cont = [], []
        for i in active_ix:
            s = self.slots[i]
            tok = int(nxt[i])
            if len(s.out) < s.req.max_new:     # max_new=0 emits nothing
                s.out.append(tok)
            if (tok == s.req.eos_id or len(s.out) >= s.req.max_new
                    or s.pos >= self.engine.max_len - 1):
                finished.append(i)
            else:
                cont.append(i)
        # retire completed rows before the pool dispatch: their pages go
        # to the prefix cache and their table rows onto the scratch page
        for i in finished:
            self._finish_slot(i)
        if not cont:
            return
        if self.spec:
            drafts = self._collect_drafts(cont)
            if any(drafts.values()):
                self._verify_round(cont, nxt, drafts)
                return
            # no slot drafted: the one-token pool decode commits the same
            # single token per row with a W-times smaller dispatch
            self.engine.spec_draftless_rounds += 1
        self._decode_round(cont, nxt)

    def _decode_round(self, cont: list, nxt):
        """ONE one-token batched decode dispatch for the continuing rows."""
        eng = self.engine
        B = self.max_active
        tok = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        act = np.zeros((B,), bool)
        for i in cont:
            s = self.slots[i]
            tok[i, 0] = nxt[i]
            pos[i] = s.pos
            act[i] = True
            if eng.paged:    # the write position may cross into a new block
                eng.ensure_page_for(s.pages, s.pos)
                self._ptab[i, :len(s.pages)] = s.pages
        args = (eng.to_device(tok), eng.to_device(pos), eng.to_device(act))
        if eng.paged:
            logits, eng.arena = eng._decode_batched(
                eng.params, eng.arena, eng.to_device(self._ptab), *args)
        else:
            logits, self._cache = eng._decode_batched(eng.params, self._cache,
                                                      *args)
        self.metrics["decode_calls"] += 1
        greedy = self._argmax([logits])
        for i in cont:
            self.slots[i].pos += 1
            self._next[i] = greedy[i]

    # ------------------------------------------------------------------
    # speculative n-gram decode
    # ------------------------------------------------------------------
    def _collect_drafts(self, cont: list) -> dict:
        """Feed each continuing slot's drafter and collect its proposal
        (possibly empty)."""
        eng, W = self.engine, self._spec_w
        drafts: dict = {}
        for i in cont:
            s = self.slots[i]
            dr = s.drafter
            n_new = len(s.req.tokens) + len(s.out) - len(dr.tokens)
            if n_new > 0:
                dr.extend(s.out[-n_new:])
            # drafting past max_new or max_len could never be committed
            cap = min(W - 1, s.req.max_new - len(s.out),
                      eng.max_len - 1 - (s.pos + 1))
            drafts[i] = [int(t) for t in dr.draft(cap)]
            eng.spec_drafted += len(drafts[i])
        return drafts

    def _verify_round(self, cont: list, nxt, drafts: dict):
        """ONE multi-token verify dispatch for every continuing slot: per
        row the window [nxt, draft_1 .. draft_k] at positions pos .. pos+k.
        The host accepts the longest draft prefix equal to greedy argmax,
        so outputs are token-identical to non-speculative decoding; the
        rejected tail's KV is hidden by the position mask (the row position
        does not advance over it) and overwritten later."""
        eng = self.engine
        B, W = self.max_active, self._spec_w
        tok = np.zeros((B, W), np.int32)
        pos = np.zeros((B,), np.int32)
        ntk = np.zeros((B,), np.int32)
        for i in cont:
            s = self.slots[i]
            d = drafts[i]
            n = 1 + len(d)
            tok[i, 0] = nxt[i]
            tok[i, 1:n] = d
            pos[i] = s.pos
            ntk[i] = n
            eng.ensure_page_for(s.pages, s.pos + n - 1)
            self._ptab[i, :len(s.pages)] = s.pages
        logits, eng.arena = eng._verify_paged_batched(
            eng.params, eng.arena, eng.to_device(self._ptab),
            eng.to_device(tok), eng.to_device(pos), eng.to_device(ntk))
        eng.spec_dispatches += 1
        self.metrics["decode_calls"] += 1
        greedy = self._argmax([logits])                        # (B, W)
        finished = []
        for i in cont:
            s = self.slots[i]
            s.pos += 1                     # nxt committed at the old pos
            accepted = 0
            done = False
            for j, t in enumerate(drafts[i]):
                if t != int(greedy[i, j]):
                    break                  # rejected: greedy diverged here
                s.out.append(t)
                eng.spec_accepted += 1
                accepted += 1
                if (t == s.req.eos_id or len(s.out) >= s.req.max_new
                        or s.pos >= eng.max_len - 1):
                    done = True            # finishing token: appended, its
                    break                  # KV position stays unclaimed
                s.pos += 1
            eng.spec_tokens += 1 + accepted
            if done:
                finished.append(i)
            else:                          # greedy after the last committed
                self._next[i] = greedy[i, accepted]    # window token
        for i in finished:
            self._finish_slot(i)

    def _finish_slot(self, i: int):
        s = self.slots[i]
        self.slots[i] = None
        eng = self.engine
        # s.pos counts exactly the tokens whose KV is in the slot (the
        # finishing token was appended but never decoded)
        full = ([int(t) for t in s.req.tokens] + s.out)[:s.pos]
        if eng.paged:
            eng.insert_prefix(full, s.pages)   # by reference, zero copy
            eng.release_pages(s.pages)
            self._ptab[i, :] = 0
        else:                                  # a copy of the pool row
            kv = cache_slot_read(self._cache, i)
            eng.prefix_cache.insert(full, kv, eng._cache_nbytes(kv))
        self.done.append(Result(s.req.req_id, s.out, ttft=s.ttft,
                                total=time.monotonic() - s.t_start,
                                cached_tokens=s.cached_tokens,
                                prompt_tokens=len(s.req.tokens)))
        self.metrics["completed"] += 1

    def run(self, max_rounds: int = 10_000):
        rounds = 0
        while (self.queue or self.active) and rounds < max_rounds:
            self.step()
            rounds += 1
        return self.done

    # ------------------------------------------------------------------
    def kv_bytes_in_use(self) -> int:
        """Physical KV footprint of this pool: the live pages of a paged
        engine; the whole dense pool otherwise (it holds max_active x
        max_len whatever the occupancy)."""
        if self.engine.paged:
            return self.engine.live_kv_bytes()
        return self.engine._cache_nbytes(self._cache)
