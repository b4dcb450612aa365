"""Spans around the program's calls, installed on instances by the
benchmark in a traced run only (the program is never edited).

Each call records its host interval (``time.monotonic``) and, on the card,
a pair of CUDA events around it, whose elapsed time is read once the
window has closed.  ``LM.prefill_paged`` and ``LM.decode_paged`` keep
references to their page tables, positions and live-row masks (small
tensors the engine makes for each call), read on the host after the
window; ``RealEngine.prefill_requests`` keeps its requests and what each
admitted (the prefix-cache match), and the index range of the
``prefill_paged`` calls it made.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Call:
    name: str
    t0: float                  # host monotonic seconds, entry
    t1: float = 0.0            # ... exit
    events: tuple = ()         # (start, end) CUDA events, on the card
    args: dict = field(default_factory=dict)
    ms: float = 0.0            # CUDA-event span, filled by ``Spans.resolve``


class Spans:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.calls: dict = {"prefill_paged": [], "decode_paged": [], "prefill_requests": []}

    def _timed(self, name, fn, keep):
        calls = self.calls[name]

        def wrapped(*a, **kw):
            c = Call(name, time.monotonic())
            if self.cuda:
                c.events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                c.events[0].record()
            out = fn(*a, **kw)
            if self.cuda:
                c.events[1].record()
            c.t1 = time.monotonic()
            c.args = keep(a, kw, out)
            calls.append(c)
            return out
        return wrapped

    def install_model(self, model):
        """On the ``LM`` instance, before the engine is built (the engine
        keeps the bound methods it finds at construction)."""
        def prefill_args(a, kw, out):
            # (params, arena, page_tables, tokens, pos0, active)
            act = a[5] if len(a) > 5 else kw.get("active")
            return {"pos0": a[4], "active": act, "rows": a[3].shape[0]}

        def decode_args(a, kw, out):
            # (params, arena, page_tables, tokens, pos, active, write)
            act = a[5] if len(a) > 5 else kw.get("active")
            return {"pos": a[4], "active": act, "rows": a[3].shape[0]}
        model.prefill_paged = self._timed("prefill_paged", model.prefill_paged, prefill_args)
        model.decode_paged = self._timed("decode_paged", model.decode_paged, decode_args)

    def install_engine(self, eng):
        first = {}

        def admit_args(a, kw, out):
            reqs = a[0]
            return {"req_ids": [r.req_id for r in reqs],
                    "lengths": [len(r.tokens) for r in reqs],
                    "matched": [st.matched for st in out],
                    "grid": kw.get("batch") or (a[1] if len(a) > 1 else len(reqs)),
                    "calls": (first.pop("n"), len(self.calls["prefill_paged"]))}
        inner = eng.prefill_requests

        def marked(*a, **kw):
            first["n"] = len(self.calls["prefill_paged"])
            return inner(*a, **kw)
        eng.prefill_requests = self._timed("prefill_requests", marked, admit_args)

    def resolve(self):
        """CUDA-event spans in ms, and the kept tensors on the host."""
        if self.cuda:
            torch.cuda.synchronize()
        for calls in self.calls.values():
            for c in calls:
                if c.events:
                    c.ms = c.events[0].elapsed_time(c.events[1])
                    c.events = ()
                for k, v in list(c.args.items()):
                    if isinstance(v, torch.Tensor):
                        c.args[k] = v.tolist()

    def within(self, name: str, t0: float, t1: float) -> list:
        """Calls of ``name`` entered in [t0, t1]."""
        return [c for c in self.calls[name] if t0 <= c.t0 <= t1]
