"""What a loop records while it drives the scheduler, and the record the
metric readers read.

A token counts when it first shows in its request's ``out`` after
``Scheduler.step`` returns: every new token of a step gets the host time
at which that step returned.  A request's due time is its place in the
schedule (open loop) or the moment its client sent it (closed loop).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from harness import program


@dataclass
class Req:
    prompt: list
    max_new: int
    due: float                    # host monotonic seconds
    times: list = field(default_factory=list)
    out: list = field(default_factory=list)
    result: object = None         # the scheduler's Result, once finished


class Served:
    """The scheduler under a loop: submissions, steps, token times."""

    def __init__(self, sched):
        self.sched = sched
        self.reqs: dict = {}
        self.finished: list = []      # request ids, in finishing order
        self.steps: list = []         # host (entry, exit) of each step
        self.sleeps: list = []        # host (entry, exit) of each wait
        self.peak_pages = 0           # the most arena pages in use after a step
        self._n_done = len(sched.done)     # a scheduler may serve several loops

    def submit(self, req_id: int, prompt: list, max_new: int, due: Optional[float] = None):
        self.reqs[req_id] = Req(prompt, max_new, time.monotonic() if due is None else due)
        self.sched.submit(program.request(req_id, prompt, max_new))

    def pending(self) -> int:
        """Requests submitted and not finished."""
        return len(self.reqs) - len(self.finished)

    def step(self) -> float:
        t_in = time.monotonic()
        self.sched.step()
        t = time.monotonic()
        self.steps.append((t_in, t))
        self.peak_pages = max(self.peak_pages, self.sched.engine.allocator.used_count)
        for s in self.sched.active:
            self._note(s.req.req_id, s.out, t)
        done = self.sched.done
        for r in done[self._n_done:]:
            if self._note(r.req_id, r.output, t):
                self.reqs[r.req_id].result = r
                self.finished.append(r.req_id)
        self._n_done = len(done)
        return t

    def sleep_until(self, t: float):
        t_in = time.monotonic()
        if t > t_in:
            time.sleep(t - t_in)
            self.sleeps.append((t_in, time.monotonic()))

    def _note(self, rid, out, t) -> bool:
        rec = self.reqs.get(rid)
        if rec is None:
            return False
        if len(out) > len(rec.times):
            rec.times.extend([t] * (len(out) - len(rec.times)))
        rec.out = out
        return True


@dataclass
class Record:
    """One run, as the metric readers see it."""
    t0: float                     # window start (host monotonic s)
    t_end: float                  # window end: t0 + seconds
    t_exit: float                 # the loop's exit (its last step returned)
    setup_s: float
    served: Served
    counters: tuple               # engine and scheduler counts at t0 and at exit
    port: dict
    node: dict
    traffic: dict
    spans: object = None          # harness.spans.Spans (traced run)
    trace: dict = None            # harness.trace.DeviceTrace.window(t0, t_exit)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0

    def due_in_window(self) -> list:
        return [r for r in self.served.reqs.values() if self.t0 <= r.due < self.t_end]

    def calls(self, name: str) -> list:
        return self.spans.within(name, self.t0, self.t_exit) if self.spans else []

    def counter(self, key: str) -> float:
        return self.counters[1][key] - self.counters[0][key]


def counters(eng, sched) -> dict:
    return {"prefill_tokens": eng.prefill_tokens, "prefill_dispatches": eng.prefill_dispatches,
            **{f"sched.{k}": v for k, v in sched.metrics.items()}}


def pct(values, q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, float), q)) if len(values) else None
