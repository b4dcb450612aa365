"""The device trace of a traced run: torch.profiler over the window, the
card's activity only, padded at both ends.

The tracer has been seen to drop the first records of a session, so the
session opens with ``LEAD`` marker kernels (``torch.cuda._sleep``, whose
kernel is named ``spin_kernel``) well before the window.  It closes with
one marker launched right after a synchronise, whose device start, set
against the host clock read just before its launch, maps host times onto
the trace's clock.  Reading the raw device records (not ``key_averages``)
keeps a window of a million launches to seconds.
"""
from __future__ import annotations

import heapq
import time

import torch

PAD_S = 0.05
LEAD = 8
MARK = "spin_kernel"


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.kernels = []      # (name, start ns, duration ns) on the device
        self.offset_ns = None  # device ns - host monotonic ns

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        time.sleep(PAD_S)
        for _ in range(LEAD):
            torch.cuda._sleep(1000)
            time.sleep(0.002)
        torch.cuda.synchronize()

    def stop(self):
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        host_ns = time.monotonic_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(PAD_S)
        self.prof.stop()
        marks = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            name = e.name()
            if MARK in name:
                marks.append(e.start_ns())
            else:
                self.kernels.append((name, e.start_ns(), e.duration_ns()))
        self.prof = None
        if marks:
            self.offset_ns = max(marks) - host_ns

    def window(self, t0: float, t1: float) -> dict:
        """The device's records in the host interval [t0, t1] (monotonic
        seconds): ``busy_s`` (the union of their intervals), ``window_s``,
        seconds by name, and the 64 longest idle gaps as (host start s,
        seconds), longest first."""
        if self.offset_ns is None:
            return {}
        lo = int(t0 * 1e9) + self.offset_ns
        hi = int(t1 * 1e9) + self.offset_ns
        by_name, spans = {}, []
        for name, s, d in self.kernels:
            if lo <= s <= hi:
                by_name[name] = by_name.get(name, 0.0) + d / 1e9
                spans.append((s, min(s + d, hi)))
        spans.sort()
        busy, gaps, cur = 0, [], lo

        def gap(a, b):
            item = (b - a, a)
            if len(gaps) < 64:
                heapq.heappush(gaps, item)
            elif item > gaps[0]:
                heapq.heapreplace(gaps, item)
        for s, e in spans:
            if s > cur:
                gap(cur, s)
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if hi > cur:
            gap(cur, hi)
        return {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9, "by_name": by_name,
                "gaps": [((a - self.offset_ns) / 1e9, n / 1e9)
                         for n, a in sorted(gaps, reverse=True)]}
