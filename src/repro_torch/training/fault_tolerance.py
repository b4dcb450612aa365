"""Fault tolerance for 1000+-node training (port of
``repro/training/fault_tolerance.py``, over the port's checkpoints):
heartbeat failure detection, checkpoint/restart, elastic re-mesh,
straggler mitigation.

The control logic is host-side (exactly as it would be on a real cluster
coordinator); failures/stragglers are injected through a SimulatedCluster
so every policy is unit-testable on one CPU:

  HeartbeatMonitor    declares a host dead after ``timeout`` missed beats
  TrainSupervisor     run loop: step -> periodic checkpoint; on failure,
                      restore latest committed checkpoint (possibly onto a
                      SMALLER data-parallel mesh: elastic), replay
  StragglerPolicy     per-step host timings -> flag hosts slower than
                      kappa x median; persistent stragglers are evicted
                      (checkpoint-restart without them) — the bounded
                      -staleness alternative simply skips their microbatch
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.training import checkpoint as ckpt_lib


# --------------------------------------------------------------------------
# Heartbeats
# --------------------------------------------------------------------------

@dataclass
class HeartbeatMonitor:
    timeout: float = 30.0
    last_seen: dict = field(default_factory=dict)

    def beat(self, host, now: float):
        self.last_seen[host] = now

    def dead_hosts(self, now: float) -> set:
        return {h for h, t in self.last_seen.items()
                if now - t > self.timeout}


# --------------------------------------------------------------------------
# Stragglers
# --------------------------------------------------------------------------

@dataclass
class StragglerPolicy:
    kappa: float = 2.0             # slow if > kappa * median step time
    evict_after: int = 3           # consecutive slow steps before eviction
    _slow_streak: dict = field(default_factory=dict)

    def observe(self, host_times: dict) -> dict:
        """host -> step seconds.  Returns {'slow': set, 'evict': set}."""
        if not host_times:
            return {"slow": set(), "evict": set()}
        ts = sorted(host_times.values())
        med = ts[len(ts) // 2]
        slow = {h for h, t in host_times.items() if t > self.kappa * med}
        evict = set()
        for h in host_times:
            if h in slow:
                self._slow_streak[h] = self._slow_streak.get(h, 0) + 1
                if self._slow_streak[h] >= self.evict_after:
                    evict.add(h)
            else:
                self._slow_streak[h] = 0
        return {"slow": slow, "evict": evict}


# --------------------------------------------------------------------------
# Simulated cluster (for tests/examples on one CPU)
# --------------------------------------------------------------------------

class SimulatedCluster:
    def __init__(self, n_hosts: int, base_step_s: float = 1.0, seed: int = 0):
        import random
        self.n_hosts = n_hosts
        self.alive = set(range(n_hosts))
        self.base = base_step_s
        self.rng = random.Random(seed)
        self.fail_at: dict = {}        # host -> step to fail at
        self.slow_hosts: dict = {}     # host -> multiplier

    def inject_failure(self, host: int, step: int):
        self.fail_at[host] = step

    def inject_straggler(self, host: int, mult: float):
        self.slow_hosts[host] = mult

    def step_times(self, step: int) -> dict:
        for h, s in list(self.fail_at.items()):
            if step >= s and h in self.alive:
                self.alive.discard(h)
        return {h: self.base * self.slow_hosts.get(h, 1.0)
                * (0.95 + 0.1 * self.rng.random())
                for h in self.alive}

    def evict(self, hosts: set):
        self.alive -= hosts


# --------------------------------------------------------------------------
# Supervisor
# --------------------------------------------------------------------------

@dataclass
class SupervisorConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 20
    keep: int = 3
    max_restarts: int = 8
    min_hosts: int = 1


class TrainSupervisor:
    """Drives (step_fn, state) to ``total_steps`` surviving failures.

    step_fn(state, step, n_hosts) -> state  (raises HostFailure on a dead
    host — in production this is the collective timing out).
    save_fn/restore_fn adapt state <-> checkpoint trees."""

    def __init__(self, cfg: SupervisorConfig, cluster: SimulatedCluster,
                 step_fn: Callable, save_tree: Callable,
                 load_tree: Callable,
                 straggler: Optional[StragglerPolicy] = None):
        self.cfg = cfg
        self.cluster = cluster
        self.step_fn = step_fn
        self.save_tree = save_tree
        self.load_tree = load_tree
        self.straggler = straggler or StragglerPolicy()
        self.events: list = []
        self._known_lost: set = set()

    def run(self, state, total_steps: int):
        cfg = self.cfg
        step = 0
        restarts = 0
        while step < total_steps:
            try:
                times = self.cluster.step_times(step)
                if len(times) < cfg.min_hosts:
                    raise RuntimeError("cluster below minimum size")
                lost = (set(range(self.cluster.n_hosts))
                        - self.cluster.alive - self._known_lost)
                if lost:
                    self._known_lost |= lost
                    raise HostFailure(lost)
                verdict = self.straggler.observe(times)
                if verdict["evict"]:
                    self.events.append(("evict", set(verdict["evict"]), step))
                    self.cluster.evict(verdict["evict"])
                    raise HostFailure(verdict["evict"])
                state = self.step_fn(state, step, len(times))
                step += 1
                if step % cfg.ckpt_every == 0:
                    ckpt_lib.save(cfg.ckpt_dir, step, self.save_tree(state))
                    ckpt_lib.prune(cfg.ckpt_dir, cfg.keep)
                    self.events.append(("ckpt", step))
            except HostFailure as e:
                restarts += 1
                self.events.append(("restart", tuple(sorted(e.hosts)), step))
                if restarts > cfg.max_restarts:
                    raise RuntimeError("too many restarts") from e
                last = ckpt_lib.latest_step(cfg.ckpt_dir)
                if last is not None:
                    tree, _ = ckpt_lib.restore(cfg.ckpt_dir, last,
                                               self.save_tree(state))
                    state = self.load_tree(state, tree,
                                           n_hosts=len(self.cluster.alive))
                    step = last
                else:
                    step = 0
                self.events.append(("resume", step,
                                    len(self.cluster.alive)))
        return state, step


class HostFailure(RuntimeError):
    def __init__(self, hosts):
        super().__init__(f"hosts failed: {hosts}")
        self.hosts = set(hosts)
