"""Per-device flops, bytes and collective traffic of a step, counted as it
runs: the port's counterpart of ``repro/distributed/hlo_analysis.py``,
which it replaces.

The reference reads the compiled, SPMD-partitioned HLO.  The port has no
compiler pass to read: ``analyze(fn, *args)`` runs ``fn`` under a
``TorchDispatchMode`` on one rank, usually over meta tensors and a fake
process group (``launch/dryrun.py``), so every op it sees is on that
rank's shards, and counts

  flops        the matmul family (mm, bmm, addmm, baddbmm, convolution,
               attention), by ``torch.utils.flop_counter``'s formulas
  bytes        each op's tensor operands plus its results (views move
               nothing and are skipped).  Eager ops are not fused, so this
               is an upper bound of the memory traffic where the
               reference's count was taken after XLA's fusion
  collectives  every c10d functional collective with its group's size,
               at ``collectives.py``'s ring factors (``coll_eff_bytes``)

and the peak bytes of tensors the step made that were alive at once
(``temp_peak_bytes``; a view keeps its base alive only through autograd).
Python loops over layers run once per iteration, so the while-loop trip
counts that ``hlo_analysis`` recovers need no recovering here.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import collectives

_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all", "broadcast": "collective-permute"}
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "detach", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(op: str, args) -> int:
    if op in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[-2])
    return dist.distributed_c10d._resolve_process_group(args[-1]).size()


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.flops_by_op = defaultdict(int)
        self.bytes_by_op = defaultdict(int)
        self.collectives = []          # (op, result bytes, group size)
        self.live = 0
        self.peak = 0

    def _track(self, t: torch.Tensor):
        n = _nbytes(t)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, n)

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._opname
        packet = func._overloadpacket
        results = _tensors(out)
        # a view, an in-place or an out= op returns storage it was given
        aliased = any(r.alias_info is not None for r in func._schema.returns)
        if func.namespace.startswith("_c10d_functional") and name in _COLLECTIVES:
            rb = sum(_nbytes(t) for t in results)
            self.collectives.append((_COLLECTIVES[name], rb, _group_size(name, args)))
            self.bytes += rb
            self.bytes_by_op[_COLLECTIVES[name]] += rb
        elif not func.is_view and name not in _NO_TRAFFIC:
            if packet in flop_registry:
                f = flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += f
                self.flops_by_op[name] += f
            b = sum(_nbytes(t) for t in _tensors((args, kwargs)))
            if not aliased:
                b += sum(_nbytes(t) for t in results)
            self.bytes += b
            self.bytes_by_op[name] += b
        if not aliased:
            for t in results:
                self._track(t)
        return out


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return its per-device counts:
    ``flops``, ``bytes``, ``coll_eff_bytes``, ``coll_by_op`` (effective
    bytes per collective kind), ``coll_count``, ``collectives``
    (``collectives.collective_stats``), ``flops_by_op``, ``bytes_by_op``
    and ``temp_peak_bytes``."""
    with _Counter() as c:
        fn(*args, **kwargs)
    stats = collectives.collective_stats(c.collectives, 1)
    return {"flops": float(c.flops), "bytes": float(c.bytes),
            "coll_eff_bytes": stats["total"]["eff_bytes"],
            "coll_by_op": {k: v["eff_bytes"] for k, v in stats["by_op"].items()},
            "coll_count": stats["total"]["count"], "collectives": stats,
            "flops_by_op": dict(c.flops_by_op), "bytes_by_op": dict(c.bytes_by_op),
            "temp_peak_bytes": c.peak}
