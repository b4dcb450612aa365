"""Roofline accounting of collectives (port of
``repro/distributed/collectives.py``).

The reference scans compiled HLO text for its collectives; the port
records them as a step runs (``trace_analysis.py``): each is
(op, result bytes, group size), and ``collective_stats`` applies the same
ring-algorithm effective-bytes factors per participating device:

  all-reduce          2 * R * (g-1)/g          (R = result bytes)
  all-gather          R * (g-1)/g
  reduce-scatter      R * (g-1)               (input = R * g)
  all-to-all          R * (g-1)/g
  collective-permute  R

t_collective = sum(per-device effective bytes) / link bandwidth.
"""
from __future__ import annotations

from collections import defaultdict

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute")


def effective_bytes(op: str, result_bytes: float, group: int) -> float:
    """Per-device bytes a ring moves for one collective."""
    if op == "all-reduce":
        return 2.0 * result_bytes * (group - 1) / group
    if op in ("all-gather", "all-to-all"):
        return result_bytes * (group - 1) / group
    if op == "reduce-scatter":
        return float(result_bytes) * (group - 1)
    if op == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {op!r}; one of {OPS}")


def collective_stats(records, n_devices: int) -> dict:
    """Per-op counts and per-device effective bytes of recorded collectives:
    ``records`` are (op, result bytes, group size or None for all
    ``n_devices``)."""
    stats = defaultdict(lambda: {"count": 0, "raw_bytes": 0, "eff_bytes": 0.0})
    for op, rb, g in records:
        if rb == 0:
            continue
        s = stats[op]
        s["count"] += 1
        s["raw_bytes"] += rb
        s["eff_bytes"] += effective_bytes(op, rb, g or n_devices)
    total = {"count": sum(s["count"] for s in stats.values()),
             "eff_bytes": sum(s["eff_bytes"] for s in stats.values())}
    return {"by_op": dict(stats), "total": total}


# NVIDIA H100 SXM5 80GB data sheet, dense rates at the 700 W power limit
# (``nvidia-smi --query-gpu=name,power.limit``: "NVIDIA H100 80GB HBM3,
# 700.00 W"); a card set below 700 W runs slower under load.
CARD = "NVIDIA H100 SXM5 80GB, 700 W (data sheet)"
PEAK_FLOPS_BF16 = 989e12       # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12               # bytes/s per card
NVLINK_BW = 450e9              # bytes/s per direction per card (NVLink 4)


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_eff_bytes_per_dev: float) -> dict:
    t_c = flops_per_dev / PEAK_FLOPS_BF16
    t_m = bytes_per_dev / HBM_BW
    t_n = coll_eff_bytes_per_dev / NVLINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_n),
              key=lambda kv: kv[1])
    return {"t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_n,
            "dominant": dom[0],
            "roofline_s": max(t_c, t_m, t_n)}
