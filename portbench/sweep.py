"""Find the knee of an open-loop cell: the highest arrival rate whose queue
does not grow over a window (not run by the benchmark's own runs).

    python3 portbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 2,3,4

One process sets the cell up once, then runs its loop at each rate in
turn (the mix with only its rate changed), draining the node between
rates.  For each rate: the requests due in the window, the backlog
(requests due and not yet admitted, sampled every 0.25 s of the window)
at the window's middle and end with its least-squares slope over the
whole window and over its second half, and the time-to-first-token and
inter-token tails.  A rate holds when the backlog neither trends up over
the second half (slope under ``--slope`` requests a second; the first
half still carries the lead-in's start) nor ends above the node's
slots.  Writes ``chiprun_out/sweep_<cell>.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def backlog(sv, t0: float, t1: float, dt: float = 0.25) -> list:
    """(t - t0, requests due by t and without a first token by t)."""
    out, t = [], t0
    while t <= t1:
        n = sum(1 for r in sv.reqs.values() if r.due <= t and not (r.times and r.times[0] <= t))
        out.append((t - t0, n))
        t += dt
    return out


def slope(points) -> float:
    import numpy as np
    x, y = np.array(points, float).T
    return float(np.polyfit(x, y, 1)[0]) if len(x) > 1 else 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--slope", type=float, default=0.05)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch

    from harness import cell, readers, served, spec, traffic
    from harness.served import pct
    dev = torch.device("cuda")
    c = spec.cell(ROOT, args.workload)
    port, node = c.config["port"], c.config["node"]
    b = cell.build(c, port, args.seed, args.seconds, False, dev)
    out = Path(args.out) / f"sweep_{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix_conf = dict(c.traffic, arrivals=dict(c.traffic["arrivals"], rate_per_s=rate))
        b.mix = traffic.Mix(mix_conf, port["vocab"], args.seed,
                            traffic.requests_needed(mix_conf, args.seconds), salt=k + 1)
        b.sv = served.Served(b.sched)        # the node is drained: ids may repeat
        c_rate = spec.Cell(**{**c.__dict__, "traffic": mix_conf})
        win = cell.drive(b, c_rate, args.seconds)
        rec = served.Record(t0=win["t0"], t_end=win["t_end"], t_exit=win["t_exit"], setup_s=0.0,
                            served=b.sv, counters=(win["at_t0"], win["at_exit"]), port=port,
                            node=node, traffic=mix_conf)
        pts = backlog(b.sv, win["t0"], win["t_end"])
        half = [p for p in pts if p[0] >= args.seconds / 2]
        row = {"cell": args.workload, "rate_per_s": rate, "due": len(rec.due_in_window()),
               "backlog_mid": half[0][1] if half else None, "backlog_end": pts[-1][1],
               "backlog_slope": slope(pts), "backlog_slope_late": slope(half),
               "ttft_p90_s": pct(readers.ttft_s(rec), 90),
               "itl_p95_ms": 1e3 * (pct(readers.token_gaps_s(rec), 95) or 0.0),
               "finished": len(b.sv.finished)}
        row["holds"] = (row["backlog_slope_late"] < args.slope
                        and row["backlog_end"] <= node["max_active"])
        print(json.dumps(row), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
        t = time.monotonic()
        while b.sv.pending():                        # drain before the next rate
            b.sv.step()
        print(f"sweep: drained in {time.monotonic() - t:.1f} s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
