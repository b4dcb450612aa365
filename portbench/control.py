"""The control of a cell's check, on the card, at the cell's own size and
load (not run by the benchmark's own runs).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s>

For each seed, in one process (the set-up's torch, card and kernels once):
the weights drawn anew, the cell's set-up and loop for ``--seconds``, then
on the run's sample (``harness/check.py``) the program's gaps and the
control's: the plain reference computed with float8 operands, the gap of
the token it puts first at each of the same positions.  Both go through
``check.verdict`` under the cell's own limits (``checks/<cell>.json``);
the control has to come out not correct.  Prints one JSON line a seed,
with each side's numbers beside their limits and its ``correct``, and
writes them to ``chiprun_out/control_<cell>.jsonl``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    import torch

    from harness import cell, check, spec
    dev = torch.device("cuda")
    c = spec.cell(ROOT, args.workload)
    port, limits = c.config["port"], c.check["limits"]
    ref = spec.reference(c.bench_dir, c.config["reference"])
    out = Path(args.out) / f"control_{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    w = act = None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        b = cell.build(c, port, seed, args.seconds, False, dev, w=w, act=act)
        w, act = b.w, b.act
        win = cell.drive(b, c, args.seconds)
        requests = cell.served_requests(b.sv, win["t0"])
        short = cell.short_answers(b.sv)
        del b
        cell.free(True)
        pairs = check.sample(requests, seed, c.check["sample_tokens"])
        got = check.compare(ref, port, w, pairs, control=True)
        program, correct = check.verdict(got | {"short_answers": short}, limits)
        # the control is read at every position it is held to: no answer is short
        low, low_correct = check.verdict(
            got["control"] | {"short_answers": 0, "scored_tokens": got["scored_tokens"]},
            limits)
        row = {"cell": args.workload, "seed": seed, "served": len(requests),
               "sampled": len(pairs), "scored_tokens": got["scored_tokens"],
               "late_tokens": got["late_tokens"],
               "program": {"correct": correct, "check": program, "flips": got["flips"]},
               "control": {"correct": low_correct, "check": low,
                           "flips": got["control"]["flips"]},
               "seconds": time.monotonic() - t}
        print(json.dumps(row), flush=True)
        with out.open("a") as f:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
