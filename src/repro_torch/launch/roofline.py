"""Roofline CLI: the three-term table from the port's dry-run records
(port of ``repro/launch/roofline.py`` with its own copy of
``benchmarks/bench_roofline.py``'s ``build_table`` arithmetic).

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        [--dir results/dryrun_torch/pod16x16] \\
        [--baseline results/dryrun_torch_base/pod16x16] [--json out.json]

Terms per device against the NVIDIA H100 data sheet
(``distributed.collectives``): compute = trace flops / bf16 peak, memory =
trace bytes (eager, unfused: an upper bound) / HBM rate, collective =
ring-effective bytes / NVLink rate.  ``useful`` is MODEL_FLOPS (6ND for a
train step, 2ND for inference, N the active parameters) over the traced
flops of every device; ``HBM/dev`` is argument plus temporary bytes.
"""
from __future__ import annotations

import argparse
import glob
import json
from pathlib import Path

from repro_torch import configs
from repro_torch.distributed.collectives import roofline_terms


def model_flops(rec: dict) -> float:
    """6*N*D for train (N=active params, D=tokens); 2*N*D for inference."""
    n_active = rec["params_active"]
    shape = configs.SHAPES[rec["shape"]]
    if rec["kind"] == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if rec["kind"] == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 token/request


def build_table(dryrun_dir="results/dryrun_torch/pod16x16") -> list:
    rows = []
    for f in sorted(glob.glob(f"{dryrun_dir}/*.json")):
        r = json.loads(Path(f).read_text())
        if r["status"] != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"], "status": r["status"],
                         "reason": r.get("reason", r.get("error", ""))[:90]})
            continue
        t_an = r["trace_analysis"]
        t = roofline_terms(t_an["flops"], t_an["bytes"], t_an["coll_eff_bytes"])
        mf = model_flops(r)
        mem = r["memory_analysis"]
        temp = mem["temp_size_in_bytes"]
        per_dev_hbm = mem["argument_size_in_bytes"] + (temp if isinstance(temp, int) else 0)
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "status": "ok",
            "t_compute_s": t["t_compute_s"], "t_memory_s": t["t_memory_s"],
            "t_collective_s": t["t_collective_s"], "dominant": t["dominant"],
            "model_flops": mf, "trace_flops_per_dev": t_an["flops"],
            "useful_flops_ratio": mf / (t_an["flops"] * r["n_devices"]) if t_an["flops"] else 0.0,
            "hbm_per_dev_gb": per_dev_hbm / 1e9,
            "fits_80gb": per_dev_hbm < 80e9,
            "trace_s": r.get("trace_s"),
        })
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="results/dryrun_torch/pod16x16")
    ap.add_argument("--baseline", default="")
    ap.add_argument("--json", default="")
    args = ap.parse_args()

    rows = build_table(args.dir)
    base = {(r["arch"], r["shape"]): r for r in build_table(args.baseline)} \
        if args.baseline else {}
    hdr = (f"{'arch':<22} {'shape':<12} {'t_comp':>9} {'t_mem':>9} "
           f"{'t_coll':>9} {'dom':<5} {'useful':>6} {'HBM/dev':>8}")
    if base:
        hdr += "  vs-baseline"
    print(hdr)
    for r in rows:
        if r["status"] != "ok":
            print(f"{r['arch']:<22} {r['shape']:<12} {r['status']}: "
                  f"{r.get('reason', '')[:60]}")
            continue
        line = (f"{r['arch']:<22} {r['shape']:<12} "
                f"{r['t_compute_s']:>9.3g} {r['t_memory_s']:>9.3g} "
                f"{r['t_collective_s']:>9.3g} {r['dominant'][:4]:<5} "
                f"{r['useful_flops_ratio']:>6.2f} "
                f"{r['hbm_per_dev_gb']:>7.1f}G")
        b = base.get((r["arch"], r["shape"]))
        if b and b.get("status") == "ok":
            bmax = max(b["t_compute_s"], b["t_memory_s"], b["t_collective_s"])
            vmax = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
            line += f"  {bmax / max(vmax, 1e-12):>6.1f}x"
        print(line)
    if args.json:
        Path(args.json).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
