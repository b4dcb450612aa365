"""Runs edited copies of the flash backward's source on the card, to weigh
one of its design choices and to show that its checks fail a wrong kernel.

    python3 scripts/bwd_variants.py [--out DIR] [--variants tree,no_split,...]

Variants of csrc/flash_attention_bwd.cu:

* ``tree``: the source as it is;
* ``no_split``: the bf16 dK/dV walk never split over the group's query
  heads (``kMaxSplits`` 1), so granite's one KV head gets 64 blocks;
* ``dkdv_no_tanh_factor`` / ``dq_no_tanh_factor``: dS without the
  softcap's 1 - tanh^2 factor in ``dkdv_tc_kernel`` / ``dq_tc_kernel``;
* ``dkdv_cap_ignored`` / ``dq_cap_ignored``: that kernel's P computed from
  the uncapped scores.

Each variant is a copy of ``chip_smoke.py`` and ``src/repro_torch`` in a
temporary directory, edited and built there (all copies at once; the
checkout is not changed), and run in a process of its own: every bf16 case of
``chip_smoke.FLASH_BWD_SHAPES`` (each gradient's largest error over its
largest entry, as a share of the 2e-2 gate, and whether the case passes),
and for ``tree`` and ``no_split`` the device time of granite's backward
(B=2 H=48 Hkv=1 S=2048 D=128 causal bf16) with its per-kernel split, in
turns tree, no_split, no_split, tree.  Prints the card's name and power
limit, then one JSON line a run (also written to DIR/bwd_variants.jsonl).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path("src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu")
TANH_FACTOR = ("\n        if (capped) ds *= 1.f - th * th;", "\n      if (capped) ds *= 1.f - th * th;")
CAPPED = "const bool capped = a.softcap > 0.f;"
# variant -> [(text, replacement, which occurrence)]: dkdv_tc_kernel's
# lines come before dq_tc_kernel's in the source
VARIANTS = {
    "tree": [],
    "no_split": [("constexpr int kMaxSplits = 16;", "constexpr int kMaxSplits = 1;", 0)],
    "dkdv_no_tanh_factor": [(TANH_FACTOR[0], "", 0)],
    "dq_no_tanh_factor": [(TANH_FACTOR[1], "", 0)],
    "dkdv_cap_ignored": [(CAPPED, "const bool capped = false;", 0)],
    "dq_cap_ignored": [(CAPPED, "const bool capped = false;", 1)],
}
TIMED = ("tree", "no_split")


def make_copy(name: str, into: Path) -> Path:
    """``chip_smoke.py`` and ``src/repro_torch`` under into/name, the
    variant's edits applied; each edited text must occur as many times as
    the edit expects."""
    dest = into / name
    shutil.copytree(ROOT / "src" / "repro_torch", dest / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dest)
    path = dest / SOURCE
    text = path.read_text()
    for old, new, nth in VARIANTS[name]:
        at = -1
        for _ in range(nth + 1):
            at = text.index(old, at + 1)
        text = text[:at] + new + text[at + len(old):]
    path.write_text(text)
    return dest


def child(name: str, timed: bool) -> dict:
    """In a variant's copy (the working directory): its bf16 cases and, if
    ``timed``, granite's backward timed."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as c
    from repro_torch.kernels.flash_attention import ops
    assert Path(ops.__file__).resolve().is_relative_to(Path.cwd().resolve())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    tol = c.FLASH_BWD_TOL[torch.bfloat16]
    cases = {}
    for case, shape in c.FLASH_BWD_SHAPES.items():
        r = c.flash_bwd_case(gen, dev, shape, torch.bfloat16)
        ratios = {g: e[1] / tol for g, e in r["errs"].items()}
        cases[case] = {"gate_share": ratios, "passes": max(ratios.values()) <= 1.0,
                       "same_bits": r["same_bits"]}
    line = {"variant": name, "cases": cases}
    if timed:
        B, H, Hkv, S, Skv, D, causal, window, softcap = c.FLASH_BWD_TIMED["granite"]
        q, k, v, do = c._flash_bwd_inputs(gen, dev, B, H, Hkv, S, Skv, D, torch.bfloat16)
        o, lse = ops._dense_forward(q, k, v, causal, window, softcap, D ** -0.5,
                                    with_lse=True)

        def call():
            return ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal)

        def calls(n=5):
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        line["granite"] = {
            "shape": f"B={B} H={H} Hkv={Hkv} S={S} D={D} causal bf16",
            "splits": ops.launch_plan(B, H, Hkv, S, Skv, D, torch.bfloat16)[1],
            "ms": c.time_ms(call, iters=10, warmup=3),
            "by_kernel": {f: {"ms": r["ms"] / 5, "launches": r["launches"] / 5}
                          for f, r in c._bwd_kernel_ms(
                              c._device_rows(calls, tries=5)).items()
                          if r["launches"]}}
    return line


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--timed", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--build", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        sys.path.insert(0, os.getcwd())
        import chip_smoke  # noqa: F401  (puts the copy's src first on the path)
        from repro_torch.kernels import _build
        _build.build_all(["flash_attention", "flash_attention_bwd"])
        return
    if args.child:
        print(json.dumps(child(args.child, args.timed)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("bwd_variants: torch sees no CUDA card")
    names = args.variants.split(",")
    timed = [n for n in TIMED if n in names]
    # the timed variants in turns (a, b, b, a), then the rest once
    runs = timed + timed[::-1] + [n for n in names if n not in TIMED]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    lines, rc = [], 0
    with tempfile.TemporaryDirectory() as tmp:
        copies = {n: make_copy(n, Path(tmp)) for n in names}
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        # every copy's two libraries built at once, one nvcc a source
        builds = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--build"],
                                   cwd=copies[n], env=env) for n in names]
        if any([b.wait() for b in builds]):
            sys.exit("bwd_variants: a variant did not build")
        for n in runs:
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child", n]
                                  + (["--timed"] if n in TIMED else []),
                                  cwd=copies[n], env=env, capture_output=True, text=True)
            if proc.returncode:
                rc = 1
                print(json.dumps({"variant": n, "rc": proc.returncode,
                                  "stderr": proc.stderr[-2000:]}), flush=True)
                continue
            lines.append(proc.stdout.strip().splitlines()[-1])
            print(lines[-1], flush=True)
    if args.out:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "bwd_variants.jsonl").write_text("\n".join(lines) + "\n")
    sys.exit(rc)


if __name__ == "__main__":
    main()
