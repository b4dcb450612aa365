"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the check's numbers, each beside its
limit, as the last lines of standard error, and one JSON object as the
last line of standard output: ``correct``, ``attempted``, ``failed``, the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, with the device's busy and window seconds and a
breakdown), ``device``, the card's name and power limit, the KV arena's
pages and the most of them in use, the tokens checked, and last ``check``.
Exits non-zero, printing no result, without a CUDA card (or fewer than the
cell asks for), or if the JAX package, JAX, jaxlib or flax was loaded in
this process.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare():
    """Every build and kernel cache at a fixed place inside the checkout
    (before torch is imported), and the port and the harness importable."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare()
    import torch

    from harness import cell, spec
    chips = spec.cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    sc, fill = out["scored"], out["arena"]
    print(f"portbench: {out['served']} requests served, {sc['scored_tokens']} of their tokens "
          f"checked, {sc['late_tokens']} of those of requests admitted in the window; "
          f"arena {fill['peak_pages_used']} of {fill['pages']} pages at most in use",
          file=sys.stderr)
    for name, (value, limit) in out["check"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    line = {"correct": out["correct"], **out["line"], "card": card(), "arena": fill,
            "scored": sc, "check": out["check"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
