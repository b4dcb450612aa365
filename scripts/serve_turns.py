"""The serving phases of two checkouts in turns on one card, for the
before/after of a change that may reach the serving paths.

    python3 scripts/serve_turns.py BASE TREE [--seed N] [--turns 2] [--out DIR]

Runs ``chip_smoke.py``'s ``serve_bf16`` (llama on the paged pool, all 32
layers), ``jamba_serve_bf16`` and ``xlstm_serve_bf16`` (the dense slot pool:
the flash kernel's dense entry, the dense decode, the scan and the mLSTM)
of each checkout's own ``chip_smoke.py``, each checkout building its own
kernels, in turns BASE, TREE, TREE, BASE (``--turns`` pairs of them), one
process a turn; prints one JSON line a phase and turn (the card's name and
power limit first): tokens/s, TTFT, the traced window's idle share and the
scan's and the mLSTM's device time there (also appended to
DIR/serve_turns.jsonl with ``--out``).  Exits nonzero if a phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TURN = r'''
import json, os, sys
sys.path[:0] = ["src", "."]
import torch
import chip_smoke as c
from repro_torch.kernels import _build
_build.build_all()
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
seed = int(sys.argv[1])

def pick(line, keys):
    return {k: line.get(k) for k in keys if k in line}

line, _, params = c.serve_bf16(seed, dev, None)
del params
c._free()
print(json.dumps({"tree": os.getcwd(), "phase": "serve_bf16",
                  **pick(line, ("runs", "ttft_s", "profile"))}), flush=True)
for phase in (c.jamba_serve_bf16, c.xlstm_serve_bf16):
    line, _ = phase(seed, dev, None)
    c._free()
    print(json.dumps({"tree": os.getcwd(), "phase": line["phase"],
                      **pick(line, ("run", "profile", "prefill_2048"))}), flush=True)
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base", type=Path)
    ap.add_argument("tree", type=Path)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--turns", type=int, default=2, help="pairs of turns (each BASE, TREE)")
    ap.add_argument("--out", type=Path, default=None, help="directory for serve_turns.jsonl")
    args = ap.parse_args()
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    if args.out is not None:
        with open(args.out / "serve_turns.jsonl", "a") as f:
            f.write(json.dumps({"card": card}) + "\n")
    order = []
    for i in range(args.turns):
        order += [args.base, args.tree] if i % 2 == 0 else [args.tree, args.base]
    rc = 0
    for tree in order:
        r = subprocess.run([sys.executable, "-c", TURN, str(args.seed)], cwd=tree.resolve(),
                           stdout=subprocess.PIPE, text=True)
        print(r.stdout, end="", flush=True)
        if args.out is not None:
            with open(args.out / "serve_turns.jsonl", "a") as f:
                f.writelines(ln for ln in r.stdout.splitlines(keepends=True) if ln.startswith("{"))
        rc = rc or r.returncode
    sys.exit(rc)


if __name__ == "__main__":
    main()
