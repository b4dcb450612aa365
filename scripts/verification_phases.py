"""The verification phases of ``chip_smoke.py`` on their own, on the
card, then the card test of the verifier.

    python3 scripts/verification_phases.py [--seed N] [--out DIR]

Builds the three kernels the path runs (chunk hash, paged decode, flash
attention), runs ``verification_f32_parity`` and, on ``serve_bf16``'s
full-depth bf16 weights made from the same seed, ``verification_bf16``:
one JSON line each, as ``chip_smoke.py`` prints them, with each phase's
seconds (also written to ``DIR/verification_phases.jsonl`` with
``--out``).  Then ``tests/test_torch_cuda.py -k verifier``.  The card's
name and power limit come first.  ``SMOKE=scripts/verification_phases.py
bash scripts/chip_check.sh OUT`` runs it in place of ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory that also receives the phases' lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("verification_phases: torch sees no CUDA card")
    import chip_smoke as c
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.params import init_params
    t0 = time.monotonic()
    _build.build_all(["chunk_hash", "paged_decode", "flash_attention"])
    print(c.smi_line(), flush=True)
    lines = []

    def emit(obj):
        c.emit(obj)
        lines.append(json.dumps(obj))
    emit({"phase": "build", "seconds": time.monotonic() - t0})
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    emit({**c.verification_f32_parity(args.seed, dev), "seconds": time.monotonic() - t0})
    c._free()
    cfg = configs.get_config(c.NAME)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev,
                         dtype=torch.bfloat16)
    t0 = time.monotonic()
    line, _ = c.verification_bf16(args.seed, dev, params)
    emit({**line, "seconds": time.monotonic() - t0})
    del params
    c._free()
    c._write(args.out, "verification_phases.jsonl", "\n".join(lines) + "\n")
    sys.exit(subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "cuda",
         "tests/test_torch_cuda.py", "-k", "verifier"], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}).returncode)


if __name__ == "__main__":
    main()
