"""Dry-run sweep of the port: every (arch x shape x mesh) cell in its own
subprocess (the fake process group is process-global), resumable: cells
with an ``ok`` or ``skipped`` record are kept unless FORCE=1.

    PYTHONPATH=src python scripts/dryrun_sweep_torch.py [--meshes 1pod|2pod|both] \
        [--archs ARCH,ARCH] [--shapes SHAPE,SHAPE]

Records go to ``results/dryrun_torch/<mesh>/``, a log with each cell's
status and seconds to ``results/dryrun_torch/sweep.log``; render them with
``python -m repro_torch.launch.roofline``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ARCHS = [
    "whisper-base", "xlstm-1.3b", "h2o-danube-1.8b", "gentorrent-llama3-8b",
    "gemma2-9b", "llama-3.2-vision-11b", "moonshot-v1-16b-a3b", "granite-20b",
    "yi-34b", "jamba-v0.1-52b", "dbrx-132b",
]
SHAPES = ["train_4k", "decode_32k", "prefill_32k", "long_500k"]
ROOT = Path(__file__).resolve().parents[1]
OUT = Path("results/dryrun_torch")
LOG = OUT / "sweep.log"
TIMEOUT_S = 7200


def log(msg):
    line = f"[{time.strftime('%H:%M:%S')}] {msg}"
    print(line, flush=True)
    LOG.parent.mkdir(parents=True, exist_ok=True)
    with LOG.open("a") as f:
        f.write(line + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--meshes", default="both", choices=("1pod", "2pod", "both"))
    ap.add_argument("--archs", default=",".join(ARCHS),
                    help="comma-separated configs to run (default: all)")
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated shapes to run (default: all)")
    args = ap.parse_args()
    archs, shapes = args.archs.split(","), args.shapes.split(",")
    unknown = (set(archs) - set(ARCHS)) | (set(shapes) - set(SHAPES))
    if unknown:
        ap.error(f"unknown configs or shapes: {sorted(unknown)}")
    force = os.environ.get("FORCE") == "1"
    pods = {"1pod": (False,), "2pod": (True,), "both": (False, True)}[args.meshes]
    cells = [(a, s, mp) for mp in pods for a in archs for s in shapes]
    t_all = time.time()
    for i, (arch, shape, mp) in enumerate(cells):
        mesh = "pod2x16x16" if mp else "pod16x16"
        out = OUT / mesh / f"{arch}_{shape}.json"
        if out.exists() and not force and \
                json.loads(out.read_text()).get("status") in ("ok", "skipped"):
            continue
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--out", str(OUT), "--force"]
        if mp:
            cmd.append("--multi-pod")
        t0 = time.time()
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        try:
            subprocess.run(cmd, capture_output=True, text=True, timeout=TIMEOUT_S, env=env)
        except subprocess.TimeoutExpired:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps({"arch": arch, "shape": shape, "mesh": mesh,
                                       "status": "error",
                                       "error": f"timeout ({TIMEOUT_S} s)"}))
        rec = json.loads(out.read_text()) if out.exists() else {}
        log(f"{i + 1}/{len(cells)} {mesh} {arch} {shape}: {rec.get('status', '?')} "
            f"({time.time() - t0:.1f}s)")
        if rec.get("status") == "error":
            log(f"   ERROR: {rec.get('error', '')[:200]}")
    log(f"sweep done in {(time.time() - t_all) / 60:.1f} min")


if __name__ == "__main__":
    main()
