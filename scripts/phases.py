"""One group of ``chip_smoke.py``'s phases on its own, on the card, then
the card tests of that group.

    python3 scripts/phases.py GROUP [--seed N] [--out DIR]

GROUP is one of:

* ``privacy``: ``privacy_overlay_f32_parity``, then
  ``privacy_overlay_bf16`` on ``serve_bf16``'s full-depth bf16 weights
  made from the same seed; card tests ``-k overlay``;
* ``verification``: ``verification_f32_parity``, then
  ``verification_bf16`` on those weights; card tests ``-k verifier``;
* ``families``: the three attention kernels' checks (their new shapes
  included: the non-causal dense entry with keys of their own length, the
  dense decode over a static memory, both paged entries at every paged
  config's head layout), then ``families_f32_parity``,
  ``families_serve_bf16`` and ``encdec_serve_bf16``; the card tests of
  those shapes and families;
* ``training``: the three backward kernels against their plain versions
  (rows 2b, 4b and 5b of the ``kernels`` line: the flash kernel's, the
  scan's, the mLSTM's), then ``train_f32_parity``, ``train_bf16``,
  ``train_jamba_bf16`` and ``train_xlstm_bf16``; card tests of the
  backwards, the refused gradients and ``lm_loss`` on the card;
* ``distributed``: ``train_sharded_bf16`` (the sharded train step on a
  one-rank NCCL group: its f32 check against the unsharded step, its bf16
  run, the dry-run of one 16 x 16 cell on this host), then both flash
  kernels at one rank's heads under tensor parallelism (``TP_LAYOUTS``),
  the scan and the mLSTM with their backwards at one rank's share
  (``TP_SCAN``, ``TP_MLSTM``) and ``tp_emulated_bf16`` (16 model ranks
  of a full-width layer emulated on the card); card tests ``-k sharded``
  and the kernels at those layouts;
* ``examples``: ``examples``, each twin of ``examples/`` through its own
  ``main`` on the card, held to the same twin's run on the CPU; card
  tests of the paged serving, the overlay and the verifier.

Builds the kernels the group runs, prints the card's name and power
limit, then one JSON line a phase as ``chip_smoke.py`` prints it, with
its seconds (also written to ``DIR/GROUP_phases.jsonl`` with ``--out``),
then runs the card tests; exits with their code.  ``SMOKE="scripts/phases.py
GROUP" bash scripts/chip_check.sh OUT`` runs it in place of
``chip_smoke.py``.
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


def _llama_bf16(c, seed, dev):
    """``serve_bf16``'s full-depth bf16 weights from ``seed``."""
    from repro_torch import configs
    from repro_torch.params import init_params
    return init_params(configs.get_config(c.NAME), torch.Generator(device=dev).manual_seed(seed),
                       dev, dtype=torch.bfloat16)


def _groups(c, seed, dev, out):
    """GROUP -> (kernels to build, phase callables, card tests' -k)."""
    attn = ["paged_decode", "flash_attention"]

    def kernels():
        gen = torch.Generator(device=dev).manual_seed(seed)
        return {"phase": "kernels", "kernels": [check(gen, dev) for check in (
            c.check_paged_decode, c.check_paged_flash, c.check_dense_flash,
            c.check_dense_decode)]}
    return {
        "privacy": (["chunk_hash", *attn], [
            lambda: c.privacy_overlay_f32_parity(seed, dev),
            lambda: c.privacy_overlay_bf16(seed, dev, _llama_bf16(c, seed, dev))],
            "overlay"),
        "verification": (["chunk_hash", *attn], [
            lambda: c.verification_f32_parity(seed, dev),
            lambda: c.verification_bf16(seed, dev, _llama_bf16(c, seed, dev))],
            "verifier"),
        "families": ([*attn, "decode_attention"], [
            kernels, lambda: c.families_f32_parity(seed, dev),
            lambda: c.families_serve_bf16(seed, dev, out),
            lambda: c.encdec_serve_bf16(seed, dev, out)],
            "noncausal or static_memory or every_head_layout or full_width_layer"),
        "training": (["flash_attention", "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd",
                      "mlstm", "mlstm_bwd"], [
            lambda: {"phase": "kernels", "kernels": [check(
                torch.Generator(device=dev).manual_seed(seed), dev) for check in (
                    c.check_flash_bwd, c.check_mamba_scan_bwd, c.check_mlstm_bwd)]},
            lambda: c.train_f32_parity(seed, dev),
            lambda: c.train_bf16(seed, dev, out),
            lambda: c.train_jamba_bf16(seed, dev, out),
            lambda: c.train_xlstm_bf16(seed, dev, out)],
            "bwd or backward or refuse_a_gradient or float64 or return_gradients"),
        "distributed": (["flash_attention", "flash_attention_bwd", "mamba_scan",
                         "mamba_scan_bwd", "mlstm", "mlstm_bwd"], [
            lambda: c.train_sharded_bf16(seed, dev, out),
            lambda: {"phase": "kernels", "kernels": {
                **c.check_flash_tp_layouts(torch.Generator(device=dev).manual_seed(seed), dev),
                **c.check_recurrent_tp_layouts(torch.Generator(device=dev).manual_seed(seed),
                                               dev)}},
            lambda: c.tp_emulated_bf16(seed, dev, out)],
            "sharded or 1x2x1x2048 or 1x3x1x2048 or 1x1x1x2048 or 2048x4x128 "
            "or 1x2048x4x1024x64"),
        "examples": (["paged_decode", "flash_attention", "flash_attention_bwd",
                      "decode_attention", "chunk_hash"], [
            lambda: c.examples(seed, dev, out)],
            "test_serving_on_card or overlay_on_card or preprocess_batch or verifier"),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("group", choices=("privacy", "verification", "families", "training",
                                      "distributed", "examples"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None,
                    help="directory that also receives the phases' lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("phases: torch sees no CUDA card")
    import chip_smoke as c
    from repro_torch.kernels import _build
    dev = torch.device("cuda")
    builds, phases, card_tests = _groups(c, args.seed, dev, args.out)[args.group]
    t0 = time.monotonic()
    _build.build_all(builds)
    print(c.smi_line(), flush=True)
    lines = []

    def emit(obj):
        c.emit(obj)
        lines.append(json.dumps(obj))
    emit({"phase": "build", "seconds": time.monotonic() - t0})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for phase in phases:
        t0 = time.monotonic()
        line = phase()
        emit({**(line[0] if isinstance(line, tuple) else line),
              "seconds": time.monotonic() - t0})
        del line
        c._free()
    c._write(args.out, f"{args.group}_phases.jsonl", "\n".join(lines) + "\n")
    sys.exit(subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-m", "cuda",
         "tests/test_torch_cuda.py", "-k", card_tests], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}).returncode)


if __name__ == "__main__":
    main()
