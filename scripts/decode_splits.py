"""Device time of the two split-K decode kernels (paged and dense) under
several split targets, at the shapes the serving paths give them, on one
CUDA card.

    python3 scripts/decode_splits.py [--targets 132,264,512,1024]

Both kernels take their split count from one rule,
``decode_attention.ops.split_count``: about ``TARGET_CTAS`` blocks, never
more than one per 32-position tile or page.  This sets that target in
turn and times each kernel by device time (``chip_smoke.time_ms``), all
in one process on one card, so the targets compare within a call.

Paged decode (llama's pool: H=32, Hkv=8, D=128, pages of 32, a 32-page
table, bf16): the serving run's decode batches of 1 to 4 rows at its
lengths (prompts of 200..600 tokens plus up to 64 generated), one
100-token row, and chip_smoke.py's timed shape [1000, 517, 0, 33].
Dense decode (the slot pool, S=1024): chip_smoke.py's timed shapes, B=4
at [1000, 517, 0, 33] and B=1 at 9, 100 and 600.  One JSON line a shape,
then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as c  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", default="132,264,512,1024")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("decode_splits.py: no CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dense_ops
    from repro_torch.kernels.paged_decode import ops as paged_ops
    _build.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    targets = [int(t) for t in args.targets.split(",")]
    H, Hkv, D = 32, 8, 128

    ka, va, pt = (t.to(torch.bfloat16) if t.is_floating_point() else t
                  for t in c._paged_inputs(gen, dev))
    serving = rng.integers(200, 601 + 64, size=4).tolist()
    paged_shapes = [serving[:b] for b in (1, 2, 3, 4)] + [[100], [1000, 517, 0, 33]]
    for lens in paged_shapes:
        B = len(lens)
        q = torch.randn(B, H, D, generator=gen, device=dev).to(torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        row = {"kernel": "paged_decode_attention", "lengths": lens, "by_target": {}}
        for tgt in targets:
            dense_ops.TARGET_CTAS = tgt
            ms = c.time_ms(lambda: paged_ops.paged_decode_attention(
                q, ka, va, pt[:B], lengths))
            row["by_target"][tgt] = {"n_splits": paged_ops.n_splits(B, Hkv, pt.shape[1]),
                                     "ms": ms}
        row["bound_ms"] = c.bound(c._paged_decode_bytes(lengths, H, Hkv, D, 2),
                                  4 * sum(lens) * H * D, torch.bfloat16)[0]
        c.emit(row)

    S = 1024
    for lens in ([1000, 517, 0, 33], [9], [100], [600]):
        B = len(lens)
        q, k, v = (torch.randn(B, *shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((H, D), (S, Hkv, D), (S, Hkv, D)))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        row = {"kernel": "decode_attention", "lengths": lens, "by_target": {}}
        for tgt in targets:
            dense_ops.TARGET_CTAS = tgt
            ms = c.time_ms(lambda: dense_ops.decode_attention(q, k, v, lengths))
            row["by_target"][tgt] = {"n_splits": dense_ops.n_splits(B, Hkv, S), "ms": ms}
        row["bound_ms"] = c.bound(*c._decode_cost(lengths, H, Hkv, D, 2), torch.bfloat16)[0]
        c.emit(row)
    c.emit({"timed_by_events": len(c.PROFILER_MISSES)})
    print(c.smi_line(), flush=True)


if __name__ == "__main__":
    main()
