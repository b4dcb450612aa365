"""Device time of each kernel behind one call of the scan and the chunk
hash, on the card, at chip_smoke.py's timed shapes.

    python3 scripts/scan_kernels.py

A bf16 scan call is three launches (chunk states, state passing, chunk
outputs) or, on the boot path, one; ``chip_smoke.py`` reports their sum.
This prints each launch's device time (torch.profiler, averaged over the
calls) at B=1 S=2048 H=64 P=128 N=16 L=128 with a start state and at the
S=8 boot prefill, and the chunk hash's fixed and ranged entries beside an
empty kernel with the ranged entry's launch shape.  One JSON line each,
then the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def per_kernel_ms(fn, iters=20, warmup=5):
    """[kernel name, device ms a call, launches a call] for every device
    kernel ``fn`` runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [[e.key[:80], e.self_device_time_total / iters / 1e3, e.count / iters]
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def main():
    if not torch.cuda.is_available():
        sys.exit("scan_kernels: torch sees no CUDA card")
    import chip_smoke
    from repro_torch.core import hrtree
    from repro_torch.kernels import _build
    from repro_torch.kernels.chunk_hash import ops as hash_ops
    from repro_torch.kernels.mamba_scan import ops
    _build.build_all(["mamba_scan", "chunk_hash"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, P, N, L = 1, 64, 128, 16, 128
    for S, with_h0 in ((2048, True), (8, False)):
        x = (torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5).bfloat16()
        loga = -torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen, device=dev))
        bm, cm = ((torch.randn(B, S, N, generator=gen, device=dev) * 0.5).bfloat16()
                  for _ in range(2))
        h0 = torch.randn(B, H, N, P, generator=gen, device=dev) * 0.1 if with_h0 else None
        print(json.dumps({"scan": f"B={B} S={S} H={H} P={P} N={N} L={min(L, S)} bf16 "
                                  f"h0={with_h0}",
                          "kernels": per_kernel_ms(
                              lambda: ops.mamba_scan(x, loga, bm, cm, h0, chunk=L))}),
              flush=True)
    flat, st, ln, _ = hrtree.chunk_table(chip_smoke._traffic(0, 128_256),
                                         chip_smoke._overlay_lengths(), device=dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 128_256, (64, 8192))
                            .astype(np.int32)).to(dev)
    for name, fn in (("ranged sync broadcast", lambda: hash_ops.chunk_hash_ranges(flat, st, ln)),
                     ("empty launch, ranged shape", lambda: hash_ops.launch_floor(len(ln), dev)),
                     ("fixed B=64 S=8192 width 64", lambda: hash_ops.chunk_hash_fixed(toks, 64))):
        print(json.dumps({"chunk_hash": name, "kernels": per_kernel_ms(fn, iters=50)}),
              flush=True)
    print(chip_smoke.smi_line(), flush=True)


if __name__ == "__main__":
    main()
