"""How far one float32 training step is from the same step in float64, on
the CPU: the floor under any card-against-CPU comparison of a float32 step.

    PYTHONPATH=src python scripts/train_f32_drift.py [CONFIG ...]

For each reduced config (default: jamba-v0.1-52b and xlstm-1.3b), one
``make_train_step`` step (AdamW, lr 1e-3, 2 warm-up steps; the config,
batch and seed of ``chip_smoke.py``'s ``train_f32_parity``, the weights as
this machine's torch draws them) runs in float32 and in float64 from the
same weights; prints the loss's and the gradient norm's
difference, and the updated weights' largest difference over all leaves,
absolute and as a share of the leaf's largest entry.  AdamW's first step
moves a weight by about lr sign(g), so where float32 rounding is comparable
to a gradient entry the weight moves by up to 2 lr: that, not the kernels,
sets how close two float32 steps can be.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main():
    import chip_smoke as c
    from repro_torch import configs
    from repro_torch.models.lm import LM
    from repro_torch.params import init_params
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step
    configs._DTYPES.setdefault("float64", torch.float64)  # this measurement only
    cpu = torch.device("cpu")
    adamw = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    for name in sys.argv[1:] or (c.JAMBA, c.XLSTM):
        cfg = configs.get_config(name).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0), cpu)
        batch = c._train_batch(cfg, 0, 2, 48, cpu)
        runs = {}
        for dtype, dname in ((torch.float32, "float32"), (torch.float64, "float64")):
            cfg_d = dataclasses.replace(cfg, dtype=dname, param_dtype=dname)
            p = opt.tree_map(lambda t: t.to(dtype), params)
            new, _, m = make_train_step(cfg_d, LM(cfg_d, cpu), adamw)(
                p, opt.init_state(p), batch)
            runs[dname] = (m["loss"].double(), m["grad_norm"].double(),
                           [t.double() for t in c._leaves(new)])
        (l32, g32, w32), (l64, g64, w64) = runs["float32"], runs["float64"]
        abs_err = max((a - b).abs().max().item() for a, b in zip(w32, w64))
        share = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(w32, w64))
        print(f"{name}: loss {l64.item():.6g}, off by {abs(l32 - l64).item():.3g}; grad norm "
              f"{g64.item():.6g}, off by {abs(g32 - g64).item():.3g}; updated weights off by "
              f"{abs_err:.3g} at most, {share:.3g} of a leaf's largest entry at most")


if __name__ == "__main__":
    main()
