"""Train a ~100M-parameter llama-family model for a few hundred steps with
the full training substrate of the PyTorch/CUDA port: AdamW, remat,
checkpointing, int8 gradient compression.

~100M params: d_model=512, 8 layers, vocab 50304 (most params in the
embedding at this scale, as usual for small LMs).

The twin of ``examples/train_100m.py``, through ``repro_torch`` alone.
As there, the ~100M config is counted and printed, and the run trains
``launch.train.build_small_cfg``'s reduced llama (``d_model=0,
layers=0``).  Its weights are drawn on the CPU from a generator seeded 0
and moved to ``--device``, so a run on the card starts from the CPU
run's weights.  On the card each step's attention runs the flash
kernel's forward with its lse and its backward kernel.  The checkpoints
go to a directory of their own (``gentorrent_100m_torch`` in the temp
directory): the two packages do not read each other's checkpoints.

    PYTHONPATH=src python examples/torch_train_100m.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch import configs, require_device
from repro_torch.launch.train import build_small_cfg, train
from repro_torch.models.lm import LM
from repro_torch.params import init_params
from repro_torch.training.optimizer import tree_leaves, tree_map

ARCH = "gentorrent-llama3-8b"
CKPT_DIR = os.path.join(tempfile.gettempdir(), "gentorrent_100m_torch")


def config_100m():
    """The ~100M-param config the example counts."""
    cfg = configs.get_config(ARCH).reduced()
    return dataclasses.replace(cfg, d_model=512, d_head=128, n_layers=8,
                               d_ff=1408, vocab=50304)


def n_params(cfg) -> int:
    """``cfg``'s parameter count, from the weight tree's shapes on the
    meta device (no storage)."""
    return sum(x.numel() for x in tree_leaves(LM(cfg, device="meta").param_specs()))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression w/ error feedback")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains (cuda or cpu)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)

    # ~100M-param config check
    cfg = config_100m()
    n = n_params(cfg)
    print(f"model: {n/1e6:.1f}M params "
          f"({cfg.n_layers}L d{cfg.d_model} ff{cfg.d_ff} V{cfg.vocab})")

    params = init_params(build_small_cfg(ARCH), torch.Generator().manual_seed(0), "cpu")
    out = train(ARCH, steps=args.steps, batch=args.batch,
                seq=args.seq, ckpt_dir=args.ckpt_dir, d_model=0, layers=0,
                lr=3e-3, compress=args.compress,
                params=tree_map(lambda t: t.to(dev), params), device=dev)
    print(f"loss: {out['first_loss']:.3f} -> {out['final_loss']:.3f} "
          f"({out['tokens_per_s']:,.0f} tok/s)")
    assert out["final_loss"] < out["first_loss"]
    return {"n_params": n, **{k: out[k] for k in (
        "losses", "first_loss", "final_loss", "tokens_per_s")}}


if __name__ == "__main__":
    main()
