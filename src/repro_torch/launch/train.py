"""End-to-end training driver (port of ``repro/launch/train.py``): data
pipeline -> train_step -> checkpoints, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch gentorrent-llama3-8b --steps 100 --batch 8 --seq 128 --device cuda

trains the reduced config of ``--arch`` (``--d-model`` and ``--layers``
widen and deepen it) from random weights made from seed 0, on batches of
``MarkovCorpus(vocab, seed=0)``, and prints the first and final loss and
tokens/s as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch import configs, require_device
from repro_torch.models.lm import LM
from repro_torch.params import init_params
from repro_torch.training import checkpoint as ckpt_lib
from repro_torch.training import compression, optimizer as opt_lib
from repro_torch.training.data import MarkovCorpus
from repro_torch.training.train_step import make_train_step


def build_small_cfg(arch: str, d_model: int = 0, layers: int = 0):
    red = configs.get_config(arch).reduced()
    kw = {}
    if d_model:
        kw.update(d_model=d_model, d_head=d_model // red.n_heads)
    if layers:
        if layers % len(red.pattern):
            raise ValueError(f"layers={layers} is not a multiple of the "
                             f"{len(red.pattern)}-layer pattern")
        kw.update(n_layers=layers)
    return dataclasses.replace(red, **kw) if kw else red


def train(arch: str, steps: int, batch: int, seq: int, ckpt_dir: str = "",
          d_model: int = 0, layers: int = 0, lr: float = 3e-3,
          resume: bool = True, compress: bool = False,
          microbatches: int = 1, log_every: int = 10,
          fail_at_step: int = -1, params=None, device="cuda") -> dict:
    """Train for ``steps`` steps on ``device`` (a CUDA device needs a
    card).  ``params``: the initial weights (a tree on ``device``; by
    default ``init_params`` with a generator seeded 0).  Returns the
    losses, the first and final loss, tokens/s, the params and the
    config."""
    dev = require_device(device)
    cfg = build_small_cfg(arch, d_model, layers)
    model = LM(cfg, device=dev)
    adamw = opt_lib.AdamWConfig(lr=lr, warmup_steps=max(10, steps // 20),
                                total_steps=steps)
    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)

    compress_grads = None
    if compress:
        err_state = compression.init_error_state(params)

        def compress_grads(grads):
            nonlocal err_state
            g, err_state = compression.compress_int8_ef(grads, err_state)
            return g

    step_fn = make_train_step(cfg, model, adamw, microbatches=microbatches,
                              compress_grads=compress_grads)
    opt_state = opt_lib.init_state(params)
    start = 0
    if resume and ckpt_dir:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), start = ckpt_lib.restore(
                ckpt_dir, last, (params, opt_state))
            print(f"resumed from step {start}")

    corpus = MarkovCorpus(cfg.vocab, seed=0)
    losses = []
    t0 = time.time()
    tokens_done = 0
    it = corpus.batches(batch, seq, steps, seed=100 + start)
    for i, b in zip(range(start, steps), it):
        if i == fail_at_step:
            raise RuntimeError(f"injected failure at step {i}")
        batch_t = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        params, opt_state, m = step_fn(params, opt_state, batch_t)
        loss = float(m["loss"])
        losses.append(loss)
        tokens_done += batch * seq
        if ckpt_dir and (i + 1) % 50 == 0:
            ckpt_lib.save(ckpt_dir, i + 1, (params, opt_state))
            ckpt_lib.prune(ckpt_dir, keep=2)
        if (i + 1) % log_every == 0:
            tps = tokens_done / (time.time() - t0)
            print(f"step {i+1:>5} loss {loss:.4f} ({tps:,.0f} tok/s)")
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, steps, (params, opt_state))
    return {"final_loss": losses[-1] if losses else None,
            "first_loss": losses[0] if losses else None,
            "losses": losses, "params": params, "cfg": cfg,
            "tokens_per_s": tokens_done / max(time.time() - t0, 1e-9)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gentorrent-llama3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = train(args.arch, args.steps, args.batch, args.seq, args.ckpt_dir,
                d_model=args.d_model, layers=args.layers, lr=args.lr,
                compress=args.compress, microbatches=args.microbatches,
                fail_at_step=args.fail_at_step, device=args.device)
    print(json.dumps({k: v for k, v in out.items()
                      if k in ("final_loss", "first_loss", "tokens_per_s")}))


if __name__ == "__main__":
    main()
