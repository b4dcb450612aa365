"""Ground-truth model for the verification example on the PyTorch/CUDA
port (the port's copy of ``benchmarks/gt_model.py``): a tiny LM trained on
the structured Markov corpus, plus the four degraded impostors of §4.3:

  GT  trained model (stands in for Meta-Llama-3.1-8B-Instruct-Q4_0)
  m1  mild weight quantization        (Llama-3.2-3B-Q4_K_M stand-in)
  m2  harsh weight quantization       (Llama-3.2-1B-Q4_K_M)
  m3  harsh quantization + noise      (Llama-3.2-1B-Q4_K_S)
  m4  mild quantization + noise       (Llama-3.2-3B-Q4_K_S)

The stand-ins reproduce the *ordering* GT > m1/m4 > m2/m3 that drives the
paper's credit-score separation.  On the card, training runs the flash
kernel's forward with its lse and its backward kernel, and ``greedy`` the
flash kernel's dense entry (prefill) and the dense decode kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import configs, require_device
from repro_torch.models.lm import LM
from repro_torch.params import init_params
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.data import MarkovCorpus
from repro_torch.training.optimizer import tree_map
from repro_torch.training.train_step import make_train_step


def gt_config():
    cfg = configs.get_config("gentorrent-llama3-8b").reduced()
    return dataclasses.replace(cfg, vocab=256, d_model=96, d_head=24)


def trained_gt(steps: int = 150, params=None, device="cuda"):
    """The GT model after ``steps`` AdamW steps on batches of 16 x 48
    tokens of the corpus.  ``params``: the initial weights on ``device``
    (by default ``init_params`` from a CPU generator seeded 0, moved to
    ``device``).  Returns (cfg, model, params, corpus, each step's
    loss)."""
    dev = require_device(device)
    cfg = gt_config()
    model = LM(cfg, device=dev)
    adamw = opt_lib.AdamWConfig(lr=5e-3, warmup_steps=10, total_steps=steps)
    step = make_train_step(cfg, model, adamw)
    if params is None:
        params = tree_map(lambda t: t.to(dev), init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
    opt = opt_lib.init_state(params)
    corpus = MarkovCorpus(cfg.vocab, seed=0, branching=2, noise=0.02)
    losses = []
    for b in corpus.batches(16, 48, steps):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v).to(dev)
                                            for k, v in b.items()})
        losses.append(float(m["loss"]))
    return cfg, model, params, corpus, losses


def _quantize(params, levels, noise=0.0, seed=1):
    """Each leaf with ndim >= 2 rounded to ``levels`` steps of its largest
    magnitude s (over the whole stacked leaf), plus ``noise`` * s Gaussian
    noise from a CPU generator seeded ``seed`` (drawn leaf by leaf in the
    tree's order, so every device gets the same noise); other leaves are
    shared."""
    gen = torch.Generator().manual_seed(seed)

    def q(x):
        if x.ndim < 2:
            return x
        s = x.abs().max() + 1e-9
        y = torch.round(x / s * levels) / levels * s
        if noise:
            y = y + noise * s * torch.randn(y.shape, generator=gen).to(y)
        return y
    return tree_map(q, params)


def impostors(params):
    """Degradation ladder: m1/m4 mild (3B-class stand-ins), m2/m3 harsh
    (1B-class).  Calibrated so the mild pair sits near the abnormal
    threshold and the harsh pair well below it (paper Fig 11/12)."""
    return {
        "m1": _quantize(params, levels=4, noise=0.02),
        "m2": _quantize(params, levels=2, noise=0.10),
        "m3": _quantize(params, levels=1, noise=0.08),
        "m4": _quantize(params, levels=4, noise=0.04),
    }


def greedy(model, params, prompt, n=16):
    """``n`` greedy tokens after ``prompt``: one dense prefill, then one
    decode a token."""
    dev = model.device
    toks = list(prompt)
    logits, cache = model.prefill(params, torch.tensor([toks], dtype=torch.int32, device=dev),
                                  max_len=len(toks) + n + 2)
    out = []
    pos = len(toks)
    for _ in range(n):
        nxt = int(logits[0].argmax())
        out.append(nxt)
        logits, cache = model.decode(params, cache,
                                     torch.tensor([[nxt]], dtype=torch.int32, device=dev),
                                     torch.tensor([pos], dtype=torch.int32, device=dev))
        pos += 1
    return out
