"""AdamW and its learning-rate schedule (port of
``repro/training/optimizer.py``), in plain torch on the port's param
trees: nested dicts whose ``blocks`` is a tuple, leaves of any dtype.

The state mirrors the params: f32 ``mu`` and ``nu`` and an int ``step``.
Updates run leaf by leaf in float32 and are written back in each
parameter's dtype, as in the reference; ``apply_updates`` returns new
trees and leaves its inputs as they were.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_leaves(tree) -> list:
    """The tensors of a param tree, in ``tree_map``'s order (dicts in
    their keys' order, tuples in order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of ``rest``),
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_pick(tree, i):
    """Element ``i`` of each tuple of tensors at the leaves of ``tree`` (a
    ``tree_map`` whose function returned several tensors)."""
    if isinstance(tree, dict):
        return {k: tree_pick(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree[0], torch.Tensor):
        return tuple(tree_pick(v, i) for v in tree)
    return tree[i]


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio * lr``
    at ``total_steps`` (float32, as the reference computes it)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(params) -> dict:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    return {"mu": zeros, "nu": tree_map(torch.clone, zeros),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in leaves]).sum())


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, grad_norm=None):
    """One AdamW step.  Returns (new_params, new_state, {"grad_norm",
    "lr"}); the gradients are clipped to ``grad_clip`` by their global
    norm, weight decay is decoupled.  ``grad_norm``: that norm where the
    trees are one rank's shards (the sharded step's, over every rank);
    default ``global_norm(grads)``."""
    step = state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    return tree_pick(out, 0), {"mu": tree_pick(out, 1), "nu": tree_pick(out, 2),
                               "step": step}, {"grad_norm": gnorm, "lr": lr}
