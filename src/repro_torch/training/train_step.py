"""Training step (port of ``repro/training/train_step.py``): loss and
gradients by autograd (through the flash kernel's backward on the card),
optional microbatch gradient accumulation, optional gradient compression,
then AdamW."""
from __future__ import annotations

import torch

from repro_torch.models.lm import lm_loss
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import tree_leaves, tree_map


def make_train_step(cfg, model, adamw: opt.AdamWConfig,
                    microbatches: int = 1, compress_grads=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}).

    batch: {"tokens": (B, S) int32, "labels": (B, S) int32, [aux inputs]},
    tensors on the params' device.  With ``microbatches`` > 1 the batch is
    cut into that many equal parts along B, whose f32 gradients are summed
    and divided, as the reference's scan does.  ``compress_grads``
    (training/compression.py) is applied to the gradient tree before the
    optimizer.  The params given are left as they were: the step returns
    new trees."""

    def grads_of(params, batch):
        """(loss, f32 gradient tree) of one (micro)batch."""
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        graded = tree_map(lambda _: next(it), params)
        aux = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        loss, _ = lm_loss(cfg, model, graded, batch["tokens"], batch["labels"],
                          aux=aux or None, remat=True)
        gs = torch.autograd.grad(loss, live, allow_unused=True)
        it = iter(torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  if g is None else g.float() for p, g in zip(live, gs))
        return loss.detach(), tree_map(lambda _: next(it), params)

    def compute_grads(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
        mb = B // microbatches
        acc, loss_sum = None, 0.0
        for i in range(microbatches):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = grads_of(params, part)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            loss_sum = loss_sum + loss
        return loss_sum / microbatches, tree_map(lambda g: g / microbatches, acc)

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state, om = opt.apply_updates(adamw, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **om}

    return train_step
