"""Activation-checkpoint (remat) policies for the train step (port of
``repro/distributed/remat.py``).

The policy trades recomputation in the backward pass against the memory
of live activations:

* ``"full"``: keep nothing of the body, recompute it in the backward
  (``torch.utils.checkpoint.checkpoint``, non-reentrant);
* ``"dots"``: keep the outputs of matrix products without batch dims
  (``aten.mm`` / ``aten.addmm``: every projection and FFN product), and
  recompute the rest (selective checkpointing);
* ``"none"``: no remat, the body as it is.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = ("full", "dots", "none")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def wrap(body, policy: str = "full"):
    """``body`` under ``policy``: a function of the same arguments."""
    if policy not in POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {POLICIES}")
    if policy == "none":
        return body
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _dots_policy)

    @functools.wraps(body)
    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return wrapped
