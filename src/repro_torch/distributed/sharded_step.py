"""The train step over a mesh: the counterpart of the reference's
``jax.jit(train_step, in_shardings=..., out_shardings=...)``
(``repro/launch/dryrun.py`` ``build_step``, ``tests/test_distributed_exec.py``).

State: params and AdamW ``mu`` / ``nu`` are DTensors in
``param_shardings(train=True)``'s placements (weights FSDP-sharded over
'data', TP dims over 'model'); ``step`` is a plain tensor, the same on
every rank.  The batch is a dict of DTensors split over the DP axes
(``input_shardings``).

Each rank computes on plain local tensors: its slice of the batch over
the DP ranks, and its shard over 'model' (``constraints.model_shards``;
``distributed/tensor_parallel.py``): its query heads (and KV heads where
they divide), its columns and rows of ``d_ff``, its experts, its vocab
rows of the embedding and the head, a Mamba mixer's heads, an mLSTM's
value columns and an sLSTM's columns of every head, with the sums,
gathers and all-to-alls that GSPMD inserts in the reference made explicit
over the model group.  Whatever the rules leave whole on 'model' (yi's 56
query heads at 16; a Mamba, mLSTM or sLSTM mixer whose split dim does not
divide the extent; the sLSTM's FFN where its width does not) is computed
whole by every model rank.  Each
stacked weight is all-gathered over the DP axes just before its layer
uses it, keeping its 'model' shard (``constraints.gather_tp`` in
``lm._layer_slice``, ``constraints.gather`` in a mixer computed whole;
remat gathers it again in the backward), the others once at the start of
the step; the gradients come back summed over the data ranks and
reduce-scattered onto the weights' placements.  The loss divides by the
whole batch's label count and the MoE aux loss takes this rank's share, so
the shares sum to the unsharded loss; AdamW clips by the norm over every
rank's shards and updates each rank's shards in place of the whole.  On a
(1, 1) mesh every collective is skipped and the step is the unsharded
one, bit for bit.
"""
from __future__ import annotations

import math

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed import constraints, sharding, tensor_parallel
from repro_torch.models.lm import lm_loss
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import tree_leaves, tree_map


def _waited(x):
    """A functional collective's result, waited for."""
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


def _stacked(path) -> bool:
    return "blocks" in path or "layers" in path


def compute_view(params):
    """The params as the model code reads them on a rank: stacked leaves
    (``blocks``, the encoder's ``layers``) stay DTensors, gathered layer by
    layer where they are used; every other leaf (the embedding, the head,
    the final norms) is gathered over the DP axes now, keeping its 'model'
    shard (``constraints.gather_tp``)."""
    return sharding.tree_map_with_path(
        lambda path, t: t if _stacked(path) else constraints.gather_tp(t), params)


def model_shards_of(mesh, cfg) -> tuple:
    """(group, index, extent, kv_group) of this rank on the mesh's 'model'
    axis for ``cfg``, for ``constraints.model_shards``: (None, 0, 1, None)
    without one or at extent 1; ``kv_group`` the blocks of ranks that read
    one whole KV head (``tensor_parallel.kv_sharers``), made here, on every
    rank."""
    extent = mesh.shape.get("model", 1)
    if extent == 1:
        return None, 0, 1, None
    n = tensor_parallel.kv_sharers(cfg, extent)
    return (mesh.group(("model",)), mesh.device_mesh.get_local_rank("model"), extent,
            mesh.model_blocks(n) if n > 1 else None)


def _like(local, ref: DTensor) -> DTensor:
    """``local`` as the shard of a DTensor placed as ``ref``."""
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


def _replicas(t: DTensor) -> int:
    """Ranks that hold each shard of ``t`` (its Replicate mesh dims)."""
    return math.prod(n for n, p in zip(t.device_mesh.shape, t.placements)
                     if isinstance(p, Replicate))


def sharded_global_norm(grads, refs, group) -> torch.Tensor:
    """The gradients' global norm from each rank's shards (``refs``: the
    DTensors whose placements they have): every shard's sum of squares,
    divided by the ranks that hold it (its ``Replicate`` mesh dims: a leaf
    ``Shard`` over 'model' counts once a model rank), summed over
    ``group`` (every rank)."""
    local = torch.stack([torch.sum(torch.square(g.float())) / _replicas(r)
                         for g, r in zip(tree_leaves(grads), tree_leaves(refs))]).sum()
    return torch.sqrt(_waited(funcol.all_reduce(local, "sum", group)))


def init_state(params) -> dict:
    """AdamW state for DTensor params: zero ``mu`` / ``nu`` placed as the
    params, a plain ``step``."""
    zeros = tree_map(lambda p: _like(torch.zeros(p.to_local().shape, dtype=torch.float32,
                                                 device=p.to_local().device), p), params)
    return {"mu": zeros, "nu": tree_map(lambda z: _like(z.to_local().clone(), z), zeros),
            "step": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


def make_sharded_train_step(cfg, model, adamw: opt.AdamWConfig, mesh):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}), the unsharded ``make_train_step``'s
    result on sharded state (module docstring).  ``mesh``: a
    ``launch.mesh.Mesh``.  The batch must split over every DP axis."""
    dp_axes = tuple(a for a in constraints.DP_AXES if a in mesh.axis_names)
    dp_group = mesh.group(dp_axes)
    world = mesh.group(mesh.axis_names)
    shards = model_shards_of(mesh, cfg)

    def dp_sum(x):
        return _waited(funcol.all_reduce(x, "sum", dp_group)) if dp_group is not None else x

    def train_step(params, opt_state, batch):
        B = batch["tokens"].shape[0]
        if sharding.batch_axes(mesh, B) != dp_axes:
            raise ValueError(f"batch {B} does not split over the DP axes {dp_axes} "
                             f"of {mesh}")
        local = {k: v.to_local() if isinstance(v, DTensor) else v for k, v in batch.items()}
        refs = tree_leaves(params)
        live = [p.to_local().detach().requires_grad_(True) for p in refs]
        it = iter(_like(x, p) for x, p in zip(live, refs))
        view = compute_view(tree_map(lambda _: next(it), params))
        aux = {k: v for k, v in local.items() if k not in ("tokens", "labels")}
        with constraints.activation_mesh(mesh), constraints.batch_slices(dp_group), \
                constraints.model_shards(*shards):
            n_labels = dp_sum((local["labels"] >= 0).sum().float())
            loss, _ = lm_loss(cfg, model, view, local["tokens"], local["labels"],
                              aux=aux or None, remat=True, n_labels=n_labels)
            gs = torch.autograd.grad(loss, live, allow_unused=True)
        it = iter(torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                  if g is None else g.float() for x, g in zip(live, gs))
        grads = tree_map(lambda _: next(it), params)
        local_params = tree_map(lambda p: p.to_local(), params)
        state = {"mu": tree_map(lambda t: t.to_local(), opt_state["mu"]),
                 "nu": tree_map(lambda t: t.to_local(), opt_state["nu"]),
                 "step": opt_state["step"]}
        gnorm = sharded_global_norm(grads, params, world)
        new, state, om = opt.apply_updates(adamw, local_params, grads, state,
                                           grad_norm=gnorm)
        wrap = lambda t, ref: _like(t, ref)  # noqa: E731
        return (tree_map(wrap, new, params),
                {"mu": tree_map(wrap, state["mu"], params),
                 "nu": tree_map(wrap, state["nu"], params), "step": state["step"]},
                {"loss": dp_sum(loss.detach()), **om})

    return train_step
