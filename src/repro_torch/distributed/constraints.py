"""Activation sharding constraints (port of
``repro/distributed/constraints.py``), and how compute on a rank's slice
of the batch meets sharded weights.

``activation_mesh`` installs a mesh for the model code below it; ``pin``
constrains a DTensor activation dim by dim (a no-op on a plain tensor, and
with no mesh installed), as ``with_sharding_constraint`` does in the
reference; ``dp_extent`` gives mesh-agnostic code (the MoE's dispatch
groups) the data-parallel degree.

The sharded train step (``sharded_step.py``) computes on plain local
tensors: each rank holds its slice of the batch over the data-parallel
ranks (``batch_slices``) and its shard over 'model' (``model_shards``:
the model group, this rank's index on it and its extent).  Each weight is
gathered just before use: over the DP axes only where the rules give it a
'model' shard that the model code computes on (``gather_tp``), whole
otherwise (``gather``).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed import sharding

DP_AXES = ("pod", "data")

_ACTIVE_MESH = None
_DP_GROUP = None


class ModelShards(NamedTuple):
    """Where a rank's compute sits on the 'model' axis: the process group
    of the ranks that share its batch slice (None: no collective, one rank
    or ranks emulated in one process), its index on it and the axis'
    extent; ``kv_group``, where KV heads are whole on 'model' and several
    ranks' query heads read one, the group of those ranks
    (``tensor_parallel.kv_sharers``), else None; ``peers``, where the ranks
    are emulated in one process (``tensor_parallel.emulate``), what their
    collectives inside a split sublayer meet at, else None."""
    group: object
    index: int
    extent: int
    kv_group: object = None
    peers: object = None


_MODEL = ModelShards(None, 0, 1)


@contextlib.contextmanager
def activation_mesh(mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


@contextlib.contextmanager
def batch_slices(group):
    """Inside: activations are this rank's slice of the batch, one of
    ``group.size()`` data-parallel slices (``group`` the process group of
    the ranks that share this rank's model index)."""
    global _DP_GROUP
    prev = _DP_GROUP
    _DP_GROUP = group
    try:
        yield
    finally:
        _DP_GROUP = prev


@contextlib.contextmanager
def model_shards(group, index: int, extent: int, kv_group=None, peers=None):
    """Inside: the model code computes rank ``index``'s shard of every
    split over 'model' (``distributed/tensor_parallel.py``), of
    ``extent``; ``group`` sums and gathers over the model ranks (None: the
    caller combines the ranks' results itself); ``kv_group`` and ``peers``
    as ``ModelShards`` says.  Process-wide, as the other installs here
    are: the autograd engine runs a CUDA graph's backward, and the
    recompute of a checkpointed body with it, on a thread of its own."""
    prev = install_model(ModelShards(group, int(index), int(extent), kv_group, peers))
    try:
        yield
    finally:
        install_model(prev)


def install_model(shards: ModelShards) -> ModelShards:
    """Install ``shards`` as ``model()``; returns what was installed
    (``model_shards``, and emulated ranks taking their turns)."""
    global _MODEL
    prev, _MODEL = _MODEL, shards
    return prev


def model() -> ModelShards:
    """The installed ``model_shards`` (extent 1 outside one)."""
    return _MODEL


def dp_group():
    """The data-parallel process group while computing on a batch slice
    (``batch_slices``), else None."""
    return _DP_GROUP


def _dp(mesh) -> tuple:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)


def pin(x, kinds):
    """Constrain x dim by dim: kinds[i] in {"batch", "model", None}.

    "batch" pins to the DP axes ('pod', 'data'), "model" to the TP axis,
    None replicates; dims that do not divide their axis fall back to None.
    Only a DTensor under an installed mesh is redistributed: compute on
    plain local tensors is already placed."""
    mesh = _ACTIVE_MESH
    if mesh is None or not isinstance(x, DTensor):
        return x
    dp = _dp(mesh)
    parts = []
    for dim, kind in zip(x.shape, kinds):
        if kind == "batch" and dp and dim % math.prod(
                mesh.shape[a] for a in dp) == 0:
            parts.append(dp if len(dp) > 1 else dp[0])
        elif kind == "model" and "model" in mesh.axis_names \
                and dim % mesh.shape["model"] == 0:
            parts.append("model")
        else:
            parts.append(None)
    return x.redistribute(x.device_mesh, sharding.placements(parts, mesh))


def constrain_batch(x):
    """Pin x's leading dim to the DP axes, the rest replicated."""
    return pin(x, ("batch",) + (None,) * (max(x.ndim, 1) - 1))


def dp_extent():
    """Product of the data-parallel axis sizes of the installed mesh (None
    when none is installed or it has no DP axis)."""
    mesh = _ACTIVE_MESH
    if mesh is None:
        return None
    dp = _dp(mesh)
    return math.prod(mesh.shape[a] for a in dp) if dp else None


def gather(w):
    """A weight as a plain full tensor for compute on this rank's batch
    slice.  A DTensor is all-gathered; its gradient comes back ``Partial``
    over the mesh's DP dims (each data rank's batch adds its share: the
    redistribution to the weight's placements sums it, a reduce-scatter)
    and ``Replicate`` over the others (ranks that share a data index
    computed the same slice).  A plain tensor is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    return w.full_tensor(grad_placements=[
        Partial() if n in DP_AXES else Replicate() for n in names])


def gather_tp(w):
    """A weight as this rank computes on it under tensor parallelism: a
    DTensor is all-gathered over the DP axes and keeps its 'model' shard
    (a leaf the rules leave whole on 'model' comes whole, as ``gather``
    gives it).  Its gradient comes back ``Partial`` over the DP dims and
    as the weight is placed over 'model': ``Shard`` where each model rank
    computed with its own shard, ``Replicate`` where they all computed
    with the whole leaf and got the same gradient (the model code sums a
    whole leaf's gradient over the model ranks where each reads a part of
    it, ``tensor_parallel.copy_in``).  A plain tensor is returned as it
    is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    keep = [p if n == "model" and isinstance(p, Shard) else Replicate()
            for n, p in zip(names, w.placements)]
    return w.redistribute(w.device_mesh, keep).to_local(grad_placements=[
        Partial() if n in DP_AXES else p for n, p in zip(names, keep)])
