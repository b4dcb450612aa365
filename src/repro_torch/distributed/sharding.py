"""Logical-axis -> PartitionSpec rules for every parameter, cache and input
(port of ``repro/distributed/sharding.py``, rule for rule), and their
DTensor placements.

Scheme:
  - batch over ('pod', 'data')                   [DP; FSDP weights on 'data']
  - heads / d_ff / experts / vocab over 'model'  [TP / EP]
  - KV heads over 'model' only when divisible (else replicated KV)
  - train: weights and optimizer state FSDP-sharded on 'data' (ZeRO)
  - serve: weights sharded on 'model' only (replicated over 'data')
  - long-context decode (batch 1): the cache's *sequence* shards over
    'data' (context parallelism), heads over 'model'

A spec is a ``P``: one entry per tensor dim, each None, an axis name or a
tuple of axis names (the dim split over those axes, the first major).  The
rules read only ``mesh.axis_names`` and ``mesh.shape[axis]``, so specs can
be computed for a 256-device mesh with no process group; ``placements``
maps a spec to DTensor placements over the mesh's dims.

Trees are the port's param trees (nested dicts, ``blocks`` a tuple); a
leaf's path is the tuple of its keys and indices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor


class P(tuple):
    """A PartitionSpec: ``P(None, "model")``, ``P(("pod", "data"), None)``.
    As JAX's, a one-axis tuple is that axis and an empty one None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _axis(mesh, name) -> Optional[str]:
    return name if name in mesh.axis_names else None


def _divisible(n: int, mesh, axis: Optional[str]) -> Optional[str]:
    if axis is None:
        return None
    return axis if n % mesh.shape[axis] == 0 else None


def kv_axis(cfg, mesh) -> Optional[str]:
    return _divisible(cfg.n_kv_heads, mesh, _axis(mesh, "model"))


def head_axis(cfg, mesh) -> Optional[str]:
    return _axis(mesh, "model")


def batch_axes(mesh, batch: int):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    n = math.prod(mesh.shape[a] for a in axes) if axes else 1
    if axes and batch % n == 0:
        return axes
    # fall back to whatever prefix divides
    if "data" in mesh.axis_names and batch % mesh.shape["data"] == 0:
        return ("data",)
    return ()


def _names(path) -> list:
    return [str(k) for k in path]


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------

def param_pspec(cfg, path: tuple, shape: tuple, mesh, train: bool) -> P:
    """PartitionSpec for one parameter leaf, identified by its tree path.
    Every rule is divisibility-guarded (a DTensor shards evenly only)."""
    names = _names(path)
    leaf = names[-1]
    stacked = ("blocks" in names) or ("layers" in names)
    if stacked:  # stacked repeats: leading repeat dim, never sharded
        shape = shape[1:]
    fsdp = _axis(mesh, "data") if train else None
    mdl = _axis(mesh, "model")
    kva = kv_axis(cfg, mesh)

    def fs(dim: int):  # fsdp only if divisible
        return _divisible(dim, mesh, fsdp)

    def md(dim: int):
        return _divisible(dim, mesh, mdl)

    def rule() -> tuple:
        if leaf in ("embed", "lm_head", "pos_embed"):
            return (md(shape[0]), fs(shape[1]))
        if leaf in ("scale",) or (leaf == "bias" and len(shape) == 1):
            return (None,)
        if leaf == "wq":
            return (fs(shape[0]), md(shape[1]), None)
        if leaf in ("wk", "wv"):
            return (fs(shape[0]), kva, None)
        if leaf == "wo":
            return (md(shape[0]), None, fs(shape[2]))
        if leaf in ("w_gate", "w_up", "w_in", "ffn_gate", "ffn_up"):
            if len(shape) == 3:   # MoE experts (E, d, ff)
                return (md(shape[0]), fs(shape[1]), None)
            return (fs(shape[0]), md(shape[1]))
        if leaf in ("w_down", "w_out", "ffn_down"):
            if len(shape) == 3:   # (E, ff, d)
                return (md(shape[0]), None, fs(shape[2]))
            return (md(shape[0]), fs(shape[1]))
        if leaf == "router":
            return (fs(shape[0]), None)
        if leaf == "conv":
            return (None, md(shape[1]))
        if leaf in ("w_dt", "w_B", "w_C", "w_if"):
            return (md(shape[0]), None)
        if leaf in ("A_log", "D", "dt_bias", "if_bias"):
            return (None,)
        if leaf in ("w_q", "w_k"):  # mLSTM square projections
            return (None, md(shape[1]))
        if leaf == "head_norm":
            return (None, None)
        if leaf == "W" and len(shape) == 4:   # sLSTM gates (d,4,H,dh)
            return (fs(shape[0]), None, None, md(shape[3]))
        if leaf == "R" and len(shape) == 4:   # sLSTM recurrent (4,H,dh,dh)
            return (None, None, None, md(shape[3]))
        if leaf == "bias" and len(shape) == 3:
            return (None, None, None)
        return tuple([None] * len(shape))

    spec = rule()
    if len(spec) != len(shape):
        raise ValueError(f"rule for {leaf} gives {spec} for shape {shape}")
    if stacked:
        spec = (None,) + spec
    return P(*spec)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a param tree, keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(cfg, params_tree, mesh, train: bool):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, param_pspec(cfg, path, tuple(leaf.shape), mesh, train)),
        params_tree)


# --------------------------------------------------------------------------
# Cache specs (decode)
# --------------------------------------------------------------------------

def cache_pspec(cfg, path: tuple, shape: tuple, mesh, long_ctx: bool) -> P:
    leaf = _names(path)[-1]
    mdl = _axis(mesh, "model")
    kva = kv_axis(cfg, mesh)
    data = _axis(mesh, "data")
    if long_ctx:
        b = None
        seq = data
    else:
        b = batch_axes(mesh, shape[1]) or None
        seq = None
    if leaf in ("k", "v"):
        # (R, B, size, n_kv, d_head)
        s = _divisible(shape[2], mesh, seq) if seq else None
        return P(None, b, s, kva, None)
    if leaf == "conv":
        return P(None, b, None, _divisible(shape[3], mesh, mdl))
    if leaf == "h" and len(shape) == 5:       # mamba (R,B,H,N,P)
        return P(None, b, _divisible(shape[2], mesh, mdl), None, None)
    if leaf == "C" and len(shape) == 5:       # mlstm (R,B,H,dk,dv)
        dk = _divisible(shape[3], mesh, seq) if long_ctx else None
        return P(None, b, None, dk, _divisible(shape[4], mesh, mdl))
    if leaf == "n" and len(shape) == 4:       # mlstm (R,B,H,dk)
        return P(None, b, None, None)
    if leaf == "m" and len(shape) == 3:
        return P(None, b, None)
    if len(shape) == 4:                       # slstm h/c/n/m (R,B,H,dh)
        return P(None, b, None, _divisible(shape[3], mesh, mdl))
    return P(*([None] * len(shape)))


def cache_shardings(cfg, cache_tree, mesh, long_ctx: bool):
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_pspec(cfg, path, tuple(leaf.shape), mesh, long_ctx)),
        cache_tree)


# --------------------------------------------------------------------------
# Input specs
# --------------------------------------------------------------------------

def input_shardings(cfg, specs: dict, mesh):
    out = {}
    for name, s in specs.items():
        b = batch_axes(mesh, s.shape[0]) or None
        out[name] = NamedSharding(mesh, P(b, *([None] * (len(s.shape) - 1))))
    return out


# --------------------------------------------------------------------------
# DTensor placements
# --------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` over the mesh's dims, in
    ``mesh.axis_names`` order: ``Shard(dim)`` on each mesh dim that a
    tensor dim names, ``Replicate()`` on the others.  A dim split over
    several axes (``("pod", "data")``) nests in mesh-dim order, the first
    axis major, as JAX's ``P(("pod", "data"))`` does; axes named out of
    mesh order cannot nest so and raise."""
    out = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        idx = [mesh.axis_names.index(a) for a in _entry_axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{entry!r} on dim {dim} is not in mesh order "
                             f"{mesh.axis_names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {mesh.axis_names[i]!r} named "
                                 f"twice in {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """A device's shard shape of a tensor of ``shape`` under ``spec``
    (every sharded dim divides, as the rules guarantee)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {entry!r}")
        out[dim] //= n
    return tuple(out)


def zip_map(fn, tree, shardings):
    """``fn(leaf, sharding)`` over a tree and its tree of shardings."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(zip_map(fn, v, s) for v, s in zip(tree, shardings))
    return fn(tree, shardings)


def distribute(tree, shardings):
    """Each leaf of ``tree`` (a full tensor, the same on every rank) as a
    DTensor in its sharding (a tree of ``NamedSharding``, e.g.
    ``param_shardings``); each rank keeps its own shard, with no
    communication.  The mesh must have a ``device_mesh``."""
    return zip_map(lambda t, s: distribute_tensor(
        t, s.mesh.device_mesh, s.placements, src_data_rank=None), tree, shardings)


def meta_shards(tree, shardings):
    """DTensors shaped as ``tree``'s leaves (tensors, or anything with
    ``shape`` and ``dtype``), each rank's shard an empty meta tensor: the
    dry-run's arguments, which hold no memory."""
    def one(t, s):
        local = torch.empty(local_shape(t.shape, s.spec, s.mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, s.mesh.device_mesh, s.placements,
                                  run_check=False, shape=torch.Size(t.shape),
                                  stride=torch.empty(t.shape, device="meta").stride())
    return zip_map(one, tree, shardings)
