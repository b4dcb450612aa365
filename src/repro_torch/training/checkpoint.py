"""Checkpoints of param and optimizer trees (port of
``repro/training/checkpoint.py``), same directory layout:

  <dir>/step_<N>/manifest.json       step, leaf count, shapes, dtype names
  <dir>/step_<N>/shard_<P>.npz       flat arrays by leaf index (a0, a1, ...)
  <dir>/step_<N>/COMMITTED           write-atomicity marker (last)

written into ``step_<N>.tmp`` and renamed into place.  One difference
from the reference, on purpose: the manifest is JSON, not msgpack (the
card's host has no msgpack).  numpy has no bfloat16, so a bf16 leaf is
stored through its int16 view with ``"bfloat16"`` as its dtype name.
Leaves are tensors (numpy arrays and scalars are taken as tensors).
Restore takes a target tree for the structure and puts each leaf on the
target leaf's device.

Sharded trees: ``save`` gathers each DTensor leaf (every rank calls it,
rank 0 writes, all wait for the write); ``restore`` with ``shardings``
gives each rank its shard of the new placements, so a checkpoint saved on
one mesh restores onto another (the elastic re-mesh).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding
from repro_torch.training.optimizer import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save(ckpt_dir, step: int, tree, process_index: int = 0) -> Path:
    """Write ``tree`` as step ``step``.  With DTensor leaves every rank of
    their group must call it: the leaves are gathered, rank 0 writes, and
    every rank returns once the checkpoint is committed."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    leaves = tree_leaves(tree)
    if any(isinstance(x, DTensor) for x in leaves):
        leaves = [x.full_tensor() if isinstance(x, DTensor) else x for x in leaves]
        if dist.get_rank() == 0:
            _write(d, step, leaves, process_index)
        dist.barrier()
        return d
    return _write(d, step, leaves, process_index)


def _write(d: Path, step: int, leaves, process_index: int) -> Path:
    tmp = Path(str(d) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = [torch.as_tensor(x) for x in leaves]
    np.savez(tmp / f"shard_{process_index}.npz",
             **{f"a{i}": _array(x) for i, x in enumerate(leaves)})
    manifest = {"step": step, "n_leaves": len(leaves),
                "shapes": [list(x.shape) for x in leaves],
                "dtypes": [str(x.dtype).removeprefix("torch.") for x in leaves]}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMITTED").write_text("ok")
    if d.exists():
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def latest_step(ckpt_dir) -> int | None:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.name.startswith("step_") and (p / "COMMITTED").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, target_tree, shardings=None):
    """The tree saved at ``step``, shaped as ``target_tree`` (its leaves
    give the structure and, for tensors, the device; other leaves come
    back as CPU tensors).  ``shardings``: a tree of
    ``sharding.NamedSharding`` (``param_shardings`` on the new mesh); each
    leaf then comes back as a DTensor in its sharding, each rank holding
    its own shard.  Returns (tree, step)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    manifest = json.loads((d / "manifest.json").read_text())
    targets = tree_leaves(target_tree)
    if manifest["n_leaves"] != len(targets):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, the "
                         f"target tree {len(targets)}")
    data = np.load(d / "shard_0.npz")
    leaves = []
    for i, (name, target) in enumerate(zip(manifest["dtypes"], targets)):
        t = torch.from_numpy(data[f"a{i}"])
        if name == "bfloat16":
            t = t.view(torch.bfloat16)
        leaves.append(t.to(dtype=_DTYPES[name],
                           device=getattr(target, "device", "cpu")))
    it = iter(leaves)
    tree = tree_map(lambda _: next(it), target_tree)
    if shardings is not None:
        tree = sharding.distribute(tree, shardings)
    return tree, manifest["step"]


def prune(ckpt_dir, keep: int = 3):
    d = Path(ckpt_dir)
    if not d.exists():
        return
    steps = sorted(p for p in d.iterdir() if p.name.startswith("step_")
                   and (p / "COMMITTED").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p)
