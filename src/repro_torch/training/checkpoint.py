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
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.training.optimizer import tree_leaves, tree_map

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def save(ckpt_dir, step: int, tree, process_index: int = 0) -> Path:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = Path(str(d) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = [torch.as_tensor(x) for x in tree_leaves(tree)]
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


def restore(ckpt_dir, step: int, target_tree):
    """The tree saved at ``step``, shaped as ``target_tree`` (its leaves
    give the structure and, for tensors, the device; other leaves come
    back as CPU tensors).  Returns (tree, step)."""
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
    return tree_map(lambda _: next(it), target_tree), manifest["step"]


def prune(ckpt_dir, keep: int = 3):
    d = Path(ckpt_dir)
    if not d.exists():
        return
    steps = sorted(p for p in d.iterdir() if p.name.startswith("step_")
                   and (p / "COMMITTED").exists())
    for p in steps[:-keep]:
        shutil.rmtree(p)
