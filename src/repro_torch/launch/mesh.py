"""Meshes over the running process group (port of ``repro/launch/mesh.py``).

Functions, not module constants, so that importing this module touches no
process group.  Single pod: 16 x 16 = 256 ranks over ("data", "model");
multi-pod: 2 x 16 x 16 = 512 ranks with a leading "pod" axis (pure DP
across pods).  The dry-run runs them over a fake process group of that
many ranks (``launch/dryrun.py``); a real job over its NCCL or gloo group.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.distributed.constraints import DP_AXES


class Mesh:
    """A ``DeviceMesh`` as the sharding rules read it: ``axis_names`` and
    ``shape`` (axis -> size), and ``size`` ranks."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.size = device_mesh.size()

    def group(self, axes):
        """The process group of the ranks that differ only along ``axes``
        (one axis, or several flattened into one), or None for no axis."""
        axes = tuple(axes)
        if not axes:
            return None
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self.device_mesh[axes]._flatten("_".join(axes)).get_group()

    def model_blocks(self, size: int):
        """The process group of this rank's block of ``size`` consecutive
        ranks along 'model' (the last axis), its data indices fixed."""
        names = self.axis_names
        if names[-1] != "model" or self.shape["model"] % size:
            raise ValueError(f"'model' of {self} does not split into blocks of {size}")
        shape = tuple(self.shape[a] for a in names[:-1]) + (self.shape["model"] // size, size)
        sub = init_device_mesh(self.device_mesh.device_type, shape,
                               mesh_dim_names=names[:-1] + ("model_block", "model_share"))
        return sub.get_group("model_share")

    def __repr__(self):
        return f"Mesh({self.shape})"


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over ``axes`` on the running process group,
    whose world size must be the product of ``shape``."""
    return Mesh(init_device_mesh(_device_type(), tuple(shape),
                                 mesh_dim_names=tuple(axes)))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """(world // model, model) over ("data", "model"): every rank of the
    running group (tests, one card)."""
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in DP_AXES if a in mesh.axis_names)
