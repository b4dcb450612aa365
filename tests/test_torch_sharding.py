"""The port's sharding rules and dry-run config helpers against the
reference's, leaf for leaf: ``param_pspec`` for every parameter of all 11
configs on the 1-pod (16 x 16), 2-pod (2 x 16 x 16) and (4, 2) meshes,
train and serve; ``cache_pspec`` with long context on and off; ``kv_axis``,
``batch_axes`` and ``input_shardings``; ``SHAPES``, ``cell_is_runnable``,
``input_specs`` and ``param_counts``; ``LM.param_specs`` / ``cache_specs``
against ``jax.eval_shape``; and the DTensor placements' pod-major nesting.

The reference's rules run on a ``jax.sharding.AbstractMesh``; the port's
on a plain stand-in that has only ``axis_names`` and ``shape``, as the
rules need no process group."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402

MESHES = {"1pod": ((16, 16), ("data", "model")),
          "2pod": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
ARCHS = configs.list_configs()
CACHE_ARCHS = ["h2o-danube-1.8b", "jamba-v0.1-52b", "xlstm-1.3b", "gemma2-9b",
               "whisper-base"]


class StandIn:
    """What the rules read of a mesh, and nothing else."""

    def __init__(self, sizes, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), StandIn(sizes, names)


def _jpath(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jleaves(tree, keep_path=False) -> dict:
    """{path: leaf} of a reference tree (keys and indices as the port's);
    with ``keep_path`` {path: (the reference's own path, leaf)}."""
    return {_jpath(p): (p, x) if keep_path else x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tleaves(tree) -> dict:
    out = {}
    sharding.tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


@functools.lru_cache(maxsize=None)
def _jparams(arch, keep_path=False):
    return _jleaves(build_model(base.get_config(arch)).param_specs(), keep_path)


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return _tleaves(LM(configs.get_config(arch), device="cpu").param_specs())


def _t_mem(cfg, shape):
    return shape.seq_len // 2 if cfg.is_encdec else cfg.n_image_tokens


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_equal_eval_shape(arch):
    """``LM.param_specs`` and ``cache_specs`` (meta tensors) have the
    reference's ``jax.eval_shape`` leaves: paths, shapes and dtypes."""
    want, got = _jparams(arch), _tparams(arch)
    assert set(got) == set(want)
    for path, w in want.items():
        assert (tuple(got[path].shape), _dtype(got[path])) == (w.shape, str(w.dtype)), path
        assert got[path].device.type == "meta"
    jcfg, tcfg = base.get_config(arch), configs.get_config(arch)
    shape = base.SHAPES["decode_32k"]
    want = _jleaves(build_model(jcfg).cache_specs(shape.global_batch, shape.seq_len,
                                                  _t_mem(jcfg, shape)))
    got = _tleaves(LM(tcfg, device="cpu").cache_specs(shape.global_batch, shape.seq_len,
                                                      _t_mem(tcfg, shape)))
    assert set(got) == set(want)
    for path, w in want.items():
        assert (tuple(got[path].shape), _dtype(got[path])) == (w.shape, str(w.dtype)), path


@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_equals_reference(arch, mesh, train):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = base.get_config(arch), configs.get_config(arch)
    got = _tparams(arch)
    for path, (jpath, leaf) in _jparams(arch, True).items():
        want = tuple(jsharding.param_pspec(jcfg, jpath, leaf.shape, jmesh, train))
        spec = sharding.param_pspec(tcfg, path, tuple(got[path].shape), tmesh, train)
        assert tuple(spec) == want, (path, spec, want)
        for dim, entry in zip(got[path].shape, spec):   # every sharded dim divides
            for ax in sharding._entry_axes(entry):
                assert dim % tmesh.shape[ax] == 0


@pytest.mark.parametrize("long_ctx", [False, True], ids=["short", "long"])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_pspec_equals_reference(arch, long_ctx):
    jmesh, tmesh = _meshes("1pod")
    jcfg, tcfg = base.get_config(arch), configs.get_config(arch)
    shape = base.SHAPES["decode_32k"]
    cache = _tleaves(LM(tcfg, device="cpu").cache_specs(
        shape.global_batch, shape.seq_len, _t_mem(tcfg, shape)))
    jcache = _jleaves(build_model(jcfg).cache_specs(
        shape.global_batch, shape.seq_len, _t_mem(jcfg, shape)), keep_path=True)
    assert set(cache) == set(jcache)
    for path, leaf in cache.items():
        want = tuple(jsharding.cache_pspec(jcfg, jcache[path][0], tuple(leaf.shape),
                                           jmesh, long_ctx))
        got = sharding.cache_pspec(tcfg, path, tuple(leaf.shape), tmesh, long_ctx)
        assert tuple(got) == want, (path, got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_kv_axis_and_batch_axes_equal_reference(mesh):
    jmesh, tmesh = _meshes(mesh)
    for arch in ARCHS:
        assert sharding.kv_axis(configs.get_config(arch), tmesh) == \
            jsharding.kv_axis(base.get_config(arch), jmesh), arch
        assert sharding.head_axis(configs.get_config(arch), tmesh) == \
            jsharding.head_axis(base.get_config(arch), jmesh)
    for batch in (1, 2, 4, 8, 16, 32, 48, 128, 256, 512):
        assert sharding.batch_axes(tmesh, batch) == jsharding.batch_axes(jmesh, batch), batch
    assert sharding.kv_axis(configs.get_config("gemma2-9b"), _meshes("1pod")[1]) is None
    assert sharding.kv_axis(configs.get_config("moonshot-v1-16b-a3b"),
                            _meshes("1pod")[1]) == "model"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_shardings_equal_reference(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    jcfg, tcfg = base.get_config(arch), configs.get_config(arch)
    for name in base.SHAPES:
        want = jsharding.input_shardings(jcfg, base.input_specs(jcfg, base.SHAPES[name]), jmesh)
        got = sharding.input_shardings(tcfg, configs.input_specs(tcfg, configs.SHAPES[name]),
                                       tmesh)
        assert {k: tuple(v.spec) for k, v in got.items()} == \
            {k: tuple(v.spec) for k, v in want.items()}, name


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_helpers_equal_reference(arch):
    """``SHAPES``, ``cell_is_runnable``, ``input_specs`` (meta tensors),
    ``param_counts``, the long-context policy and ``ASSIGNED``."""
    jcfg, tcfg = base.get_config(arch), configs.get_config(arch)
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in configs.SHAPES.items()} \
        == {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in base.SHAPES.items()}
    assert tcfg.supports_long_context == jcfg.supports_long_context
    assert tcfg.has_decoder == jcfg.has_decoder
    assert tcfg.param_counts() == jcfg.param_counts()
    assert tcfg.reduced().param_counts() == jcfg.reduced().param_counts()
    for name in base.SHAPES:
        assert configs.cell_is_runnable(tcfg, configs.SHAPES[name]) == \
            base.cell_is_runnable(jcfg, base.SHAPES[name])
        want = base.input_specs(jcfg, base.SHAPES[name])
        got = configs.input_specs(tcfg, configs.SHAPES[name])
        assert {k: (tuple(v.shape), _dtype(v), v.device.type) for k, v in got.items()} == \
            {k: (v.shape, str(v.dtype), "meta") for k, v in want.items()}
        assert configs.cfg_enc_frames(tcfg, 1000) == base.cfg_enc_frames(jcfg, 1000)
    assert configs.ASSIGNED == base.ASSIGNED


def test_placements_map_specs_to_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    mesh = StandIn(*MESHES["2pod"])
    assert sharding.placements(sharding.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert sharding.placements(sharding.P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert sharding.local_shape((64, 8, 32), sharding.P(("pod", "data"), None, "model"),
                                mesh) == (2, 8, 2)
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements(sharding.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="named twice"):
        sharding.placements(sharding.P("data", "data"), mesh)


def test_pod_major_nesting_over_a_mesh():
    """``P(("pod", "data"))`` on a (2, 2, 2) mesh: the rank at (pod p,
    data d) holds rows (2p + d) * 4 ... + 4 of a 16-row tensor, on every
    model index, as JAX lays it out.  Each of the 8 ranks is played in turn
    over a fake process group (no communication: each rank chunks the
    tensor itself)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    full = torch.arange(16 * 3).reshape(16, 3)
    spec = sharding.P(("pod", "data"), None)
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=8)
        try:
            dm = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
            p, d, _ = dm.get_coordinate()
            shard = sharding.distribute({"w": full}, {"w": sharding.NamedSharding(
                _Mesh(dm), spec)})["w"]
            np.testing.assert_array_equal(shard.to_local().numpy(),
                                          full[(2 * p + d) * 4:(2 * p + d + 1) * 4].numpy())
        finally:
            dist.destroy_process_group()


class _Mesh(StandIn):
    def __init__(self, dm):
        super().__init__(dm.shape, dm.mesh_dim_names)
        self.device_mesh = dm
