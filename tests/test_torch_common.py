"""Port parity on the CPU: configs and model primitives of ``repro_torch``
against the JAX reference on the same numpy inputs."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import common  # noqa: E402

NAME = "gentorrent-llama3-8b"


NEW_FAMILIES = ["h2o-danube-1.8b", "gemma2-9b", "yi-34b", "granite-20b",
                "dbrx-132b", "moonshot-v1-16b-a3b", "llama-3.2-vision-11b",
                "whisper-base"]


def _pair(kind):
    name = NAME
    for prefix, other in (("jamba-", "jamba-v0.1-52b"), ("xlstm-", "xlstm-1.3b"),
                          *((f"{n}/", n) for n in NEW_FAMILIES)):
        if kind.startswith(prefix):
            name, kind = other, kind.removeprefix(prefix)
    jcfg, tcfg = base.get_config(name), configs.get_config(name)
    if kind == "reduced":
        return jcfg.reduced(), tcfg.reduced()
    if kind == "reduced-2l":
        return (dataclasses.replace(jcfg.reduced(), n_layers=2),
                dataclasses.replace(tcfg.reduced(), n_layers=2))
    return jcfg, tcfg


@pytest.mark.parametrize("kind", ["full", "reduced", "reduced-2l",
                                  "jamba-full", "jamba-reduced",
                                  "xlstm-full", "xlstm-reduced",
                                  *(f"{n}/{k}" for n in NEW_FAMILIES
                                    for k in ("full", "reduced"))])
def test_config_fields_equal_reference(kind):
    jcfg, tcfg = _pair(kind)
    for f in dataclasses.fields(tcfg):
        got, want = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if f.name == "pattern":
            got = [dataclasses.astuple(s) for s in got]
            want = [(s.mixer, s.window, s.ffn) for s in want]
        elif f.name in ("moe", "mamba", "xlstm") and want is not None:
            got, want = dataclasses.astuple(got), dataclasses.astuple(want)
        assert got == want, f.name
    assert tcfg.n_repeats == jcfg.n_repeats
    assert tcfg.padded_vocab == jcfg.padded_vocab
    assert tcfg.d_inner_mamba == jcfg.d_inner_mamba
    assert tcfg.compute_dtype == configs.torch_dtype(jcfg.dtype)
    assert str(jcfg.compute_dtype) == str(tcfg.compute_dtype).split(".")[1]


def test_registry_equals_reference():
    assert configs.list_configs() == base.list_configs()


def test_cross_attention_layers_construct():
    """The port takes every mixer of the reference; an unknown one raises."""
    assert configs.LayerSpec(mixer="cross_attn").mixer == "cross_attn"
    assert configs.MIXERS == base.MIXERS and configs.FFNS == base.FFNS
    with pytest.raises(ValueError, match="unknown layer"):
        configs.LayerSpec(mixer="conv")


def _cfg_pair(norm):
    jcfg, tcfg = _pair("reduced")
    return (dataclasses.replace(jcfg, norm=norm),
            dataclasses.replace(tcfg, norm=norm))


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm(norm):
    rng = np.random.default_rng(0)
    jcfg, tcfg = _cfg_pair(norm)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=(64,)).astype(np.float32),
         "bias": rng.normal(size=(64,)).astype(np.float32)}
    want = jcommon.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x))
    got = common.apply_norm(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 0.0])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 4, 16)).astype(np.float32)
    positions = rng.integers(0, 1000, size=(3, 7)).astype(np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                            theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_act_fn(act):
    x = np.linspace(-6, 6, 301, dtype=np.float32)
    want = jcommon.act_fn(act)(jnp.asarray(x))
    got = common.act_fn(act)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("cap", [None, 30.0, 50.0])
def test_softcap(cap):
    x = np.linspace(-200, 200, 401, dtype=np.float32)
    want = jcommon.softcap(jnp.asarray(x), cap)
    got = common.softcap(torch.from_numpy(x), cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scale", [False, True])
def test_take_embedding(scale):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    want = jcommon.take_embedding(jnp.asarray(emb), jnp.asarray(tok), scale)
    got = common.take_embedding(torch.from_numpy(emb), torch.from_numpy(tok),
                                scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
