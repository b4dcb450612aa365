"""Port parity on the CPU for the Mamba mixer: the chunked SSD scan's plain
version (what ``kernels/mamba_scan/ops.py`` runs for CPU tensors, and what
the CUDA kernel is held against on the card) against the JAX scan in
interpret mode and its sequential oracle, and ``mamba_forward`` /
``mamba_decode`` against ``repro/models/mamba.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.mamba_scan.ops import mamba_scan as j_mamba_scan  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.mamba_scan import ops  # noqa: E402
from repro_torch.models import mamba  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402

NAME = "jamba-v0.1-52b"


def _softplus(x):
    return np.logaddexp(0.0, x)


def _scan_inputs(B, H, C, L, P, N, seed):
    """The JAX kernel's layout: xbar (B,H,C,L,P), loga (B,H,C,L), Bm/Cm
    (B,C,L,N), h0 (B,H,N,P)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.normal(size=(B, H, C, L, P)).astype(f32) * 0.5,
            -_softplus(rng.normal(size=(B, H, C, L))).astype(f32),
            rng.normal(size=(B, C, L, N)).astype(f32) * 0.5,
            rng.normal(size=(B, C, L, N)).astype(f32) * 0.5,
            rng.normal(size=(B, H, N, P)).astype(f32) * 0.1)


def _to_model_layout(xbar, loga, Bm, Cm):
    """-> xbar (B,S,H,P), loga (B,S,H), Bm/Cm (B,S,N)."""
    B, H, C, L, P = xbar.shape
    S = C * L
    return (xbar.reshape(B, H, S, P).transpose(0, 2, 1, 3),
            loga.reshape(B, H, S).transpose(0, 2, 1),
            Bm.reshape(B, S, -1), Cm.reshape(B, S, -1))


@pytest.mark.parametrize("ragged", [False, True], ids=["whole", "ragged"])
@pytest.mark.parametrize("B,H,C,L,P,N", [(2, 2, 4, 16, 32, 8),
                                         (1, 4, 3, 32, 64, 16)])
def test_scan_plain_matches_reference(B, H, C, L, P, N, ragged):
    """Whole chunks: the same inputs.  Ragged: the port scans S = C*L - 5
    steps (its last chunk masked), JAX the same steps zero-padded to C*L
    (loga 0, xbar 0), which leaves the final state unchanged."""
    xbar, loga, Bm, Cm, h0 = _scan_inputs(B, H, C, L, P, N, C * L + P)
    S = C * L - 5 if ragged else C * L
    if ragged:
        pad = np.arange(C * L) >= S
        xbar.reshape(B, H, C * L, P)[:, :, pad] = 0
        loga.reshape(B, H, C * L)[:, :, pad] = 0
        Bm.reshape(B, C * L, N)[:, pad] = 0
        Cm.reshape(B, C * L, N)[:, pad] = 0
    tx, tl, tb, tc = (torch.from_numpy(np.ascontiguousarray(a[:, :S]))
                      for a in _to_model_layout(xbar, loga, Bm, Cm))
    y, h = ops.mamba_scan(tx, tl, tb, tc, torch.from_numpy(h0), chunk=L)
    assert ops.mamba_scan.launches == 0                 # CPU: plain version
    assert y.shape == (B, S, H, P) and h.dtype == torch.float32
    for impl in ("interpret", "ref"):
        jy, jh = j_mamba_scan(*map(jnp.asarray, (xbar, loga, Bm, Cm, h0)),
                              impl=impl)
        jy = np.asarray(jy).reshape(B, H, C * L, P).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(y.numpy(), jy[:, :S], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-4,
                                   rtol=1e-4)


def _cfgs(d_model):
    """Reduced jamba; d_model=128 gives d_inner 256, two SSD heads."""
    return (dataclasses.replace(base.get_config(NAME).reduced(), d_model=d_model),
            dataclasses.replace(configs.get_config(NAME).reduced(),
                                d_model=d_model))


@pytest.mark.parametrize("d_model", [64, 128], ids=["1head", "2heads"])
def test_mamba_forward_and_decode_match_reference(d_model):
    jcfg, tcfg = _cfgs(d_model)
    jp = jmamba.init_mamba(jcfg, jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    di, H, P, N = mamba.dims(tcfg)
    assert (di, H, P, N) == jmamba.dims(jcfg)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 37, d_model)).astype(np.float32)   # 3 chunks, ragged
    cache = {"conv": rng.normal(size=(2, 3, di)).astype(np.float32),
             "h": rng.normal(size=(2, H, N, P)).astype(np.float32) * 0.1}
    tol = dict(atol=2e-4, rtol=2e-4)

    jo, jc = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in cache.items()},
                                  return_cache=True)
    to, tc = mamba.mamba_forward(tcfg, tp, torch.from_numpy(x),
                                 {k: torch.from_numpy(v) for k, v in cache.items()},
                                 return_cache=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
    for k in ("conv", "h"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **tol)
    # without a cache to start from
    np.testing.assert_allclose(
        mamba.mamba_forward(tcfg, tp, torch.from_numpy(x)).numpy(),
        np.asarray(jmamba.mamba_forward(jcfg, jp, jnp.asarray(x))), **tol)

    for step in range(3):
        xt = rng.normal(size=(2, 1, d_model)).astype(np.float32)
        jo, jc = jmamba.mamba_decode(jcfg, jp, jnp.asarray(xt), jc)
        to, tc = mamba.mamba_decode(tcfg, tp, torch.from_numpy(xt), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **tol)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), **tol)


def test_init_cache_matches_reference():
    jcfg, tcfg = _cfgs(64)
    jc = jmamba.init_cache(jcfg, 3)
    tc = mamba.init_cache(tcfg, 3, "cpu")
    for k in ("conv", "h"):
        assert tuple(tc[k].shape) == jc[k].shape and not tc[k].any()
    assert tc["h"].dtype == torch.float32
