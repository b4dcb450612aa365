"""Port parity for paged attention: the port's plain versions (what the
wrappers run for CPU tensors) against the JAX reference and its Pallas
kernels in interpret mode.  The CUDA kernels are held against these plain
versions on the card by ``test_torch_cuda.py``.

Dead rows are garbage by contract in the reference (uniform average over
masked keys) and zeros in the port, so only live rows are compared."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as j_paged_decode_op  # noqa: E402
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as j_paged_decode_ref  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash_op  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_decode import ops as decode_ops  # noqa: E402
from repro_torch.models import attention  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
BLK, P, N_PG = 32, 9, 4
NAME = "gentorrent-llama3-8b"
VARIANTS = [(None, None), (8, None), (None, 50.0), (8, 50.0)]


def _cfgs(softcap):
    jcfg = dataclasses.replace(base.get_config(NAME).reduced(),
                               attn_softcap=softcap)
    tcfg = dataclasses.replace(configs.get_config(NAME).reduced(),
                               attn_softcap=softcap)
    return jcfg, tcfg


def _arena_inputs(seed, B=4, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    ka = rng.normal(size=(P, BLK, Hkv, D)).astype(np.float32)
    va = rng.normal(size=(P, BLK, Hkv, D)).astype(np.float32)
    # distinct pages per row, in scrambled order; unused entries -> page 0
    perm = rng.permutation(np.arange(1, P))
    pt = np.zeros((B, N_PG), np.int32)
    for b in range(B):
        pt[b] = np.roll(perm, 2 * b)[:N_PG]
    return rng, ka, va, pt


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -------------------------------------------------------- paged decode
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_paged_decode_plain_matches_reference(window, softcap):
    rng, ka, va, pt = _arena_inputs(0)
    q = rng.normal(size=(4, 4, 16)).astype(np.float32)
    lengths = np.array([1, 37, 0, 128], np.int32)
    live = lengths > 0
    kw = dict(window=window, softcap=softcap, scale=0.25)
    got = decode_ops.paged_decode_attention(_t(q), _t(ka), _t(va), _t(pt),
                                            _t(lengths), **kw).numpy()
    assert decode_ops.paged_decode_attention.launches == 0
    want = np.asarray(j_paged_decode_ref(*map(jnp.asarray,
                                              (q, ka, va, pt, lengths)), **kw))
    np.testing.assert_allclose(got[live], want[live], **TOL)
    want = np.asarray(j_paged_decode_op(*map(jnp.asarray,
                                             (q, ka, va, pt, lengths)),
                                        impl="interpret", **kw))
    np.testing.assert_allclose(got[live], want[live], **TOL)


@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_model_paged_decode_matches_reference(window, softcap):
    jcfg, tcfg = _cfgs(softcap)
    rng, ka, va, pt = _arena_inputs(1)
    q = rng.normal(size=(4, 1, 4, 16)).astype(np.float32)
    pos = np.array([0, 40, 5, 127], np.int32)
    active = np.array([True, True, False, True])
    want = np.asarray(jattn.paged_decode_attention(
        jcfg, *map(jnp.asarray, (q, ka, va, pt, pos)), window=window,
        active=jnp.asarray(active)))
    got = attention.paged_decode_attention(
        tcfg, *map(_t, (q, ka, va, pt, pos)), window=window,
        active=_t(active)).numpy()
    np.testing.assert_allclose(got[active], want[active], **TOL)
    # the kernel's plain version computes the same function on live rows
    lengths = np.where(active, pos + 1, 0).astype(np.int32)
    kern = decode_ops.paged_decode_attention(
        _t(q[:, 0]), _t(ka), _t(va), _t(pt), _t(lengths), window=window,
        softcap=softcap, scale=attention._scale(tcfg)).numpy()
    np.testing.assert_allclose(kern[active], want[active, 0], **TOL)


# ------------------------------------------------------- flash (dense)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_flash_plain_matches_reference(causal, window, softcap):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, 64, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, 64, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, 64, 16)).astype(np.float32)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_ops.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert flash_ops.flash_attention.launches == 0
    want = np.asarray(j_flash_op(*map(jnp.asarray, (q, k, v)), bq=32, bk=32,
                                 impl="interpret", **kw))
    np.testing.assert_allclose(got, want, **TOL)


# ------------------------------------------------ paged prefill / verify
@pytest.mark.parametrize("C", [32, 5])
@pytest.mark.parametrize("window,softcap", VARIANTS)
def test_paged_prefill_plain_matches_reference(C, window, softcap):
    jcfg, tcfg = _cfgs(softcap)
    rng, ka, va, pt = _arena_inputs(3)
    q = rng.normal(size=(4, C, 4, 16)).astype(np.float32)
    pos0 = np.array([0, 32, 64, 96], np.int32) if C == 32 else \
        np.array([3, 30, 0, 100], np.int32)
    qpos = (pos0[:, None] + np.arange(C)[None]).astype(np.int32)
    active = np.array([True, False, True, True])
    want = np.asarray(jattn.paged_prefill_attention(
        jcfg, *map(jnp.asarray, (q, ka, va, pt, qpos)), window=window,
        active=jnp.asarray(active)))
    got = attention.paged_prefill_attention(
        tcfg, *map(_t, (q, ka, va, pt, qpos)), window=window,
        active=_t(active)).numpy()
    np.testing.assert_allclose(got[active], want[active], **TOL)
    assert not got[~active].any() and not want[~active].any()
    # the paged flash kernel's plain version: same function
    kern = flash_ops.paged_flash_attention(
        _t(q), _t(ka), _t(va), _t(pt), _t(pos0), _t(active), window=window,
        softcap=softcap, scale=attention._scale(tcfg)).numpy()
    assert flash_ops.paged_flash_attention.launches == 0
    np.testing.assert_allclose(kern, want, **TOL)


# ------------------------------------------------------- arena updates
def _live_pages(a):
    return a[1:]                     # page 0 is scratch: contents free


def test_update_paged_cache_matches_reference():
    rng, ka, va, pt = _arena_inputs(4)
    kn = rng.normal(size=(4, 1, 2, 16)).astype(np.float32)
    vn = rng.normal(size=(4, 1, 2, 16)).astype(np.float32)
    pos = np.array([0, 33, 70, 127], np.int32)
    jk, jv = jattn.update_paged_cache(*map(jnp.asarray, (ka, va, kn, vn, pt,
                                                         pos)))
    tk, tv = _t(ka.copy()), _t(va.copy())
    out = attention.update_paged_cache(tk, tv, _t(kn), _t(vn), _t(pt),
                                       _t(pos))
    assert out[0] is tk and out[1] is tv                  # in place
    np.testing.assert_array_equal(_live_pages(tk.numpy()),
                                  _live_pages(np.asarray(jk)))
    np.testing.assert_array_equal(_live_pages(tv.numpy()),
                                  _live_pages(np.asarray(jv)))


@pytest.mark.parametrize("n_tok", [None, (5, 1, 0, 3)])
def test_update_paged_cache_window_matches_reference(n_tok):
    rng, ka, va, pt = _arena_inputs(5)
    W = 5
    kn = rng.normal(size=(4, W, 2, 16)).astype(np.float32)
    vn = rng.normal(size=(4, W, 2, 16)).astype(np.float32)
    pos = np.array([30, 0, 64, 125], np.int32)     # straddle + near max_len
    nt = None if n_tok is None else np.array(n_tok, np.int32)
    if nt is None:
        pos = np.array([30, 0, 64, 100], np.int32)  # every token is real
    jk, jv = jattn.update_paged_cache_window(
        *map(jnp.asarray, (ka, va, kn, vn, pt, pos)),
        n_tok=None if nt is None else jnp.asarray(nt))
    tk, tv = _t(ka.copy()), _t(va.copy())
    attention.update_paged_cache_window(tk, tv, _t(kn), _t(vn), _t(pt),
                                        _t(pos),
                                        n_tok=None if nt is None else _t(nt))
    np.testing.assert_array_equal(_live_pages(tk.numpy()),
                                  _live_pages(np.asarray(jk)))
    np.testing.assert_array_equal(_live_pages(tv.numpy()),
                                  _live_pages(np.asarray(jv)))
