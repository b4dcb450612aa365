"""Port parity on the CPU for xLSTM: the chunkwise mLSTM's plain version
(what ``kernels/mlstm/ops.py`` runs for CPU tensors, and what the CUDA
kernel is held against on the card) against the JAX kernel in interpret
mode and its per-step oracle; the mLSTM and sLSTM mixers against
``repro/models/xlstm.py``; and the reduced xlstm LM and its weights
against ``repro/models/lm.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.mlstm.ops import mlstm_chunkwise as j_mlstm  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.mlstm import ops  # noqa: E402
from repro_torch.models import lm, xlstm  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402

NAME = "xlstm-1.3b"
# the JAX kernel test's tolerances (tests/test_kernels.py:139-147): h is
# a ratio whose denominator may cancel, the state sums many products
TOL_H = dict(rtol=2e-4, atol=2e-4)
TOL_C = dict(rtol=2e-3, atol=2e-3)
TOL_M = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=2e-4, atol=2e-4)     # mixers and LM logits


def _log_sigmoid(x):
    return -np.logaddexp(0.0, -x)


def _kernel_inputs(B, H, C, L, dh, seed):
    """tests/test_kernels.py's distributions in the JAX kernel's layout:
    q/k/v (B, H, C, L, dh), gates (B, H, C, L)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q, k, v = (rng.normal(size=(B, H, C, L, dh)).astype(f32) for _ in range(3))
    gi = (rng.normal(size=(B, H, C, L)) * 2.0).astype(f32)
    gf = _log_sigmoid(rng.normal(size=(B, H, C, L)) + 4.0).astype(f32)
    return q, k, v, gi, gf


def _to_model_layout(q, k, v, gi, gf, S=None):
    """-> q/k/v (B, S, H, dh), gates (B, S, H) as torch tensors, the first
    S steps."""
    B, H, C, L, dh = q.shape
    S = S or C * L

    def seq(a):
        a = a.reshape(B, H, C * L, -1).transpose(0, 2, 1, 3)[:, :S]
        return torch.from_numpy(np.ascontiguousarray(a))
    return (*(seq(a) for a in (q, k, v)),
            *(seq(a[..., None])[..., 0] for a in (gi, gf)))


def _state(rng, B, H, dh):
    return (rng.normal(size=(B, H, dh, dh)).astype(np.float32) * 0.1,
            rng.normal(size=(B, H, dh)).astype(np.float32) * 0.1,
            rng.normal(size=(B, H)).astype(np.float32))


def _assert_matches(h, st, jh, jst, S):
    B, H, C, L, dh = jh.shape
    jh = np.asarray(jh).reshape(B, H, C * L, dh).transpose(0, 2, 1, 3)[:, :S]
    np.testing.assert_allclose(h.numpy(), jh, **TOL_H)
    for got, want, tol in zip(st, jst, (TOL_C, TOL_C, TOL_M)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("B,H,C,L,dh", [(2, 2, 4, 16, 32), (1, 4, 2, 32, 64)])
def test_mlstm_plain_matches_reference(B, H, C, L, dh, impl):
    """tests/test_kernels.py:127-147's shapes and scale 0.17: h, C, n, m."""
    x = _kernel_inputs(B, H, C, L, dh, C * L + dh)
    h, st = ops.mlstm_chunkwise(*_to_model_layout(*x), chunk=L, scale=0.17)
    assert ops.mlstm_chunkwise.launches == 0                # CPU: plain version
    assert h.shape == (B, C * L, H, dh) and st[0].dtype == torch.float32
    jh, jst = j_mlstm(*map(jnp.asarray, x), impl=impl, scale=0.17)
    _assert_matches(h, st, jh, jst, C * L)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
def test_mlstm_plain_continues_a_state(impl):
    """tests/test_kernels.py:150: the second half run from the first
    half's state gives the full run's h; and from a random start state the
    plain version matches JAX given the same state."""
    B, H, C, L, dh = 1, 2, 4, 16, 32
    x = _kernel_inputs(B, H, C, L, dh, 11)
    q, k, v, gi, gf = _to_model_layout(*x)
    h_full, st_full = ops.mlstm_chunkwise(q, k, v, gi, gf, chunk=L)
    half = 2 * L
    _, st1 = ops.mlstm_chunkwise(q[:, :half], k[:, :half], v[:, :half],
                                 gi[:, :half], gf[:, :half], chunk=L)
    h2, st2 = ops.mlstm_chunkwise(q[:, half:], k[:, half:], v[:, half:],
                                  gi[:, half:], gf[:, half:], st1, chunk=L)
    np.testing.assert_allclose(h2.numpy(), h_full[:, half:].numpy(), **TOL_H)
    for a, b in zip(st2, st_full):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL_C)
    state = _state(np.random.default_rng(12), B, H, dh)
    h, st = ops.mlstm_chunkwise(q, k, v, gi, gf,
                                tuple(map(torch.from_numpy, state)), chunk=L)
    jh, jst = j_mlstm(*map(jnp.asarray, x), tuple(map(jnp.asarray, state)),
                      impl=impl)
    _assert_matches(h, st, jh, jst, C * L)


@pytest.mark.parametrize("impl", ["interpret", "ref"])
@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_plain_masks_a_ragged_tail(impl, with_state):
    """The port runs S = C*L - 5 steps (its last chunk 5 shorter), JAX the
    same steps padded as ``repro/models/xlstm.py`` pads them (log_i = -60,
    log_f = 0, zero q/k/v): h on the real steps and the final m, C and n
    agree."""
    B, H, C, L, dh = 2, 2, 3, 16, 32
    q, k, v, gi, gf = _kernel_inputs(B, H, C, L, dh, 13)
    S = C * L - 5
    pad = np.arange(C * L) >= S
    for a in (q, k, v):
        a.reshape(B, H, C * L, dh)[:, :, pad] = 0
    gi.reshape(B, H, C * L)[:, :, pad] = -60.0
    gf.reshape(B, H, C * L)[:, :, pad] = 0.0
    state = _state(np.random.default_rng(14), B, H, dh) if with_state else None
    h, st = ops.mlstm_chunkwise(
        *_to_model_layout(q, k, v, gi, gf, S),
        None if state is None else tuple(map(torch.from_numpy, state)),
        chunk=L)
    jh, jst = j_mlstm(*map(jnp.asarray, (q, k, v, gi, gf)),
                      None if state is None else tuple(map(jnp.asarray, state)),
                      impl=impl)
    _assert_matches(h, st, jh, jst, S)


# ------------------------------------------------------------- mixers
def _cfgs():
    return base.get_config(NAME).reduced(), configs.get_config(NAME).reduced()


def _close_cache(tc, jc):
    assert sorted(tc) == sorted(jc)
    for n in jc:
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]), **TOL,
                                   err_msg=n)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
@pytest.mark.parametrize("from_cache", [False, True])
def test_mixer_forward_and_decode_match_reference(mixer, from_cache):
    """Forward over S = 40 (mLSTM in chunks of 16: two whole chunks and a
    ragged one), from an empty or a random cache, then three decode steps:
    outputs and every cache leaf."""
    jcfg, tcfg = _cfgs()
    init = jxlstm.init_mlstm if mixer == "mlstm" else jxlstm.init_slstm
    jp = init(jcfg, jax.random.PRNGKey(3))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, 64)).astype(np.float32)
    cache = None
    if from_cache:
        empty = (jxlstm.empty_mlstm_state if mixer == "mlstm"
                 else jxlstm.empty_slstm_state)(jcfg, 2)
        cache = {n: (rng.normal(size=a.shape) * 0.1).astype(np.float32)
                 for n, a in empty.items()}
        cache["m"] = np.abs(cache["m"]) * 10                 # a finite stabilizer
    jcache = None if cache is None else {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = None if cache is None else {n: torch.from_numpy(a) for n, a in cache.items()}
    if mixer == "mlstm":
        jf, tf, kw = jxlstm.mlstm_forward, xlstm.mlstm_forward, dict(chunk=16)
        jdec, tdec = jxlstm.mlstm_decode, xlstm.mlstm_decode
    else:
        jf, tf, kw = jxlstm.slstm_forward, xlstm.slstm_forward, {}
        jdec, tdec = jxlstm.slstm_decode, xlstm.slstm_decode
    jo, jc = jf(jcfg, jp, jnp.asarray(x), jcache, return_cache=True, **kw)
    to, tc = tf(tcfg, tp, torch.from_numpy(x), tcache, return_cache=True, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_cache(tc, jc)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        jo, jc = jdec(jcfg, jp, jnp.asarray(xt), jc)
        to, tc = tdec(tcfg, tp, torch.from_numpy(xt), tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _close_cache(tc, jc)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_empty_states_match_reference(mixer):
    jcfg, tcfg = _cfgs()
    if mixer == "mlstm":
        jc, tc = (jxlstm.empty_mlstm_state(jcfg, 3),
                  xlstm.empty_mlstm_state(tcfg, 3, "cpu"))
    else:
        jc, tc = (jxlstm.empty_slstm_state(jcfg, 3),
                  xlstm.empty_slstm_state(tcfg, 3, "cpu"))
    assert sorted(tc) == sorted(jc)
    for n in jc:
        assert tuple(tc[n].shape) == jc[n].shape
        assert str(tc[n].dtype).split(".")[1] == jc[n].dtype.name
        np.testing.assert_array_equal(tc[n].numpy(), np.asarray(jc[n]))


# ----------------------------------------------------------------- the LM
@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jm = jlm.LM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, lm.LM(tcfg, device="cpu"), tparams


def _leaves(cache):
    return [(n, np.asarray(t)) for layer in cache for n, t in sorted(layer.items())]


def test_lm_prefill_and_decode_match_reference(models):
    """The reduced 8-layer model (7 mLSTM, 1 sLSTM): ``LM.prefill`` of two
    21-token prompts (one mLSTM chunk of 21) and four ``LM.decode`` steps;
    logits and every cache leaf within 2e-4."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 512, size=(2, 21)).astype(np.int32)
    jl, jc = jm.prefill(jparams, jnp.asarray(tok), max_len=48)
    tl, tc = tm.prefill(tparams, torch.from_numpy(tok), max_len=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    pos = np.array([21, 21], np.int32)
    for _ in range(4):
        t = rng.integers(0, 512, size=(2, 1)).astype(np.int32)
        jl, jc = jm.decode(jparams, jc, jnp.asarray(t), jnp.asarray(pos))
        tl, out = tm.decode(tparams, tc, torch.from_numpy(t), torch.from_numpy(pos))
        assert out is tc                                     # in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        pos = pos + 1
    for (n, a), (m, b) in zip(_leaves(tc), _leaves(jc)):
        assert n == m and a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL, err_msg=n)


def test_cache_zeros_matches_reference(models):
    jm, _, tm, _ = models
    got, want = _leaves(tm.cache_zeros(3, 40)), _leaves(jm.cache_zeros(3, 40))
    assert [(n, a.shape, a.dtype.name) for n, a in got] == \
        [(n, a.shape, a.dtype.name) for n, a in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=n)       # m = -1e30


def test_init_params_matches_reference_layout(models):
    """Keys, shapes and dtypes of the reference's tree; the reference's
    init rules: mLSTM's forget-gate bias linspace(3, 6) over heads, sLSTM's
    bias row 2 likewise, and ``ffn_gate == ffn_up`` (one key there)."""
    _, jparams, tm, _ = models
    got = init_params(tm.cfg, torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(jparams)
    tl, tdef = jax.tree.flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    jm_, tm_ = jparams["blocks"][0]["mixer"], got["blocks"][0]["mixer"]
    np.testing.assert_allclose(tm_["if_bias"].numpy(), np.asarray(jm_["if_bias"]),
                               atol=1e-6)
    js, ts = jparams["blocks"][7]["mixer"], got["blocks"][7]["mixer"]
    np.testing.assert_allclose(ts["bias"].numpy(), np.asarray(js["bias"]), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(js["ffn_gate"]), np.asarray(js["ffn_up"]))
    assert torch.equal(ts["ffn_gate"], ts["ffn_up"])
    assert ts["ffn_gate"].data_ptr() != ts["ffn_up"].data_ptr()
