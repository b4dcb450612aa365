"""Port parity on the CPU for the decoder-only families beside llama on
the paged pool: ``h2o-danube-1.8b`` (a window on every layer),
``gemma2-9b`` (softcaps, sandwich norms, alternating windows, scaled and
tied embeddings, D=256 at full width), ``yi-34b`` (zero-padded query
heads), ``granite-20b`` (one KV head), ``dbrx-132b`` and
``moonshot-v1-16b-a3b`` (MoE, the second with shared experts), reduced.

``test_torch_lm.py``'s scenario on each: ``prefill_paged`` over two chunks
(a dead row in the second), ``decode_paged`` (also with ``write=False``)
and ``verify_paged``, logits and arenas within 2e-4 of ``repro.models.lm``
on the same weights (float32, different summation orders).  Their paged
serving, against the reference engine, is
``tests/test_torch_families_serving.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402
from test_torch_lm import BLK, TOL, Pair, _tables  # noqa: E402

PAGED = ["h2o-danube-1.8b", "gemma2-9b", "yi-34b", "granite-20b",
         "dbrx-132b", "moonshot-v1-16b-a3b"]


@pytest.fixture(scope="module", params=PAGED)
def models(request):
    jcfg = base.get_config(request.param).reduced()
    tcfg = configs.get_config(request.param).reduced()
    jm = JLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, LM(tcfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def served(models):
    """Both models after a prefill of three rows over two chunks (64
    positions: past the reduced window of 8), one row dead in the second."""
    pair = Pair(models)
    rng = np.random.default_rng(0)
    pt = _tables()
    out = []
    for step, act in enumerate([np.array([True, True, True]),
                                np.array([True, False, True])]):
        tok = rng.integers(0, 512, size=(3, BLK)).astype(np.int32)
        pos0 = np.full((3,), step * BLK, np.int32)
        out.append((act, pair.run("prefill_paged", pt, tok, pos0, active=act)))
    return pair, pt, out


def test_prefill_paged_matches_reference(served):
    pair, _, out = served
    for act, (tl, jl) in out:
        np.testing.assert_allclose(tl[act], jl[act], **TOL)
    pair.assert_arenas_equal_live()


def test_decode_paged_matches_reference(served):
    pair, pt, _ = served
    tok = np.array([[7], [300], [11]], np.int32)
    pos = np.array([64, 32, 64], np.int32)
    act = np.array([True, True, False])
    tl, jl = pair.run("decode_paged", pt, tok, pos, active=act)
    np.testing.assert_allclose(tl[act], jl[act], **TOL)
    pair.assert_arenas_equal_live()


def test_decode_paged_write_false_leaves_arena(served):
    pair, pt, _ = served
    before = pair.tarena_np()
    tok = np.array([[9], [9], [9]], np.int32)
    pos = np.array([40, 20, 63], np.int32)
    tl, jl = pair.run("decode_paged", pt, tok, pos, write=False)
    np.testing.assert_allclose(tl, jl, **TOL)
    for b, a in zip(before, pair.tarena_np()):
        np.testing.assert_array_equal(b, a)                  # bit-identical


def test_verify_paged_matches_reference(served):
    pair, pt, _ = served
    W = 5
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 512, size=(3, W)).astype(np.int32)
    pos = np.array([62, 33, 65], np.int32)            # row 0 straddles a block
    n_tok = np.array([5, 2, 0], np.int32)
    tl, jl = pair.run("verify_paged", pt, tok, pos, n_tok=n_tok)
    for b in range(3):
        np.testing.assert_allclose(tl[b, :n_tok[b]], jl[b, :n_tok[b]], **TOL)
    pair.assert_arenas_equal_live()


def test_init_params_matches_reference_layout(models):
    jm, jparams, tm, _ = models
    got = init_params(tm.cfg, torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(jparams)
    tl, tdef = jax.tree.flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
