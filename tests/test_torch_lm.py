"""Port parity on the CPU for the paged LM: ``prefill_paged``,
``decode_paged`` (incl. ``write=False``) and ``verify_paged`` logits and
arenas of ``repro_torch.models.lm.LM`` against ``repro.models.lm.LM`` on the
same weights (carried over by ``from_jax_params``), plus the params tree."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.models.lm import LM as JLM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
NAME = "gentorrent-llama3-8b"
BLK, P, N_PG = 32, 12, 4


@pytest.fixture(scope="module", params=[1, 2], ids=["1layer", "2layers"])
def models(request):
    jcfg = dataclasses.replace(base.get_config(NAME).reduced(),
                               n_layers=request.param)
    tcfg = dataclasses.replace(configs.get_config(NAME).reduced(),
                               n_layers=request.param)
    jm = JLM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, LM(tcfg, device="cpu"), tparams


class Pair:
    """Both LMs with their weights and their own arenas, driven in step."""

    def __init__(self, models):
        self.jm, self.jparams, self.tm, self.tparams = models
        self.jarena = self.jm.paged_arena_zeros(P, BLK)
        self.tarena = self.tm.paged_arena_zeros(P, BLK)

    def run(self, fn, *args, **kw):
        """``fn`` on both LMs with numpy args -> (torch, jax) logits."""
        def conv(f, v):
            return f(v) if isinstance(v, np.ndarray) else v
        jl, self.jarena = getattr(self.jm, fn)(
            self.jparams, self.jarena, *map(jnp.asarray, args),
            **{k: conv(jnp.asarray, v) for k, v in kw.items()})
        tl, arena = getattr(self.tm, fn)(
            self.tparams, self.tarena, *map(torch.from_numpy, args),
            **{k: conv(torch.from_numpy, v) for k, v in kw.items()})
        assert arena is self.tarena                          # in place
        return tl.numpy(), np.asarray(jl)

    def tarena_np(self):
        return [a[n].numpy().copy() for a in self.tarena for n in ("k", "v")]

    def assert_arenas_equal_live(self):
        jarena = [np.asarray(a[n]) for a in self.jarena for n in ("k", "v")]
        for t, j in zip(self.tarena_np(), jarena):
            np.testing.assert_allclose(t[:, 1:], j[:, 1:], **TOL)  # 0: scratch


def _tables():
    pt = np.zeros((3, N_PG), np.int32)
    pt[0, :3] = [5, 2, 9]
    pt[1, :2] = [7, 1]
    pt[2, :4] = [3, 11, 4, 8]
    return pt


@pytest.fixture(scope="module")
def served(models):
    """Both models after a prefill of three rows (two chunks, one row dead
    in the second), arenas carried along."""
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


def test_from_jax_params_keeps_tree(models):
    jm, jparams, _, tparams = models
    jl, jdef = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    tl, tdef = jax.tree.flatten(tparams)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())
    half = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu",
                           dtype=torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in jax.tree.leaves(half))


def test_init_params_matches_reference_layout(models):
    jm, jparams, tm, _ = models
    got = init_params(tm.cfg, torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(jparams)
    tl, tdef = jax.tree.flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert b.dtype == torch.float32
    std = got["blocks"][0]["mixer"]["wq"].std().item()
    assert abs(std * np.sqrt(tm.cfg.d_model) - 0.88) < 0.1   # trunc-normal(±2)
