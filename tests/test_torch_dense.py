"""Port parity on the CPU for the dense slot pool: the dense decode
kernel's plain version against the JAX split-K kernel in interpret mode,
``LM.prefill`` / ``LM.decode(active=)`` / ``cache_zeros`` /
``cache_slot_write`` / ``cache_slot_read`` of reduced jamba against
``repro/models/lm.py``, and the copies that keep in-place pool updates from
reaching a read slot or a prefix-cache entry."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.kernels.decode_attention.ops import \
    decode_attention as j_decode_op  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attention import ops as decode_ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402
from repro_torch.serving.engine import RealEngine, Request  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)
NAME = "jamba-v0.1-52b"


# ------------------------------------------------------------ dense decode
@pytest.mark.parametrize("B,H,Hkv,S,D,window,softcap,ns", [
    (2, 4, 2, 256, 64, None, None, 4),
    (2, 4, 1, 512, 64, None, None, 8),
    (1, 8, 8, 256, 128, 128, None, 5),
    (2, 2, 2, 256, 64, None, 50.0, 1),
])
def test_dense_decode_plain_matches_reference(B, H, Hkv, S, D, window,
                                              softcap, ns):
    """``tests/test_kernels.py::test_decode_attention``'s cases; the port
    reads the cache as (B, S, Hkv, D), the TPU kernel as (B, Hkv, S, D)."""
    rng = np.random.default_rng(S + H + ns)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    lengths = rng.integers(S // 4, S + 1, size=(B,)).astype(np.int32)
    kw = dict(window=window, softcap=softcap)
    got = decode_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k.transpose(0, 2, 1, 3).copy()),
        torch.from_numpy(v.transpose(0, 2, 1, 3).copy()),
        torch.from_numpy(lengths), **kw).numpy()
    assert decode_ops.decode_attention.launches == 0     # CPU: plain version
    for impl, extra in (("interpret", dict(n_splits=ns)), ("ref", {})):
        want = j_decode_op(*map(jnp.asarray, (q, k, v, lengths)), impl=impl,
                           **kw, **extra)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


# ------------------------------------------------------------- the LM
@pytest.fixture(scope="module", params=[None, 8], ids=["full", "window8"])
def models(request):
    """Reduced jamba; "window8" gives its attention layer a window of 8,
    so decode runs through the ring cache."""
    def cut(cfg):
        pattern = list(cfg.pattern)
        pattern[4] = dataclasses.replace(pattern[4], window=request.param)
        return dataclasses.replace(cfg, pattern=tuple(pattern))
    jcfg = cut(base.get_config(NAME).reduced())
    tcfg = cut(configs.get_config(NAME).reduced())
    jm = jlm.LM(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jm, jparams, lm.LM(tcfg, device="cpu"), tparams


def _leaves(cache):
    return [(n, np.asarray(t)) for layer in cache for n, t in sorted(layer.items())]


def _assert_caches_close(tcache, jcache, rows=slice(None)):
    for (n, a), (m, b) in zip(_leaves(tcache), _leaves(jcache)):
        assert n == m and a.shape == b.shape
        np.testing.assert_allclose(a[:, rows], b[:, rows], **TOL, err_msg=n)


def test_cache_zeros_matches_reference(models):
    jm, _, tm, _ = models
    got, want = tm.cache_zeros(3, 40), jm.cache_zeros(3, 40)
    assert [(n, a.shape, a.dtype.name) for n, a in _leaves(got)] == \
        [(n, a.shape, a.dtype.name) for n, a in _leaves(want)]
    assert not any(a.any() for _, a in _leaves(got))


def test_prefill_and_pool_decode_match_reference(models):
    """Two prompts prefilled batch-1, written into rows 0 and 2 of a
    3-row pool, then three pool decodes with row 1 dead; logits and every
    cache leaf of the live rows, and a row read back, agree."""
    jm, jparams, tm, tparams = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=(1, n)).astype(np.int32)
               for n in (21, 9)]
    jpool, tpool = jm.cache_zeros(3, 48), tm.cache_zeros(3, 48)
    for slot, tok in zip((0, 2), prompts):
        jl, jc = jm.prefill(jparams, jnp.asarray(tok), max_len=48)
        tl, tc = tm.prefill(tparams, torch.from_numpy(tok), max_len=48)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_caches_close(tc, jc)
        jpool = jlm.cache_slot_write(jpool, jc, slot)
        assert lm.cache_slot_write(tpool, tc, slot) is tpool       # in place
    _assert_caches_close(tpool, jpool)
    pos = np.array([21, 0, 9], np.int32)
    act = np.array([True, False, True])
    live = [0, 2]
    for step in range(3):
        tok = rng.integers(0, 512, size=(3, 1)).astype(np.int32)
        jl, jpool = jm.decode(jparams, jpool, jnp.asarray(tok),
                              jnp.asarray(pos), active=jnp.asarray(act))
        tl, out = tm.decode(tparams, tpool, torch.from_numpy(tok),
                            torch.from_numpy(pos), active=torch.from_numpy(act))
        assert out is tpool
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], **TOL)
        _assert_caches_close(tpool, jpool, rows=live)
        pos = pos + 1
    _assert_caches_close(lm.cache_slot_read(tpool, 2),
                         jlm.cache_slot_read(jpool, 2))


def test_init_params_matches_reference_layout(models):
    jm, jparams, tm, _ = models
    got = init_params(tm.cfg, torch.Generator().manual_seed(0), device="cpu")
    jl, jdef = jax.tree.flatten(jparams)
    tl, tdef = jax.tree.flatten(got)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    mixer = got["blocks"][0]["mixer"]
    A = torch.exp(mixer["A_log"])
    assert ((A >= 1) & (A <= 16)).all() and (mixer["D"] == 1).all()
    assert not mixer["dt_bias"].any()


# ----------------------------------------------------------------- copies
def test_read_slot_is_a_copy(models):
    _, _, tm, _ = models
    pool = tm.cache_zeros(2, 16)
    single = tuple({n: torch.full_like(t[:, :1], 2.0) for n, t in layer.items()}
                   for layer in pool)
    lm.cache_slot_write(pool, single, 1)
    read = lm.cache_slot_read(pool, 1)
    lm.cache_slot_write(pool, tuple({n: torch.full_like(t, 5.0)
                                     for n, t in layer.items()}
                                    for layer in single), 1)
    assert all((t == 2.0).all() for layer in read for t in layer.values())
    assert all((t[:, 1] == 5.0).all() for layer in pool for t in layer.values())


def test_reused_prefix_entry_is_unchanged():
    """A dense engine decodes a prefix hit from a copy of the cached
    entry: the entry's tensors stay bit-identical after the hit's own
    decode and after later admissions through the pool."""
    cfg = configs.get_config("gentorrent-llama3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = RealEngine(cfg, lm.LM(cfg, "cpu"), params, max_len=128, paged=False,
                     device="cpu")
    shared = [7] * 40
    eng.generate(Request(0, shared + [1, 2], max_new=4))
    _, entry = eng.prefix_cache.peek(shared + [9])
    before = [t.clone() for layer in entry.handle for t in layer.values()]
    hit = eng.generate(Request(1, shared + [9, 9, 9], max_new=6))
    assert hit.cached_tokens == 32
    s = Scheduler(eng, max_active=2)
    for i in range(3):
        s.submit(Request(2 + i, shared + [3 + i] * 5, max_new=5))
    done = s.run()
    assert all(r.cached_tokens == 32 for r in done)
    after = [t for layer in entry.handle for t in layer.values()]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
