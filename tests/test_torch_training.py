"""The port's training path on the CPU against the reference's: the loss
and its gradients (``lm_loss`` under ``torch.autograd`` against
``jax.value_and_grad`` of ``repro.models.lm.lm_loss``, remat on) for eight
reduced configs, AdamW, the train step, the gradient codecs, checkpoints,
the fault-tolerant supervisor and ``launch/train.train``; and the plain
version of the flash kernel's backward against autograd.

Weights come from the reference's ``LM.init`` through
``params.from_jax_params``; inputs and gradients are numpy arrays made from
seeds and handed to both packages.  The card's side of the backward kernel
is in ``tests/test_torch_cuda.py``."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro.models.lm import lm_loss as jlm_loss  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import fault_tolerance as jft  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training.train_step import make_train_step as jmake_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import remat  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.models.lm import lm_loss as tlm_loss  # noqa: E402
from repro_torch.params import from_jax_params  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402
from repro_torch.training import fault_tolerance as tft  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training.data import MarkovCorpus  # noqa: E402
from repro_torch.training.train_step import make_train_step as tmake_step  # noqa: E402

DANUBE = "h2o-danube-1.8b"
JAMBA = "jamba-v0.1-52b"
XLSTM = "xlstm-1.3b"
FAMILIES = ["gentorrent-llama3-8b", DANUBE, "gemma2-9b", "moonshot-v1-16b-a3b",
            JAMBA, XLSTM, "whisper-base", "llama-3.2-vision-11b"]
# gradients: rtol 1e-4, atol 1e-6 element by element, but for the leaves
# where float32 loses more digits in both packages than atol 1e-6 allows,
# measured against a float64 run of the port.  There atol is a share of the
# leaf's largest entry:
#   xlstm, its first three mLSTM layers and the embedding (the exponential
#   gates and a normaliser that cancels): each package within 3.6e-5 of the
#   leaf's max of float64, the port within 5.7e-5 of the reference; 1e-4.
#   jamba, the embedding: each package within 2.6e-6 of the leaf's max of
#   float64, the port within 2.6e-6 of the reference; 1e-5.
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _atol_of_max(name, path):
    """The share of the leaf's largest entry that is its atol, for the
    leaves named above; None for the others (atol 1e-6)."""
    if name == XLSTM and (path == ("embed",) or (path[0] == "blocks" and path[1] < 3)):
        return 1e-4
    if name == JAMBA and path == ("embed",):
        return 1e-5
    return None


def _configs(name):
    """(reference config, port config), reduced.  jamba's Mamba layers
    scan in chunks of 4: the reference's SSD scan (``models/mamba.py``
    ``ssd_scan``) takes exp of the masked upper triangle before its
    ``where``, which overflows once a chunk's summed decay passes ~88 and
    turns every gradient below the last Mamba layer into NaN at the
    reduced chunk of 16."""
    cfgs = base.get_config(name).reduced(), configs.get_config(name).reduced()
    if name == JAMBA:
        cfgs = tuple(dataclasses.replace(c, mamba=dataclasses.replace(c.mamba, chunk=4))
                     for c in cfgs)
    return cfgs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(name, key=0):
    cfg = _configs(name)[0]
    model = build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(key))


def _named_leaves(tree, path=()):
    """(path, leaf) of a nested dict / tuple tree, dict keys sorted (jax's
    flatten order, so both packages' trees line up)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, path + (i,))
    else:
        yield path, tree


def _batch(cfg, rng, B=2, S=24):
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels[0, :3] = -1                                 # masked positions
    aux = {}
    if cfg.is_encdec:
        aux["frames"] = rng.standard_normal((B, 20, cfg.d_model)).astype(np.float32)
    if cfg.n_image_tokens:
        aux["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return toks, labels, aux


def _graded(tree):
    for _, t in _named_leaves(tree):
        t.requires_grad_(True)
    return tree


# ---------------------------------------------------------- loss and grads
@pytest.mark.parametrize("name", FAMILIES)
def test_lm_loss_and_gradients_match_reference(name):
    """Loss within 1e-5 relative, ``moe_aux`` within 1e-5, every gradient
    leaf finite in both packages and within ``GRAD_TOL`` (measured worst
    over the leaves at atol 1e-6: 0.16 of the tolerance) or its share of
    the leaf's max (``_atol_of_max``), remat on, float32 (the reference
    with block_q=32).  Whisper's encoder and the MoE routers get non-zero
    gradients."""
    jcfg, jm, jp = _reference(name)
    tcfg = _configs(name)[1]
    toks, labels, aux = _batch(jcfg, np.random.default_rng(0))
    jaux = {k: jnp.asarray(v) for k, v in aux.items()} or None
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jlm_loss(jcfg, jm, p, jnp.asarray(toks), jnp.asarray(labels),
                           aux=jaux, remat=True, block_q=32), has_aux=True)(jp)
    tp = _graded(from_jax_params(_np(jp), device="cpu"))
    tl, tmet = tlm_loss(tcfg, LM(tcfg, device="cpu"), tp, torch.from_numpy(toks),
                        torch.from_numpy(labels),
                        aux={k: torch.from_numpy(v) for k, v in aux.items()} or None,
                        remat=True)
    tl.backward()
    assert tl.item() == pytest.approx(float(jl), rel=1e-5)
    assert tmet["ce"].item() == pytest.approx(float(jmet["ce"]), rel=1e-5)
    assert tmet["moe_aux"].item() == pytest.approx(float(jmet["moe_aux"]), abs=1e-5)
    assert tmet["tokens"].item() == float(jmet["tokens"]) == labels.size - 3
    want = dict(_named_leaves(_np(jg)))
    got = list(_named_leaves(tp))
    assert [p for p, _ in got] == list(want)
    for path, t in got:
        assert t.grad is not None and torch.isfinite(t.grad).all(), path
        assert np.isfinite(want[path]).all(), path
        tol = dict(GRAD_TOL)
        share = _atol_of_max(name, path)
        if share is not None:
            tol["atol"] = share * float(np.abs(want[path]).max())
        np.testing.assert_allclose(t.grad.numpy(), want[path], err_msg=str(path), **tol)
    if jcfg.moe is not None:
        assert tmet["moe_aux"].item() > 0
        routers = [t for p, t in got if p[-1] == "router"]
        assert routers and all(r.grad.abs().max() > 0 for r in routers)
    if jcfg.is_encdec:
        enc = [t for p, t in got if p[0] == "encoder"]
        assert enc and all(t.grad.abs().max() > 0 for t in enc)


def test_mamba_gradients_match_the_recurrence():
    """The Mamba mixer's gradients through the chunked scan's plain version
    (chunks of 4 over 11 steps, one of them ragged) equal those through
    the one-token recurrence of ``mamba_decode``, step by step: the
    weights' and the input's, within 1e-5."""
    from repro_torch.models import mamba
    cfg = _configs(JAMBA)[1]
    _, _, jp = _reference(JAMBA)
    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32))
    grads = []
    for scan in (True, False):
        p = {k: v[0] for k, v in from_jax_params(_np(jp), device="cpu")["blocks"][0]
             ["mixer"].items()}
        _graded(p)
        x = torch.from_numpy(x0).requires_grad_(True)
        if scan:
            out = mamba.mamba_forward(cfg, p, x)
        else:
            cache, outs = mamba.init_cache(cfg, 2, "cpu"), []
            for t in range(x.shape[1]):
                o, cache = mamba.mamba_decode(cfg, p, x[:, t:t + 1], cache)
                outs.append(o)
            out = torch.cat(outs, dim=1)
        (out * w).sum().backward()
        grads.append([x.grad] + [p[k].grad for k in sorted(p)])
    for a, b in zip(*grads):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", ["full", "dots", "none", False])
def test_remat_policies_give_the_same_gradients(policy):
    """Every remat policy (and none) gives the gradients of no remat, on
    danube (a window) and moonshot (MoE)."""
    for name in (DANUBE, "moonshot-v1-16b-a3b"):
        cfg = configs.get_config(name).reduced()
        _, _, jp = _reference(name)
        toks, labels, _ = _batch(cfg, np.random.default_rng(1))
        grads = []
        for r in (False, policy):
            tp = _graded(from_jax_params(_np(jp), device="cpu"))
            loss, _ = tlm_loss(cfg, LM(cfg, device="cpu"), tp, torch.from_numpy(toks),
                               torch.from_numpy(labels), remat=r)
            loss.backward()
            grads.append([t.grad for _, t in _named_leaves(tp)])
        for a, b in zip(*grads):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="unknown remat policy"):
        remat.wrap(lambda x: x, "some")


def test_apply_is_graded_only_where_asked():
    """``LM.apply`` builds a graph for weights that require grad, none
    under ``no_grad`` (the verifier's call), and its ``collect_aux`` sum
    is the MoE layers' aux loss."""
    name = "moonshot-v1-16b-a3b"
    cfg = configs.get_config(name).reduced()
    _, _, jp = _reference(name)
    tp = _graded(from_jax_params(_np(jp), device="cpu"))
    toks = torch.from_numpy(_batch(cfg, np.random.default_rng(2))[0])
    model = LM(cfg, device="cpu")
    logits, aux = model.apply(tp, toks, collect_aux=True)
    assert logits.requires_grad and aux.requires_grad and aux.item() > 0
    with torch.no_grad():
        plain = model.apply(tp, toks)
    assert not plain.requires_grad
    torch.testing.assert_close(plain, logits.detach())


# ---------------------------------------------------------------- flash bwd
@pytest.mark.parametrize("B,H,Hkv,Sq,Skv,D,causal,window,softcap", [
    (2, 4, 4, 17, 17, 16, True, None, None),
    (2, 4, 1, 20, 20, 16, True, 5, None),
    (1, 8, 2, 12, 12, 8, True, None, 5.0),
    (1, 48, 1, 9, 9, 8, True, 4, 2.0),
    (1, 8, 2, 7, 23, 16, False, None, None),
    (2, 4, 4, 21, 21, 8, False, None, 3.0),
], ids=["causal-G1", "window-G4", "softcap-G4", "G48", "cross", "noncausal-cap"])
def test_attention_bwd_ref_equals_autograd(B, H, Hkv, Sq, Skv, D, causal, window, softcap):
    """``attention_bwd_ref`` (the explicit formula the kernel computes)
    equals torch autograd of ``attention_ref`` within 1e-5, with the lse
    of ``lse_ref``; the kernel's f32 gradients are held to it on the
    card."""
    g = torch.Generator().manual_seed(B * 100 + H + Sq)
    q = torch.randn(B, H, Sq, D, generator=g, requires_grad=True)
    k = torch.randn(B, Hkv, Skv, D, generator=g, requires_grad=True)
    v = torch.randn(B, Hkv, Skv, D, generator=g, requires_grad=True)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o = flash_ref.attention_ref(q, k, v, **kw)
    do = torch.randn(o.shape, generator=g)
    o.backward(do)
    lse = flash_ref.lse_ref(q.detach(), k.detach(), **kw)
    got = flash_ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(), o.detach(),
                                      do, lse, **kw)
    for a, b in zip(got, (q.grad, k.grad, v.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- optimizer
def _grads_like(params, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                        _np(params))


def test_apply_updates_on_equal_gradients():
    """Two AdamW steps fed the same numpy gradients in both packages:
    params, mu, nu within 1e-6, and the same grad_norm and lr.  (Equal
    gradients, not a full step: on the first step Adam turns a gradient
    near eps into +-1.)"""
    _, _, jp = _reference(DANUBE)
    cfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=0.5)
    tcfg = topt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5, grad_clip=0.5)
    jstate, tp = jopt.init_state(jp), from_jax_params(_np(jp), device="cpu")
    tstate = topt.init_state(tp)
    for seed in (0, 1):
        g = _grads_like(jp, seed)
        jp, jstate, jm = jopt.apply_updates(cfg, jp, jax.tree.map(jnp.asarray, g), jstate)
        tp, tstate, tm = topt.apply_updates(tcfg, tp, from_jax_params(g, device="cpu"),
                                            tstate)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    for jt, tt in ((jp, tp), (jstate["mu"], tstate["mu"]), (jstate["nu"], tstate["nu"])):
        for (pa, a), (pb, b) in zip(_named_leaves(_np(jt)), _named_leaves(tt), strict=True):
            assert pa == pb
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6, err_msg=str(pa))


def test_schedule_and_global_norm_match_reference():
    for kw in (dict(), dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)):
        jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        for s in (0, 1, 50, 100, 10_000):
            assert float(topt.schedule(tc, s)) == pytest.approx(
                float(jopt.schedule(jc, jnp.asarray(s))), rel=1e-7, abs=1e-12)
    g = _grads_like(_reference(DANUBE)[2], 3, scale=1.0)
    assert float(topt.global_norm(from_jax_params(g, device="cpu"))) == pytest.approx(
        float(jopt.global_norm(jax.tree.map(jnp.asarray, g))), rel=1e-6)
    # tests/test_training.py::test_schedule_warmup_and_decay on the port
    c = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(topt.schedule(c, s)) for s in (1, 10, 50, 100)]
    assert lrs[0] < lrs[1] == pytest.approx(1.0)
    assert lrs[1] > lrs[2] > lrs[3] >= 0.1 - 1e-6


# ---------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def danube():
    cfg, model, params = _reference(DANUBE)
    return cfg, model, params, configs.get_config(DANUBE).reduced()


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_train_step_matches_reference(danube):
    """One step of each package's ``make_train_step`` (the reference's
    jitted): the loss and the gradient norm agree."""
    jcfg, jm, jp, tcfg = danube
    adamw = dict(lr=1e-3, warmup_steps=2, total_steps=30)
    b = next(MarkovCorpus(jcfg.vocab, seed=0).batches(4, 32, 1))
    jstep = jax.jit(jmake_step(jcfg, jm, jopt.AdamWConfig(**adamw), block_q=32))
    _, _, jmet = jstep(jp, jopt.init_state(jp), {k: jnp.asarray(v) for k, v in b.items()})
    tp = from_jax_params(_np(jp), device="cpu")
    tstep = tmake_step(tcfg, LM(tcfg, device="cpu"), topt.AdamWConfig(**adamw))
    _, _, tmet = tstep(tp, topt.init_state(tp), _torch_batch(b))
    assert set(tmet) == {"loss", "grad_norm", "lr"}
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
    assert float(tmet["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-7)


def test_microbatch_equals_full_batch(danube):
    """tests/test_training.py::test_microbatch_equals_full_batch on the
    port, and the step leaves the params it was given as they were."""
    _, _, jp, cfg = danube
    params = from_jax_params(_np(jp), device="cpu")
    before = [t.clone() for _, t in _named_leaves(params)]
    adamw = topt.AdamWConfig(lr=1e-3)
    model = LM(cfg, device="cpu")
    s1 = tmake_step(cfg, model, adamw, microbatches=1)
    s2 = tmake_step(cfg, model, adamw, microbatches=2)
    batch = _torch_batch(next(MarkovCorpus(cfg.vocab, seed=0).batches(4, 32, 1)))
    opt = topt.init_state(params)
    p1, _, m1 = s1(params, opt, batch)
    p2, _, m2 = s2(params, opt, batch)
    for (_, a), (_, b) in zip(_named_leaves(p1), _named_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-5)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, (_, b) in zip(before, _named_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="microbatches"):
        tmake_step(cfg, model, adamw, microbatches=3)(params, opt, batch)


def test_training_reduces_loss(danube):
    """tests/test_training.py::test_training_reduces_loss on the port."""
    _, _, jp, cfg = danube
    params = from_jax_params(_np(jp), device="cpu")
    adamw = topt.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=30)
    step = tmake_step(cfg, LM(cfg, device="cpu"), adamw)
    opt = topt.init_state(params)
    losses = []
    for b in MarkovCorpus(cfg.vocab, seed=0).batches(4, 32, 25):
        params, opt, m = step(params, opt, _torch_batch(b))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.1
    assert np.isfinite(losses).all()


def test_launch_train_matches_reference(danube):
    """``launch/train.train`` from the reference's ``LM.init(PRNGKey(0))``:
    the first loss within 1e-5 and every loss within 1e-3 relative of the
    reference's ``train``."""
    _, _, jp, _ = danube
    want = jtrain.train(DANUBE, steps=10, batch=4, seq=32, ckpt_dir="")
    got = ttrain.train(DANUBE, steps=10, batch=4, seq=32,
                       params=from_jax_params(_np(jp), device="cpu"), device="cpu")
    assert len(got["losses"]) == len(want["losses"]) == 10
    assert got["first_loss"] == pytest.approx(want["first_loss"], rel=1e-5)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    assert got["cfg"] == configs.get_config(DANUBE).reduced()


def test_launch_train_resumes_and_compresses(tmp_path):
    """A run that checkpoints, fails at a step and resumes from its last
    checkpoint; and the int8 codec on the gradients, on the port's own
    weights (``init_params`` from seed 0)."""
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        ttrain.train(DANUBE, steps=4, batch=2, seq=16, ckpt_dir=ck, fail_at_step=3,
                     device="cpu")
    assert tckpt.latest_step(ck) is None
    first = ttrain.train(DANUBE, steps=2, batch=2, seq=16, ckpt_dir=ck, device="cpu")
    assert tckpt.latest_step(ck) == 2 and len(first["losses"]) == 2
    resumed = ttrain.train(DANUBE, steps=3, batch=2, seq=16, ckpt_dir=ck, device="cpu")
    assert len(resumed["losses"]) == 1 and tckpt.latest_step(ck) == 3
    out = ttrain.train(DANUBE, steps=3, batch=2, seq=16, compress=True, microbatches=2,
                       device="cpu")
    assert np.isfinite(out["losses"]).all()
    with pytest.raises(ValueError, match="pattern"):
        ttrain.build_small_cfg("jamba-v0.1-52b", layers=12)
    assert ttrain.build_small_cfg(DANUBE, d_model=128).d_head == 128 // 4


# ---------------------------------------------------------------- compression
def _ties_free(rng, shape):
    """Gradients with distinct magnitudes (no ties at the top-k threshold)."""
    n = int(np.prod(shape))
    mags = rng.permutation(np.arange(1, n + 1)).astype(np.float32) / n
    return (mags * rng.choice([-1.0, 1.0], n)).reshape(shape).astype(np.float32)


def test_codecs_match_reference():
    """Three steps of ``compress_int8_ef`` and ``compress_topk_ef`` on equal
    gradients: the values sent and the error states within 1 ulp, the same
    top-k masks, the same wire ratio."""
    rng = np.random.default_rng(0)
    shapes = {"w": (64, 33), "b": (7,), "blocks": ({"k": (5, 4, 3)},)}
    grads = [jax.tree.map(lambda s: _ties_free(rng, s), shapes,
                          is_leaf=lambda x: isinstance(x, tuple) and
                          all(isinstance(i, int) for i in x)) for _ in range(3)]
    for jf, tf in ((jcomp.compress_int8_ef, tcomp.compress_int8_ef),
                   (lambda g, e: jcomp.compress_topk_ef(g, e, frac=0.1),
                    lambda g, e: tcomp.compress_topk_ef(g, e, frac=0.1))):
        je = jcomp.init_error_state(jax.tree.map(jnp.asarray, grads[0]))
        te = tcomp.init_error_state(from_jax_params(grads[0], device="cpu"))
        for g in grads:
            js, je = jf(jax.tree.map(jnp.asarray, g), je)
            ts, te = tf(from_jax_params(g, device="cpu"), te)
            for (pa, a), (pb, b) in zip(_named_leaves(_np(js)), _named_leaves(ts), strict=True):
                np.testing.assert_array_max_ulp(b.numpy(), a, maxulp=1)
                np.testing.assert_array_equal(b.numpy() != 0, a != 0)
            for (_, a), (_, b) in zip(_named_leaves(_np(je)), _named_leaves(te), strict=True):
                np.testing.assert_array_max_ulp(b.numpy(), a, maxulp=1)
    p = {"w": np.zeros((1000,), np.float32), "b": np.zeros((10,), np.float32)}
    assert tcomp.compression_ratio_int8(from_jax_params(p, device="cpu")) == \
        pytest.approx(jcomp.compression_ratio_int8(jax.tree.map(jnp.asarray, p)))


def test_int8_quantization_error_bound():
    """tests/test_training.py::test_int8_quantization_error_bound on the port."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(0, 1, (128, 64))
                               .astype(np.float32))}
    sent, err2 = tcomp.compress_int8_ef(g, tcomp.init_error_state(g))
    assert (sent["w"] - g["w"]).abs().max().item() <= \
        g["w"].abs().max().item() / 127.0 + 1e-6
    torch.testing.assert_close(err2["w"], g["w"] - sent["w"], atol=1e-6, rtol=0)


def test_error_feedback_unbiased_over_time():
    """tests/test_training.py::test_error_feedback_unbiased_over_time on
    the port: sum(transmitted) ~ sum(true grads)."""
    rng = np.random.default_rng(1)
    g_true = [{"w": torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))}
              for _ in range(20)]
    err = tcomp.init_error_state(g_true[0])
    sent_sum, true_sum = np.zeros(64), np.zeros(64)
    for g in g_true:
        s, err = tcomp.compress_int8_ef(g, err)
        sent_sum += s["w"].numpy()
        true_sum += g["w"].numpy()
    np.testing.assert_allclose(sent_sum, true_sum, atol=0.05)
    assert tcomp.compression_ratio_int8({"w": torch.zeros(1000), "b": torch.zeros(10)}) > 3.5


# ---------------------------------------------------------------- checkpoint
def test_checkpoint_roundtrip_and_prune(tmp_path):
    """Save, prune and restore (params and AdamW state, a bf16 copy of the
    params, numpy and int leaves) bit-exact, in the reference's layout
    with a JSON manifest."""
    _, _, jp = _reference(DANUBE)
    params = from_jax_params(_np(jp), device="cpu")
    tree = (params, topt.init_state(params),
            topt.tree_map(lambda t: t.to(torch.bfloat16), params),
            {"n": np.arange(5, dtype=np.int64), "x": torch.tensor(3.5)})
    d = tmp_path / "ck"
    for s in (10, 20, 30, 40):
        tckpt.save(d, s, tree)
    tckpt.prune(d, keep=2)
    assert tckpt.latest_step(d) == 40
    assert sorted(p.name for p in d.iterdir()) == ["step_00000030", "step_00000040"]
    assert sorted(p.name for p in (d / "step_00000040").iterdir()) == \
        ["COMMITTED", "manifest.json", "shard_0.npz"]
    back, step = tckpt.restore(d, 40, tree)
    assert step == 40
    got, want = topt.tree_leaves(back), topt.tree_leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = torch.as_tensor(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert tckpt.latest_step(tmp_path / "none") is None
    (d / "step_00000050").mkdir()                    # no COMMITTED marker
    assert tckpt.latest_step(d) == 40
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, 50, tree)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore(d, 40, params)


# ---------------------------------------------------------------- fault tolerance
def _supervise(ft, d, fail=(), slow=(), total=60, seed=0, **cfg):
    cluster = ft.SimulatedCluster(n_hosts=4, seed=seed)
    for host, step in fail:
        cluster.inject_failure(host=host, step=step)
    for host, mult in slow:
        cluster.inject_straggler(host, mult)
    torch_side = ft is tft
    sup = ft.TrainSupervisor(
        ft.SupervisorConfig(ckpt_dir=str(d), **cfg), cluster,
        lambda state, step, n_hosts: {"x": state["x"] + n_hosts},
        save_tree=lambda s: {"x": torch.tensor(s["x"]) if torch_side else np.asarray(s["x"])},
        load_tree=lambda s, t, n_hosts: {"x": int(t["x"])},
        straggler=ft.StragglerPolicy(kappa=2.0, evict_after=2))
    state, step = sup.run({"x": 0}, total_steps=total)
    return state, step, sup.events


@pytest.mark.parametrize("scenario", [
    dict(fail=((2, 33),), ckpt_every=10),
    dict(fail=((1, 5), (3, 47)), ckpt_every=20, keep=1),
    dict(slow=((0, 5.0),), ckpt_every=10),
    dict(fail=((2, 4),), ckpt_every=10),
], ids=["failure", "two-failures", "straggler", "failure-before-ckpt"])
def test_supervisor_matches_reference(tmp_path, scenario):
    """The reference's failure and straggler scenarios on both packages'
    ``TrainSupervisor``: the same events and final step and state."""
    want = _supervise(jft, tmp_path / "j", **scenario)
    got = _supervise(tft, tmp_path / "t", **scenario)
    assert got == want
    assert got[1] == 60
    kinds = [e[0] for e in got[2]]
    assert "ckpt" in kinds and ("restart" in kinds or "evict" in kinds)


def test_straggler_detection_and_eviction():
    """tests/test_training.py::test_straggler_detection_and_eviction and
    the heartbeat monitor on the port."""
    pol = tft.StragglerPolicy(kappa=2.0, evict_after=2)
    times = {0: 1.0, 1: 1.0, 2: 5.0, 3: 1.1}
    v1 = pol.observe(times)
    assert 2 in v1["slow"] and not v1["evict"]
    assert 2 in pol.observe(times)["evict"]
    assert pol.observe({}) == {"slow": set(), "evict": set()}
    mon = tft.HeartbeatMonitor(timeout=30.0)
    mon.beat("a", 0.0)
    mon.beat("b", 20.0)
    assert mon.dead_hosts(40.0) == {"a"}
    with pytest.raises(tft.HostFailure) as e:
        raise tft.HostFailure({3})
    assert e.value.hosts == {3}
    assert dataclasses.asdict(tft.SupervisorConfig(ckpt_dir="x")) == \
        dataclasses.asdict(jft.SupervisorConfig(ckpt_dir="x"))
