"""Tensor-parallel compute over 'model' (``distributed/tensor_parallel.py``)
on the CPU, with m model ranks emulated in one process: each rank's
sublayers run on its shards (``shard_params``) under
``model_shards(None, r, m)``, and the ranks' partial sums and their
inputs' gradients are summed (``emulate``), as ``reduce_out`` and
``copy_in`` sum them across processes.

- Emulation: for m in {2, 4}, in float32, layers of reduced llama, gemma2
  (softcaps, a windowed layer; at m=4 its 2 KV heads are whole on
  'model'), granite (one KV head), moonshot (MoE experts on 'model',
  shared experts split as the dense FFN) and whisper (the encoder's
  non-causal layer, the decoder's self- and cross-attention): the output
  and every gradient (weights, input, memory) equal the unsharded port
  layer's, which the other test files hold against the reference.
- The vocab: the split embedding lookup equals the whole one, and the
  split cross-entropy (``ce_parts`` of each rank's logit slice) equals
  ``lm_loss``'s ``ce`` and its gradient, with a padded vocab and a
  final softcap.
- The layout: for all 11 full-width configs at model extent 16, each
  rank's heads (``head_layout``) and shards agree with the reference's
  ``param_pspec`` / ``kv_axis``.
- The recurrent mixers split over 'model' (the Mamba mixer's heads, the
  mLSTM's value columns, the sLSTM's columns with its FFN whole or split)
  on 2, 4 and 8 emulated ranks against the reference's ``jax.vjp``, each
  rank's cache its shard of the reference's, and broken copies of each
  split caught.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import base  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import constraints  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import tree_map_with_path  # noqa: E402
from repro_torch.models import common, lm, mamba, moe, xlstm  # noqa: E402
from repro_torch.params import from_jax_params, init_params  # noqa: E402

B, S, T = 2, 24, 20
# gradients: float32 sums in another order (the ranks' partial sums)
RTOL, ATOL = 1e-4, 1e-6


def _leaves(tree) -> list:
    out = []
    tree_map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


def _graded(tree):
    """A copy of ``tree`` whose leaves are new float32 leaves that need a
    gradient."""
    return tree_map_with_path(lambda _, t: t.detach().clone().requires_grad_(True), tree)


def _layer(cfg, i=0):
    """Layer ``i`` of the pattern (repeat 0) from seed 0."""
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return params, lm._layer_slice(params["blocks"][i], 0)


def _ffn(cfg, spec, p, h):
    return lm.ffn_forward(cfg, p, h) if spec.ffn == "dense" else moe.moe_ffn(cfg, p, h)


def _emulated_layer(cfg, spec, p, x, positions, m, memory=None):
    """``layer_forward_full`` with each sublayer's m ranks emulated: the
    mixer's and the FFN's partial sums summed over the ranks, the norms
    and residuals as the layer has them (``lm._residual``)."""
    def mixer(r, h, *memory):
        pr = tp.shard_params(cfg, p, r, m)["mixer"]
        if spec.mixer == "attn":
            return lm._self_attention(cfg, spec, pr, h, positions)[0]
        return lm._cross_prefill(cfg, pr, h, positions, *memory)[0]
    h = common.apply_norm(cfg, p["norm1"], x)
    a = tp.emulate(mixer, m, h, *([] if memory is None else [memory]))
    if cfg.double_norm:
        a = common.apply_norm(cfg, p["norm1b"], a)
    x = x + a
    if spec.ffn == "none":
        return x
    h2 = common.apply_norm(cfg, p["norm2"], x)
    f = tp.emulate(lambda r, h2: _ffn(cfg, spec, tp.shard_params(cfg, p, r, m)["ffn"], h2),
                   m, h2)
    if cfg.double_norm:
        f = common.apply_norm(cfg, p["norm2b"], f)
    return x + f


def _emulated_encoder_layer(cfg, p, x, m):
    """One layer of ``lm.encode`` (non-causal, no RoPE) with its m ranks
    emulated."""
    h = common.apply_norm(cfg, p["norm1"], x)

    def attn(r, h):
        pr = tp.shard_params(cfg, p, r, m)["mixer"]
        q, k, v = lm.attention.project_qkv(cfg, pr, h, rope=False)
        return lm.attention.merge_heads(cfg, pr, lm.attention.full_attention(
            cfg, q, k, v, causal=False))
    x = x + tp.emulate(attn, m, h)
    h2 = common.apply_norm(cfg, p["norm2"], x)
    return x + tp.emulate(lambda r, h2: lm.ffn_forward(
        cfg, tp.shard_params(cfg, p, r, m)["ffn"], h2), m, h2)


def _encoder_layer(cfg, p, x):
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = lm.attention.project_qkv(cfg, p["mixer"], h, rope=False)
    x = x + lm.attention.merge_heads(cfg, p["mixer"], lm.attention.full_attention(
        cfg, q, k, v, causal=False))
    return lm._ffn_block(cfg, lm.ENC_SPEC, p, x)


def _check_grads(run, p, inputs, seed):
    """``run(params, *inputs)`` unsharded and emulated on copies of the
    same leaves, against a fixed output gradient: outputs equal within
    2e-5, every gradient within ``RTOL`` / ``ATOL`` of its largest entry."""
    outs, grads = [], []
    dy = None
    for emulated in (False, True):
        pc = _graded(p)
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = run(emulated, pc, *xs)
        if dy is None:
            dy = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                out.shape).astype(np.float32))
        (out * dy).sum().backward()
        outs.append(out.detach())
        grads.append([(path, t.grad) for path, t in _leaves(pc)]
                     + [(("input", i), x.grad) for i, x in enumerate(xs)])
    torch.testing.assert_close(outs[1], outs[0], atol=2e-5, rtol=2e-5)
    assert [p for p, _ in grads[1]] == [p for p, _ in grads[0]]
    for (path, got), (_, want) in zip(grads[1], grads[0]):
        assert (got is None) == (want is None), path
        if want is None:
            continue
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL + RTOL * scale,
                                   msg=lambda s, path=path: f"{path}: {s}")


DECODER_LAYERS = [("gentorrent-llama3-8b", 0), ("gemma2-9b", 0), ("gemma2-9b", 1),
                  ("granite-20b", 0), ("moonshot-v1-16b-a3b", 0), ("whisper-base", 0),
                  ("whisper-base", 1)]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name,i", DECODER_LAYERS, ids=lambda v: str(v))
def test_emulated_ranks_equal_the_unsharded_layer(name, i, m):
    """Layer ``i`` of the pattern through m emulated model ranks: output
    and every gradient (weights, the input, a cross-attention's memory)
    equal the unsharded layer's."""
    cfg = configs.get_config(name).reduced()
    spec = cfg.pattern[i]
    _, p = _layer(cfg, i)
    g = np.random.default_rng(i + 10 * m)
    x = torch.from_numpy(g.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    mem = torch.from_numpy(g.standard_normal((B, T, cfg.d_model)).astype(np.float32))
    positions = torch.arange(S)
    cross = spec.mixer == "cross_attn"

    def run(emulated, pc, x, *memory):
        mem = memory[0] if memory else None
        if emulated:
            return _emulated_layer(cfg, spec, pc, x, positions, m, mem)
        return lm.layer_forward_full(cfg, spec, pc, x, positions, mem)
    assert tp.head_layout(cfg, 0, m).split
    _check_grads(run, p, [x, mem] if cross else [x], seed=i)


@pytest.mark.parametrize("m", [2, 4])
def test_emulated_ranks_equal_the_unsharded_encoder_layer(m):
    """whisper's encoder layer (non-causal, no RoPE, a dense FFN without
    GLU) through m emulated model ranks."""
    cfg = configs.get_config("whisper-base").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = lm._layer_slice(params["encoder"]["layers"], 0)
    x = torch.from_numpy(np.random.default_rng(m).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32))

    def run(emulated, pc, x):
        return _emulated_encoder_layer(cfg, pc, x, m) if emulated \
            else _encoder_layer(cfg, pc, x)
    _check_grads(run, p, [x], seed=m)


def test_one_rank_is_the_unsharded_code():
    """At extent 1 nothing splits: the layer under ``model_shards(None, 0,
    1)`` gives the unsharded layer's output bit for bit."""
    cfg = configs.get_config("gemma2-9b").reduced()
    _, p = _layer(cfg)
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want = lm.layer_forward_full(cfg, cfg.pattern[0], p, x, torch.arange(S))
    with constraints.model_shards(None, 0, 1):
        assert not tp.head_layout(cfg).split and not tp.splits(cfg.d_ff)
        got = lm.layer_forward_full(cfg, cfg.pattern[0], p, x, torch.arange(S))
    assert torch.equal(got, want)


@pytest.mark.parametrize("m", [2, 4])
def test_split_embedding_equals_the_whole(m):
    """Token rows summed over the ranks' vocab slices (gemma2's scaled,
    tied table) equal the whole table's rows."""
    cfg = configs.get_config("gemma2-9b").reduced()
    model = lm.LM(cfg, "cpu")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(m).integers(
        0, cfg.vocab, (B, S)))
    want = model._embed(params, tokens, torch.arange(S))
    got = 0
    for r in range(m):
        with constraints.model_shards(None, r, m):
            got = got + model._embed(tp.shard_params(cfg, params, r, m), tokens,
                                     torch.arange(S))
    assert torch.equal(got, want)


class _Logits:
    """A model whose ``apply`` is given logits, for ``lm_loss``."""

    def __init__(self, logits):
        self.logits = logits

    def apply(self, params, tokens, **kw):
        return self.logits


@pytest.mark.parametrize("m", [2, 4])
def test_split_cross_entropy_equals_lm_loss(m):
    """gemma2 reduced with vocab 500 (padded to 512, the pad's logits at
    -1e30 by global index) and its final softcap 30: the log-likelihood
    from the ranks' logit slices (``_logits`` on each rank's rows of the
    tied head; the max over the ranks, then ``ce_parts`` summed) gives
    ``lm_loss``'s ``ce``, and its gradients with respect to the hidden
    states and the head equal ``lm_loss``'s."""
    cfg = dataclasses.replace(configs.get_config("gemma2-9b").reduced(), vocab=500)
    assert cfg.padded_vocab == 512 and cfg.final_softcap
    model = lm.LM(cfg, "cpu")
    g = np.random.default_rng(m)
    x0 = torch.from_numpy(3 * g.standard_normal((B, S, cfg.d_model)).astype(np.float32))
    head0 = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["embed"]
    labels = torch.from_numpy(g.integers(0, cfg.vocab, (B, S)))
    labels[0, :5] = -1
    labels[1, -1] = cfg.vocab - 1

    x, head = x0.clone().requires_grad_(True), head0.clone().requires_grad_(True)
    _, parts = lm.lm_loss(cfg, _Logits(model._logits({"embed": head}, x)), None, labels,
                          labels, remat=False)
    parts["ce"].backward()
    want = (parts["ce"].detach(), x.grad, head.grad)

    x, head = x0.clone().requires_grad_(True), head0.clone().requires_grad_(True)
    logits = []
    for r in range(m):
        with constraints.model_shards(None, r, m):
            shard = tp.shard_params(cfg, {"embed": head}, r, m)
            logits.append(model._logits(shard, x))
    assert logits[-1].shape[-1] == cfg.padded_vocab // m
    assert (logits[-1][..., -(cfg.padded_vocab - cfg.vocab):] == -1e30).all()
    gmax = torch.stack([t.detach().amax(-1) for t in logits]).amax(0)
    safe = labels.clamp_min(0)
    sumexp = tgt = 0
    for r, t in enumerate(logits):
        with constraints.model_shards(None, r, m):
            s, l = tp.ce_parts(t, safe, gmax)
        sumexp, tgt = sumexp + s, tgt + l
    ll = tgt - gmax - torch.log(sumexp)
    mask = (labels >= 0).float()
    ce = -(ll * mask).sum() / mask.sum()
    ce.backward()
    torch.testing.assert_close(ce.detach(), want[0], rtol=1e-6, atol=0)
    for got, w in ((x.grad, want[1]), (head.grad, want[2])):
        torch.testing.assert_close(got, w, rtol=RTOL, atol=ATOL * w.abs().max().item())
    with constraints.model_shards(None, 0, 1):     # one rank: the whole vocab
        torch.testing.assert_close(tp.log_likelihood(model._logits({"embed": head0}, x0),
                                                     safe), ll.detach(), rtol=1e-6,
                                   atol=1e-6)


def _jpath(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@pytest.mark.parametrize("arch", configs.list_configs())
def test_layout_at_16_agrees_with_the_reference_rules(arch):
    """Model extent 16, every full-width config: whether a rank's query
    heads split, and its KV heads with them, as the reference's
    ``param_pspec`` for ``wq`` and ``kv_axis`` say (16 x 16 mesh); every
    rank's query heads read KV heads of its layout; and every leaf's
    shard (``shard_params``, on meta tensors) has the shape the
    reference's spec gives it over 'model', but a mixer's that stays
    whole (``mixer_splits``)."""
    jcfg, tcfg = base.get_config(arch), configs.get_config(arch)
    mesh = AbstractMesh((16, 16), ("data", "model"))
    jleaves = {_jpath(p): (p, x) for p, x in jax.tree_util.tree_flatten_with_path(
        build_model(jcfg).param_specs())[0]}
    wq = [(p, x) for k, (p, x) in jleaves.items() if k[-1] == "wq"]
    kv_split = jsharding.kv_axis(jcfg, mesh) == "model"
    if wq:
        path, leaf = wq[0]
        spec = jsharding.param_pspec(jcfg, path, leaf.shape, mesh, True)
        heads_split = spec[-2] == "model"
    else:
        heads_split = False
    G = tcfg.n_heads // tcfg.n_kv_heads
    readers = {}
    for r in range(16):
        lay = tp.head_layout(tcfg, r, 16)
        assert (lay.split, lay.kv_split) == (heads_split, heads_split and kv_split), r
        assert lay.nq == (tcfg.n_heads // 16 if heads_split else tcfg.n_heads)
        assert {q // G for q in range(lay.q0, lay.q0 + lay.nq)} == \
            set(range(lay.kv0, lay.kv0 + lay.nkv)), (r, lay)
        readers.setdefault((lay.kv0, lay.nkv), []).append(r)
    # the ranks that read one whole KV head: blocks of kv_sharers in a row
    n = tp.kv_sharers(tcfg, 16)
    want = [list(range(i, i + n)) for i in range(0, 16, n)] \
        if heads_split and not kv_split else None
    assert want is None or sorted(readers.values()) == want, (n, readers)
    assert want is not None or n == 1
    params = lm.LM(tcfg, "meta").param_specs()
    local = dict(_leaves(tp.shard_params(tcfg, params, 3, 16)))
    for path, leaf in _leaves(params):
        jp, jl = jleaves[path]
        spec = jsharding.param_pspec(jcfg, jp, jl.shape, mesh, True)
        want = tuple(n // 16 if e == "model" or (isinstance(e, tuple) and "model" in e)
                     else n for n, e in zip(leaf.shape, spec))
        if tp._whole(tcfg, path, 16):
            want = tuple(leaf.shape)
        assert tuple(local[path].shape) == want, (path, spec)


# --------------------------------------------------------------------------
# The Mamba and mLSTM mixers split over 'model', against the reference
# --------------------------------------------------------------------------
# each tensor's largest error over its largest entry, float32 (the ranks'
# partial sums run in another order); the mLSTM's h passes a cancelling
# denominator, yet holds this gate too
MIXER_GATE = 2e-5


# a case of the mixer tests -> the mixer it runs
MIXER = {"mamba": "mamba", "mlstm": "mlstm", "slstm": "slstm", "slstm_d96": "slstm"}


def _mixer_cfgs(kind):
    """(reference, port) configs of a mixer whose split dim divides 2, 4
    and 8: jamba reduced at d_model 512 (d_inner 1024, eight SSD heads of
    128; at the reduced d_model 64 its one head splits nothing), scanning
    in chunks of 4, where the reference's SSD scan keeps finite gradients;
    xlstm reduced (the mLSTM's four heads of width 32, the sLSTM's of 16,
    its FFN's 85 columns whole on the ranks); ``slstm_d96``: xlstm reduced
    at d_model 96 (the sLSTM's heads of 24, its FFN's 128 columns split)."""
    widths = {"mamba": 512, "slstm_d96": 96}
    name = "jamba-v0.1-52b" if kind == "mamba" else "xlstm-1.3b"

    def widen(c):
        if kind not in widths:
            return c
        kw = dict(mamba=dataclasses.replace(c.mamba, chunk=4)) if c.mamba else {}
        return dataclasses.replace(c, d_model=widths[kind], **kw)
    return widen(base.get_config(name).reduced()), widen(configs.get_config(name).reduced())


def _mixer_fns(kind):
    """(reference forward, port forward), the mLSTM in chunks of 16."""
    if kind == "mamba":
        return jmamba.mamba_forward, mamba.mamba_forward
    if MIXER[kind] == "slstm":
        return jxlstm.slstm_forward, xlstm.slstm_forward
    return (functools.partial(jxlstm.mlstm_forward, chunk=16),
            functools.partial(xlstm.mlstm_forward, chunk=16))


def _mixer_case(kind, seed):
    """The reference's params (its own init), the port's copy of them, an
    input x (B, S, d) and an output gradient dy, float32."""
    jcfg, tcfg = _mixer_cfgs(kind)
    init = {"mamba": jmamba.init_mamba, "mlstm": jxlstm.init_mlstm,
            "slstm": jxlstm.init_slstm}[MIXER[kind]]
    jp = init(jcfg, jax.random.PRNGKey(seed))
    g = np.random.default_rng(seed)
    x = g.standard_normal((B, 40, tcfg.d_model)).astype(np.float32)
    dy = g.standard_normal((B, 40, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu"), x, dy


def _reference_mixer(kind, jcfg, jp, x, dy):
    """The reference mixer's output and the gradients of sum(out * dy)
    with respect to each param leaf (by name) and x."""
    jf = _mixer_fns(kind)[0]
    out, vjp = jax.vjp(lambda p, x: jf(jcfg, p, x), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _emulated_mixer(kind, cfg, p, x, m):
    """The port's mixer on m emulated model ranks, each on its shards."""
    tf = _mixer_fns(kind)[1]
    return tp.emulate(lambda r, h: tf(cfg, tp.shard_params(cfg, {"mixer": p}, r, m)["mixer"],
                                      h), m, x)


def _mixer_errs(kind, tcfg, tparams, x, dy, m):
    """Each tensor's largest error over its largest entry: the emulated
    port mixer's output and gradients against ``want`` (the reference's
    output, param gradients by name, and x's gradient)."""
    pc = {k: v.detach().clone().requires_grad_(True) for k, v in tparams.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out = _emulated_mixer(kind, tcfg, pc, xt, m)
    (out * torch.from_numpy(dy)).sum().backward()
    return out.detach(), {k: v.grad for k, v in pc.items()}, xt.grad


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


def _check_mixer(kind, got, want):
    out, gp, gx = got
    jout, jgp, jgx = want
    errs = {"out": _rel(out, jout), "x": _rel(gx, jgx),
            **{k: _rel(gp[k], jgp[k]) for k in jgp}}
    bad = {k: e for k, e in errs.items() if e > MIXER_GATE}
    assert not bad, (bad, errs)
    return errs


@pytest.mark.parametrize("m", [2, 4, 8])
@pytest.mark.parametrize("kind", list(MIXER))
def test_emulated_mixer_ranks_equal_the_reference(kind, m):
    """The Mamba mixer (its heads split), the mLSTM (its value columns of
    every head split) and the sLSTM (its columns of every head split, h
    gathered at each step; its FFN whole on every rank, ``repeated``, or
    at d_model 96 its columns of ``d_ff`` split) through m emulated model
    ranks, each on its shards (``shard_params``), with the collectives
    inside them among the ranks (``xz_columns``, ``all_sum``,
    ``gather_last``, ``gather_last_own``, ``head_columns``,
    ``flat_channels``): the output and the gradient of every param leaf
    and of the input equal the reference mixer's (``jax.vjp``), each
    within ``MIXER_GATE`` of its largest entry.  (The reduced jamba's one
    head would split nothing: ``_mixer_cfgs`` widens it.)"""
    jcfg, tcfg, jp, tparams, x, dy = _mixer_case(kind, 5 + m)
    assert tp.mixer_splits(tcfg, MIXER[kind], m)
    if MIXER[kind] == "slstm":   # the FFN whole at d_model 64, split at 96
        assert tp.splits(tparams["ffn_gate"].shape[1], m) == (kind == "slstm_d96")
    got = _mixer_errs(kind, tcfg, tparams, x, dy, m)
    _check_mixer(kind, got, _reference_mixer(kind, jcfg, jp, x, dy))


# Broken copies of the split, each of which a rank's arithmetic must catch:
# (mixer, what is broken, a patch of tensor_parallel)
def _flat_xz(w, di):
    """w_in / w_up as the rules chunk it, taken for x | z of the rank's
    channels."""
    return w


class _ForwardSumOnly(torch.autograd.Function):
    """``_EmulatedSum``'s forward, backward each rank's own gradient (the
    other ranks' reads of the sum dropped)."""

    @staticmethod
    def forward(ctx, *xs):
        total = tp._f32_sum(xs)
        return tuple(total.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return gs


def _sum_without_backward(width):
    """``all_sum`` whose backward is the identity for tensors of last dim
    ``width``."""
    real = tp.all_sum

    def all_sum(x):
        if x.shape[-1] != width:
            return real(x)
        return tp._inside(x, None, lambda xs: _ForwardSumOnly.apply(*xs))
    return all_sum


def _sum_skipped(width):
    """``all_sum`` that leaves tensors of last dim ``width`` as the rank
    has them."""
    real = tp.all_sum
    return lambda x: x if x.shape[-1] == width else real(x)


MUTANTS = {
    "mamba_w_in_chunked_flat": ("mamba", "xz_columns", lambda cfg: _flat_xz),
    "mamba_no_backward_sum_of_dt_B_C": (
        "mamba", "all_sum",
        lambda cfg: _sum_without_backward(mamba.dims(cfg)[1] + 2 * cfg.mamba.d_state)),
    "mlstm_w_up_chunked_flat": ("mlstm", "xz_columns", lambda cfg: _flat_xz),
    "mlstm_no_backward_sum_of_the_gates": (
        "mlstm", "all_sum", lambda cfg: _sum_without_backward(2 * cfg.n_heads)),
    "mlstm_head_norm_without_the_ranks_sum": ("mlstm", "all_sum", lambda cfg: _sum_skipped(1)),
    # the per-step gather of h, whose gradient a rank's R h makes partial,
    # taking the rank's own block back unsummed (the FFN is whole here)
    "slstm_h_gather_without_the_backward_sum": (
        "slstm", "gather_last", lambda cfg: tp.gather_last_own),
    "slstm_head_norm_without_the_ranks_sum": ("slstm", "all_sum", lambda cfg: _sum_skipped(1)),
    # the gather before the FFN every rank computes whole, reduce-scattered
    # back: m times the gradient
    "slstm_whole_ffn_gather_reduce_scattered": (
        "slstm", "gather_last_own", lambda cfg: tp.gather_last),
}


@functools.lru_cache(maxsize=None)
def _mutant_case(kind):
    """The mutants' case (seed 9) and the reference's result on it, once a
    kind: the whole split passes ``_check_mixer`` on it at m = 4."""
    jcfg, tcfg, jp, tparams, x, dy = _mixer_case(kind, 9)
    want = _reference_mixer(kind, jcfg, jp, x, dy)
    _check_mixer(kind, _mixer_errs(kind, tcfg, tparams, x, dy, 4), want)
    return tcfg, tparams, x, dy, want


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_broken_split_fails_the_reference_check(mutant, monkeypatch):
    """Each broken copy of the split (``MUTANTS``: a weight's x | z columns
    taken as the rules chunk them, a partial sum every head reads summed
    forward only, the head norm's sums of squares left unsummed, a gather
    whose backward does not fit who reads the gathered tensor) puts some
    tensor past ``_check_mixer``'s gate at m = 4, where the whole split
    passes it (``test_emulated_mixer_ranks_equal_the_reference``)."""
    kind, name, patch = MUTANTS[mutant]
    tcfg, tparams, x, dy, want = _mutant_case(kind)
    monkeypatch.setattr(tp, name, patch(tcfg))
    with pytest.raises(AssertionError):
        _check_mixer(kind, _mixer_errs(kind, tcfg, tparams, x, dy, 4), want)


@pytest.mark.parametrize("kind", list(MIXER))
def test_emulated_mixer_cache_and_decode_equal_the_reference(kind):
    """At m = 4: each rank's prefill cache is its shard of the reference's
    cache (a Mamba rank's heads of ``h`` and conv channels, an mLSTM
    rank's columns of C and conv channels, an sLSTM rank's columns of h,
    c, n and m; the mLSTM's n and m whole on every rank), and one decode
    step from the ranks' caches gives the reference's output and the next
    cache's shards."""
    m = 4
    jcfg, tcfg, jp, tparams, x, _ = _mixer_case(kind, 3)
    jf, tf = _mixer_fns(kind)
    jdec, tdec = {"mamba": (jmamba.mamba_decode, mamba.mamba_decode),
                  "mlstm": (jxlstm.mlstm_decode, xlstm.mlstm_decode),
                  "slstm": (jxlstm.slstm_decode, xlstm.slstm_decode)}[MIXER[kind]]
    jout, jcache = jf(jcfg, jp, jnp.asarray(x), return_cache=True)
    xt = np.random.default_rng(4).standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    jout2, jcache2 = jdec(jcfg, jp, jnp.asarray(xt), jcache)
    # a leaf's dim that holds each rank's share: concatenated over the ranks
    dims = {"mamba": {"conv": -1, "h": 1}, "mlstm": {"conv": -1, "C": -1},
            "slstm": dict.fromkeys(("h", "c", "n", "m"), -1)}[MIXER[kind]]
    caches = {}

    def prefill(r, h):
        out, caches[r] = tf(tcfg, tp.shard_params(tcfg, {"mixer": tparams}, r, m)["mixer"], h,
                            return_cache=True)
        return out

    def decode(r, h):
        out, caches[r] = tdec(tcfg, tp.shard_params(tcfg, {"mixer": tparams}, r, m)["mixer"],
                              h, caches[r])
        return out
    for step, (fn, inp, want, wcache) in enumerate(((prefill, x, jout, jcache),
                                                    (decode, xt, jout2, jcache2))):
        with torch.no_grad():
            out = tp.emulate(fn, m, torch.from_numpy(inp))
        assert _rel(out, want) <= MIXER_GATE, step
        for name, w in wcache.items():
            parts = [caches[r][name] for r in range(m)]
            got = torch.cat(parts, dims[name]) if name in dims else parts[0]
            if name not in dims:
                assert all(torch.equal(t, got) for t in parts), (step, name)
            assert _rel(got, w) <= MIXER_GATE, (step, name)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("cols", [(0, 8), (16, 32), (8, 24)])
def test_narrow_value_columns_equal_the_sliced_mlstm(cols, state):
    """The mLSTM's plain versions with v's (and so h's and C's) columns
    narrower than q's and k's (a tensor-parallel rank's share of every
    head): ``mlstm_ref`` (in float64), ``mlstm_tiled`` (the kernels'
    split, in float32) and ``mlstm_bwd_tiled`` (the backward's, in
    float64) on columns [a, b) of v and C equal the same columns of the
    full-width call; the
    gradients of q, k, the gates and n0 are the columns' share of the
    whole: summed over a partition of the columns they give the whole
    call's."""
    from repro_torch.kernels.mlstm import ref as mref
    g = np.random.default_rng(cols[0] + 10 * state)
    Bq, Sq, H, dh = 2, 50, 2, 32
    f64 = torch.float64
    q, k, v, dh_ = (torch.from_numpy(g.standard_normal((Bq, Sq, H, dh))).to(f64)
                    for _ in range(4))
    li = torch.from_numpy(g.standard_normal((Bq, Sq, H)))
    lf = torch.nn.functional.logsigmoid(torch.from_numpy(g.standard_normal((Bq, Sq, H))) + 2)
    st = None
    if state:
        st = (torch.from_numpy(g.standard_normal((Bq, H, dh, dh))) * 0.1,
              torch.from_numpy(g.standard_normal((Bq, H, dh))) * 0.1,
              torch.from_numpy(g.standard_normal((Bq, H))))
    a, b = cols
    sl = slice(a, b)
    part_st = None if st is None else (st[0][..., sl].contiguous(), st[1], st[2])
    for fn in (mref.mlstm_ref, mref.mlstm_tiled):     # float64; float32 (the kernels')
        h, (C, n, mm) = fn(q, k, v, li, lf, st, chunk=16)
        hs, (Cs, ns, ms) = fn(q, k, v[..., sl].contiguous(), li, lf, part_st, chunk=16)
        for got, want in ((hs, h[..., sl]), (Cs, C[..., sl]), (ns, n), (ms, mm)):
            assert got.dtype == want.dtype
            torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-6 * want.abs().max())
    whole = mref.mlstm_bwd_tiled(q, k, v, li, lf, st, dh_, chunk=16)
    shares = [mref.mlstm_bwd_tiled(q, k, v[..., c].contiguous(), li, lf,
                                   None if st is None else (st[0][..., c].contiguous(),
                                                            st[1], st[2]),
                                   dh_[..., c].contiguous(), chunk=16)
              for c in (slice(0, a), sl, slice(b, dh)) if c.stop > c.start]
    mid = shares[1 if a else 0]
    torch.testing.assert_close(mid[2], whole[2][..., sl], rtol=1e-10, atol=1e-10)   # dv
    if state:
        torch.testing.assert_close(mid[5][0], whole[5][0][..., sl], rtol=1e-10, atol=1e-10)
    for i in (0, 1, 3, 4):                  # dq, dk, dlog_i, dlog_f: summed
        torch.testing.assert_close(sum(s[i] for s in shares), whole[i], rtol=1e-9, atol=1e-9)
    if state:                               # dn0, dm0: summed
        for j in (1, 2):
            torch.testing.assert_close(sum(s[5][j] for s in shares), whole[5][j], rtol=1e-9,
                                       atol=1e-9)


def test_emulated_ranks_take_turns(monkeypatch):
    """``emulate``'s ranks run one at a time in rank order between their
    collectives, each collective handing every rank its share, under a
    short thread switch interval with more ranks than this host's cores;
    a rank that raises fails the call with its error, and the others stop
    (no rank waits for ever).  Each rank runs with its own shards installed
    (``constraints.model()``), and the caller's are back after the call."""
    import sys
    m = 16
    log = []
    x = torch.arange(4.0)

    def fn(r, x):
        log.append((r, 0, constraints.model().index))
        s = tp.all_sum(x * (r + 1))
        log.append((r, 1, constraints.model().index))
        g = tp.gather_last(s[r % 4:r % 4 + 1])
        log.append((r, 2, constraints.model().index))
        return g.sum() * 0 + s
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = tp.emulate(fn, m, x)
    finally:
        sys.setswitchinterval(interval)
    assert log == [(r, k, r) for k in range(3) for r in range(m)]
    assert constraints.model() == constraints.ModelShards(None, 0, 1)
    torch.testing.assert_close(out, m * x * sum(range(1, m + 1)), rtol=0, atol=0)

    def bad(r, x):
        s = tp.all_sum(x)
        if r == 3:
            raise ValueError("rank 3")
        return tp.all_sum(s)
    monkeypatch.setattr(tp._Peers, "WAIT_S", 60.0)
    with pytest.raises(ValueError, match="rank 3"):
        tp.emulate(bad, m, x)


def test_installed_shards_reach_a_backward_on_another_thread():
    """The autograd engine runs a CUDA graph's backward, and with it the
    recompute of a checkpointed body (the sharded step's remat), on a
    thread of its own.  A split layer (reduced gemma2's, rank 2 of 4 on its
    shards, reading the second of the two KV heads that every rank holds
    whole) checkpointed under ``model_shards(None, 2, 4)`` and run back
    from a second thread gives the gradients of its backward run on the
    calling thread: the recompute computes the same rank's shard."""
    import threading

    from repro_torch.distributed import remat
    cfg = configs.get_config("gemma2-9b").reduced()
    spec = cfg.pattern[0]
    _, p = _layer(cfg)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))

    def grads(on_thread):
        pc = _graded(tp.shard_params(cfg, p, 2, 4))
        body = remat.wrap(lambda x: lm.layer_forward_full(cfg, spec, pc, x, torch.arange(S)),
                          "full")
        with constraints.model_shards(None, 2, 4):
            assert tp.head_layout(cfg).kv0 == 1
            out = body(x)
            run = lambda: out.square().sum().backward()  # noqa: E731
            if on_thread:
                errors = []
                t = threading.Thread(target=lambda: _catching(run, errors))
                t.start()
                t.join()
                assert not errors, errors
            else:
                run()
        return [(path, t.grad) for path, t in _leaves(pc)]
    for (path, got), (_, want) in zip(grads(True), grads(False)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, msg=str(path))


def _catching(fn, errors):
    try:
        fn()
    except Exception as e:  # handed to the test's thread
        errors.append(e)
