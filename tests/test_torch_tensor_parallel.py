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
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

import jax  # noqa: E402
from repro.configs import base  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models.lm import build_model  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import constraints  # noqa: E402
from repro_torch.distributed import tensor_parallel as tp  # noqa: E402
from repro_torch.distributed.sharding import tree_map_with_path  # noqa: E402
from repro_torch.models import common, lm, moe  # noqa: E402
from repro_torch.params import init_params  # noqa: E402

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
    reference's spec gives it over 'model', but a recurrent mixer's,
    which stays whole."""
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
        if tp._recurrent(tcfg, path):
            want = tuple(leaf.shape)
        assert tuple(local[path].shape) == want, (path, spec)
