"""Tensor-parallel compute over the mesh's 'model' axis: the sums and
gathers that GSPMD inserts in the reference (``repro/distributed/
sharding.py``'s rules put query heads, KV heads where they divide,
``d_ff``, experts and vocab on 'model'), made explicit.

A rank computes on its shards (``constraints.gather_tp``) under
``constraints.model_shards(group, index, extent)``.  The model code
enters a split region through ``copy_in`` (identity forward, its
gradient summed over the model ranks) and leaves it through
``reduce_out`` (the ranks' partial sums summed forward, identity
backward): the Megatron pair.  Both are functional collectives
(``torch.distributed._functional_collectives``), so that
``trace_analysis`` counts them at the reference's ring factors.  The
sums run in float32 and round once to a bf16 tensor's dtype, as the
unsplit product's accumulator does.

Each rank's local computation depends only on its shards, its index and
the extent; the collectives stand outside it and do nothing where the
group is None.  So m ranks can be emulated in one process: ``emulate``
runs m calls, each under ``model_shards(None, r, m)`` with rank r's
shards (``shard_params``), and sums their outputs and their inputs'
gradients as the collectives do; the gradients of the whole leaves that
the shards are views of come out concatenated or summed by autograd.

What splits, rule for rule (a dim splits where it divides the extent):
query heads where ``n_heads`` does (else the attention stays whole on
every model rank: yi's 56 stored heads at 16); KV heads where
``n_kv_heads`` does, else every rank holds them whole and reads the ones
its query heads use (``head_layout``), the ranks that read one KV head
each projecting a part of the tokens (``kv_project``); ``d_ff``;
experts; vocab rows of ``embed``, ``lm_head`` and ``pos_embed``.  The
Mamba, mLSTM and sLSTM mixers stay whole on every model rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed import _functional_collectives as funcol

from repro_torch.distributed import constraints, sharding

RECURRENT = ("mamba", "mlstm", "slstm")


def _waited(x):
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


def _all_reduce(x, op, group):
    return _waited(funcol.all_reduce(x.contiguous(), op, group))


def _sum_over(x, group):
    """The model ranks' ``x`` summed in float32, in ``x``'s dtype."""
    return _all_reduce(x.float(), "sum", group).to(x.dtype)


def splits(n: int) -> bool:
    """Whether a dim of ``n`` splits over the installed model extent (the
    rules' divisibility guard), at an extent above 1."""
    extent = constraints.model().extent
    return extent > 1 and n % extent == 0


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x):
    """``x``, replicated on every model rank, into a split region: the
    same tensor forward; backward, the model ranks' gradients summed."""
    group = constraints.model().group
    return x if group is None else _CopyIn.apply(x, group)


def reduce_out(x):
    """The model ranks' partial sums ``x`` summed (all-reduce) forward;
    backward, the gradient as it is (it is the same on every rank)."""
    group = constraints.model().group
    return x if group is None else _ReduceOut.apply(x, group)


# --------------------------------------------------------------------------
# Attention heads
# --------------------------------------------------------------------------

class HeadLayout(NamedTuple):
    """A rank's heads: stored query heads [q0, q0 + nq), KV heads [kv0,
    kv0 + nkv) that they read; ``split``: the heads are split over the
    model ranks (else the rank holds and computes them all);
    ``kv_split``: ``wk`` / ``wv`` are sharded over 'model' (else the rank
    holds them whole and reads [kv0, kv0 + nkv) of them)."""
    q0: int
    nq: int
    kv0: int
    nkv: int
    split: bool
    kv_split: bool


def head_layout(cfg, index: int = None, extent: int = None) -> HeadLayout:
    """The layout of rank ``index`` of ``extent`` (default: the installed
    ``model_shards``), by the rules for ``wq`` (heads on 'model' where
    ``n_heads`` divides) and ``wk`` / ``wv`` (``kv_axis``).  Where KV
    heads are whole and query heads split, a rank's query heads must lie
    in whole GQA groups or inside one group."""
    ms = constraints.model()
    index = ms.index if index is None else index
    extent = ms.extent if extent is None else extent
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if extent == 1 or H % extent:
        return HeadLayout(0, H, 0, Hkv, False, False)
    nq = H // extent
    q0 = index * nq
    if Hkv % extent == 0:
        nkv = Hkv // extent
        return HeadLayout(q0, nq, index * nkv, nkv, True, True)
    G = H // Hkv
    if nq % G and G % nq:
        raise ValueError(f"{nq} query heads a rank straddle GQA groups of {G}")
    return HeadLayout(q0, nq, q0 // G, max(nq // G, 1), True, False)


def kv_sharers(cfg, extent: int) -> int:
    """How many consecutive model ranks read each KV head, where KV heads
    are whole on 'model' and a rank's query heads lie inside one GQA group
    (1 elsewhere)."""
    lay = head_layout(cfg, 0, extent)
    if not lay.split or lay.kv_split:
        return 1
    return max(cfg.n_heads // cfg.n_kv_heads // lay.nq, 1)


class _GatherRows(torch.autograd.Function):
    """The ranks' row blocks concatenated in rank order; backward, each
    rank's block of the gradient summed over the ranks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _waited(funcol.all_gather_tensor(x.contiguous(), 0, group))

    @staticmethod
    def backward(ctx, g):
        return _waited(funcol.reduce_scatter_tensor(
            g.float().contiguous(), "sum", 0, ctx.group)).to(g.dtype), None


def kv_project(proj, x, w):
    """``proj(x, w)`` (B, S, n, h) for KV heads that several model ranks
    read (the installed ``kv_group``): each of them projects its block of
    the B * S tokens and the blocks are gathered, in place of each rank
    projecting every token; as it is where there is no such group or the
    tokens do not split over it."""
    ms = constraints.model()
    group = ms.kv_group
    B, S, d = x.shape
    n = group.size() if group is not None else 1
    if n == 1 or (B * S) % n:
        return proj(x, w)
    rows = B * S // n
    r = ms.index % n
    part = proj(x.reshape(1, B * S, d)[:, r * rows:(r + 1) * rows], w)[0]
    return _GatherRows.apply(part, group).reshape(B, S, *part.shape[1:])


# --------------------------------------------------------------------------
# Vocab
# --------------------------------------------------------------------------

def vocab_lookup(emb, tokens, scale: bool, dtype, take):
    """Rows of ``tokens`` from a table split over the model ranks by rows
    (rank r holds rows [r * n, (r + 1) * n) of ``emb``'s n): the rank's
    rows, zeros for the tokens of the other ranks' rows, summed over the
    ranks.  ``take(emb, tokens, scale, dtype)`` is the unsplit lookup."""
    n = emb.shape[0]
    local = tokens - constraints.model().index * n
    inside = (local >= 0) & (local < n)
    x = take(emb, torch.where(inside, local, 0), scale, dtype)
    return reduce_out(x.masked_fill(~inside[..., None], 0))


def vocab_index(n: int, device) -> torch.Tensor:
    """Global vocab indices of this rank's ``n`` logits."""
    return constraints.model().index * n + torch.arange(n, device=device)


def ce_parts(logits, labels, gmax):
    """A rank's share of the cross-entropy over its vocab slice
    (``logits`` (..., n), float32): the sum over its slice of exp(logit -
    ``gmax``), and each label's logit where the label falls in its slice
    (else 0)."""
    n = logits.shape[-1]
    local = labels.long() - constraints.model().index * n
    inside = (local >= 0) & (local < n)
    tgt = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    return torch.exp(logits - gmax[..., None]).sum(-1), tgt * inside


def log_likelihood(logits, labels):
    """log softmax(logits)[label] over the whole vocab from each rank's
    slice of it (``logits`` (..., n) float32, labels >= 0): the max over
    the ranks (no gradient), then the summed exp and the label's logit,
    each summed over the ranks (``ce_parts``)."""
    gmax = logits.detach().amax(-1)
    group = constraints.model().group
    if group is not None:
        gmax = _all_reduce(gmax, "max", group)
    sumexp, tgt = ce_parts(logits, labels, gmax)
    return reduce_out(tgt) - gmax - torch.log(reduce_out(sumexp))


# --------------------------------------------------------------------------
# Emulated ranks
# --------------------------------------------------------------------------

class _ModelOnly:
    """A mesh of the 'model' axis alone, as the rules read one."""

    def __init__(self, extent: int):
        self.axis_names = ("model",)
        self.shape = {"model": extent}


def _recurrent(cfg, path) -> bool:
    return len(path) > 2 and path[0] == "blocks" and path[2] == "mixer" \
        and cfg.pattern[path[1]].mixer in RECURRENT


def shard_params(cfg, tree, index: int, extent: int):
    """Rank ``index``'s shards of a param tree (a whole model's, or one
    layer's), as ``constraints.gather_tp`` gives them on a mesh whose
    'model' axis is ``extent``: each leaf's chunk along the dim the rules
    put on 'model', views of the whole leaves; a recurrent mixer's leaves
    whole."""
    mesh = _ModelOnly(extent)

    def one(path, t):
        if _recurrent(cfg, path):
            return t
        spec = sharding.param_pspec(cfg, path, tuple(t.shape), mesh, train=False)
        for dim, entry in enumerate(spec):
            if entry == "model":
                t = t.chunk(extent, dim=dim)[index]
        return t
    return sharding.tree_map_with_path(one, tree)


def _f32_sum(ts):
    return torch.stack([t.float() for t in ts]).sum(0).to(ts[0].dtype)


class _Ranks(torch.autograd.Function):
    """``emulate``'s ranks: each rank's graph built on its own copies of
    the inputs; backward, each graph run back (its weights' gradients land
    in their leaves) and the inputs' gradients summed over the ranks."""

    @staticmethod
    def forward(ctx, fn, extent, *xs):
        ctx.ins, ctx.outs = [], []
        with torch.enable_grad():
            for r in range(extent):
                ins = [x.detach().requires_grad_(x.requires_grad) for x in xs]
                with constraints.model_shards(None, r, extent):
                    ctx.outs.append(fn(r, *ins))
                ctx.ins.append(ins)
        return _f32_sum([o.detach() for o in ctx.outs])

    @staticmethod
    def backward(ctx, g):
        outs = [o for o in ctx.outs if o.requires_grad]
        torch.autograd.backward(outs, [g] * len(outs))
        grads = [_f32_sum([ins[i].grad if ins[i].grad is not None
                           else torch.zeros_like(ins[i]) for ins in ctx.ins])
                 if ctx.ins[0][i].requires_grad else None for i in range(len(ctx.ins[0]))]
        ctx.ins = ctx.outs = None
        return (None, None, *grads)


def emulate(fn, extent: int, *xs):
    """The ``extent`` model ranks of a split sublayer in one process:
    ``fn(r, *xs)`` under ``model_shards(None, r, extent)`` (rank r's
    partial sum, on rank r's shards), the ranks' outputs summed in float32
    as ``reduce_out`` sums them, and in the backward the gradients of the
    inputs ``xs`` (replicated on every rank) summed in float32 as
    ``copy_in``'s backward sums them."""
    return _Ranks.apply(fn, extent, *xs)
