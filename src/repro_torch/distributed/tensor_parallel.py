"""Tensor-parallel compute over the mesh's 'model' axis: the sums and
gathers that GSPMD inserts in the reference (``repro/distributed/
sharding.py``'s rules put query heads, KV heads where they divide,
``d_ff``, experts, vocab and the Mamba and mLSTM mixers' channels on
'model'), made explicit.

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

Inside a split sublayer the recurrent mixers meet once more, where the
compute needs another layout than the rules give its weights:
``all_sum`` (the ranks' partial sums summed forward, and their gradients
summed backward: every rank reads the sum), ``gather_last`` (the ranks'
blocks of the last dim concatenated; backward, reduce-scattered: each
rank's read of the whole is partial, as where it feeds the rank's own
columns of a product) and ``regroup`` (an all-to-all that hands each rank
the entries of a dim it computes on, e.g. ``xz_columns``' x and z
channels of its own heads from ``w_in``'s flat column chunks).  The sums
run in float32 and round once.  A sublayer's tail that every rank
computes whole (the sLSTM's FFN where ``d_ff`` does not divide the
extent) runs under ``repeated``: its input gathered by ``gather_last_own``
(backward, the rank's own block of a gradient that is already whole on
every rank), its output the same on every rank.

Each rank's local computation depends only on its shards, its index and
the extent, and on what those collectives hand it; ``copy_in`` and
``reduce_out`` do nothing where the group is None.  So m ranks can be
emulated in one process: ``emulate`` runs m calls, each under
``model_shards(None, r, m)`` with rank r's shards (``shard_params``), and
sums their outputs and their inputs' gradients as the collectives do;
the gradients of the whole leaves that the shards are views of come out
concatenated or summed by autograd.  A call that meets the others inside
(``all_sum`` and the rest) runs on a thread of its own, the calls one at
a time in rank order, handing over at each collective (``_Peers``).

What splits, rule for rule (a dim splits where it divides the extent):
query heads where ``n_heads`` does (else the attention stays whole on
every model rank: yi's 56 stored heads at 16); KV heads where
``n_kv_heads`` does, else every rank holds them whole and reads the ones
its query heads use (``head_layout``), the ranks that read one KV head
each projecting a part of the tokens (``kv_project``); ``d_ff``;
experts; vocab rows of ``embed``, ``lm_head`` and ``pos_embed``; a
Mamba mixer's heads where ``H`` does (``mamba.py``: the conv channels,
the rows of ``w_dt`` / ``w_B`` / ``w_C`` / ``w_out`` and the columns of
``w_in`` as the rules chunk them, the state's heads), else the mixer
stays whole on every model rank; an mLSTM's value columns of every head
where its head width does (``xlstm.py``: ``v``, ``h`` and C's columns, as
the cache rule splits C, with q, k, n and m whole), else it stays whole;
an sLSTM's columns of every head where its head width does (``W``'s and
``R``'s last dim, its state's columns, ``h`` gathered at each step; its
FFN's columns of ``d_ff`` where that divides too, else the FFN whole on
every rank, ``repeated``), else it stays whole.  A mixer that stays whole
runs as the one rank of one (``lm._recurrent``), so each mixer has one
code path.
"""
from __future__ import annotations

import functools
import threading
from typing import NamedTuple

import torch
from torch.distributed import _functional_collectives as funcol

from repro_torch.distributed import constraints, sharding


def _waited(x):
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


def _all_reduce(x, op, group):
    return _waited(funcol.all_reduce(x.contiguous(), op, group))


def _sum_over(x, group):
    """The model ranks' ``x`` summed in float32, in ``x``'s dtype."""
    return _all_reduce(x.float(), "sum", group).to(x.dtype)


def splits(n: int, extent: int = None) -> bool:
    """Whether a dim of ``n`` splits over ``extent`` (default: the
    installed model extent; the rules' divisibility guard), above 1."""
    extent = constraints.model().extent if extent is None else extent
    return extent > 1 and n % extent == 0


def mixer_splits(cfg, mixer: str, extent: int = None) -> bool:
    """Whether a layer's ``mixer`` computes its share over ``extent``
    model ranks (default: the installed extent): attention always (its
    heads decide, ``head_layout``); a Mamba mixer where its heads split,
    an mLSTM or an sLSTM where its head width does."""
    from repro_torch.models import mamba, xlstm    # they import this module
    if mixer == "mamba":
        return splits(mamba.dims(cfg)[1], extent)
    if mixer == "mlstm":
        return splits(xlstm.mlstm_dims(cfg)[2], extent)
    if mixer == "slstm":
        return splits(xlstm.slstm_dims(cfg)[2], extent)
    return True


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
# Collectives inside a split sublayer (the recurrent mixers)
# --------------------------------------------------------------------------

class _AllSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_over(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = _waited(funcol.all_gather_tensor(x.movedim(-1, 0).contiguous(), 0, group))
        return y.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        y = _waited(funcol.reduce_scatter_tensor(
            g.float().movedim(-1, 0).contiguous(), "sum", 0, ctx.group))
        return y.movedim(0, -1).to(g.dtype), None


class _GatherLastOwn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index):
        ctx.index, ctx.n = index, x.shape[-1]
        y = _waited(funcol.all_gather_tensor(x.movedim(-1, 0).contiguous(), 0, group))
        return y.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.index * ctx.n, ctx.n).contiguous(), None, None


class _Plan(NamedTuple):
    """Rank r's all-to-all of ``regroup``: the entries of its block it
    sends (indices into the block, receivers in rank order), how many to
    each rank, how many it receives from each, and where each received
    entry goes in its new block."""
    send: torch.Tensor
    send_splits: list
    recv_splits: list
    place: torch.Tensor


@functools.lru_cache(maxsize=None)
def _plan(have: tuple, want: tuple, r: int) -> _Plan:
    """``have[s]`` / ``want[s]``: the global indices rank s holds / needs,
    in its block's order."""
    where = {i: (s, j) for s, h in enumerate(have) for j, i in enumerate(h)}
    send = [[j for i in want[q] for s, j in [where[i]] if s == r] for q in range(len(want))]
    got = [[i for i in want[r] if where[i][0] == s] for s in range(len(have))]
    order = {i: n for n, i in enumerate(x for part in got for x in part)}
    return _Plan(torch.tensor([j for part in send for j in part], dtype=torch.long),
                 [len(x) for x in send], [len(x) for x in got],
                 torch.tensor([order[i] for i in want[r]], dtype=torch.long))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, group):
        ctx.plan, ctx.group, ctx.n = plan, group, x.shape[-1]
        buf = x.index_select(-1, plan.send.to(x.device)).movedim(-1, 0).contiguous()
        y = _waited(funcol.all_to_all_single(buf, plan.recv_splits, plan.send_splits, group))
        return y.movedim(0, -1).index_select(-1, plan.place.to(x.device))

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        back = torch.empty_like(g).index_copy_(-1, plan.place.to(g.device), g)
        y = _waited(funcol.all_to_all_single(back.movedim(-1, 0).contiguous(),
                                             plan.send_splits, plan.recv_splits, ctx.group))
        dx = g.new_zeros((*g.shape[:-1], ctx.n))
        return dx.index_add_(-1, plan.send.to(g.device), y.movedim(0, -1)), None, None


def _inside(x, real, emulated):
    """A collective inside a split sublayer: ``real(x, group)`` over the
    model group, ``emulated(xs)`` (every rank's ``x`` -> every rank's
    result) among emulated ranks, ``x`` itself at extent 1."""
    ms = constraints.model()
    if ms.extent == 1:
        return x
    if ms.peers is not None:
        return ms.peers.exchange(ms.index, x, emulated)
    if ms.group is None:
        raise RuntimeError("a collective inside a split sublayer needs the model group "
                           "or the emulated ranks (tensor_parallel.emulate)")
    return real(x, ms.group)


class _EmulatedSum(torch.autograd.Function):
    """Every emulated rank's ``x`` summed in float32, a copy to each;
    backward, their gradients summed alike."""

    @staticmethod
    def forward(ctx, *xs):
        total = _f32_sum(xs)
        return tuple(total.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        total = _f32_sum(gs)
        return tuple(total.clone() for _ in gs)


class _EmulatedGather(torch.autograd.Function):
    """Every emulated rank's block of the last dim concatenated, a copy to
    each; backward, the gradients summed in float32 and cut into the
    ranks' blocks."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.sizes = [x.shape[-1] for x in xs]
        whole = torch.cat(xs, -1)
        return tuple(whole.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(t.contiguous() for t in _f32_sum(gs).split(ctx.sizes, -1))


class _EmulatedGatherOwn(torch.autograd.Function):
    """``_EmulatedGather``'s forward; backward, each rank's own block of
    its own gradient."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.sizes = [x.shape[-1] for x in xs]
        whole = torch.cat(xs, -1)
        return tuple(whole.clone() for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(g.split(ctx.sizes, -1)[r].contiguous() for r, g in enumerate(gs))


class _EmulatedFirst(torch.autograd.Function):
    """Rank 0's ``x`` (every rank's is the same) as the ranks' sum: rank 0's
    forward, zeros for the others; backward, each rank's own gradient."""

    @staticmethod
    def forward(ctx, *xs):
        return (xs[0].clone(), *(torch.zeros_like(x) for x in xs[1:]))

    @staticmethod
    def backward(ctx, *gs):
        return gs


def all_sum(x):
    """The model ranks' partial sums ``x`` summed (all-reduce, in float32,
    rounded once) forward, where every rank reads the whole sum; backward,
    the ranks' gradients summed alike (each rank's read adds its share)."""
    return _inside(x, _AllSum.apply, lambda xs: _EmulatedSum.apply(*xs))


def gather_last(x):
    """The model ranks' blocks of ``x``'s last dim concatenated in rank
    order (all-gather); backward, each rank's block of the gradient summed
    over the ranks in float32 (reduce-scatter)."""
    return _inside(x, _GatherLast.apply, lambda xs: _EmulatedGather.apply(*xs))


def gather_last_own(x):
    """The model ranks' blocks of ``x``'s last dim concatenated in rank
    order (all-gather), for a computation that every rank repeats on the
    whole (``repeated``): the gradient of the whole is then the same on
    every rank, so the backward takes the rank's own block of it (a
    reduce-scatter would count it m times)."""
    def real(x, group):
        return _GatherLastOwn.apply(x, group, constraints.model().index)
    return _inside(x, real, lambda xs: _EmulatedGatherOwn.apply(*xs))


def repeated(fn, x, *ws):
    """``fn(whole x, *ws)``: a sublayer's tail that every model rank
    computes whole, on whole weights ``ws``, from its block of ``x``'s
    last dim (``gather_last_own``).  Its output is the same on every rank,
    and so are the weights' gradients (``constraints.gather_tp`` gives
    them back ``Replicate`` over 'model').  Among emulated ranks, whose
    outputs ``emulate`` sums and whose weights are one leaf, rank 0's
    output counts once and every rank runs back from its own copy of the
    output's gradient, the ranks past 0 on their weights detached: each
    weight's gradient counts once, and each rank's block of x gets the
    whole's gradient as a real rank does."""
    ms = constraints.model()
    if ms.peers is not None and ms.index:
        ws = [w.detach() for w in ws]
    y = fn(gather_last_own(x), *ws)
    return _inside(y, lambda y, group: y, lambda ys: _EmulatedFirst.apply(*ys))


def regroup(x, have: tuple, want: tuple):
    """The entries of ``x``'s last dim that this rank computes on
    (``want[r]``, global indices), from the blocks the ranks hold
    (``have[s]``): an all-to-all of the entries, backward the reverse.
    ``have`` and ``want``: a tuple of indices for each rank."""
    def real(x, group):
        return _AllToAll.apply(x, _plan(have, want, constraints.model().index), group)

    def emulated(xs):
        whole = torch.cat(xs, -1)      # in the order of cat(have)
        order = torch.tensor([i for h in have for i in h], device=whole.device)
        whole = torch.empty_like(whole).index_copy(-1, order, whole)
        return [whole.index_select(-1, torch.tensor(w, device=whole.device)) for w in want]
    return _inside(x, real, emulated)


@functools.lru_cache(maxsize=None)
def _flat(n: int, m: int) -> tuple:
    """Each of m ranks' flat block of n entries (the rules' chunks)."""
    return tuple(tuple(range(r * n // m, (r + 1) * n // m)) for r in range(m))


@functools.lru_cache(maxsize=None)
def _xz(di: int, m: int) -> tuple:
    """Each rank's x channels and z channels of its flat block of ``di``
    (x | z concatenated, 2 di columns)."""
    return tuple(tuple(i for part in (b, (di + i for i in b)) for i in part)
                 for b in _flat(di, m))


@functools.lru_cache(maxsize=None)
def _columns(H: int, dh: int, m: int) -> tuple:
    """Each rank's share of the columns of every one of H heads of width
    dh, head by head."""
    dv = dh // m
    return tuple(tuple(h * dh + r * dv + j for h in range(H) for j in range(dv))
                 for r in range(m))


def xz_columns(w, di: int):
    """A weight whose columns are x | z (``di`` each: ``w_in``, ``w_up``),
    chunked flat over the model ranks by the rules (rank r holds columns
    [2 r di / m, 2 (r + 1) di / m), x only or z only at an even extent):
    the rank's own block of x's columns and the same block of z's."""
    m = constraints.model().extent
    return regroup(w, _flat(2 * di, m), _xz(di, m))


def head_columns(x, H: int, dh: int):
    """``x``'s last dim, the rank's flat block of the H * dh channels, as
    its share of every head's columns ((..., H * dh / m) -> (..., H, dh /
    m)): what an mLSTM rank's v, h and C hold."""
    m = constraints.model().extent
    return regroup(x, _flat(H * dh, m), _columns(H, dh, m)).unflatten(-1, (H, dh // m))


def flat_channels(x):
    """The inverse of ``head_columns``: (..., H, dh / m) -> the rank's
    flat block of the H * dh channels."""
    m = constraints.model().extent
    H, dv = x.shape[-2:]
    return regroup(x.flatten(-2), _columns(H, dv * m, m), _flat(H * dv * m, m))


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


def _whole(cfg, path, extent) -> bool:
    return len(path) > 2 and path[0] == "blocks" and path[2] == "mixer" \
        and not mixer_splits(cfg, cfg.pattern[path[1]].mixer, extent)


def shard_params(cfg, tree, index: int, extent: int):
    """Rank ``index``'s shards of a param tree (a whole model's, or one
    layer's), as ``constraints.gather_tp`` gives them on a mesh whose
    'model' axis is ``extent``: each leaf's chunk along the dim the rules
    put on 'model', views of the whole leaves; the leaves of a mixer that
    stays whole (``mixer_splits``) whole."""
    mesh = _ModelOnly(extent)

    def one(path, t):
        if _whole(cfg, path, extent):
            return t
        spec = sharding.param_pspec(cfg, path, tuple(t.shape), mesh, train=False)
        for dim, entry in enumerate(spec):
            if entry == "model":
                t = t.chunk(extent, dim=dim)[index]
        return t
    return sharding.tree_map_with_path(one, tree)


def _f32_sum(ts):
    return torch.stack([t.float() for t in ts]).sum(0).to(ts[0].dtype)


class _Abandoned(Exception):
    """An emulated rank stopped because another one failed."""


class _Peers:
    """The emulated ranks of ``emulate``: each on a thread of its own, one
    running at a time in rank order, from its start or its last
    collective to its next collective (or its end), when the next rank
    takes over.  The rank whose turn it is is installed as
    ``constraints.model()`` (rank r's ``model_shards(None, r, m)``, with
    these peers).  The last rank to reach a collective works it out for
    all of them (``exchange``).  So the ranks run as one after another
    in one thread would, in the same order, and nothing they share is
    touched by two threads at once.  A rank that waits longer than
    ``WAIT_S`` for its turn (ranks that do not meet at the same
    collectives) fails the call."""

    WAIT_S = 1800.0

    def __init__(self, extent: int):
        self.extent = extent
        self.cond = threading.Condition()
        self.turn = 0
        self.slots = [None] * extent
        self.result = None
        self.error = None
        self.shards = [constraints.ModelShards(None, r, extent, peers=self)
                       for r in range(extent)]

    def _hand_over(self, r: int):
        """Rank ``r`` gives the next rank its turn and waits for its own
        (the lock held)."""
        self.turn = (r + 1) % self.extent
        self.cond.notify_all()
        self._wait(r)

    def _wait(self, r: int):
        if not self.cond.wait_for(lambda: self.turn == r or self.error is not None,
                                  self.WAIT_S):
            raise RuntimeError(f"emulated rank {r} waited {self.WAIT_S} s for its turn")
        if self.error is not None:
            raise _Abandoned()
        constraints.install_model(self.shards[r])

    def exchange(self, r: int, x, combine):
        """Rank ``r``'s ``x`` into a collective; its share of ``combine(xs)``
        (a result for every rank), once every rank's ``x`` is in."""
        with self.cond:
            self.slots[r] = x
            if r == self.extent - 1:
                self.result, self.slots = combine(self.slots), [None] * self.extent
            self._hand_over(r)
            return self.result[r]

    def run(self, fns) -> list:
        """Each rank's ``fns[r]()`` on its own thread, in turns; their
        results, or the first error raised."""
        outs = [None] * self.extent

        def one(r):
            try:
                with self.cond:
                    self._wait(r)
                outs[r] = fns[r]()
                with self.cond:
                    self.turn = (r + 1) % self.extent
                    self.cond.notify_all()
            except _Abandoned:
                pass
            except Exception as e:  # handed to the caller
                with self.cond:
                    self.error = self.error or e
                    self.cond.notify_all()
        threads = [threading.Thread(target=one, args=(r,), daemon=True)
                   for r in range(self.extent)]
        outer = constraints.model()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            constraints.install_model(outer)
        if self.error is not None:
            raise self.error
        return outs


class _Ranks(torch.autograd.Function):
    """``emulate``'s ranks: each rank's graph built on its own copies of
    the inputs (the ranks' graphs meet where a split sublayer's
    collectives join them); backward, the graphs run back (the weights'
    gradients land in their leaves) and the inputs' gradients summed over
    the ranks."""

    @staticmethod
    def forward(ctx, fn, extent, *xs):
        ctx.ins = [[x.detach().requires_grad_(x.requires_grad) for x in xs]
                   for _ in range(extent)]
        peers = _Peers(extent)

        def rank(r):
            def call():
                with torch.enable_grad():
                    return fn(r, *ctx.ins[r])
            return call
        ctx.outs = peers.run([rank(r) for r in range(extent)])
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
    partial sum, on rank r's shards; the collectives inside it, e.g. a
    mixer's ``all_sum``, among the emulated ranks: ``_Peers``), the ranks'
    outputs summed in float32 as ``reduce_out`` sums them, and in the
    backward the gradients of the inputs ``xs`` (replicated on every
    rank) summed in float32 as ``copy_in``'s backward sums them."""
    return _Ranks.apply(fn, extent, *xs)
