"""Decoder LM over the paged KV pool and the dense slot pool, its
full-sequence forward and its training loss (port of the serving paths,
``apply``, ``encode`` and ``lm_loss`` of ``repro/models/lm.py`` for
attention, cross-attention, Mamba, mLSTM, sLSTM and MoE layers, and the
encoder of the encoder-decoder family).

Params are the reference's nested dicts: ``cfg.pattern`` positions are a
tuple in ``params["blocks"]``, each leaf stacked over ``cfg.n_repeats`` on
axis 0.  The reference's ``lax.scan`` over repeats is a Python loop here.
Paged arenas and dense caches keep the reference layouts, tuples over
pattern positions of dicts of tensors stacked over repeats: an arena's
``{"k", "v"}`` are ``(R, P, BLOCK, nkv, dh)``; a dense cache holds, per
attention layer, ``{"k", "v"}`` of ``(R, B, size, nkv, dh)`` (size =
window or max_len), per cross-attention layer ``{"k", "v"}`` of the
memory's K/V, ``(R, B, T_mem, nkv, dh)`` (static: decoding reads it and
never writes it), per Mamba layer ``{"conv", "h"}``, per mLSTM
layer ``{"C", "n", "m", "conv"}``, per sLSTM layer ``{"h", "c", "n",
"m"}``.  Both are updated **in place**: each entry point returns the object
it was given.

Under ``constraints.model_shards`` (the sharded train step, the dry-run)
a rank computes its shard over 'model' (``distributed/tensor_parallel.py``):
its heads, its columns and rows of ``d_ff``, its experts, its vocab rows
of the embedding and the head, a Mamba mixer's heads, an mLSTM's value
columns of every head and an sLSTM's columns of every head (where they
divide the extent).  Its logits are then its vocab slice, and a dense
cache holds its KV heads (all of them, only its own written, where KV
heads are whole on 'model'), its Mamba heads' state and conv channels,
its columns of the mLSTM's C and its conv channels, and its columns of
the sLSTM's h, c, n and m.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
from torch import nn

from repro_torch import require_device
from repro_torch.configs import LayerSpec
from repro_torch.distributed import constraints
from repro_torch.distributed import remat as remat_lib
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import attention, common, mamba, moe, xlstm

MAX_LEARNED_POS = 65_536  # rows of the learned position table (whisper)


def ffn_forward(cfg, p, x):
    """The dense FFN; where ``d_ff`` splits over 'model', the rank's
    columns of ``w_gate`` / ``w_up`` (``w_in``) and rows of ``w_down``
    (``w_out``), the ranks' partial sums summed."""
    dt = cfg.compute_dtype
    act = common.act_fn(cfg.act)
    split = tp.splits(cfg.d_ff)
    if split:
        x = tp.copy_in(x)
    if cfg.glu:
        g = act(x @ p["w_gate"].to(dt))
        out = (g * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    else:
        out = act(x @ p["w_in"].to(dt)) @ p["w_out"].to(dt)
    return tp.reduce_out(out) if split else out


def _ffn_block(cfg, spec, p, x, aux=None):
    """The FFN sublayer; ``aux``: a list that receives an MoE layer's
    load-balance loss (None: not computed)."""
    if spec.ffn == "none":
        return x
    h = common.apply_norm(cfg, p["norm2"], x)
    if spec.ffn == "dense":
        h = ffn_forward(cfg, p["ffn"], h)
    elif aux is None:
        h = moe.moe_ffn(cfg, p["ffn"], h)
    else:
        h, a = moe.moe_ffn(cfg, p["ffn"], h, return_aux=True)
        aux.append(a)
    if cfg.double_norm:
        h = common.apply_norm(cfg, p["norm2b"], h)
    return x + h


def _residual(cfg, spec, p, x, h, aux=None):
    """Optional post-norm of the mixer output, residual, then the FFN."""
    if cfg.double_norm:
        h = common.apply_norm(cfg, p["norm1b"], h)
    return _ffn_block(cfg, spec, p, x + h, aux)


def _mixer_out(cfg, spec, p, x, o):
    """Attention output projection, then ``_residual``."""
    return _residual(cfg, spec, p, x, attention.merge_heads(cfg, p["mixer"], o))


# --------------------------------------------------------------------------
# Dense caches (the slot pool)
# --------------------------------------------------------------------------

class _Recurrent(NamedTuple):
    """A recurrent mixer's entry points."""
    forward: Callable   # (cfg, p, x, return_cache=True) -> (out, cache)
    decode: Callable    # (cfg, p, x, cache) -> (out, new cache)
    empty: Callable     # (cfg, batch, device) -> a new stream's cache


_RECURRENT = {
    "mamba": _Recurrent(mamba.mamba_forward, mamba.mamba_decode,
                        mamba.init_cache),
    "mlstm": _Recurrent(xlstm.mlstm_forward, xlstm.mlstm_decode,
                        xlstm.empty_mlstm_state),
    "slstm": _Recurrent(xlstm.slstm_forward, xlstm.slstm_decode,
                        xlstm.empty_slstm_state),
}


def _recurrent(cfg, spec) -> _Recurrent:
    """``spec``'s recurrent mixer's entry points.  Where the model ranks
    compute it whole (``tensor_parallel.mixer_splits``: a Mamba, mLSTM or
    sLSTM mixer whose split dim does not divide the extent) they run as
    the one rank of one (``model_shards(None, 0, 1)``), on the whole
    weights ``_layer_slice`` gives them."""
    entry = _RECURRENT[spec.mixer]
    if constraints.model().extent == 1 or tp.mixer_splits(cfg, spec.mixer):
        return entry
    return _Recurrent(*(_one_rank(fn) for fn in entry))


def _one_rank(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        with constraints.model_shards(None, 0, 1):
            return fn(*args, **kw)
    return run


def _cache_size(spec, max_len):
    return min(spec.window, max_len) if spec.window else max_len


def _self_attention(cfg, spec, p, x, positions):
    """Causal self-attention over a whole sequence (positions 0..S-1)
    through the flash kernel's dense entry.  Returns (out, k, v)."""
    q, k, v = attention.project_qkv(cfg, p, x, positions)
    out = attention.merge_heads(cfg, p, attention.full_attention(
        cfg, q, k, v, window=spec.window))
    return out, k, v


def _cache_heads(cfg):
    """(KV heads of a rank's dense cache, the slice of them it writes and
    reads): all and all, but where heads are split over 'model' its shard
    (KV heads on 'model') or, where KV heads are whole, all of them and
    those its query heads use."""
    lay = tp.head_layout(cfg)
    if not lay.split or lay.kv_split:
        return lay.nkv, slice(None)
    return cfg.n_kv_heads, slice(lay.kv0, lay.kv0 + lay.nkv)


def _cross_prefill(cfg, p, x, positions, memory):
    """Cross-attention over ``memory`` (B, T, d).  Returns (out, k, v):
    the memory's K/V, which decoding reads as they are."""
    k, v = attention.project_kv_memory(cfg, p, memory)
    return attention.cross_attention(cfg, p, x, positions, k, v), k, v


def _memory_cache(cfg, k, v):
    """A cross-attention layer's cache of the rank's memory K/V
    (``_cache_heads``)."""
    n, own = _cache_heads(cfg)
    if n == k.shape[2]:
        return {"k": k, "v": v}
    out = {}
    for name, t in (("k", k), ("v", v)):
        out[name] = t.new_zeros((*t.shape[:2], n, t.shape[3]))
        out[name][:, :, own] = t
    return out


def _attn_prefill(cfg, spec, p, x, positions, max_len):
    """Self-attention over the whole prompt plus its dense cache: the last
    ``size`` positions' K/V (a ring by position for a windowed layer)."""
    B, S, _ = x.shape
    out, k, v = _self_attention(cfg, spec, p, x, positions)
    size = _cache_size(spec, max_len)
    n, own = _cache_heads(cfg)
    kc = k.new_zeros((B, size, n, cfg.d_head))
    vc = torch.zeros_like(kc)
    tail = min(S, size)
    slots = positions[-tail:] % size if spec.window else positions[-tail:]
    kc[:, slots, own] = k[:, -tail:]
    vc[:, slots, own] = v[:, -tail:]
    return out, {"k": kc, "v": vc}


def layer_prefill(cfg, spec, p, x, positions, max_len, memory=None):
    """A whole prompt through one layer.  x: (B, S, d); positions: (S,)
    = 0..S-1; memory: (B, T, d), what a cross-attention layer attends.
    Returns (x, the layer's batch-B dense cache)."""
    h = common.apply_norm(cfg, p["norm1"], x)
    if spec.mixer == "attn":
        h, cache = _attn_prefill(cfg, spec, p["mixer"], h, positions, max_len)
    elif spec.mixer == "cross_attn":
        h, k, v = _cross_prefill(cfg, p["mixer"], h, positions, memory)
        cache = _memory_cache(cfg, k, v)
    else:
        h, cache = _recurrent(cfg, spec).forward(cfg, p["mixer"], h,
                                                  return_cache=True)
    return _residual(cfg, spec, p, x, h), cache


def layer_forward_full(cfg, spec, p, x, positions, memory=None, aux=None):
    """A whole sequence through one layer, building no cache (the
    reference's ``layer_forward_full``).  x: (B, S, d); positions: (S,) =
    0..S-1; memory: (B, T, d), what a cross-attention layer attends;
    ``aux``: a list that receives an MoE layer's load-balance loss."""
    h = common.apply_norm(cfg, p["norm1"], x)
    if spec.mixer == "attn":
        h = _self_attention(cfg, spec, p["mixer"], h, positions)[0]
    elif spec.mixer == "cross_attn":
        h = _cross_prefill(cfg, p["mixer"], h, positions, memory)[0]
    else:
        h = _recurrent(cfg, spec).forward(cfg, p["mixer"], h)
    return _residual(cfg, spec, p, x, h, aux)


def _decode_lengths(spec, pos, size, active):
    """Valid cache slots per row for the decode kernel.  A windowed ring
    of ``size`` slots holds positions (pos - size, pos]: every filled slot
    is inside the window and attention does not depend on key order, so
    the row attends min(pos + 1, size) slots (the reference's
    ``_ring_kv_positions`` mask); otherwise slots 0..pos."""
    lengths = torch.minimum(pos + 1, torch.full_like(pos, size)) \
        if spec.window else pos + 1
    return lengths if active is None else torch.where(active, lengths, 0)


def layer_decode(cfg, spec, p, x, pos, cache, active=None):
    """One token per row.  x: (B, 1, d); pos: (B,) absolute position of
    the new token; cache: the layer's batch-B dense cache, written in
    place; active: optional (B,) slot-pool mask (a dead row's attention
    output is discarded; its recurrent state advances, as in the reference,
    and is overwritten at the next admission)."""
    h = common.apply_norm(cfg, p["norm1"], x)
    if spec.mixer in ("attn", "cross_attn"):
        own = _cache_heads(cfg)[1]
        kc, vc = cache["k"][:, :, own], cache["v"][:, :, own]
    if spec.mixer == "attn":
        q, k, v = attention.project_qkv(cfg, p["mixer"], h, pos[:, None])
        size = kc.shape[1]
        attention.update_cache(kc, vc, k, v, pos % size if spec.window else pos)
        o = attention.decode_attention(cfg, q, kc, vc,
                                       _decode_lengths(spec, pos, size, active))
        h = attention.merge_heads(cfg, p["mixer"], o)
    elif spec.mixer == "cross_attn":
        # every memory position is visible to a live row
        q = attention.project_q_cross(cfg, p["mixer"], h, pos[:, None])
        T = torch.full_like(pos, kc.shape[1])
        o = attention.decode_attention(
            cfg, q, kc, vc, T if active is None else torch.where(active, T, 0))
        h = attention.merge_heads(cfg, p["mixer"], o)
    else:
        h, new = _recurrent(cfg, spec).decode(cfg, p["mixer"], h, cache)
        for n, t in cache.items():
            t.copy_(new[n])
    return _residual(cfg, spec, p, x, h)


def layer_cache_zeros(cfg, spec, B, max_len, device, T_mem=0):
    if spec.mixer in ("attn", "cross_attn"):
        size = _cache_size(spec, max_len) if spec.mixer == "attn" else T_mem
        shape = (B, size, cfg.n_kv_heads, cfg.d_head)
        return {n: torch.zeros(shape, dtype=cfg.compute_dtype, device=device)
                for n in ("k", "v")}
    return _recurrent(cfg, spec).empty(cfg, B, device)


def cache_slot_write(pool, single, slot):
    """Copy a batch-1 cache into batch row ``slot`` of ``pool`` (leaves
    (R, B, ...)), in place."""
    for pl, sl in zip(pool, single):
        for n in pl:
            pl[n][:, slot] = sl[n][:, 0]
    return pool


def cache_slot_read(pool, slot):
    """Batch row ``slot`` of ``pool`` as a new batch-1 cache.  A copy, not
    a view: the pool row is overwritten by the next admission, and the
    reference's read returns a new array."""
    return tuple({n: t[:, slot:slot + 1].clone() for n, t in pl.items()}
                 for pl in pool)


def cache_copy(cache):
    """A new cache with the same contents (a prefix-cache entry is decoded
    from a copy, so the entry itself never changes)."""
    return tuple({n: t.clone() for n, t in pl.items()} for pl in cache)


def arena_gather_pages(arena, pages):
    """Physical pages out of a paged arena: every ``{"k", "v"}`` leaf
    (R, P, BLOCK, nkv, dh) -> a new (R, n, BLOCK, nkv, dh) tensor of the n
    requested pages, in order (cross-node page export)."""
    idx = torch.as_tensor(pages, dtype=torch.long, device=arena[0]["k"].device)
    return tuple({n: a[:, idx] for n, a in layer.items()} for layer in arena)


def arena_scatter_pages(arena, pages, blocks):
    """Inverse of ``arena_gather_pages``, **in place**: write (R, n, BLOCK,
    nkv, dh) blocks (any device; cast to the arena dtype) into the n
    physical pages of every arena leaf.  The caller owns the pages
    (refcount 1): aliased pages are never written.  Blocks that do not
    match the arena raise ``ValueError`` before any page is written.
    Returns ``arena``."""
    if len(blocks) != len(arena) or any(set(b) != set(a) for a, b in zip(arena, blocks)):
        raise ValueError(f"{len(blocks)} block layers for an arena of {len(arena)}")
    for layer, blk in zip(arena, blocks):
        for n, a in layer.items():
            want = (a.shape[0], len(pages), *a.shape[2:])
            if tuple(blk[n].shape) != want:
                raise ValueError(f"{n} blocks of shape {tuple(blk[n].shape)}, "
                                 f"the arena takes {want}")
    idx = torch.as_tensor(pages, dtype=torch.long, device=arena[0]["k"].device)
    for layer, blk in zip(arena, blocks):
        for n, a in layer.items():
            a[:, idx] = blk[n].to(device=a.device, dtype=a.dtype)
    return arena


# --------------------------------------------------------------------------
# Paged KV
# --------------------------------------------------------------------------


def layer_decode_paged(cfg, spec, p, x, pos, arena, page_table,
                       active=None, write=True):
    """One token per row.  x: (B, 1, d); pos: (B,); arena: {"k","v"}: (P,
    BLOCK, nkv, h), written in place.  ``write=False`` skips the write
    (query-only replay over fully cached tokens: pages another request may
    alias are never mutated)."""
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = attention.project_qkv(cfg, p["mixer"], h, pos[:, None])
    if write:
        attention.update_paged_cache(arena["k"], arena["v"], k, v,
                                     page_table, pos)
    o = attention.paged_decode_attention(cfg, q, arena["k"], arena["v"],
                                         page_table, pos, window=spec.window,
                                         active=active)
    return _mixer_out(cfg, spec, p, x, o)


def layer_prefill_paged(cfg, spec, p, x, pos0, arena, page_table,
                        active=None):
    """One teacher-forced prefill chunk: write the chunk's K/V into its
    (fresh) page in place, then attend over all the row's pages.  x: (B,
    C, d) with C == BLOCK and ``pos0`` block-aligned.  ``active``: optional
    (B,) bool — inactive rows write onto the scratch page 0 and get zero
    attention output."""
    B, C, _ = x.shape
    ka, va = arena["k"], arena["v"]
    positions = pos0[:, None] + torch.arange(C, device=x.device)[None]
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = attention.project_qkv(cfg, p["mixer"], h, positions)
    phys = page_table[torch.arange(B, device=x.device),
                      pos0.long() // ka.shape[1]].long()
    if active is not None:
        phys = torch.where(active, phys, 0)
    ka[phys] = k
    va[phys] = v
    o = attention.paged_prefill_attention(cfg, q, ka, va, page_table,
                                          positions, window=spec.window,
                                          active=active)
    return _mixer_out(cfg, spec, p, x, o)


def layer_verify_paged(cfg, spec, p, x, pos, arena, page_table, n_tok=None):
    """One speculation-window step: write the window's K/V by token
    position in place (it may straddle a block boundary), then attend
    causally over the pages and inside the window.  x: (B, W, d); row b's
    window starts at ``pos[b]``; ``n_tok`` (B,) real tokens per row (0 =
    dead row: scratch writes, zero attention output)."""
    W = x.shape[1]
    positions = pos[:, None] + torch.arange(W, device=x.device)[None]
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = attention.project_qkv(cfg, p["mixer"], h, positions)
    attention.update_paged_cache_window(arena["k"], arena["v"], k, v,
                                        page_table, pos, n_tok=n_tok)
    active = None if n_tok is None else n_tok > 0
    o = attention.paged_prefill_attention(cfg, q, arena["k"], arena["v"],
                                          page_table, positions,
                                          window=spec.window, active=active)
    return _mixer_out(cfg, spec, p, x, o)


def _layer_slice(tree, r, cfg=None, spec=None, whole=False):
    """Repeat ``r`` of a stacked params subtree (of a layer of ``spec``
    in ``cfg``); a sharded (DTensor) leaf is gathered here, just before its
    layer uses it: with its 'model' shard kept (``constraints.gather_tp``),
    but whole in a mixer that every model rank computes whole
    (``constraints.gather``): a Mamba, mLSTM or sLSTM mixer whose split
    dim does not divide the model extent (``tensor_parallel.mixer_splits``)."""
    def one(k, v):
        if isinstance(v, dict):
            return _layer_slice(v, r, whole=whole or (
                k == "mixer" and spec is not None
                and not tp.mixer_splits(cfg, spec.mixer)))
        return (constraints.gather if whole else constraints.gather_tp)(v[r])
    return {k: one(k, v) for k, v in tree.items()}


# --------------------------------------------------------------------------
# The encoder (whisper): bidirectional self-attention over frames
# --------------------------------------------------------------------------

ENC_SPEC = LayerSpec(mixer="attn", ffn="dense")   # every encoder layer


def encode(cfg, p, frames):
    """frames: (B, T, d), the stub conv frontend's output -> (B, T, d).
    Fixed sinusoidal positions are added to the frames; each of the
    ``n_enc_layers`` layers (``p["layers"]``, stacked) is non-causal
    self-attention without RoPE through the flash kernel's dense entry,
    then a dense FFN; ``p["final_norm"]`` last."""
    T = frames.shape[1]
    x = frames + common.sinusoidal_positions(
        T, cfg.d_model, frames.device).to(frames.dtype)
    for r in range(cfg.n_enc_layers):
        lp = _layer_slice(p["layers"], r)
        h = common.apply_norm(cfg, lp["norm1"], x)
        q, k, v = attention.project_qkv(cfg, lp["mixer"], h, rope=False)
        x = x + attention.merge_heads(cfg, lp["mixer"], attention.full_attention(
            cfg, q, k, v, causal=False))
        x = _ffn_block(cfg, ENC_SPEC, lp, x)
    return common.apply_norm(cfg, p["final_norm"], x)


class LM(nn.Module):
    """The model's serving entry points and its full forward.  Holds the
    config and the device; the weights are a parameter dict
    (``repro_torch.params``) passed to every call, as in the reference."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = require_device(device)

    def _layers(self, params, state=None):
        """(spec, layer params, the layer's slice of ``state``) in execution
        order; ``state`` is an arena or a dense cache (or None)."""
        cfg = self.cfg
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.pattern):
                yield (spec, _layer_slice(params["blocks"][i], r, cfg, spec),
                       None if state is None else
                       {n: t[r] for n, t in state[i].items()})

    def _embed(self, params, tokens, positions):
        """Token embeddings, plus the learned position rows (clamped to the
        table) where the config has no RoPE; ``positions`` broadcasts
        against ``tokens``.  A table whose rows split over 'model' is
        looked up on each rank's rows and summed (``tp.vocab_lookup``)."""
        cfg = self.cfg
        dt = cfg.compute_dtype

        def take(table, rows, idx, scale):
            if tp.splits(rows):
                return tp.vocab_lookup(table, idx, scale, dt, common.take_embedding)
            return common.take_embedding(table, idx, scale, dt)
        x = take(params["embed"], cfg.padded_vocab, tokens, cfg.embed_scale)
        if cfg.rope_theta <= 0:
            idx = positions.long().clamp(max=MAX_LEARNED_POS - 1)
            x = x + take(params["pos_embed"], MAX_LEARNED_POS, idx, False)
        return constraints.constrain_batch(x)

    def _memory(self, params, aux):
        """What the cross-attention layers attend: the encoder's output
        over ``aux["frames"]`` (whisper), or ``aux["image_embeds"]``
        (vision), in the compute dtype; None for a decoder-only config.  A
        missing key raises ``KeyError``, as in the reference."""
        cfg = self.cfg
        if cfg.is_encdec:     # graded where grad mode is on (training)
            return encode(cfg, params["encoder"],
                          aux["frames"].to(cfg.compute_dtype))
        if cfg.n_image_tokens:
            return aux["image_embeds"].to(cfg.compute_dtype)
        return None

    def _logits(self, params, x):
        """float32 logits; where the vocab splits over 'model', the rank's
        slice of them (its rows of the head, or of a tied ``embed``)."""
        cfg = self.cfg
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        if tp.splits(cfg.padded_vocab):
            x = tp.copy_in(x)
        logits = (x @ head.to(cfg.compute_dtype).t()).float()
        logits = common.softcap(logits, cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab:   # out of place: tanh's backward reads its output
            pad = tp.vocab_index(logits.shape[-1], logits.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _head(self, params, x):
        return self._logits(params, common.apply_norm(
            self.cfg, params["final_norm"], x))

    def supports_paging(self) -> bool:
        """Only attention KV has per-position state to page; recurrent
        and cross-attention mixers keep the dense slot pool."""
        return all(s.mixer == "attn" for s in self.cfg.pattern)

    # ---------------- shapes ----------------
    def param_specs(self):
        """The weight tree as meta tensors (``init_params`` on the meta
        device: shapes and dtypes, no storage), the reference's
        ``jax.eval_shape(self.init, key)``."""
        from repro_torch.params import init_params
        return init_params(self.cfg, None, device="meta")

    def cache_specs(self, B, max_len, T_mem=0):
        """``cache_zeros(B, max_len, T_mem)`` as meta tensors."""
        return LM(self.cfg, "meta").cache_zeros(B, max_len, T_mem)

    # ---------------- full forward ----------------
    @torch.no_grad()
    def encode(self, params, frames):
        """The encoder over frames (B, T, d), cast to the compute dtype ->
        (B, T, d) (``encode``), without autograd, as the serving entry
        points; ``apply`` runs the graded encoder."""
        return encode(self.cfg, params["encoder"],
                      frames.to(self.cfg.compute_dtype))

    def apply(self, params, tokens, aux=None, remat=False, collect_aux=False):
        """Full-sequence forward, tokens (B, S) from position 0 -> (B, S,
        V) float32 logits at every position (the reference's
        ``LM.apply``), graded where grad mode is on: serving callers
        (the verifier) call it under ``torch.no_grad()``.  ``aux``:
        ``{"frames"}`` or ``{"image_embeds"}`` for the configs with
        cross-attention.  ``remat``: each repeat's layers under
        ``distributed.remat`` (True is ``"full"``, or a policy name).  With
        ``collect_aux``, returns (logits, the MoE aux losses summed over
        layers)."""
        cfg = self.cfg
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self._embed(params, tokens, positions)
        memory = self._memory(params, aux or {})

        def body(x, r):
            """Repeat ``r`` of the pattern -> (x, its MoE aux losses summed)."""
            aux = [] if collect_aux else None
            for i, spec in enumerate(cfg.pattern):
                x = layer_forward_full(cfg, spec, _layer_slice(params["blocks"][i], r, cfg, spec),
                                       x, positions, memory, aux)
            return x, sum(aux or [], x.new_zeros((), dtype=torch.float32))

        if remat:
            body = remat_lib.wrap(body, "full" if remat is True else remat)
        aux_sum = 0.0
        for r in range(cfg.n_repeats):
            x, a = body(x, r)
            aux_sum = aux_sum + a
        logits = self._head(params, x)
        return (logits, aux_sum) if collect_aux else logits

    # ---------------- dense slot pool ----------------
    def cache_zeros(self, B, max_len, T_mem=0):
        """A dense cache for ``B`` rows of up to ``max_len`` positions
        (``T_mem`` memory positions for a cross-attention layer): per
        pattern position, leaves stacked over repeats (R, B, ...)."""
        R = self.cfg.n_repeats
        return tuple({n: torch.stack([t] * R) for n, t in layer_cache_zeros(
            self.cfg, spec, B, max_len, self.device, T_mem).items()}
            for spec in self.cfg.pattern)

    @torch.no_grad()
    def prefill(self, params, tokens, aux=None, max_len=None):
        """A whole prompt, tokens (B, S), from position 0.  Returns the
        last position's (B, V) logits and a new dense cache sized for
        ``max_len`` (default S); a cross-attention layer's cache holds the
        memory's K/V (``aux`` as for ``apply``)."""
        cfg = self.cfg
        S = tokens.shape[1]
        positions = torch.arange(S, device=tokens.device)
        x = self._embed(params, tokens, positions)
        memory = self._memory(params, aux or {})
        caches = [[] for _ in cfg.pattern]          # [position][repeat]
        for i, (spec, p, _) in enumerate(self._layers(params)):
            x, c = layer_prefill(cfg, spec, p, x, positions, max_len or S,
                                 memory)
            caches[i % len(cfg.pattern)].append(c)
        cache = tuple({n: torch.stack([c[n] for c in cs]) for n in cs[0]}
                      for cs in caches)
        return self._head(params, x[:, -1]), cache

    @torch.no_grad()
    def decode(self, params, cache, tokens, pos, active=None):
        """tokens (B, 1), pos (B,) absolute position of the new token ->
        ((B, V) logits, cache).  ``active``: optional (B,) bool slot-pool
        mask (dead rows decode too, masked, instead of a new shape).  A
        cross-attention layer reads its memory's K/V from the cache."""
        x = self._embed(params, tokens, pos[:, None])
        for spec, p, c in self._layers(params, cache):
            x = layer_decode(self.cfg, spec, p, x, pos, c, active=active)
        return self._head(params, x[:, -1]), cache

    def paged_arena_zeros(self, num_pages, block):
        """Node-wide paged KV arena: per pattern position separate {"k",
        "v"} tensors (R, num_pages, BLOCK, nkv, d_head).  Page 0 is the
        scratch page."""
        cfg = self.cfg
        shape = (cfg.n_repeats, num_pages, block, cfg.n_kv_heads, cfg.d_head)

        def z():
            return torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=self.device)
        return tuple({"k": z(), "v": z()} for _ in cfg.pattern)

    @torch.no_grad()
    def prefill_paged(self, params, arena, page_tables, tokens, pos0,
                      active=None):
        """One teacher-forced prompt chunk: tokens (B, C) with C == BLOCK,
        pos0 (B,) block-aligned.  Writes the chunk's K/V into each row's
        write page and returns ((B, C, V) logits, arena).  ``active``:
        optional (B,) bool for batched admission (dead rows write to the
        scratch page)."""
        x = self._embed(params, tokens, pos0[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device))
        for spec, p, ar in self._layers(params, arena):
            x = layer_prefill_paged(self.cfg, spec, p, x, pos0, ar,
                                    page_tables, active=active)
        return self._head(params, x), arena

    @torch.no_grad()
    def decode_paged(self, params, arena, page_tables, tokens, pos,
                     active=None, write=True):
        """tokens (B, 1), pos (B,), page_tables (B, n_pg) -> ((B, V)
        logits, arena).  ``write=False`` leaves the arena untouched."""
        x = self._embed(params, tokens, pos[:, None])
        for spec, p, ar in self._layers(params, arena):
            x = layer_decode_paged(self.cfg, spec, p, x, pos, ar, page_tables,
                                   active=active, write=write)
        return self._head(params, x[:, -1]), arena

    @torch.no_grad()
    def verify_paged(self, params, arena, page_tables, tokens, pos,
                     n_tok=None):
        """Speculative verify: tokens (B, W) — the committed token then up
        to W-1 drafts — from position pos (B,); n_tok (B,) real tokens per
        row.  Returns ((B, W, V) logits equal to W sequential decodes,
        arena)."""
        x = self._embed(params, tokens, pos[:, None] + torch.arange(
            tokens.shape[1], device=tokens.device))
        for spec, p, ar in self._layers(params, arena):
            x = layer_verify_paged(self.cfg, spec, p, x, pos, ar, page_tables,
                                   n_tok=n_tok)
        return self._head(params, x), arena


# --------------------------------------------------------------------------
# Loss
# --------------------------------------------------------------------------

def lm_loss(cfg, model: LM, params, tokens, labels, aux=None, remat=True,
            n_labels=None):
    """Mean next-token cross-entropy over the labels >= 0 (the reference's
    ``lm_loss``).  Returns (total, {"ce", "moe_aux", "tokens"}) with total
    = ce + 0.01 * moe_aux, the MoE configs' Switch load-balance loss (0
    without MoE).  Where the vocab splits over 'model', each label's
    log-likelihood comes from the ranks' logit slices
    (``tp.log_likelihood``).  ``n_labels``: the count to divide the summed
    cross-entropy by (default: this batch's labels >= 0); a rank that holds
    a slice of the batch passes the whole batch's count."""
    collect = cfg.moe is not None
    out = model.apply(params, tokens, aux=aux, remat=remat, collect_aux=collect)
    logits, moe_aux = out if collect else \
        (out, torch.zeros((), dtype=torch.float32, device=tokens.device))
    logits = logits.float()
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    if tp.splits(cfg.padded_vocab):    # logits: this rank's vocab slice
        ll = tp.log_likelihood(logits, safe)
    else:
        ll = torch.gather(logits, -1, safe[..., None])[..., 0] \
            - torch.logsumexp(logits, dim=-1)
    ce = -(ll * mask).sum() / (mask.sum() if n_labels is None else n_labels).clamp_min(1.0)
    return ce + 0.01 * moe_aux, {"ce": ce, "moe_aux": moe_aux,
                                 "tokens": mask.sum()}
