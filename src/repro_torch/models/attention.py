"""GQA attention over the paged KV arena and the dense slot pool (port of
``repro/models/attention.py``).

Every attention goes through a kernel wrapper (``kernels/*/ops.py``):
for CUDA tensors the hand-written kernel, with no fallback; for CPU
tensors its plain version in ``kernels/*/ref.py``, the only CPU version.
A dead row's output is garbage by contract, as in the reference: the
kernels write zeros, the decode plain versions the reference's uniform
average over masked keys.  Cache and arena updates happen **in
place** (indexed assignment), where the reference returns new arrays.

Under ``constraints.model_shards`` a rank computes its heads only
(``tensor_parallel.head_layout``): the projections read its shards of
``wq`` / ``wk`` / ``wv`` / ``wo`` (or, where KV heads are whole on
'model', the KV heads its query heads use), the flash kernel runs on the
local heads, and ``out_proj`` gives the rank's partial sum, which
``merge_heads`` sums over the model ranks.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed import constraints
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.decode_attention.ops import \
    decode_attention as dense_decode_kernel
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     paged_flash_attention)
from repro_torch.kernels.paged_decode.ops import \
    paged_decode_attention as paged_decode_kernel
from repro_torch.models import common


def _scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale else 1.0 / math.sqrt(cfg.d_head)


def _pad_heads_w(cfg, w, head_axis: int):
    """Zero-pad query heads per GQA group (keeps the original query-head
    to KV-head assignment).  Heads split over 'model' are not padded: a
    padded head's output meets zero rows of ``wo`` and adds exactly 0."""
    if not cfg.head_pad or tp.head_layout(cfg).split:
        return w
    nkv = cfg.n_kv_heads
    g = cfg.n_heads // nkv
    g_new = (cfg.n_heads + cfg.head_pad) // nkv
    shape = w.shape
    grouped = w.reshape(shape[:head_axis] + (nkv, g) + shape[head_axis + 1:])
    pad = grouped.new_zeros(shape[:head_axis] + (nkv, g_new - g)
                            + shape[head_axis + 1:])
    padded = torch.cat([grouped, pad], dim=head_axis + 1)
    return padded.reshape(shape[:head_axis] + (nkv * g_new,)
                          + shape[head_axis + 1:])


def _proj(x, w):
    """x: (B, S, d) @ w: (d, n, h) -> (B, S, n, h)."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).reshape(*x.shape[:-1], n, h)


def _kv_w(cfg, w):
    """The rank's KV heads of ``wk`` / ``wv``: its shard as it comes where
    KV heads are on 'model'; where they are whole and query heads split,
    the KV heads its query heads read, out of the whole leaf (whose
    gradient then sums over the model ranks)."""
    lay = tp.head_layout(cfg)
    if not lay.split or lay.kv_split:
        return w
    return tp.copy_in(w)[:, lay.kv0:lay.kv0 + lay.nkv]


def _kv_proj(cfg, x, w):
    """K or V of the rank's KV heads from x (B, S, d) and the whole leaf
    ``w`` (``_kv_w``), projected by parts where ranks share a KV head
    (``tp.kv_project``)."""
    return tp.kv_project(_proj, x, _kv_w(cfg, w).to(cfg.compute_dtype))


def _into_heads(cfg, x):
    """``x`` into the region of split heads (``tp.copy_in``), where they
    are split."""
    return tp.copy_in(x) if tp.head_layout(cfg).split else x


def project_qkv(cfg, p, x, positions=None, rope: bool = True):
    """The rank's heads of q, k and v of x (B, S, d)."""
    dt = cfg.compute_dtype
    x = _into_heads(cfg, x)
    q = _proj(x, _pad_heads_w(cfg, p["wq"].to(dt), 1))
    k, v = _kv_proj(cfg, x, p["wk"]), _kv_proj(cfg, x, p["wv"])
    if rope and cfg.rope_theta > 0 and positions is not None:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_q_cross(cfg, p, x, positions):
    """A cross-attention layer's queries: the padded ``wq``, RoPE when the
    config has it (the memory's keys get none; the reference's
    ``attn_layer_forward(memory=...)`` and cross ``layer_decode``)."""
    q = _proj(_into_heads(cfg, x), _pad_heads_w(cfg, p["wq"].to(cfg.compute_dtype), 1))
    if cfg.rope_theta > 0:
        q = common.apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv_memory(cfg, p, mem):
    """Cross-attention K/V from a (B, T, d) memory, no RoPE."""
    mem = _into_heads(cfg, mem)
    return _kv_proj(cfg, mem, p["wk"]), _kv_proj(cfg, mem, p["wv"])


def out_proj(cfg, p, o):
    """The output projection of the rank's heads o (B, S, n, h) -> (B, S,
    d): where heads are split over 'model', the rank's partial sum."""
    wo = _pad_heads_w(cfg, p["wo"].to(cfg.compute_dtype), 0)
    n, h, d = wo.shape
    return o.reshape(*o.shape[:-2], n * h) @ wo.reshape(n * h, d)


def merge_heads(cfg, p, o):
    """``out_proj``, summed over the model ranks where heads are split."""
    out = out_proj(cfg, p, o)
    return tp.reduce_out(out) if tp.head_layout(cfg).split else out


# --------------------------------------------------------------------------
# Dense caches (the slot pool): (B, S, nkv, h) per layer
# --------------------------------------------------------------------------

def full_attention(cfg, q, k, v, causal: bool = True,
                   window: Optional[int] = None):
    """Attention of a whole sequence, queries at positions 0..Sq-1 and
    keys at 0..Skv-1: causal self-attention over a prompt, or (``causal=
    False``) the encoder's self-attention and cross-attention over a
    memory of Skv positions.  q: (B, Sq, nq, h); k, v: (B, Skv, nkv, h) ->
    (B, Sq, nq, h), through the dense entry of the flash attention kernel,
    which reads these layouts through its strides (heads-before-positions
    views, no copies).  Where grad mode is on and an input requires grad,
    on the card, the kernel's ``FlashAttention`` gives the gradient (its
    backward kernel).  Under a mesh, the queries (and so the scores and
    probabilities inside the kernel) and the output pin batch to the DP
    axes and heads to the TP axis."""
    q = constraints.pin(q, ("batch", None, "model", None))
    o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), causal=causal, window=window,
                        softcap=cfg.attn_softcap or None, scale=_scale(cfg))
    return constraints.pin(o.transpose(1, 2), ("batch", None, "model", None))


def cross_attention(cfg, p, x, positions, k, v):
    """A cross-attention layer over a memory's K/V (``project_kv_memory``):
    queries of x (B, S, d) at ``positions``, every memory position visible
    (no causal mask, no window) -> (B, S, d)."""
    q = project_q_cross(cfg, p, x, positions)
    return merge_heads(cfg, p, full_attention(cfg, q, k, v, causal=False))


def decode_attention(cfg, q, k_cache, v_cache, lengths):
    """One-token decode over a dense cache.  q: (B, 1, nq, h); caches: (B,
    S, nkv, h); lengths: (B,), row b attending to cache slots [0, len) (0 =
    dead row, output discarded).  Under a mesh the caches pin batch to the
    DP axes and KV heads to the TP axis."""
    k_cache = constraints.pin(k_cache, ("batch", None, "model", None))
    v_cache = constraints.pin(v_cache, ("batch", None, "model", None))
    o = dense_decode_kernel(q[:, 0].contiguous(), k_cache, v_cache,
                            lengths.to(torch.int32).contiguous(),
                            softcap=cfg.attn_softcap or None,
                            scale=_scale(cfg))
    return o[:, None]


def update_cache(k_cache, v_cache, k_new, v_new, slot):
    """Write (B, 1, nkv, h) new K/V **in place** at per-row cache index
    ``slot`` (B,)."""
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, slot.long()] = k_new[:, 0]
    v_cache[rows, slot.long()] = v_new[:, 0]
    return k_cache, v_cache


# --------------------------------------------------------------------------
# Paged KV: node-wide (P, BLOCK, nkv, h) arena indexed by page tables.
# Physical page 0 is scratch: masked rows write there and it is never read
# unmasked.
# --------------------------------------------------------------------------

def update_paged_cache(k_arena, v_arena, k_new, v_new, page_table, pos):
    """Write (B, 1, nkv, h) new K/V **in place** at each row's write page
    ``page_table[b, pos[b] // BLOCK]``, offset ``pos[b] % BLOCK``.  Rows
    whose table points at the scratch page write there harmlessly."""
    B = page_table.shape[0]
    blk = k_arena.shape[1]
    pos = pos.long()
    phys = page_table[torch.arange(B, device=pos.device), pos // blk].long()
    off = pos % blk
    k_arena[phys, off] = k_new[:, 0]
    v_arena[phys, off] = v_new[:, 0]
    return k_arena, v_arena


def update_paged_cache_window(k_arena, v_arena, k_new, v_new, page_table,
                              pos, n_tok=None):
    """Write a (B, W, nkv, h) speculation window **in place**: token m of
    row b lands at page ``page_table[b, (pos[b]+m) // BLOCK]``, offset
    ``(pos[b]+m) % BLOCK`` (a window may straddle a block boundary).
    Tokens at or beyond ``n_tok[b]`` (ragged drafts; 0 = dead row) go to
    the scratch page 0, and the block index is clipped so a row parked
    near ``max_len`` cannot index past its page table."""
    W = k_new.shape[1]
    blk = k_arena.shape[1]
    n_pg = page_table.shape[1]
    steps = torch.arange(W, device=pos.device)
    positions = pos.long()[:, None] + steps[None]             # (B, W)
    blocks = (positions // blk).clamp(0, n_pg - 1)
    phys = torch.gather(page_table.long(), 1, blocks)          # (B, W)
    if n_tok is not None:
        phys = torch.where(steps[None] < n_tok[:, None], phys, 0)
    off = positions % blk
    k_arena[phys, off] = k_new
    v_arena[phys, off] = v_new
    return k_arena, v_arena


def paged_decode_attention(cfg, q, k_arena, v_arena, page_table, pos,
                           window: Optional[int] = None, active=None):
    """One-token decode over paged KV.  q: (B, 1, nq, h); arenas: (P,
    BLOCK, nkv, h); page_table: (B, n_pg) int32; pos: (B,); active:
    optional (B,) bool (a dead row's output is discarded).  The paged
    decode kernel gathers the pages itself."""
    lengths = pos + 1 if active is None else torch.where(active, pos + 1, 0)
    o = paged_decode_kernel(q[:, 0].contiguous(), k_arena, v_arena,
                            page_table, lengths.to(torch.int32).contiguous(),
                            window=window, softcap=cfg.attn_softcap or None,
                            scale=_scale(cfg))
    return o[:, None]


def paged_prefill_attention(cfg, q, k_arena, v_arena, page_table,
                            q_positions, window: Optional[int] = None,
                            active=None):
    """Causal attention of a query chunk over paged KV (prefill chunks and
    speculative verify windows), through the paged entry of the flash
    attention kernel: the chunk's own K/V must already be in the arena.
    q: (B, C, nq, h); q_positions: (B, C), consecutive per row
    (``q_positions[b, i] == q_positions[b, 0] + i``); active: optional
    (B,) bool — a dead row's output is zeros."""
    return paged_flash_attention(
        q.contiguous(), k_arena, v_arena, page_table,
        q_positions[:, 0].to(torch.int32).contiguous(), active,
        window=window, softcap=cfg.attn_softcap or None, scale=_scale(cfg))
