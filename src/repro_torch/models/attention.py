"""GQA attention over the paged KV arena (port of the attention-family
parts of ``repro/models/attention.py``).

The plain versions (``full_attention``, ``decode_attention`` and the page
gather) keep the reference's numerics, including its ``-2**30`` masks,
and run for CPU tensors.  For CUDA tensors ``paged_decode_attention`` and
``paged_prefill_attention`` launch the hand-written kernels
(``kernels/paged_decode``, ``kernels/flash_attention``); there is no
fallback.  Arena updates happen **in place** (indexed assignment), where
the reference returns a new arena.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import paged_flash_attention
from repro_torch.kernels.paged_decode.ops import \
    paged_decode_attention as paged_decode_kernel
from repro_torch.models import common

NEG_INF = -2.0 ** 30  # large-but-finite: keeps softmax well-defined in bf16


def _scale(cfg) -> float:
    return cfg.attn_scale if cfg.attn_scale else 1.0 / math.sqrt(cfg.d_head)


def _pad_heads_w(cfg, w, head_axis: int):
    """Zero-pad query heads per GQA group (keeps the original query-head
    to KV-head assignment)."""
    if not cfg.head_pad:
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


def project_qkv(cfg, p, x, positions=None, rope: bool = True):
    dt = cfg.compute_dtype
    q = _proj(x, _pad_heads_w(cfg, p["wq"].to(dt), 1))
    k = _proj(x, p["wk"].to(dt))
    v = _proj(x, p["wv"].to(dt))
    if rope and cfg.rope_theta > 0 and positions is not None:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(cfg, p, o):
    wo = _pad_heads_w(cfg, p["wo"].to(cfg.compute_dtype), 0)
    n, h, d = wo.shape
    return o.reshape(*o.shape[:-2], n * h) @ wo.reshape(n * h, d)


# --------------------------------------------------------------------------
# Plain attention (the reference's numerics)
# --------------------------------------------------------------------------

def _expand_kv(k, n_heads):
    g = n_heads // k.shape[2]
    return k if g == 1 else k.repeat_interleave(g, dim=2)


def _gqa_scores(q, k, scale, cap):
    """q: (B, Sq, H, h); k: (B, Skv, H, h) -> (B, H, Sq, Skv) float32."""
    s = torch.einsum("bqhd,bthd->bhqt", q, k) * scale
    return common.softcap(s.float(), cap)


def _gqa_out(probs, v):
    return torch.einsum("bhqt,bthd->bqhd", probs, v)


def full_attention(cfg, q, k, v, q_positions, kv_positions,
                   causal: bool = True, window: Optional[int] = None):
    """q: (B, Sq, nq, h); k, v: (B, Skv, nkv, h); q_positions: (B, Sq) or
    (Sq,); kv_positions: (B, Skv) or (Skv,).  Unlike the reference it does
    not chunk over query blocks: it serves chunk-sized queries only."""
    B, Sq, nq, _ = q.shape
    k = _expand_kv(k, nq)
    v = _expand_kv(v, nq)
    q_positions = q_positions.expand(B, Sq)
    kv_positions = kv_positions.expand(B, k.shape[1])
    s = _gqa_scores(q, k, _scale(cfg), cfg.attn_softcap)
    m = torch.ones(B, Sq, k.shape[1], dtype=torch.bool, device=q.device)
    if causal:
        m &= kv_positions[:, None, :] <= q_positions[:, :, None]
    if window is not None:
        m &= (q_positions[:, :, None] - kv_positions[:, None, :]) < window
    s = torch.where(m[:, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(v.dtype)
    return _gqa_out(probs, v)


def decode_attention(cfg, q, k_cache, v_cache, kv_positions, pos,
                     window: Optional[int] = None, active=None):
    """One-token decode.  q: (B, 1, nq, h); caches: (B, S, nkv, h);
    kv_positions: (B, S) absolute positions (-1 = empty); pos: (B,);
    active: optional (B,) bool — a dead row gets a fully masked score row
    and its output is discarded by the caller."""
    nq = q.shape[2]
    kc = _expand_kv(k_cache, nq)
    vc = _expand_kv(v_cache, nq)
    s = _gqa_scores(q, kc, _scale(cfg), cfg.attn_softcap)
    valid = (kv_positions >= 0) & (kv_positions <= pos[:, None])
    if window is not None:
        valid &= (pos[:, None] - kv_positions) < window
    if active is not None:
        valid &= active[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(vc.dtype)
    return _gqa_out(probs, vc)


# --------------------------------------------------------------------------
# Paged KV: node-wide (P, BLOCK, nkv, h) arena indexed by page tables.
# Physical page 0 is scratch: masked rows write there and it is never read
# unmasked.
# --------------------------------------------------------------------------

def gather_pages(arena, page_table):
    """arena: (P, BLOCK, nkv, h); page_table: (B, n_pg) -> (B, n_pg *
    BLOCK, nkv, h): logical position j of row b lives at
    arena[page_table[b, j // BLOCK], j % BLOCK]."""
    B, n_pg = page_table.shape
    g = arena[page_table.reshape(-1).long()]
    return g.reshape(B, n_pg * arena.shape[1], *arena.shape[2:])


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
    BLOCK, nkv, h); page_table: (B, n_pg) int32; pos: (B,).

    CUDA tensors go through the paged decode kernel, which gathers pages
    inside the kernel (a dead row's output is zeros); CPU tensors gather
    the pages and run ``decode_attention``."""
    if q.is_cuda:
        lengths = pos + 1 if active is None else torch.where(active, pos + 1, 0)
        o = paged_decode_kernel(q[:, 0].contiguous(), k_arena, v_arena,
                                page_table, lengths.to(torch.int32),
                                window=window, softcap=cfg.attn_softcap or None,
                                scale=_scale(cfg))
        return o[:, None]
    B = q.shape[0]
    S = page_table.shape[1] * k_arena.shape[1]
    kv_pos = torch.arange(S, device=q.device).expand(B, S)
    return decode_attention(cfg, q, gather_pages(k_arena, page_table),
                            gather_pages(v_arena, page_table), kv_pos, pos,
                            window=window, active=active)


def paged_prefill_attention(cfg, q, k_arena, v_arena, page_table,
                            q_positions, window: Optional[int] = None,
                            active=None):
    """Causal attention of a query chunk over paged KV (prefill chunks and
    speculative verify windows): the chunk's own K/V must already be in
    the arena.  q: (B, C, nq, h); q_positions: (B, C), consecutive per row
    (``q_positions[b, i] == q_positions[b, 0] + i``); active: optional
    (B,) bool — a dead row's output is zeros.

    CUDA tensors go through the paged entry of the flash attention kernel;
    CPU tensors gather the pages and run ``full_attention``."""
    if q.is_cuda:
        return paged_flash_attention(
            q.contiguous(), k_arena, v_arena, page_table,
            q_positions[:, 0].to(torch.int32).contiguous(), active,
            window=window, softcap=cfg.attn_softcap or None, scale=_scale(cfg))
    B = q.shape[0]
    S = page_table.shape[1] * k_arena.shape[1]
    kv_pos = torch.arange(S, device=q.device).expand(B, S)
    o = full_attention(cfg, q, gather_pages(k_arena, page_table),
                       gather_pages(v_arena, page_table), q_positions, kv_pos,
                       causal=True, window=window)
    if active is not None:
        o = torch.where(active[:, None, None, None], o, 0.0)
    return o
