"""Plain PyTorch version of the paged decode kernel (port of
``repro/kernels/decode_attention/ref.py`` ``paged_decode_attention_ref``):
gather the row's pages into a dense view, then the dense decode's plain
version in float32."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def gather_dense(arena, page_table):
    """(P, BLOCK, Hkv, D) arena -> (B, Hkv, n_pg * BLOCK, D) per-row view."""
    B, n_pg = page_table.shape
    g = arena[page_table.reshape(-1).long()]
    return g.reshape(B, n_pg * arena.shape[1], *arena.shape[2:]).transpose(1, 2)


def paged_decode_attention_ref(q, k_arena, v_arena, page_table, lengths, *,
                               window=None, softcap=None, scale=None):
    """q: (B, H, D); arenas: (P, BLOCK, Hkv, D); page_table: (B, n_pg);
    lengths: (B,) valid tokens (0 = dead row, output discarded)."""
    return decode_attention_ref(
        q, gather_dense(k_arena, page_table).transpose(1, 2),
        gather_dense(v_arena, page_table).transpose(1, 2), lengths,
        window=window, softcap=softcap, scale=scale)


def partials_ref(q, k_arena, v_arena, page_table, lengths, begin, end, *,
                 window=None, softcap=None, scale=None):
    """One split's float32 partial of every row, as the kernel records it
    (csrc/paged_decode.cu): over the row's visible positions inside its
    pages ``[begin[b], end[b])``, ``acc`` (B, H, D) = sum of e^(s - m) v,
    ``m`` (B, H) the largest score and ``l`` (B, H) = sum of e^(s - m); an
    empty span gives (0, -1e30, 0)."""
    B, H, D = q.shape
    blk = k_arena.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kd, vd = gather_dense(k_arena, page_table), gather_dense(v_arena, page_table)
    group = H // kd.shape[1]
    s = torch.einsum("bhd,bhkd->bhk", q.float(),
                     kd.float().repeat_interleave(group, dim=1)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(kd.shape[2], device=q.device)[None]
    first = (lengths - window).clamp(min=0) if window else torch.zeros_like(lengths)
    mask = ((pos < lengths[:, None]) & (pos >= first[:, None])
            & (pos >= begin[:, None] * blk) & (pos < end[:, None] * blk))[:, None]
    s = torch.where(mask, s, -1e30)
    m = s.max(dim=-1).values
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhk,bhkd->bhd", p,
                       vd.float().repeat_interleave(group, dim=1))
    return acc, m, p.sum(dim=-1)


def combine_partials(acc, m, l):
    """The kernel's combine (split_combine.cuh) of the partials of each
    (row, head): acc (..., n_splits, D), m and l (..., n_splits) ->
    sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), zeros where no split
    saw a visible position."""
    M = m.max(dim=-1, keepdim=True).values
    w = torch.where(l > 0, torch.exp(m - M), 0.0)
    L = (l * w).sum(dim=-1, keepdim=True)
    out = (acc * w[..., None]).sum(dim=-2)
    return torch.where(L > 0, out / torch.where(L > 0, L, 1.0), 0.0)
