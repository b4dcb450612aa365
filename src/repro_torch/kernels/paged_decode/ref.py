"""Plain PyTorch version of the paged decode kernel (port of
``repro/kernels/decode_attention/ref.py``): gather the row's pages into a
dense view, then one-token attention in float32."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, lengths, *, window=None, softcap=None,
                         scale=None):
    """q: (B, H, D); k, v: (B, Hkv, S, D); lengths: (B,) -> (B, H, D)."""
    B, H, D = q.shape
    S = k.shape[2]
    group = H // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), kr) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, None]
    lengths = lengths[:, None, None]
    mask = pos < lengths
    if window is not None:
        mask &= pos >= lengths - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p, vr).to(q.dtype)


def gather_dense(arena, page_table):
    """(P, BLOCK, Hkv, D) arena -> (B, Hkv, n_pg * BLOCK, D) per-row view."""
    B, n_pg = page_table.shape
    g = arena[page_table.reshape(-1).long()]
    return g.reshape(B, n_pg * arena.shape[1], *arena.shape[2:]).transpose(1, 2)


def paged_decode_attention_ref(q, k_arena, v_arena, page_table, lengths, *,
                               window=None, softcap=None, scale=None):
    """q: (B, H, D); arenas: (P, BLOCK, Hkv, D); page_table: (B, n_pg);
    lengths: (B,) valid tokens (0 = dead row, output discarded)."""
    return decode_attention_ref(q, gather_dense(k_arena, page_table),
                                gather_dense(v_arena, page_table), lengths,
                                window=window, softcap=softcap, scale=scale)
