"""Plain PyTorch versions of the flash attention kernel (port of
``repro/kernels/flash_attention/ref.py``), dense and paged, in float32."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_decode.ref import gather_dense


def _attend(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D); q_pos: (B, Sq) or (Sq,);
    k_pos: (Skv,) -> (B, H, Sq, D) float32."""
    group = q.shape[1] // k.shape[1]
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_pos[..., :, None]
    mask = torch.ones_like(qp - k_pos, dtype=torch.bool)
    if causal:
        mask &= k_pos <= qp
    if window is not None:
        mask &= (qp - k_pos) < window
    if mask.dim() == 3:                                   # per-row positions
        mask = mask[:, None]
    s = torch.where(mask, s, -1e30)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vr)


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  scale=None):
    """q: (B, H, S, D); k, v: (B, Hkv, Skv, D) -> (B, H, S, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    dev = q.device
    o = _attend(q, k, v, torch.arange(q.shape[2], device=dev),
                torch.arange(k.shape[2], device=dev), causal=causal,
                window=window, softcap=softcap, scale=scale)
    return o.to(q.dtype)


def paged_attention_ref(q, k_arena, v_arena, page_table, pos0, active=None,
                        *, window=None, softcap=None, scale=None):
    """q: (B, Sq, H, D), query i of row b at position pos0[b] + i; arenas:
    (P, BLOCK, Hkv, D); page_table: (B, n_pg); active: (B,) bool or None.
    Causal over logical positions; dead rows are zeros.  -> (B, Sq, H, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    kd = gather_dense(k_arena, page_table)                # (B, Hkv, S, D)
    vd = gather_dense(v_arena, page_table)
    dev = q.device
    q_pos = pos0[:, None] + torch.arange(q.shape[1], device=dev)
    o = _attend(q.transpose(1, 2), kd, vd, q_pos,
                torch.arange(kd.shape[2], device=dev), causal=True,
                window=window, softcap=softcap, scale=scale).transpose(1, 2)
    if active is not None:
        o = torch.where(active[:, None, None, None], o, 0.0)
    return o.to(q.dtype)
