"""Plain PyTorch versions of the flash attention kernel (port of
``repro/kernels/flash_attention/ref.py``), dense and paged, in float32,
and of its backward kernel (``csrc/flash_attention_bwd.cu``): the dense
entry's gradients by the explicit formula."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.paged_decode.ref import gather_dense


def _wide(t):
    """t in float32, or float64 where it is (the gradient checks)."""
    return t if t.dtype == torch.float64 else t.float()


def _mask(q_pos, k_pos, causal, window):
    """(Sq, Skv) or (B, 1, Sq, Skv) bool: which keys each query sees."""
    qp = q_pos[..., :, None]
    mask = torch.ones_like(qp - k_pos, dtype=torch.bool)
    if causal:
        mask &= k_pos <= qp
    if window is not None:
        mask &= (qp - k_pos) < window
    return mask[:, None] if mask.dim() == 3 else mask     # per-row positions


def _attend(q, k, v, q_pos, k_pos, *, causal, window, softcap, scale):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Skv, D); q_pos: (B, Sq) or (Sq,);
    k_pos: (Skv,) -> (B, H, Sq, D) float32 (float64 for float64 inputs)."""
    group = q.shape[1] // k.shape[1]
    kr = _wide(k).repeat_interleave(group, dim=1)
    vr = _wide(v).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), kr) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(_mask(q_pos, k_pos, causal, window), s, -1e30)
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


def _dense_scores(q, k, causal, window, softcap, scale):
    """Scaled, soft-capped scores (B, H, Sq, Skv) float32 of the dense
    entry, tanh of the softcap (or None) and the mask."""
    group = q.shape[1] // k.shape[1]
    kr = _wide(k).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), kr) * scale
    th = None
    if softcap is not None:
        th = torch.tanh(s / softcap)
        s = softcap * th
    dev = q.device
    mask = _mask(torch.arange(q.shape[2], device=dev),
                 torch.arange(k.shape[2], device=dev), causal, window)
    return s, th, mask


def lse_ref(q, k, *, causal=True, window=None, softcap=None, scale=None):
    """Each query row's log-sum-exp over the keys it sees (the forward's
    lse output) -> (B, H, Sq) float32."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s, _, mask = _dense_scores(q, k, causal, window, softcap, scale)
    return torch.logsumexp(torch.where(mask, s, -1e30), dim=-1)


def attention_bwd_ref(q, k, v, o, do, lse, *, causal=True, window=None,
                      softcap=None, scale=None):
    """Gradients of ``attention_ref`` by the explicit formula, in float32:
    P = exp(s - lse) on the visible keys, dV = P^T dO, dP = dO V^T, Delta =
    rowsum(dO o O), dS = P (dP - Delta) (times 1 - tanh^2 under a softcap),
    dQ = scale dS K, dK = scale dS^T Q; dK and dV summed over each KV
    head's query heads.  q, o, do: (B, H, Sq, D); k, v: (B, Hkv, Skv, D);
    lse: (B, H, Sq) -> (dq, dk, dv) float32 (float64 for float64 inputs)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    s, th, mask = _dense_scores(q, k, causal, window, softcap, scale)
    p = torch.where(mask, torch.exp(s - _wide(lse)[..., None]), 0.0)
    dof, kr = _wide(do), _wide(k).repeat_interleave(group, dim=1)
    vr = _wide(v).repeat_interleave(group, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vr)
    delta = (dof * _wide(o)).sum(-1)
    ds = p * (dp - delta[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, _wide(q))
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return (dq, dk.reshape(B, Hkv, group, Skv, D).sum(2),
            dv.reshape(B, Hkv, group, Skv, D).sum(2))
