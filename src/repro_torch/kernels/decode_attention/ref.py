"""Plain PyTorch version of the dense decode kernel (port of
``repro/kernels/decode_attention/ref.py`` ``decode_attention_ref``):
one-token attention over a dense cache in float32, read in the slot
pool's serving layout ``(B, S, Hkv, D)``."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, lengths, *, window=None, softcap=None,
                         scale=None):
    """q: (B, H, D); k, v: (B, S, Hkv, D); lengths: (B,) valid positions
    per row -> (B, H, D).  A dead row (length 0) gets the reference's
    output, garbage by contract (the kernel writes zeros)."""
    B, H, D = q.shape
    S = k.shape[1]
    group = H // k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    kr = k.float().repeat_interleave(group, dim=2)
    vr = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), kr) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)[None, None]
    lengths = lengths[:, None, None]
    mask = pos < lengths
    if window is not None:
        mask &= pos >= lengths - window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, vr).to(q.dtype)
