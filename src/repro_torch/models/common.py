"""Shared model primitives: norms, RoPE, activations, softcap, embedding
(port of ``repro/models/common.py``; same numerics: norms and RoPE
angles in float32, half-split rotation, tanh-approximate gelu), and the
causal depthwise conv of the Mamba and mLSTM mixers."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def apply_norm(cfg, p, x, eps: float = 1e-6):
    xf = x.float()
    if cfg.norm == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope_freqs(d_head: int, theta: float, device=None):
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    the two halves of D (not interleaved pairs)."""
    if theta <= 0:
        return x
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs           # (..., S, D/2)
    ang = ang[..., None, :]                              # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None):
    """(n, d) float32 table of the encoder's fixed positions: the sines of
    pos / 10000^(2i/d) in the first half of d, their cosines in the second."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def take_embedding(emb, tokens, scale: bool, dtype=None):
    """Embedding rows of ``tokens``, cast to ``dtype`` before the optional
    sqrt(d) scale (the reference casts the table, then gathers)."""
    x = emb[tokens]
    if dtype is not None:
        x = x.to(dtype)
    if scale:
        x = x * math.sqrt(emb.shape[-1])
    return x


def depthwise_conv(w, x, init_state=None):
    """Causal depthwise conv with dc taps (``repro/models/mamba.py``
    ``_depthwise_conv``, ``xlstm.py`` ``_conv_silu`` before its silu).
    x: (B, S, di); init_state: (B, dc-1, di) trailing inputs of the
    previous segment.  Returns the output (B, S, di) and the new trailing
    state."""
    dc = w.shape[0]
    if init_state is None:
        init_state = x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
    xp = torch.cat([init_state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i][None, None, :] for i in range(dc))
    return out, xp[:, xp.shape[1] - (dc - 1):]
