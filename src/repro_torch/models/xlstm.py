"""xLSTM mixers (port of ``repro/models/xlstm.py``): chunkwise-parallel
mLSTM and sequential sLSTM.

mLSTM: C_t = f_t C_{t-1} + i_t k_t v_t^T, n_t = f_t n_{t-1} + i_t k_t,
h_t = (q_t C_t) / max(|q_t n_t|, exp(-m_t)), with exp input gates, sigmoid
forget gates in log space and the running-max stabilizer m.  The prompt
runs in chunks of 64 steps through ``mlstm_chunkwise`` (the hand-written
kernel for CUDA tensors, its plain version for CPU tensors); decode is the
one-step recurrence in plain torch, as in the reference (no TPU kernel).
The head width is ``di / H`` (1024 at full width), not ``cfg.d_head``.

sLSTM: a scalar memory per unit with block-diagonal recurrent matrices R
per head; its hidden-state feedback makes the prompt a Python loop over
time (the reference's ``lax.scan``).  Same numerics as the reference: gate
math and states in float32, sLSTM's ``W x`` a float32 product even when
serving in bf16.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm import ref as mlstm_ref
from repro_torch.kernels.mlstm.ops import mlstm_chunkwise
from repro_torch.models import common

EPS = 1e-6          # head-wise RMS norm
CHUNK = 64          # mLSTM chunk length (reference ``mlstm_forward``)


def mlstm_dims(cfg):
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    H = cfg.n_heads
    return di, H, di // H


def _head_norm(h, scale):
    """Head-wise RMS norm in float32: h (..., H, dh) -> float32."""
    hf = h.float()
    var = hf.square().mean(-1, keepdim=True)
    return hf * torch.rsqrt(var + EPS) * scale.float()


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def _mlstm_proj(cfg, p, x, conv_state=None):
    """x: (B, S, d) -> q, k, v (B, S, H, dh) and z (B, S, di) in the
    compute dtype, log_i, log_f (B, S, H) float32, the new conv state."""
    dt = cfg.compute_dtype
    di, H, dh = mlstm_dims(cfg)
    B, S, _ = x.shape
    xi, z = (x @ p["w_up"].to(dt)).chunk(2, dim=-1)
    xc, new_conv = common.depthwise_conv(p["conv"].to(dt), xi, conv_state)
    xc = F.silu(xc)
    # q is scaled in the compute dtype, before the kernel (xlstm.py:72-73):
    # the kernel's own scale stays 1 on the model path
    q = ((xc @ p["w_q"].to(dt)) * (1.0 / math.sqrt(dh))).reshape(B, S, H, dh)
    k = (xc @ p["w_k"].to(dt)).reshape(B, S, H, dh)
    v = xi.reshape(B, S, H, dh)
    # the gate product in the compute dtype, then f32 and the bias
    # (xlstm.py:76-78)
    gates = (xc @ p["w_if"].to(dt)).float() + p["if_bias"].float()
    log_i, f_raw = gates.chunk(2, dim=-1)
    return q, k, v, log_i, F.logsigmoid(f_raw), z, new_conv


def _finish(cfg, p, h, z):
    """h: (B, S, H, dh) -> (B, S, d): head-wise RMS norm, gate, down-proj."""
    dt = cfg.compute_dtype
    di = mlstm_dims(cfg)[0]
    hn = _head_norm(h, p["head_norm"]).to(dt).reshape(h.shape[0], h.shape[1], di)
    return (hn * F.silu(z)) @ p["w_down"].to(dt)


def empty_mlstm_state(cfg, batch, device):
    di, H, dh = mlstm_dims(cfg)
    C, n, m = mlstm_ref.empty_state(batch, H, dh, device)
    return {"C": C, "n": n, "m": m,
            "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, di),
                                dtype=cfg.compute_dtype, device=device)}


def mlstm_forward(cfg, p, x, cache=None, return_cache=False, chunk=CHUNK):
    """Chunkwise-parallel mLSTM.  x: (B, S, d) -> (B, S, d); cache: {"C",
    "n", "m", "conv"} to continue from; with ``return_cache`` also returns
    the new cache."""
    q, k, v, log_i, log_f, z, new_conv = _mlstm_proj(
        cfg, p, x, cache["conv"] if cache is not None else None)
    state = None if cache is None else tuple(cache[n] for n in ("C", "n", "m"))
    h, (C, n, m) = mlstm_chunkwise(q.contiguous(), k.contiguous(),
                                   v.contiguous(), log_i.contiguous(),
                                   log_f.contiguous(), state, chunk=chunk)
    out = _finish(cfg, p, h, z)
    if return_cache:
        return out, {"C": C, "n": n, "m": m, "conv": new_conv}
    return out


def mlstm_decode(cfg, p, x, cache):
    """Single-token decode.  x: (B, 1, d) -> (out, new cache)."""
    q, k, v, log_i, log_f, z, new_conv = _mlstm_proj(cfg, p, x, cache["conv"])
    qf, kf, vf = (a[:, 0].float() for a in (q, k, v))              # (B, H, dh)
    gi, gf = log_i[:, 0], log_f[:, 0]                              # (B, H)
    m_new = torch.maximum(gf + cache["m"], gi)
    f_s = torch.exp(gf + cache["m"] - m_new)[..., None]
    i_s = torch.exp(gi - m_new)[..., None]
    C = f_s[..., None] * cache["C"] + i_s[..., None] * (kf[..., :, None]
                                                        * vf[..., None, :])
    n = f_s * cache["n"] + i_s * kf
    num = torch.einsum("bhe,bhef->bhf", qf, C)
    den = torch.einsum("bhe,bhe->bh", qf, n).abs()
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    out = _finish(cfg, p, h[:, None].to(cfg.compute_dtype), z)
    return out, {"C": C, "n": n, "m": m_new, "conv": new_conv}


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_dims(cfg):
    d, H = cfg.d_model, cfg.n_heads
    return d, H, d // H


def empty_slstm_state(cfg, batch, device):
    d, H, dh = slstm_dims(cfg)
    z = torch.zeros((batch, H, dh), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full((batch, H, dh), mlstm_ref.NEG, dtype=torch.float32,
                            device=device)}


def _slstm_cell(Rf, bias, st, wx):
    """One step.  wx: (B, 4, H, dh) the float32 W x_t; st: {"h", "c", "n",
    "m"} (B, H, dh) float32."""
    rec = torch.einsum("bhe,ghef->bghf", st["h"], Rf)           # (B, 4, H, dh)
    pre = wx + rec + bias[None]
    zt = torch.tanh(pre[:, 0])
    gi = pre[:, 1]
    gf = F.logsigmoid(pre[:, 2])
    ot = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(gf + st["m"], gi)
    f_s = torch.exp(gf + st["m"] - m_new)
    i_s = torch.exp(gi - m_new)
    c = f_s * st["c"] + i_s * zt
    n = f_s * st["n"] + i_s
    h = ot * c / torch.clamp(n, min=1e-6)
    return {"h": h, "c": c, "n": n, "m": m_new}


def _slstm_wx(cfg, p, x):
    """W x in float32 whatever the compute dtype (xlstm.py:241-242):
    (B, S, d) -> (B, S, 4, H, dh)."""
    d, H, dh = slstm_dims(cfg)
    B, S, _ = x.shape
    return (x.float() @ p["W"].float().reshape(d, 4 * H * dh)).reshape(
        B, S, 4, H, dh)


def slstm_forward(cfg, p, x, cache=None, return_cache=False):
    """Sequential sLSTM + GeGLU FFN.  x: (B, S, d) -> (B, S, d); cache:
    {"h", "c", "n", "m"} to continue from."""
    wx = _slstm_wx(cfg, p, x)
    st = cache if cache is not None else empty_slstm_state(cfg, x.shape[0],
                                                           x.device)
    st = {n: st[n] for n in ("h", "c", "n", "m")}
    Rf, bias = p["R"].float(), p["bias"].float()
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_cell(Rf, bias, st, wx[:, t])
        hs.append(st["h"])
    out = _slstm_out(cfg, p, x, torch.stack(hs, dim=1))
    if return_cache:
        return out, st
    return out


def slstm_decode(cfg, p, x, cache):
    """Single-token decode.  x: (B, 1, d) -> (out, new cache)."""
    st = _slstm_cell(p["R"].float(), p["bias"].float(),
                     {n: cache[n] for n in ("h", "c", "n", "m")},
                     _slstm_wx(cfg, p, x)[:, 0])
    return _slstm_out(cfg, p, x, st["h"][:, None]), st


def _slstm_out(cfg, p, x, h):
    """Head-wise norm + GeGLU FFN (proj factor 4/3; tanh gelu).  h: (B, S,
    H, dh) float32."""
    dt = cfg.compute_dtype
    hn = _head_norm(h, p["head_norm"]).to(dt).reshape(x.shape[0], h.shape[1],
                                                      cfg.d_model)
    g = F.gelu(hn @ p["ffn_gate"].to(dt), approximate="tanh")
    return (g * (hn @ p["ffn_up"].to(dt))) @ p["ffn_down"].to(dt)
