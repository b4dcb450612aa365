"""Mamba mixer in chunked SSD form (port of ``repro/models/mamba.py``).

Scalar decay per head per step, head dim P, B and C of size N shared by
the heads; the sequence runs in chunks of L steps (``ssd_scan``, the
hand-written scan kernel for CUDA tensors, its plain version for CPU
tensors).  Decode keeps the O(1) recurrent state, h = a h + B xbar^T, in
plain torch: the one-token step is no TPU kernel.  Same numerics as the
reference: dt, the log decays and the state in float32, xbar, B and C in
the compute dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.models import common

HEAD_DIM = 128  # SSD head dim P


def dims(cfg):
    di = cfg.d_inner_mamba
    P = min(HEAD_DIM, di)
    return di, di // P, P, cfg.mamba.d_state


def _proj_scan_inputs(cfg, p, x):
    """x: (B, S, d) post-norm -> (x_in, z gate), each (B, S, di)."""
    xz = x @ p["w_in"].to(cfg.compute_dtype)
    return xz.chunk(2, dim=-1)


def _ssm_params(cfg, p, xc):
    """xc: (B, S, di) post-conv+act -> (xbar, loga, Bm, Cm, xh)."""
    dt_ = cfg.compute_dtype
    di, H, P, N = dims(cfg)
    B_, S, _ = xc.shape
    dt_raw = xc @ p["w_dt"].to(dt_)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())     # (B, S, H) f32
    A = -torch.exp(p["A_log"].float())                         # (H,)
    loga = dt * A                                              # log decay <= 0
    Bm = xc @ p["w_B"].to(dt_)
    Cm = xc @ p["w_C"].to(dt_)
    xh = xc.reshape(B_, S, H, P)
    xbar = xh * dt[..., None].to(xc.dtype)                     # x * dt
    return xbar, loga, Bm, Cm, xh


def ssd_scan(cfg, xbar, loga, Bm, Cm, h0=None):
    """xbar: (B, S, H, P); loga: (B, S, H) f32; Bm, Cm: (B, S, N).
    Returns y (B, S, H, P) and the final state (B, H, N, P) f32."""
    return mamba_scan(xbar.contiguous(), loga.contiguous(), Bm.contiguous(),
                      Cm.contiguous(), h0, chunk=cfg.mamba.chunk)


def _out(cfg, p, x, y, xh, z):
    dt_ = cfg.compute_dtype
    y = y + xh * p["D"].to(dt_)[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], cfg.d_inner_mamba)
    return (y * F.silu(z)) @ p["w_out"].to(dt_)


def mamba_forward(cfg, p, x, cache=None, return_cache: bool = False):
    """Full-sequence mixer.  x: (B, S, d) -> (B, S, d).  cache: {"conv":
    (B, dc-1, di), "h": (B, H, N, P) f32} to continue from; with
    ``return_cache`` also returns the new cache."""
    xi, z = _proj_scan_inputs(cfg, p, x)
    xc, new_conv = common.depthwise_conv(
        p["conv"].to(cfg.compute_dtype), xi,
        cache["conv"] if cache is not None else None)
    xbar, loga, Bm, Cm, xh = _ssm_params(cfg, p, F.silu(xc))
    y, h_fin = ssd_scan(cfg, xbar, loga, Bm, Cm,
                        cache["h"] if cache is not None else None)
    out = _out(cfg, p, x, y, xh, z)
    if return_cache:
        return out, {"conv": new_conv, "h": h_fin}
    return out


def mamba_decode(cfg, p, x, cache):
    """Single-token decode.  x: (B, 1, d) -> (out, new cache)."""
    xi, z = _proj_scan_inputs(cfg, p, x)
    xc, new_conv = common.depthwise_conv(p["conv"].to(cfg.compute_dtype), xi,
                                         cache["conv"])
    xbar, loga, Bm, Cm, xh = _ssm_params(cfg, p, F.silu(xc))
    a = torch.exp(loga[:, 0])                                  # (B, H)
    h = cache["h"] * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bm[:, 0].float(), xbar[:, 0].float())
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
    out = _out(cfg, p, x, y.to(cfg.compute_dtype)[:, None], xh, z)
    return out, {"conv": new_conv, "h": h}


def init_cache(cfg, batch: int, device, dtype=None):
    di, H, P, N = dims(cfg)
    return {"conv": torch.zeros((batch, cfg.mamba.d_conv - 1, di),
                                dtype=dtype or cfg.compute_dtype, device=device),
            "h": torch.zeros((batch, H, N, P), dtype=torch.float32,
                             device=device)}
