"""Mamba mixer in chunked SSD form (port of ``repro/models/mamba.py``).

Scalar decay per head per step, head dim P, B and C of size N shared by
the heads; the sequence runs in chunks of L steps (``ssd_scan``, the
hand-written scan kernel for CUDA tensors, its plain version for CPU
tensors).  Decode keeps the O(1) recurrent state, h = a h + B xbar^T, in
plain torch: the one-token step is no TPU kernel.  Same numerics as the
reference: dt, the log decays and the state in float32, xbar, B and C in
the compute dtype.

Under ``constraints.model_shards`` of extent m (where the heads divide
it: ``tensor_parallel.mixer_splits``; the layer runs a mixer that stays
whole as the one rank of one) a rank computes its heads [r H / m,
(r + 1) H / m) (``_heads``): the conv channels and the rows of ``w_dt`` /
``w_B`` / ``w_C`` / ``w_out`` as the rules chunk them, which are its
heads' channels; ``w_in``'s columns, which the rules chunk flat over x |
z, regrouped to its heads' x and z channels (``tensor_parallel.
xz_columns``); ``A_log`` / ``D`` / ``dt_bias`` sliced to its heads
(their gradients summed over the ranks, ``copy_in``); the state of its
heads.  dt_raw, B and C are partial sums over the ranks'
channels that every head reads: summed over the ranks forward and their
gradients summed backward (``tensor_parallel.all_sum``), so the scan runs
on the rank's heads with B and C whole; the output projection's partial
sums are summed (``reduce_out``).  At extent 1 every one of these is the
identity: one code path serves both.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import constraints
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.models import common

HEAD_DIM = 128  # SSD head dim P


def dims(cfg):
    di = cfg.d_inner_mamba
    P = min(HEAD_DIM, di)
    return di, di // P, P, cfg.mamba.d_state


def _heads(cfg) -> slice:
    """The heads this rank computes: its share over the installed 'model'
    extent."""
    H = dims(cfg)[1]
    ms = constraints.model()
    n = H // ms.extent
    return slice(ms.index * n, (ms.index + 1) * n)


def _own(cfg, p, name):
    """The rank's heads of a leaf the rules leave whole (``A_log``, ``D``,
    ``dt_bias``): each rank reads its heads of it, so its gradient is
    summed over the model ranks (``copy_in``)."""
    return tp.copy_in(p[name])[_heads(cfg)]


def _proj_scan_inputs(cfg, p, x):
    """x: (B, S, d) post-norm -> (x_in, z gate), each (B, S, the rank's
    channels)."""
    w = tp.xz_columns(p["w_in"], cfg.d_inner_mamba)
    xz = tp.copy_in(x) @ w.to(cfg.compute_dtype)
    return xz.chunk(2, dim=-1)


def _ssm_params(cfg, p, xc):
    """xc: (B, S, the rank's channels) post-conv+act -> (xbar, loga, Bm,
    Cm, xh) of the rank's heads."""
    dt_ = cfg.compute_dtype
    di, H, P, N = dims(cfg)
    B_, S, _ = xc.shape
    # one product for dt, B and C: the ranks' channels' partial products
    # of the compute dtype's operands in float32, summed, rounded once to
    # the compute dtype, as the whole product's accumulator is
    w = torch.cat([p["w_dt"], p["w_B"], p["w_C"]], -1).to(dt_).float()
    dbc = tp.all_sum(xc.float() @ w).to(dt_)
    dt_raw, Bm, Cm = dbc.split([H, N, N], -1)
    dt_raw = dt_raw[..., _heads(cfg)]
    dt = F.softplus(dt_raw.float() + _own(cfg, p, "dt_bias").float())   # (B, S, h) f32
    A = -torch.exp(_own(cfg, p, "A_log").float())                       # (h,)
    loga = dt * A                                              # log decay <= 0
    xh = xc.reshape(B_, S, -1, P)
    xbar = xh * dt[..., None].to(xc.dtype)                     # x * dt
    return xbar, loga, Bm, Cm, xh


def ssd_scan(cfg, xbar, loga, Bm, Cm, h0=None):
    """xbar: (B, S, H, P); loga: (B, S, H) f32; Bm, Cm: (B, S, N).
    Returns y (B, S, H, P) and the final state (B, H, N, P) f32."""
    return mamba_scan(xbar.contiguous(), loga.contiguous(), Bm.contiguous(),
                      Cm.contiguous(), h0, chunk=cfg.mamba.chunk)


def _out(cfg, p, x, y, xh, z):
    dt_ = cfg.compute_dtype
    y = y + xh * _own(cfg, p, "D").to(dt_)[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], z.shape[-1])
    return tp.reduce_out((y * F.silu(z)) @ p["w_out"].to(dt_))


def mamba_forward(cfg, p, x, cache=None, return_cache: bool = False):
    """Full-sequence mixer.  x: (B, S, d) -> (B, S, d).  cache: {"conv":
    (B, dc-1, di), "h": (B, H, N, P) f32}, of the rank's channels and heads
    where they split, to continue from; with ``return_cache`` also returns
    the new cache."""
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
    """A new stream's cache, of the rank's channels and heads."""
    di, H, P, N = dims(cfg)
    heads = _heads(cfg)
    h = heads.stop - heads.start
    return {"conv": torch.zeros((batch, cfg.mamba.d_conv - 1, h * P),
                                dtype=dtype or cfg.compute_dtype, device=device),
            "h": torch.zeros((batch, h, N, P), dtype=torch.float32,
                             device=device)}
