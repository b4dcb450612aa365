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

Under ``constraints.model_shards`` of extent m (where the head width dh
divides it: ``tensor_parallel.mixer_splits``; the layer runs a mixer that
stays whole as the one rank of one) an mLSTM rank owns value
columns [r dh / m, (r + 1) dh / m) of every head (``_cols``), as the
cache rule splits C: its v, h and C.  h's columns are q C's columns over
max(|q n|, exp(-m)), and n and m depend only on k and the gates, so the
rank needs q and k whole: ``xc`` (conv channels chunked flat by the
rules) and its flat block of q and k (``w_q`` / ``w_k`` columns) are
gathered over the ranks (``gather_last``); its block of ``xi`` goes to
its columns of every head as v (``head_columns``), and the normed h back
to its flat block (``flat_channels``) for the gate z and ``w_down``'s
rows.  ``w_up``'s x | z columns are regrouped to its block of each
(``xz_columns``).  The gate product (``w_if`` rows) and the head norm's
sums of squares are partial over the ranks and summed both ways
(``all_sum``); the down-projection's partial sums are summed
(``reduce_out``).  ``if_bias`` and ``head_norm`` are whole on every rank,
which reads all of the one and its columns of the other: their gradients
are summed over the ranks (``copy_in``).  Every rank computes the chunk scores q k^T of every
head whole.

An sLSTM rank owns columns [r dh / m, (r + 1) dh / m) of every head, as
the rules split ``W``'s and ``R``'s last dim and the cache rule its
state: its columns of W x (x through ``copy_in``), of each gate, and of
h, c, n and m.  Each step's R h reads every column of h, so h is
gathered over the ranks before it (``gather_last``: the rank's gradient
for the whole h is partial, its own columns of R h, and is
reduce-scattered).  The head norm's sums of squares are summed over the
ranks (``all_sum``); ``bias`` and ``head_norm`` are whole on every rank,
which reads its columns of them (``copy_in``).  The normed h is gathered
once for the whole sequence: where the FFN's width divides the extent,
into the rank's columns of ``ffn_gate`` / ``ffn_up`` and rows of
``ffn_down``, the partial sums summed (``reduce_out``); else every rank
computes the FFN whole (``tensor_parallel.repeated``).  At extent 1
every collective here is the identity: one code path serves both.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import constraints
from repro_torch.distributed import tensor_parallel as tp
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
    """Head-wise RMS norm in float32: h (..., H, the rank's columns of
    each head) -> float32, the sums of squares summed over the model
    ranks."""
    hf = h.float()
    m = constraints.model().extent
    var = tp.all_sum(hf.square().sum(-1, keepdim=True)) / (hf.shape[-1] * m)
    return hf * torch.rsqrt(var + EPS) * scale.float()


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def _cols(dh: int) -> slice:
    """The columns of every head of width ``dh`` this rank computes (an
    mLSTM's value columns, an sLSTM's): its share over the installed
    'model' extent."""
    ms = constraints.model()
    n = dh // ms.extent
    return slice(ms.index * n, (ms.index + 1) * n)


def _mlstm_proj(cfg, p, x, conv_state=None):
    """x: (B, S, d) -> q, k (B, S, H, dh), v (B, S, H, the rank's
    columns) and z (B, S, the rank's channels) in the compute dtype,
    log_i, log_f (B, S, H) float32, the new conv state."""
    dt = cfg.compute_dtype
    di, H, dh = mlstm_dims(cfg)
    xi, z = (tp.copy_in(x) @ tp.xz_columns(p["w_up"], di).to(dt)).chunk(2, dim=-1)
    xc, new_conv = common.depthwise_conv(p["conv"].to(dt), xi, conv_state)
    xc = F.silu(xc)
    # the gate product in the compute dtype, then f32 and the bias
    # (xlstm.py:76-78): the ranks' partial products of the compute dtype's
    # operands in f32, summed, rounded once to the compute dtype, as the
    # whole product's accumulator is (the exponential input gate magnifies
    # a rounding)
    gates = tp.all_sum(xc.float() @ p["w_if"].to(dt).float()).to(dt)
    xc = tp.gather_last(xc)
    # q is scaled in the compute dtype, before the kernel (xlstm.py:72-73):
    # the kernel's own scale stays 1 on the model path
    q = (xc @ p["w_q"].to(dt)) * (1.0 / math.sqrt(dh))
    k = xc @ p["w_k"].to(dt)
    q, k = (tp.gather_last(t).unflatten(-1, (H, dh)) for t in (q, k))
    v = tp.head_columns(xi, H, dh)
    log_i, f_raw = (gates.float() + tp.copy_in(p["if_bias"]).float()).chunk(2, dim=-1)
    return q, k, v, log_i, F.logsigmoid(f_raw), z, new_conv


def _finish(cfg, p, h, z):
    """h: (B, S, H, the rank's columns) -> (B, S, d): head-wise RMS norm,
    gate, down-proj."""
    dt = cfg.compute_dtype
    hn = _head_norm(h, tp.copy_in(p["head_norm"])[:, _cols(mlstm_dims(cfg)[2])]).to(dt)
    return tp.reduce_out((tp.flat_channels(hn) * F.silu(z)) @ p["w_down"].to(dt))


def empty_mlstm_state(cfg, batch, device):
    """A new stream's state, of the rank's columns of C and conv
    channels."""
    di, H, dh = mlstm_dims(cfg)
    cols = _cols(dh)
    dv = cols.stop - cols.start
    C, n, m = mlstm_ref.empty_state(batch, H, dh, device, dv=dv)
    return {"C": C, "n": n, "m": m,
            "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, di * dv // dh),
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
    """A new stream's state, of the rank's columns of every head."""
    d, H, dh = slstm_dims(cfg)
    cols = _cols(dh)
    z = torch.zeros((batch, H, cols.stop - cols.start), dtype=torch.float32, device=device)
    return {"h": z, "c": z.clone(), "n": z.clone(),
            "m": torch.full_like(z, mlstm_ref.NEG)}


def _slstm_cell(Rf, bias, st, wx):
    """One step.  wx: (B, 4, H, the rank's columns) the float32 W x_t; Rf:
    (4, H, dh, the rank's columns); bias: (4, H, the rank's columns); st:
    {"h", "c", "n", "m"} (B, H, the rank's columns) float32.  h is
    gathered over the ranks for R h."""
    rec = torch.einsum("bhe,ghef->bghf", tp.gather_last(st["h"]), Rf)
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
    """The rank's columns of W x in float32 whatever the compute dtype
    (xlstm.py:241-242): (B, S, d) -> (B, S, 4, H, the rank's columns)."""
    B, S, d = x.shape
    W = p["W"].float()
    return (tp.copy_in(x).float() @ W.reshape(d, -1)).reshape(B, S, *W.shape[1:])


def _slstm_weights(cfg, p):
    """R's and the bias's float32 columns of this rank (the bias whole on
    every rank: ``copy_in``)."""
    return p["R"].float(), tp.copy_in(p["bias"]).float()[..., _cols(slstm_dims(cfg)[2])]


def slstm_forward(cfg, p, x, cache=None, return_cache=False):
    """Sequential sLSTM + GeGLU FFN.  x: (B, S, d) -> (B, S, d); cache:
    {"h", "c", "n", "m"} (the rank's columns) to continue from."""
    wx = _slstm_wx(cfg, p, x)
    st = cache if cache is not None else empty_slstm_state(cfg, x.shape[0],
                                                           x.device)
    st = {n: st[n] for n in ("h", "c", "n", "m")}
    Rf, bias = _slstm_weights(cfg, p)
    hs = []
    for t in range(x.shape[1]):
        st = _slstm_cell(Rf, bias, st, wx[:, t])
        hs.append(st["h"])
    out = _slstm_out(cfg, p, torch.stack(hs, dim=1))
    if return_cache:
        return out, st
    return out


def slstm_decode(cfg, p, x, cache):
    """Single-token decode.  x: (B, 1, d) -> (out, new cache)."""
    st = _slstm_cell(*_slstm_weights(cfg, p),
                     {n: cache[n] for n in ("h", "c", "n", "m")},
                     _slstm_wx(cfg, p, x)[:, 0])
    return _slstm_out(cfg, p, st["h"][:, None]), st


def _geglu(dt, hn, gate, up, down):
    """The sLSTM's GeGLU FFN (tanh gelu) on the normed h, (B, S, H, dh)
    read as (B, S, d), with (a rank's share of) its weights."""
    hn = hn.flatten(-2)
    g = F.gelu(hn @ gate.to(dt), approximate="tanh")
    return (g * (hn @ up.to(dt))) @ down.to(dt)


def _slstm_out(cfg, p, h):
    """Head-wise norm + GeGLU FFN (proj factor 4/3).  h: (B, S, H, the
    rank's columns) float32 -> (B, S, d): the normed h gathered over the
    ranks, then the FFN on the rank's columns of ``d_ff`` where it splits,
    else whole on every rank."""
    dt = cfg.compute_dtype
    d, _, dh = slstm_dims(cfg)
    hn = _head_norm(h, tp.copy_in(p["head_norm"])[:, _cols(dh)]).to(dt)
    w = (p["ffn_gate"], p["ffn_up"], p["ffn_down"])
    if tp.splits(int(cfg.xlstm.proj_factor_slstm * d)):
        return tp.reduce_out(_geglu(dt, tp.gather_last(hn), *w))
    return tp.repeated(functools.partial(_geglu, dt), hn, *w)
