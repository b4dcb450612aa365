"""Plain PyTorch version of the chunked SSD scan kernel: the chunked form
of ``repro/models/mamba.py`` ``ssd_scan`` in the model's layouts, with the
reference's casts (``att`` and ``y`` in the input dtype, the state and the
decays in float32)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def mamba_scan_ref(xbar, loga, Bm, Cm, h0=None, *, chunk):
    """xbar: (B, S, H, P); loga: (B, S, H) float32; Bm, Cm: (B, S, N);
    h0: (B, H, N, P) float32 or None (zeros); chunk: the chunk length L
    (``min(chunk, S)`` is used; the tail is zero-padded).  Returns y (B, S,
    H, P) in xbar's dtype and the final state (B, H, N, P) float32."""
    Bsz, S, H, P = xbar.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    nchunks = math.ceil(S / L)
    pad = nchunks * L - S
    if pad:
        xbar = F.pad(xbar, (0, 0, 0, 0, 0, pad))
        loga = F.pad(loga, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xbar.device)
         if h0 is None else h0.float())
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xbar.device))
    ys = []
    for c in range(nchunks):
        sl = slice(c * L, (c + 1) * L)
        xb, la, bm, cm = xbar[:, sl], loga[:, sl].float(), Bm[:, sl], Cm[:, sl]
        lcum = torch.cumsum(la, dim=1)                          # (B, L, H)
        y_inter = torch.einsum("bln,bhnp->blhp", cm.float(), h) \
            * torch.exp(lcum)[..., None]
        cb = torch.einsum("bsn,btn->bst", cm, bm)[:, None]       # (B, 1, L, L)
        dec = (lcum[:, :, None, :] - lcum[:, None, :, :]).permute(0, 3, 1, 2)
        # the mask goes in before the exponential: above the diagonal dec > 0
        # and exp(dec) may overflow, whose gradient (0 * inf) would be NaN
        # (the reference's where-after-exp gives NaN gradients there)
        att = torch.where(mask, cb.float() * torch.exp(torch.where(mask, dec, -torch.inf)),
                          0.0)
        y_intra = torch.einsum("bhst,bthp->bshp", att.to(xb.dtype), xb)
        w = torch.exp(lcum[:, -1:] - lcum)                      # (B, L, H)
        hb = torch.einsum("bln,blhp->bhnp", bm.float(),
                          xb.float() * w[..., None])
        h = torch.exp(lcum[:, -1])[:, :, None, None] * h + hb
        ys.append(y_inter.to(xb.dtype) + y_intra)
    return torch.cat(ys, dim=1)[:, :S], h


# ---------------------------------------------------------------------------
# The bf16 kernels' split (csrc/mamba_scan.cu), in plain PyTorch: what the
# CPU tests hold against the JAX kernel and the plain version before a card
# sees it
# ---------------------------------------------------------------------------
def _round(x, rounding):
    """What the tensor cores see of a float32 operand: x itself (None) or x
    rounded once to bf16 ("bf16"), in float32 arithmetic."""
    return x if rounding is None else x.to(torch.bfloat16).float()


def chunk_terms(loga, L):
    """Per chunk of L steps (the last one ragged): lcum, the inclusive cumsum
    of loga within the chunk, and from it w = exp(lcum_last - lcum) (a
    step's weight in the chunk's state) and e = exp(lcum); the chunk's total
    decay exp(lcum_last).  loga: (B, S, H).  Returns lcum, w, e (B, S, H)
    and the decays (B, n_chunks, H)."""
    parts, decays = [], []
    for t0 in range(0, loga.shape[1], L):
        lc = torch.cumsum(loga[:, t0:t0 + L].float(), dim=1)
        parts.append((lc, torch.exp(lc[:, -1:] - lc), torch.exp(lc)))
        decays.append(torch.exp(lc[:, -1]))
    lcum, w, e = (torch.cat(p, dim=1) for p in zip(*parts))
    return lcum, w, e, torch.stack(decays, dim=1)


def mamba_scan_tiled(xbar, loga, Bm, Cm, h0=None, *, chunk, rounding=None):
    """The chunked scan computed the way the bf16 kernels split it.

    * boot path (no h0 and one chunk, S <= L): one launch takes y = att x
      and the state h' = (B o w)^T x of the only chunk;
    * otherwise three launches: every chunk's own state S_c = (B o w)^T x
      and decay a_c = exp(lcum_last) (chunks in parallel); the state
      passing h_c = a_c h_{c-1} + S_c from h0, serial over chunks, which
      hands each chunk its entering state; every chunk's output y = att x
      + (C o e) h_{c-1} (chunks in parallel).

    att = tril(C B^T o exp(lcum_s - lcum_t)).  ``rounding`` ("bf16", as the
    bf16 kernels, or None) applies to the tensor cores' float32 operands:
    att, B o w, C o e and the entering state h_{c-1}; the products sum in
    float32, the state passes in float32, and y is rounded to xbar's dtype
    once.  Arguments and results as ``mamba_scan_ref``."""
    Bsz, S, H, P = xbar.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    lcum, w, e, decays = chunk_terms(loga, L)
    xf, bf, cf = xbar.float(), Bm.float(), Cm.float()
    n_chunks = decays.shape[1]
    spans = [(t0, min(t0 + L, S)) for t0 in range(0, S, L)]

    def att_x(t0, t1):
        lc = lcum[:, t0:t1]                                      # (B, Lc, H)
        n = t1 - t0
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=xbar.device))
        cb = torch.einsum("bsn,btn->bst", cf[:, t0:t1], bf[:, t0:t1])
        dec = torch.exp(lc[:, :, None, :] - lc[:, None, :, :])   # (B, S, T, H)
        att = torch.where(mask[None, :, :, None], cb[..., None] * dec, 0.0)
        return torch.einsum("bsth,bthp->bshp", _round(att, rounding), xf[:, t0:t1])

    def state(t0, t1):                                           # (B, H, N, P)
        bw = bf[:, t0:t1, None, :] * w[:, t0:t1, :, None]         # (B, Lc, H, N)
        return torch.einsum("bthn,bthp->bhnp", _round(bw, rounding), xf[:, t0:t1])

    if h0 is None and S <= L:                                    # the boot path
        return att_x(0, S).to(xbar.dtype), state(0, S)
    states = [state(t0, t1) for t0, t1 in spans]                 # launch 1
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=xbar.device)
         if h0 is None else h0.float())
    entering = []
    for c in range(n_chunks):                                    # launch 2
        entering.append(h)
        h = decays[:, c, :, None, None] * h + states[c]
    ys = []
    for (t0, t1), hc in zip(spans, entering):                    # launch 3
        ce = cf[:, t0:t1, None, :] * e[:, t0:t1, :, None]         # (B, Lc, H, N)
        y_inter = torch.einsum("bshn,bhnp->bshp", _round(ce, rounding),
                               _round(hc, rounding))
        ys.append((att_x(t0, t1) + y_inter).to(xbar.dtype))
    return torch.cat(ys, dim=1), h
