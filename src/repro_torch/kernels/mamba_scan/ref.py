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
        att = torch.where(mask, cb.float() * torch.exp(dec), 0.0)
        y_intra = torch.einsum("bhst,bthp->bshp", att.to(xb.dtype), xb)
        w = torch.exp(lcum[:, -1:] - lcum)                      # (B, L, H)
        hb = torch.einsum("bln,blhp->bhnp", bm.float(),
                          xb.float() * w[..., None])
        h = torch.exp(lcum[:, -1])[:, :, None, None] * h + hb
        ys.append(y_inter.to(xb.dtype) + y_intra)
    return torch.cat(ys, dim=1)[:, :S], h
