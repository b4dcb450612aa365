"""Plain PyTorch version of the chunked SSD scan kernel: the chunked form
of ``repro/models/mamba.py`` ``ssd_scan`` in the model's layouts, with the
reference's casts (``att`` and ``y`` in the input dtype, the state and the
decays in float32)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def wide(dtype):
    """The type the plain versions sum in: float32, or float64 for float64
    inputs (the tests' exact comparisons)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def mamba_scan_ref(xbar, loga, Bm, Cm, h0=None, *, chunk):
    """xbar: (B, S, H, P); loga: (B, S, H) float32; Bm, Cm: (B, S, N);
    h0: (B, H, N, P) float32 or None (zeros); chunk: the chunk length L
    (``min(chunk, S)`` is used; the tail is zero-padded).  Returns y (B, S,
    H, P) in xbar's dtype and the final state (B, H, N, P) float32 (float64
    for float64 inputs)."""
    ft = wide(xbar.dtype)
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
    h = (torch.zeros((Bsz, H, N, P), dtype=ft, device=xbar.device)
         if h0 is None else h0.to(ft))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xbar.device))
    ys = []
    for c in range(nchunks):
        sl = slice(c * L, (c + 1) * L)
        xb, la, bm, cm = xbar[:, sl], loga[:, sl].to(ft), Bm[:, sl], Cm[:, sl]
        lcum = torch.cumsum(la, dim=1)                          # (B, L, H)
        y_inter = torch.einsum("bln,bhnp->blhp", cm.to(ft), h) \
            * torch.exp(lcum)[..., None]
        cb = torch.einsum("bsn,btn->bst", cm, bm)[:, None]       # (B, 1, L, L)
        dec = (lcum[:, :, None, :] - lcum[:, None, :, :]).permute(0, 3, 1, 2)
        # the mask goes in before the exponential: above the diagonal dec > 0
        # and exp(dec) may overflow, whose gradient (0 * inf) would be NaN
        # (the reference's where-after-exp gives NaN gradients there)
        att = torch.where(mask, cb.to(ft) * torch.exp(torch.where(mask, dec, -torch.inf)),
                          0.0)
        y_intra = torch.einsum("bhst,bthp->bshp", att.to(xb.dtype), xb)
        w = torch.exp(lcum[:, -1:] - lcum)                      # (B, L, H)
        hb = torch.einsum("bln,blhp->bhnp", bm.to(ft),
                          xb.to(ft) * w[..., None])
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


# ---------------------------------------------------------------------------
# The backward's split (csrc/mamba_scan_bwd.cu), in plain PyTorch: what the
# CPU tests hold against autograd of ``mamba_scan_ref`` before a card sees it
# ---------------------------------------------------------------------------
def mamba_scan_bwd_tiled(xbar, loga, Bm, Cm, h0, dy, dh, *, chunk, rounding=None):
    """The gradients of ``mamba_scan_ref`` computed the way the backward
    kernels split them, all sums in float32 (float64 for float64 inputs):

    1. per chunk, in parallel: G_c = (C o e)^T dy_c, the gradient that the
       chunk's outputs send into its entering state (e = exp(lcum));
    2. per (b, h), serial over chunks: the entering states h_{c-1} rebuilt
       from the forward's chunk states S_c and decays a_c (its scratch,
       h_c = a_c h_{c-1} + S_c from h0), then the reverse pass dH_{c-1} =
       a_c dH_c + G_c from dh (zeros if None), dH_c the gradient of the
       state after chunk c, with da_c = <dH_c, h_{c-1}>; dH_{-1} is h0's
       gradient;
    3. per chunk, in parallel: dx = att^T dy + (B o w) dH_c, each head's
       share of dB and dC, and dloga, the reverse cumsum within the chunk
       of dlcum (terms from att's decays, from e, from w = exp(lcum_last -
       lcum) and from a_c);
    4. dB and dC summed over the heads in head order.

    att = tril(C B^T o exp(lcum_s - lcum_t)), the mask taken before the
    exponential (above the diagonal it may overflow).  ``rounding`` (None
    or "bf16", as the bf16 kernels) rounds once to bf16 what the tensor
    cores see of each float32 operand: C o e for G, att for att^T dy, B o
    w and dH_c for (B o w) dH_c and x dH_c^T, h_{c-1} for dy h_{c-1}^T, and
    datt o decay for the heads' dB and dC shares; datt = dy x^T is exact
    (bf16 inputs), and da_c, the row and column sums of datt o att and the
    state pass stay float32.  Arguments as ``mamba_scan_ref``; dy (B, S, H,
    P); dh (B, H, N, P) or None.  Returns (dx, dloga, dB, dC, dh0): dx, dB,
    dC in the inputs' dtypes, dloga and dh0 (None without h0) in the sum
    type."""
    ft = wide(xbar.dtype)
    rd = lambda t: _round(t, rounding)  # noqa: E731
    Bsz, S, H, P = xbar.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    x, dyf, bf, cf = (t.to(ft) for t in (xbar, dy, Bm, Cm))
    spans = [(t0, min(t0 + L, S)) for t0 in range(0, S, L)]
    lcum = torch.cat([torch.cumsum(loga[:, t0:t1].to(ft), dim=1) for t0, t1 in spans], dim=1)
    e = torch.exp(lcum)                                          # (B, S, H)
    w = torch.cat([torch.exp(lcum[:, t1 - 1:t1] - lcum[:, t0:t1]) for t0, t1 in spans], dim=1)
    decays = [e[:, t1 - 1] for _, t1 in spans]                   # a_c (B, H)
    zeros = torch.zeros((Bsz, H, N, P), dtype=ft, device=xbar.device)
    # the forward's chunk states, as its scratch holds them
    states = [torch.einsum("btn,bth,bthp->bhnp", bf[:, t0:t1], w[:, t0:t1], x[:, t0:t1])
              for t0, t1 in spans]
    grads_in = [torch.einsum("bshn,bshp->bhnp",
                             rd(cf[:, t0:t1, None, :] * e[:, t0:t1, :, None]), dyf[:, t0:t1])
                for t0, t1 in spans]                             # launch 1
    h = zeros if h0 is None else h0.to(ft)                       # launch 2
    entering = []
    for a, st in zip(decays, states):
        entering.append(h)
        h = a[..., None, None] * h + st
    dH = zeros if dh is None else dh.to(ft)
    d_after, da = [None] * len(spans), [None] * len(spans)
    for c in reversed(range(len(spans))):
        d_after[c] = dH
        da[c] = (dH * entering[c]).sum((2, 3))                   # (B, H)
        dH = decays[c][..., None, None] * dH + grads_in[c]
    dxs, dls, dBh, dCh = [], [], [], []
    for c, (t0, t1) in enumerate(spans):                         # launch 3
        n = t1 - t0
        xc, dyc, bc, cc = x[:, t0:t1], dyf[:, t0:t1], bf[:, t0:t1], cf[:, t0:t1]
        lc, ec, wc = lcum[:, t0:t1], e[:, t0:t1], w[:, t0:t1]
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=xbar.device))
        mask = mask[None, :, :, None]
        # the mask before the exponential: above the diagonal lc_s - lc_t > 0
        dec = torch.where(mask, torch.exp(torch.where(
            mask, lc[:, :, None, :] - lc[:, None, :, :], -torch.inf)), 0.0)  # (B, S, T, H)
        att = torch.einsum("bsn,btn->bst", cc, bc)[..., None] * dec
        dH_r = rd(d_after[c])
        bw = rd(bc[:, :, None, :] * wc[..., None])               # (B, T, H, N)
        dxs.append(torch.einsum("bsth,bshp->bthp", rd(att), dyc)
                   + torch.einsum("bthn,bhnp->bthp", bw, dH_r))
        datt = torch.where(mask, torch.einsum("bshp,bthp->bsth", dyc, xc), 0.0)
        dcb = rd(datt * dec)
        Z = torch.einsum("bshp,bhnp->bshn", dyc, rd(entering[c]))   # dy h_{c-1}^T
        U = torch.einsum("bthp,bhnp->bthn", xc, dH_r)               # x dH_c^T
        dCh.append(torch.einsum("bsth,btn->bshn", dcb, bc) + ec[..., None] * Z)
        dBh.append(torch.einsum("bsth,bsn->bthn", dcb, cc) + wc[..., None] * U)
        R = datt * att
        rw = wc * torch.einsum("btn,bthn->bth", bc, U)           # dw o w
        dlc = R.sum(2) - R.sum(1) + ec * torch.einsum("bsn,bshn->bsh", cc, Z) - rw
        last = rw.sum(1) + da[c] * decays[c]                     # into lcum_last
        dlc = torch.cat([dlc[:, :-1], dlc[:, -1:] + last[:, None]], dim=1)
        dls.append(torch.flip(torch.cumsum(torch.flip(dlc, (1,)), dim=1), (1,)))
    dB = torch.cat(dBh, dim=1).sum(2)                            # launch 4
    dC = torch.cat(dCh, dim=1).sum(2)
    return (torch.cat(dxs, dim=1).to(xbar.dtype), torch.cat(dls, dim=1), dB.to(Bm.dtype),
            dC.to(Cm.dtype), None if h0 is None else dH)
