"""Plain PyTorch version of the chunkwise mLSTM kernel: what
``repro/kernels/mlstm/kernel.py`` ``_mlstm_kernel`` computes per chunk
(the stabilized chunkwise form of ``repro/models/xlstm.py``
``mlstm_forward``), in float32, in the model's layouts.  The ragged last
chunk is run at its own length instead of padded: the reference's padding
(``log_i = -60``, ``log_f = 0``, zero q, k, v) leaves m, C and n as they
were at the last real step."""
from __future__ import annotations

import torch

NEG = -1e30


def wide(dtype):
    """The type the plain versions sum in: float32, or float64 for float64
    inputs (the tests' exact comparisons)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def empty_state(B, H, dh, device, dtype=torch.float32, dv=None):
    """The start state of a new stream: C = 0 (dh x dv, ``dv`` default
    dh), n = 0, m = -1e30."""
    return (torch.zeros((B, H, dh, dh if dv is None else dv), dtype=dtype, device=device),
            torch.zeros((B, H, dh), dtype=dtype, device=device),
            torch.full((B, H), NEG, dtype=dtype, device=device))


def mlstm_ref(q, k, v, log_i, log_f, state=None, *, chunk, scale=1.0):
    """q, k: (B, S, H, dh); v: (B, S, H, dv), dv <= dh (a tensor-parallel
    rank's value columns of every head: h and C take v's columns, every
    column is independent of the others given q, k and the gates); log_i,
    log_f: (B, S, H) float32; state: (C (B, H, dh, dv), n (B, H, dh), m (B,
    H)) float32 or None (a new stream); chunk: the chunk length L
    (``min(chunk, S)`` is used).  Returns h (B, S, H, dv) in q's dtype and
    the final (C, n, m) (float32, float64 for float64 inputs)."""
    ft = wide(q.dtype)
    B, S, H, dh = q.shape
    L = min(chunk, S)
    C, n, m = (empty_state(B, H, dh, q.device, ft, v.shape[-1]) if state is None
               else (t.to(ft) for t in state))
    hs = []
    for t0 in range(0, S, L):
        sl = slice(t0, min(t0 + L, S))
        qf = q[:, sl].to(ft) * scale
        kf, vf = k[:, sl].to(ft), v[:, sl].to(ft)
        gi, gf = log_i[:, sl].to(ft), log_f[:, sl].to(ft)        # (B, Lc, H)
        Lc = gi.shape[1]
        b = torch.cumsum(gf, dim=1)             # inclusive cumulative log f
        gmb = torch.cummax(gi - b, dim=1).values
        m_new = b + torch.maximum(m[:, None], gmb)
        inter = torch.exp(b + m[:, None] - m_new)
        # gate[s, t] = exp(b_s - b_t + gi_t - m_new_s) for t <= s
        dmat = (b[:, :, None] - b[:, None, :] + gi[:, None, :]
                - m_new[:, :, None])                             # (B, S, T, H)
        mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                     device=q.device))
        gate = torch.where(mask[None, :, :, None], torch.exp(dmat), 0.0)
        att = gate * torch.einsum("bshe,bthe->bsth", qf, kf)
        num = (torch.einsum("bsth,bthe->bshe", att, vf)
               + inter[..., None] * torch.einsum("bshe,bhef->bshf", qf, C))
        den = att.sum(2) + inter * torch.einsum("bshe,bhe->bsh", qf, n)
        h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
        hs.append(h.to(q.dtype))
        # the state at the chunk's last step
        kw = kf * gate[:, -1][..., None]                         # (B, T, H, dh)
        C = (inter[:, -1][:, :, None, None] * C
             + torch.einsum("bthe,bthf->bhef", kw, vf))
        n = inter[:, -1][..., None] * n + kw.sum(1)
        m = m_new[:, -1]
    return torch.cat(hs, dim=1), (C, n, m)


# ---------------------------------------------------------------------------
# The kernels' split (csrc/mlstm.cu), in plain PyTorch: what the CPU tests
# hold against the reference before a card sees it
# ---------------------------------------------------------------------------
E_TILE = 64        # rows of C (e) in a tensor-core tile
COLS = 32          # columns of C (f) a recurrent block owns
BOOT_COLS = 64     # columns of C a boot block owns


def chunk_gates(log_i, log_f, m0, L):
    """The gates of every chunk, as the scores kernels work them out before
    any product: a chunk moves the carried m only by ``m <- b_last +
    max(m, run_last)`` (``b`` its cumsum of log f, ``run`` the cummax of
    log i - b), so the chunks before one are summarized and chained, and
    its own steps' gates follow.  log_i, log_f: (B, S, H); m0: (B, H) or
    None.  Returns (b, m_new, inter, w), each (B, S, H) (``w``: a step's
    weight in its chunk's state update, ``gate[Lc - 1]``), and the final m."""
    B, S, H = log_i.shape
    ft = wide(log_i.dtype)
    m = torch.full((B, H), NEG, dtype=ft, device=log_i.device) \
        if m0 is None else m0.to(ft)
    parts = []
    for t0 in range(0, S, L):
        gi, gf = log_i[:, t0:t0 + L].to(ft), log_f[:, t0:t0 + L].to(ft)
        b = torch.cumsum(gf, dim=1)
        run = torch.cummax(gi - b, dim=1).values
        m_new = b + torch.maximum(m[:, None], run)
        inter = torch.exp(b + m[:, None] - m_new)
        w = torch.exp(b[:, -1:] - b + gi - m_new[:, -1:])
        parts.append((b, m_new, inter, w))
        m = b[:, -1] + torch.maximum(m, run[:, -1])           # the chain step
    return tuple(torch.cat(p, dim=1) for p in zip(*parts)), m


def _operand(x, rounding):
    """What the tensor cores see of a float32 operand x, in float32
    arithmetic: x itself (``rounding`` None), x rounded once to bf16
    ("bf16"), or the bf16 kernel's pair hi + lo ("pair": hi = x rounded,
    lo = x - hi rounded, one wgmma each, ~16 significant bits)."""
    if rounding is None:
        return x
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float() if rounding == "pair" else hi


def mlstm_tiled(q, k, v, log_i, log_f, state=None, *, chunk, scale=1.0,
                rounding=None):
    """The chunkwise mLSTM computed the way csrc/mlstm.cu splits it: the
    gate pre-pass over all chunks (``chunk_gates``); per chunk the scores
    kernels' record (att and rowsum(att), float32); then either the no-state
    boot path (no state and one chunk: C' = (k o w)^T v in E_TILE x
    BOOT_COLS tiles, n' = sum of k o w, h = att v / max(|rowsum|,
    exp(-m_new))) or the recurrent blocks' walk, where q C sums the
    E_TILE-row tiles of C (each read before it moves) and each (e, f) tile
    moves to decay C + (k o w)^T v.  ``rounding`` ("pair", as the bf16
    kernels, or "bf16") applies to the float32 operands of the bf16
    kernels' products (``_operand``): att for att v, k o w for the state
    update and the copy of C that q C reads; q n, rowsum and the carried
    state stay float32.  Arguments and results as ``mlstm_ref``."""
    B, S, H, dh = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    (b, m_new, inter, w), m = chunk_gates(
        log_i, log_f, None if state is None else state[2], L)
    boot = state is None and S <= L
    C, n, _ = (empty_state(B, H, dh, q.device, dv=dv) if state is None
               else (t.float() for t in state))
    C = C.clone()
    hs = []
    for t0 in range(0, S, L):
        sl = slice(t0, min(t0 + L, S))
        qc, kc, vc = (x[:, sl].float() for x in (q, k, v))
        gb, gi, mn, it, ww = (x[:, sl].float() for x in (b, log_i, m_new, inter, w))
        Lc = qc.shape[1]
        mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=q.device))
        gate = torch.exp(gb[:, :, None] - gb[:, None, :] + gi[:, None, :]
                         - mn[:, :, None])                        # (B, S, T, H)
        att = torch.where(mask[None, :, :, None],
                          gate * torch.einsum("bshe,bthe->bsth", qc, kc) * scale, 0.0)
        rowsum = att.sum(2)
        kw = kc * ww[..., None]
        kw_r = _operand(kw, rounding)
        num = torch.einsum("bsth,bthf->bshf", _operand(att, rounding), vc)
        if boot:
            for e0 in range(0, dh, E_TILE):
                for f0 in range(0, dv, BOOT_COLS):
                    es, fs = slice(e0, e0 + E_TILE), slice(f0, f0 + BOOT_COLS)
                    C[:, :, es, fs] = torch.einsum("bthe,bthf->bhef", kw_r[..., es],
                                                   vc[..., fs])
            n = kw.sum(1)
            den = rowsum
        else:
            decay = it[:, -1]                                     # (B, H)
            qn = torch.einsum("bshe,bhe->bsh", qc, n)
            qC = torch.zeros_like(num)
            for e0 in range(0, dh, E_TILE):
                for f0 in range(0, dv, COLS):
                    es, fs = slice(e0, e0 + E_TILE), slice(f0, f0 + COLS)
                    tile = C[:, :, es, fs]
                    qC[..., fs] += torch.einsum("bshe,bhef->bshf", qc[..., es],
                                                _operand(tile, rounding))
                    C[:, :, es, fs] = (decay[:, :, None, None] * tile
                                       + torch.einsum("bthe,bthf->bhef",
                                                      kw_r[..., es], vc[..., fs]))
            n = decay[..., None] * n + kw.sum(1)
            num = num + it[..., None] * (scale * qC)
            den = rowsum + it * (scale * qn)
        h = num / torch.maximum(den.abs(), torch.exp(-mn))[..., None]
        hs.append(h.to(q.dtype))
    return torch.cat(hs, dim=1), (C, n, m)


# ---------------------------------------------------------------------------
# The backward's split (csrc/mlstm_bwd.cu), in plain PyTorch: what the CPU
# tests hold against autograd of ``mlstm_ref`` before a card sees it
# ---------------------------------------------------------------------------
def _dot(a, b):
    """<a, b> over every axis past (B, H)."""
    return (a * b).flatten(2).sum(-1)


# The float32 operands of the bf16 backward's tensor-core products
# (csrc/mlstm_bwd.cu), by name: C for dh . (Q C) and k o w for the state
# update in the states sweep; C_prev, the entering state the scratch keeps
# for dq's C_{c-1} dnum; dC_rows, the carried gradient read by dC v (the row
# sweep), and dC_cols, by k dC (the column sweep); upd, the scaled operand
# of dC's update (inter o dnum o Q); dS for dS^T Q and dS k; att for att^T
# dnum.  q, k, v and dh are bf16 already.
BWD_OPERANDS = ("C", "kw", "C_prev", "dC_rows", "dC_cols", "upd", "dS", "att")
# what the bf16 backward gives each: a hi + lo pair to C (X = dh . (Q C)
# feeds dden = -(dh . num) / M^2, through the cancelling denominator, as C
# feeds the forward's h) and to dC_cols (dv = w (k dC) + ...: k dC sums
# dh's rows of 1024 columns of a carried gradient that grows over the
# chunks), one rounding to bf16 to the rest; at xlstm's training length
# (dh = 1024, 16 chunks of 64) one rounding of either moves a gradient past
# the 2e-2 gate on some seeds, while the rest rounded once leave every
# gradient within a third of it (tests/test_torch_mlstm_bwd.py)
BWD_ROUNDING = {**dict.fromkeys(BWD_OPERANDS, "bf16"), "C": "pair", "dC_cols": "pair"}


def _bwd_rounding(rounding):
    """operand -> rounding (None, "bf16" or "pair") from ``rounding``: None,
    one mode for every operand, or a dict (operands it leaves out: None)."""
    if isinstance(rounding, dict):
        assert set(rounding) <= set(BWD_OPERANDS), rounding
        return {k: rounding.get(k) for k in BWD_OPERANDS}
    return dict.fromkeys(BWD_OPERANDS, rounding)


def mlstm_bwd_tiled(q, k, v, log_i, log_f, state, dh, dstate=None, *, chunk,
                    scale=1.0, rounding=None):
    """The gradients of ``mlstm_ref`` computed the way the backward kernels
    split them, every sum in float32 (float64 for float64 inputs), with the
    stabiliser m, m_new and inter held constant: with num_u and den_u the
    unstabilised sums, h = num_u / max(|den_u|, 1) does not depend on m, so
    autograd's terms through ``cummax`` and ``maximum`` cancel (up to
    rounding).  Only the final state, stabilised by the final m, does
    depend on it: C_fin = exp(-m_fin) C_u, so a final-state gradient sends
    g_m = dm_fin - <dC_fin, C_fin> - <dn_fin, n_fin> into m_fin, which
    reaches log i and log f through the one step (or m0) whose running max
    it is; and m0, paired with C0 and n0, gets <dC0, C0> + <dn0, n0>.

    The launches: (1) per chunk the gates, S = Q k^T (Q = scale q), att =
    gate o S, rowsum and DV = dh v^T; (2) per (b, h) the states sweep: each
    chunk's entering C and n, qn = Q n and X = dh . (Q C), the part of dh .
    num that goes through the state; (3) per chunk the step scalars: den,
    M = max(|den|, exp(-m_new)), dden (sign(den) where |den| wins, nothing
    where exp(-m_new) does), datt = DV / M + dden, dS = datt o gate, and
    the gate gradients of att and inter; (4) the reverse sweep dC_{c-1} =
    inter_L dC_c + sum_s inter_s Q_s^T dnum_s (dnum = dh / M) and dn alike,
    from the final state's gradient; (5) rows e of dQ and dk, and dw; (6)
    columns f of dv; (7) the gate gradients summed, log f's as a reverse
    cumsum within each chunk, and the m terms.

    ``rounding`` (None, "bf16", "pair", or a dict of ``BWD_OPERANDS``)
    applies to the float32 operands of the bf16 kernels' products what the
    tensor cores see of them (``_operand``); ``BWD_ROUNDING`` is the bf16
    kernels' choice.  The row and the column sweeps carry dC each with its
    own update (the scale on dh's side in one, on Q's in the other), so
    with a rounding the mirror carries both: the row sweep's for dk, dw,
    d inter_L and dC0, the column sweep's for dv.  Arguments as
    ``mlstm_ref``; dh (B, S, H, dh); dstate (dC, dn, dm), each None for
    zeros, or None.  Returns (dq, dk, dv, dlog_i, dlog_f, (dC0, dn0, dm0)
    or None without a state)."""
    r = _bwd_rounding(rounding)
    ft = wide(q.dtype)
    B, S, H, dh_ = q.shape
    L = min(chunk, S)
    dev = q.device
    m0 = None if state is None else state[2].to(ft)
    (b, m_new, inter, w), m_fin = chunk_gates(log_i, log_f, m0, L)
    gi_all = log_i.to(ft)
    Q, kf, vf, dhf = (x.to(ft) for x in (q, k, v, dh))
    Q = Q * scale
    spans = [(t0, min(t0 + L, S)) for t0 in range(0, S, L)]
    C, n, _ = (empty_state(B, H, dh_, dev, ft, v.shape[-1]) if state is None
               else (t.to(ft) for t in state))
    C0, n0 = C, n
    chunks = []
    for t0, t1 in spans:                                         # launches 1-3
        sl = slice(t0, t1)
        Lc = t1 - t0
        Qc, kc, vc, dc = Q[:, sl], kf[:, sl], vf[:, sl], dhf[:, sl]
        gb, gi, mn, it, ww = b[:, sl], gi_all[:, sl], m_new[:, sl], inter[:, sl], w[:, sl]
        mask = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=dev))[None, :, :, None]
        gate = torch.where(mask, torch.exp(torch.where(
            mask, gb[:, :, None] - gb[:, None, :] + gi[:, None, :] - mn[:, :, None],
            -torch.inf)), 0.0)                                   # (B, S, T, H)
        att = gate * torch.einsum("bshe,bthe->bsth", Qc, kc)
        DV = torch.einsum("bshf,bthf->bsth", dc, vc)
        qn = torch.einsum("bshe,bhe->bsh", Qc, n)
        X = torch.einsum("bshf,bshf->bsh", dc,
                         torch.einsum("bshe,bhef->bshf", Qc, _operand(C, r["C"])))
        den = att.sum(2) + it * qn
        floor = torch.exp(-mn)
        M = torch.maximum(den.abs(), floor)
        hn = (att * DV).sum(2) + it * X                          # dh . num
        dden = torch.where(den.abs() > floor, -hn / M ** 2 * torch.sign(den), 0.0)
        datt = torch.where(mask, DV / M[:, :, None] + dden[:, :, None], 0.0)
        R = datt * att
        dinter = X / M + dden * qn
        chunks.append(dict(sl=sl, C=_operand(C, r["C_prev"]), n=n, gate=gate, att=att, M=M,
                           dden=dden, dS=datt * gate, db=R.sum(2) - R.sum(1) + dinter * it,
                           dgi=R.sum(1), w=ww, it=it))
        # the state after the chunk
        kw = _operand(ww[..., None] * kc, r["kw"])
        C = it[:, -1][..., None, None] * C + torch.einsum("bthe,bthf->bhef", kw, vc)
        n = it[:, -1][..., None] * n + torch.einsum("bth,bthe->bhe", ww, kc)
    dC_fin, dn_fin, dm_fin = dstate if dstate is not None else (None, None, None)
    dC = torch.zeros_like(C) if dC_fin is None else dC_fin.to(ft)
    dC_col = dC                                                  # the column sweep's
    dn = torch.zeros_like(n) if dn_fin is None else dn_fin.to(ft)
    g_m = -_dot(dC, C) - _dot(dn, n) + (0.0 if dm_fin is None else dm_fin.to(ft))
    dQ, dk, dv = torch.zeros_like(Q), torch.zeros_like(kf), torch.zeros_like(vf)
    db, dgi = torch.zeros_like(b), torch.zeros_like(b)
    for ch in reversed(chunks):                                  # launches 4-6
        sl, it, ww = ch["sl"], ch["it"], ch["w"]
        Qc, kc, vc, dc = Q[:, sl], kf[:, sl], vf[:, sl], dhf[:, sl]
        inv_m = 1.0 / ch["M"]
        dS = _operand(ch["dS"], r["dS"])
        U = torch.einsum("bhef,bthf->bthe", _operand(dC, r["dC_rows"]), vc) + dn[:, None]
        dk[:, sl] = ww[..., None] * U + torch.einsum("bsth,bshe->bthe", dS, Qc)
        Y = inv_m[..., None] * torch.einsum("bhef,bshf->bshe", ch["C"], dc)  # C_{c-1} dnum
        dQ[:, sl] = it[..., None] * (Y + ch["dden"][..., None] * ch["n"][:, None]) \
            + torch.einsum("bsth,bthe->bshe", dS, kc)
        att_m = _operand(ch["att"] * inv_m[:, :, None], r["att"])   # att o (1 / M), rows s
        dv[:, sl] = ww[..., None] * torch.einsum("bthe,bhef->bthf", kc,
                                                 _operand(dC_col, r["dC_cols"])) \
            + torch.einsum("bsth,bshf->bthf", att_m, dc)
        rw = ww * (kc * U).sum(-1)                               # dw o w
        d_inter_last = _dot(dC, ch["C"]) + _dot(dn, ch["n"])
        dbc = ch["db"] - rw
        dbc[:, -1] += rw.sum(1) + d_inter_last * it[:, -1]
        db[:, sl] = dbc
        dgi[:, sl] = ch["dgi"] + rw
        g = (it * inv_m)[..., None]                              # inter o (1 / M)
        decay = it[:, -1][..., None, None]
        dC = decay * dC + torch.einsum("bshe,bshf->bhef", _operand(g * Qc, r["upd"]), dc)
        dC_col = decay * dC_col + torch.einsum("bshe,bshf->bhef", Qc,
                                               _operand(g * dc, r["upd"]))
        dn = it[:, -1][..., None] * dn + torch.einsum("bsh,bshe->bhe", it * ch["dden"], Qc)
    dlog_f = torch.cat([torch.flip(torch.cumsum(torch.flip(db[:, t0:t1], (1,)), 1), (1,))
                        for t0, t1 in spans], dim=1)             # launch 7
    # m_fin's step: the last chunk whose running max passed the carried m
    m = torch.full((B, H), NEG, dtype=ft, device=dev) if m0 is None else m0
    winner = torch.full((B, H), -1, dtype=torch.long, device=dev)   # -1: m0
    for t0, t1 in spans:
        gcum = torch.cumsum(log_f[:, t0:t1].to(ft), 1)
        run, arg = (gi_all[:, t0:t1] - gcum).max(1)
        winner = torch.where(run > m, arg + t0, winner)
        m = gcum[:, -1] + torch.maximum(m, run)
    steps = torch.arange(S, device=dev)[None, :, None]
    dlog_f = dlog_f + g_m[:, None] * (steps > winner[:, None]).to(ft)
    dlog_i = dgi + g_m[:, None] * (steps == winner[:, None]).to(ft)
    dstate0 = None
    if state is not None:
        dstate0 = (dC, dn, _dot(dC, C0) + _dot(dn, n0) + g_m * (winner < 0).to(ft))
    return (scale * dQ).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dlog_i, dlog_f, dstate0
