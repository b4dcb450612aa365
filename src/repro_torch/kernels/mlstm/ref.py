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


def empty_state(B, H, dh, device):
    """The start state of a new stream: C = 0, n = 0, m = -1e30."""
    return (torch.zeros((B, H, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, H, dh), dtype=torch.float32, device=device),
            torch.full((B, H), NEG, dtype=torch.float32, device=device))


def mlstm_ref(q, k, v, log_i, log_f, state=None, *, chunk, scale=1.0):
    """q, k, v: (B, S, H, dh); log_i, log_f: (B, S, H) float32; state: (C
    (B, H, dh, dh), n (B, H, dh), m (B, H)) float32 or None (a new
    stream); chunk: the chunk length L (``min(chunk, S)`` is used).
    Returns h (B, S, H, dh) in q's dtype and the final (C, n, m)."""
    B, S, H, dh = q.shape
    L = min(chunk, S)
    C, n, m = (empty_state(B, H, dh, q.device) if state is None
               else (t.float() for t in state))
    hs = []
    for t0 in range(0, S, L):
        sl = slice(t0, min(t0 + L, S))
        qf = q[:, sl].float() * scale
        kf, vf = k[:, sl].float(), v[:, sl].float()
        gi, gf = log_i[:, sl].float(), log_f[:, sl].float()      # (B, Lc, H)
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
    m = torch.full((B, H), NEG, dtype=torch.float32, device=log_i.device) \
        if m0 is None else m0.float()
    parts = []
    for t0 in range(0, S, L):
        gi, gf = log_i[:, t0:t0 + L].float(), log_f[:, t0:t0 + L].float()
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
    L = min(chunk, S)
    (b, m_new, inter, w), m = chunk_gates(
        log_i, log_f, None if state is None else state[2], L)
    boot = state is None and S <= L
    C, n, _ = (empty_state(B, H, dh, q.device) if state is None
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
                for f0 in range(0, dh, BOOT_COLS):
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
                for f0 in range(0, dh, COLS):
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
