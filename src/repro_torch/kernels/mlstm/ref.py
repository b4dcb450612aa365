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
