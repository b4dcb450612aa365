"""Mixture-of-Experts FFN with sort-based dispatch (port of
``repro/models/moe.py`` ``moe_ffn``, with its Switch load-balance aux
loss).

Tokens are cut into G dispatch groups; per group the (token, k) slots are
stably sorted by expert and written into a dense (E, C, d) buffer, slots
past an expert's capacity C dropped; the experts run as batched products
over that buffer, and each slot's output is gathered back, weighted by its
renormalised gate.  Same numerics as the reference: the router in float32,
the buffer and the experts in the compute dtype.

Under ``constraints.model_shards``, where the experts split over 'model',
a rank runs its E/m experts over its dispatch buffer and combines their
slots' outputs, and the ranks' partial sums are summed
(``tensor_parallel.reduce_out``); routing, capacity and the drop are the
same on every model rank.  The shared experts split as the dense FFN
(columns of ``w_gate`` / ``w_up``, rows of ``w_down``) where their
``d_ff`` divides.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed import _functional_collectives as funcol

from repro_torch.distributed import constraints
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models import common


def _n_groups(batch: int) -> int:
    """Dispatch groups: the installed mesh's DP extent where it divides the
    batch, else the largest divisor of the batch up to 16: ``gcd(dp_extent
    or 16, batch)``.  On a rank's batch slice (``constraints.batch_slices``)
    the DP extent divides the global batch, so each rank holds one of those
    groups."""
    if constraints.dp_group() is not None:
        return 1
    return math.gcd(constraints.dp_extent() or 16, batch)


def _glu(cfg, p, x, eq_in, eq_out):
    dt = cfg.compute_dtype
    act = common.act_fn(cfg.act)
    g = torch.einsum(eq_in, x, p["w_gate"].to(dt))
    u = torch.einsum(eq_in, x, p["w_up"].to(dt))
    return torch.einsum(eq_out, act(g) * u, p["w_down"].to(dt))


def moe_ffn(cfg, p, x, capacity_factor: Optional[float] = None,
            return_aux: bool = False):
    """x: (B, S, d) -> (B, S, d) [, aux loss]: with ``return_aux`` also the
    Switch load-balance loss ``E * sum(frac_tokens * mean_probs)``, each
    factor averaged over the dispatch groups: ``frac_tokens`` the share of
    a group's (token, k) slots routed to each expert (before the capacity
    drop), ``mean_probs`` the group's mean router probability of each.  On
    a rank's batch slice the loss is this rank's share: ``frac_tokens``
    averaged over the DP ranks' groups, times this group's probabilities
    over the DP extent, so the shares sum over the ranks to the loss of the
    whole batch and its gradient."""
    m = cfg.moe
    cf = m.capacity_factor if capacity_factor is None else capacity_factor
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    dt = cfg.compute_dtype
    G = _n_groups(B)
    Tg = T // G
    C = max(1, math.ceil(Tg * k / E * cf))
    xt = constraints.pin(x.reshape(G, Tg, d), ("batch", None, None))
    dev = x.device

    split = tp.splits(E)        # this rank's experts [e0, e0 + E_loc)
    E_loc = E // constraints.model().extent if split else E
    e0 = constraints.model().index * E_loc if split else 0

    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)  # (G,Tg,E)
    gate_w, expert_ix = torch.topk(probs, k, dim=-1)                 # (G,Tg,k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = expert_ix.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    tok_of_slot = order // k
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev)
                                .expand(G, E).contiguous())
    pos_in_e = torch.arange(Tg * k, device=dev) - torch.gather(starts, 1, sorted_e)
    keep = pos_in_e < C                                 # capacity drop
    # dropped slots land in a spare slot C of each expert (no host sync
    # for a boolean index), which the experts never see
    pos_c = torch.where(keep, pos_in_e, C)
    g_ix = torch.arange(G, device=dev)[:, None].expand(G, Tg * k)
    w_sorted = torch.gather(gate_w.reshape(G, Tg * k), 1, order).to(dt)
    if split:   # the other ranks' slots land in a spare expert E_loc
        local_e = sorted_e - e0
        mine = (local_e >= 0) & (local_e < E_loc)
        e_buf, rows, use = torch.where(mine, local_e, E_loc), E_loc + 1, keep & mine
        xt, w_sorted = tp.copy_in(xt), tp.copy_in(w_sorted)
    else:
        e_buf, rows, use = sorted_e, E, keep
    buf = torch.zeros((G, rows, C + 1, d), dtype=dt, device=dev)
    src = torch.gather(xt, 1, tok_of_slot[..., None].expand(G, Tg * k, d))
    buf[g_ix, e_buf, pos_c] = src.to(dt)
    # experts on the model axis where the weights live, groups on the DP axes
    buf = constraints.pin(buf[:, :E_loc, :C], ("batch", "model", None, None))
    out_buf = _glu(cfg, p, buf, "gecd,edf->gecf", "gecf,efd->gecd")
    out_buf = constraints.pin(out_buf, ("batch", None, None, None))

    pad = (0, 0, 0, 1, 0, 1) if split else (0, 0, 0, 1)
    slot_out = torch.nn.functional.pad(out_buf, pad)[g_ix, e_buf, pos_c]
    contrib = slot_out * (w_sorted * use.to(dt))[..., None]
    out = torch.zeros((G, Tg, d), dtype=dt, device=dev)
    out.scatter_add_(1, tok_of_slot[..., None].expand(G, Tg * k, d), contrib)
    out = constraints.pin(out, ("batch", None, None)).reshape(T, d)
    partial, whole = (out, None) if split else (None, out)
    if m.num_shared:
        sh_split = tp.splits(m.num_shared * m.d_ff_expert)
        sh = _glu(cfg, p["shared"], (tp.copy_in(x) if sh_split else x).reshape(T, d).to(dt),
                  "td,df->tf", "tf,fd->td")
        if sh_split:
            partial = sh if partial is None else partial + sh
        else:
            whole = whole + sh if whole is not None else sh
    if partial is not None:
        partial = tp.reduce_out(partial)
    out = partial if whole is None else whole if partial is None else partial + whole
    out = out.reshape(B, S, d)
    if not return_aux:
        return out
    frac = torch.zeros((G, E), dtype=torch.float32, device=dev)
    frac.scatter_add_(1, flat_e, torch.ones_like(flat_e, dtype=torch.float32))
    frac = (frac / (Tg * k)).mean(0)
    mean_probs = probs.mean(1).mean(0)
    group = constraints.dp_group()
    if group is not None:
        n = group.size()
        frac = funcol.all_reduce(frac, "sum", group) / n
        mean_probs = mean_probs / n
    return out, E * torch.sum(frac * mean_probs)
