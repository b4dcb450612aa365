"""Decoder LM over the paged KV pool (port of the attention-family paged
serving path of ``repro/models/lm.py``).

Params are the reference's nested dicts: ``cfg.pattern`` positions are a
tuple in ``params["blocks"]``, each leaf stacked over ``cfg.n_repeats`` on
axis 0.  The reference's ``lax.scan`` over repeats is a Python loop here.
The arena keeps the reference layout, a tuple over pattern positions of
``{"k", "v"}`` tensors ``(R, P, BLOCK, nkv, dh)``, and is updated **in
place**: each entry point returns the same arena object it was given.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch import require_device
from repro_torch.models import attention, common


def ffn_forward(cfg, p, x):
    dt = cfg.compute_dtype
    act = common.act_fn(cfg.act)
    if cfg.glu:
        g = act(x @ p["w_gate"].to(dt))
        return (g * (x @ p["w_up"].to(dt))) @ p["w_down"].to(dt)
    return act(x @ p["w_in"].to(dt)) @ p["w_out"].to(dt)


def _ffn_block(cfg, spec, p, x):
    if spec.ffn == "none":
        return x
    h = ffn_forward(cfg, p["ffn"], common.apply_norm(cfg, p["norm2"], x))
    if cfg.double_norm:
        h = common.apply_norm(cfg, p["norm2b"], h)
    return x + h


def _mixer_out(cfg, spec, p, x, o):
    """Output projection, optional post-norm, residual, then the FFN."""
    h = attention.out_proj(cfg, p["mixer"], o)
    if cfg.double_norm:
        h = common.apply_norm(cfg, p["norm1b"], h)
    return _ffn_block(cfg, spec, p, x + h)


def layer_decode_paged(cfg, spec, p, x, pos, arena, page_table,
                       active=None, write=True):
    """One token per row.  x: (B, 1, d); pos: (B,); arena: {"k","v"}: (P,
    BLOCK, nkv, h), written in place.  ``write=False`` skips the write
    (query-only replay over fully cached tokens: pages another request may
    alias are never mutated)."""
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = attention.project_qkv(cfg, p["mixer"], h, pos[:, None])
    if write:
        attention.update_paged_cache(arena["k"], arena["v"], k, v,
                                     page_table, pos)
    o = attention.paged_decode_attention(cfg, q, arena["k"], arena["v"],
                                         page_table, pos, window=spec.window,
                                         active=active)
    return _mixer_out(cfg, spec, p, x, o)


def layer_prefill_paged(cfg, spec, p, x, pos0, arena, page_table,
                        active=None):
    """One teacher-forced prefill chunk: write the chunk's K/V into its
    (fresh) page in place, then attend over all the row's pages.  x: (B,
    C, d) with C == BLOCK and ``pos0`` block-aligned.  ``active``: optional
    (B,) bool — inactive rows write onto the scratch page 0 and get zero
    attention output."""
    B, C, _ = x.shape
    ka, va = arena["k"], arena["v"]
    positions = pos0[:, None] + torch.arange(C, device=x.device)[None]
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = attention.project_qkv(cfg, p["mixer"], h, positions)
    phys = page_table[torch.arange(B, device=x.device),
                      pos0.long() // ka.shape[1]].long()
    if active is not None:
        phys = torch.where(active, phys, 0)
    ka[phys] = k
    va[phys] = v
    o = attention.paged_prefill_attention(cfg, q, ka, va, page_table,
                                          positions, window=spec.window,
                                          active=active)
    return _mixer_out(cfg, spec, p, x, o)


def layer_verify_paged(cfg, spec, p, x, pos, arena, page_table, n_tok=None):
    """One speculation-window step: write the window's K/V by token
    position in place (it may straddle a block boundary), then attend
    causally over the pages and inside the window.  x: (B, W, d); row b's
    window starts at ``pos[b]``; ``n_tok`` (B,) real tokens per row (0 =
    dead row: scratch writes, zero attention output)."""
    W = x.shape[1]
    positions = pos[:, None] + torch.arange(W, device=x.device)[None]
    h = common.apply_norm(cfg, p["norm1"], x)
    q, k, v = attention.project_qkv(cfg, p["mixer"], h, positions)
    attention.update_paged_cache_window(arena["k"], arena["v"], k, v,
                                        page_table, pos, n_tok=n_tok)
    active = None if n_tok is None else n_tok > 0
    o = attention.paged_prefill_attention(cfg, q, arena["k"], arena["v"],
                                          page_table, positions,
                                          window=spec.window, active=active)
    return _mixer_out(cfg, spec, p, x, o)


def _layer_slice(tree, r):
    """Repeat ``r`` of a stacked params subtree."""
    return {k: _layer_slice(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


class LM(nn.Module):
    """The model's paged serving entry points.  Holds the config and the
    device; the weights are a parameter dict (``repro_torch.params``)
    passed to every call, as in the reference."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = require_device(device)

    def _layers(self, params, arena):
        """(spec, layer params, layer arena) in execution order."""
        cfg = self.cfg
        for r in range(cfg.n_repeats):
            for i, spec in enumerate(cfg.pattern):
                yield (spec, _layer_slice(params["blocks"][i], r),
                       {"k": arena[i]["k"][r], "v": arena[i]["v"][r]})

    def _embed(self, params, tokens):
        cfg = self.cfg
        return common.take_embedding(params["embed"], tokens,
                                     cfg.embed_scale, cfg.compute_dtype)

    def _logits(self, params, x):
        cfg = self.cfg
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        logits = (x @ head.to(cfg.compute_dtype).t()).float()
        logits = common.softcap(logits, cfg.final_softcap)
        if cfg.padded_vocab != cfg.vocab:
            logits[..., cfg.vocab:] = -1e30
        return logits

    def _head(self, params, x):
        return self._logits(params, common.apply_norm(
            self.cfg, params["final_norm"], x))

    def supports_paging(self) -> bool:
        return all(s.mixer == "attn" for s in self.cfg.pattern)

    def paged_arena_zeros(self, num_pages, block):
        """Node-wide paged KV arena: per pattern position separate {"k",
        "v"} tensors (R, num_pages, BLOCK, nkv, d_head).  Page 0 is the
        scratch page."""
        cfg = self.cfg
        shape = (cfg.n_repeats, num_pages, block, cfg.n_kv_heads, cfg.d_head)

        def z():
            return torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=self.device)
        return tuple({"k": z(), "v": z()} for _ in cfg.pattern)

    @torch.no_grad()
    def prefill_paged(self, params, arena, page_tables, tokens, pos0,
                      active=None):
        """One teacher-forced prompt chunk: tokens (B, C) with C == BLOCK,
        pos0 (B,) block-aligned.  Writes the chunk's K/V into each row's
        write page and returns ((B, C, V) logits, arena).  ``active``:
        optional (B,) bool for batched admission (dead rows write to the
        scratch page)."""
        x = self._embed(params, tokens)
        for spec, p, ar in self._layers(params, arena):
            x = layer_prefill_paged(self.cfg, spec, p, x, pos0, ar,
                                    page_tables, active=active)
        return self._head(params, x), arena

    @torch.no_grad()
    def decode_paged(self, params, arena, page_tables, tokens, pos,
                     active=None, write=True):
        """tokens (B, 1), pos (B,), page_tables (B, n_pg) -> ((B, V)
        logits, arena).  ``write=False`` leaves the arena untouched."""
        x = self._embed(params, tokens)
        for spec, p, ar in self._layers(params, arena):
            x = layer_decode_paged(self.cfg, spec, p, x, pos, ar, page_tables,
                                   active=active, write=write)
        return self._head(params, x[:, -1]), arena

    @torch.no_grad()
    def verify_paged(self, params, arena, page_tables, tokens, pos,
                     n_tok=None):
        """Speculative verify: tokens (B, W) — the committed token then up
        to W-1 drafts — from position pos (B,); n_tok (B,) real tokens per
        row.  Returns ((B, W, V) logits equal to W sequential decodes,
        arena)."""
        x = self._embed(params, tokens)
        for spec, p, ar in self._layers(params, arena):
            x = layer_verify_paged(self.cfg, spec, p, x, pos, ar, page_tables,
                                   n_tok=n_tok)
        return self._head(params, x), arena

