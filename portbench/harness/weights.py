"""Weights drawn from the run's seed, on the device, in the type they are
served in, by the benchmark's own code (not ``repro_torch.params``).

The tree has the layout the program reads (``repro_torch/params.py``):
``embed`` and ``lm_head`` of (vocab, d), ``final_norm``, and ``blocks``, a
tuple over the configuration's pattern whose leaves are stacked over its
layers: ``norm1`` / ``norm2`` scales, the attention's ``wq`` (d, nq, dh),
``wk`` / ``wv`` (d, nkv, dh) and ``wo`` (nq, dh, d), then a dense FFN's
``w_gate`` / ``w_up`` (d, ff) and ``w_down`` (ff, d), or an MoE FFN's
``router`` (d, E) and its experts' ``w_gate`` / ``w_up`` (E, d, ff) and
``w_down`` (E, ff, d).  The program and the reference read the same
tensors.

Each matrix is normal with standard deviation 1/sqrt(fan in); the
embedding is normal(0, 1), so the residual stream starts at unit scale,
and the head 1/sqrt(d), so logits are about unit scale; norm scales are
normal(1, 0.1), so a norm that dropped its scale would show.  One
``normal_`` call per layer of each leaf.
"""
from __future__ import annotations

import math

import torch


def _padded(vocab: int) -> int:
    return (vocab + 127) // 128 * 128


def draw(port: dict, seed: int, device, dtype=torch.bfloat16, out=None) -> dict:
    """The weight tree of ``port`` (a configuration's ``port`` block) from
    ``seed``.  ``out``: a tree of the same shapes to draw into (a second
    seed in one process reuses the memory)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    R, d = port["n_layers"], port["d_model"]
    nq, nkv, dh = port["n_heads"], port["n_kv_heads"], port["d_head"]
    V = _padded(port["vocab"])
    moe = port.get("moe")
    leaves = []          # (path, shape, mean, std), in draw order

    def leaf(path, shape, std, mean=0.0):
        leaves.append((path, shape, mean, std))

    leaf(("embed",), (V, d), 1.0)
    leaf(("final_norm", "scale"), (d,), 0.1, 1.0)
    blk = ("blocks", 0)
    leaf(blk + ("norm1", "scale"), (R, d), 0.1, 1.0)
    leaf(blk + ("mixer", "wq"), (R, d, nq, dh), 1 / math.sqrt(d))
    leaf(blk + ("mixer", "wk"), (R, d, nkv, dh), 1 / math.sqrt(d))
    leaf(blk + ("mixer", "wv"), (R, d, nkv, dh), 1 / math.sqrt(d))
    leaf(blk + ("mixer", "wo"), (R, nq, dh, d), 1 / math.sqrt(nq * dh))
    leaf(blk + ("norm2", "scale"), (R, d), 0.1, 1.0)
    if moe:
        E, ff = moe["num_experts"], moe["d_ff_expert"]
        if moe.get("num_shared", 0):
            raise ValueError("shared experts are not drawn by this benchmark yet")
        leaf(blk + ("ffn", "router"), (R, d, E), 1 / math.sqrt(d))
        leaf(blk + ("ffn", "w_gate"), (R, E, d, ff), 1 / math.sqrt(d))
        leaf(blk + ("ffn", "w_up"), (R, E, d, ff), 1 / math.sqrt(d))
        leaf(blk + ("ffn", "w_down"), (R, E, ff, d), 1 / math.sqrt(ff))
    else:
        ff = port["d_ff"]
        leaf(blk + ("ffn", "w_gate"), (R, d, ff), 1 / math.sqrt(d))
        leaf(blk + ("ffn", "w_up"), (R, d, ff), 1 / math.sqrt(d))
        leaf(blk + ("ffn", "w_down"), (R, ff, d), 1 / math.sqrt(ff))
    leaf(("lm_head",), (V, d), 1 / math.sqrt(d))
    if len(port["pattern"]) != 1 or port["pattern"][0]["mixer"] != "attn":
        raise ValueError("this benchmark draws one attention layer kind")
    if port.get("norm", "rms") != "rms":
        raise ValueError("this benchmark draws RMSNorm scales only")

    tree = out if out is not None else {"blocks": ({},)}
    for path, shape, mean, std in leaves:
        t = _get(tree, path) if out is not None else None
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=device)
            _set(tree, path, t)
        stacked = path[0] == "blocks" and len(shape) >= 3
        for part in (t.unbind(0) if stacked else (t,)):
            part.normal_(mean, std, generator=g)
    return tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {}) if isinstance(tree, dict) else tree[k]
    tree[path[-1]] = value


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()
