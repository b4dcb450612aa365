"""Model weights for the port: carried over from the reference, or made
here from a seed.

The tree is the reference's (``repro/models/lm.py`` ``LM.init``): nested
dicts with the same keys, ``blocks`` a tuple over pattern positions whose
leaves are stacked over ``cfg.n_repeats`` on axis 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import require_device


def from_jax_params(tree, device="cuda", dtype=None):
    """Convert a reference params tree whose leaves are numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) into torch tensors on
    ``device``, keeping keys and the stacked repeat axis; ``dtype`` casts
    every leaf (e.g. to the compute dtype)."""
    dev = require_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        t = torch.from_numpy(np.array(x))
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


def init_params(cfg, generator: torch.Generator, device="cuda", dtype=None):
    """Random weights with the reference's init rules: truncated normal in
    [-2, 2] scaled by 1/sqrt(fan_in) for projections, normal(0.02) for the
    embedding and LM head, ones for norm scales.  ``generator`` must live
    on ``device``; ``dtype`` defaults to ``cfg.params_dtype``.  The numbers
    differ from the reference's for the same seed (another generator)."""
    dev = require_device(device)
    dtype = dtype or cfg.params_dtype
    R, d = cfg.n_repeats, cfg.d_model

    def dense(shape, fan_in):
        """Stacked (R, *shape), one repeat at a time in float32 so a
        full-width model needs no float32 copy of itself."""
        out = torch.empty((R, *shape), dtype=dtype, device=dev)
        for r in range(R):
            w = torch.empty(shape, dtype=torch.float32, device=dev)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                        generator=generator)
            out[r] = w * (1.0 / math.sqrt(max(fan_in, 1)))
        return out

    def embed():
        w = torch.randn((cfg.padded_vocab, d), generator=generator,
                        device=dev, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def norm(stacked=True):
        shape = (R, d) if stacked else (d,)
        p = {"scale": torch.ones(shape, dtype=dtype, device=dev)}
        if cfg.norm == "ln":
            p["bias"] = torch.zeros(shape, dtype=dtype, device=dev)
        return p

    nq, nkv, dh, ff = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
    blocks = []
    for spec in cfg.pattern:
        p = {"norm1": norm(),
             "mixer": {"wq": dense((d, nq, dh), d), "wk": dense((d, nkv, dh), d),
                       "wv": dense((d, nkv, dh), d),
                       "wo": dense((nq, dh, d), nq * dh)}}
        if cfg.double_norm:
            p["norm1b"] = norm()
        if spec.ffn == "dense":
            p["norm2"] = norm()
            p["ffn"] = ({"w_gate": dense((d, ff), d), "w_up": dense((d, ff), d),
                         "w_down": dense((ff, d), ff)} if cfg.glu else
                        {"w_in": dense((d, ff), d), "w_out": dense((ff, d), ff)})
            if cfg.double_norm:
                p["norm2b"] = norm()
        blocks.append(p)
    params = {"embed": embed(), "final_norm": norm(stacked=False),
              "blocks": tuple(blocks)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed()
    return params
