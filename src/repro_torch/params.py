"""Model weights for the port: carried over from the reference, or made
here from a seed.

The tree is the reference's (``repro/models/lm.py`` ``LM.init``): nested
dicts with the same keys, ``blocks`` a tuple over pattern positions whose
leaves are stacked over ``cfg.n_repeats`` on axis 0; for an
encoder-decoder, ``encoder`` (``layers`` stacked over ``cfg.n_enc_layers``
and ``final_norm``); without RoPE, a learned ``pos_embed`` table of
``MAX_LEARNED_POS`` rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.models import lm as lm_model
from repro_torch.models import mamba as mamba_model
from repro_torch.models import xlstm as xlstm_model


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
    [-2, 2] scaled by 1/sqrt(fan_in) for projections (attention, dense and
    expert FFNs, router, Mamba, xLSTM), normal(0.02) for the embedding,
    the LM head and the learned positions, ones for norm scales, zeros for
    LayerNorm biases.  ``generator`` must live
    on ``device``; ``dtype`` defaults to ``cfg.params_dtype``.  The numbers
    differ from the reference's for the same seed (another generator).  On
    the meta device (``LM.param_specs``) nothing is drawn (``generator``
    may be None) and the projections skip their per-layer loop."""
    dev = require_device(device)
    dtype = dtype or cfg.params_dtype
    R, d = cfg.n_repeats, cfg.d_model

    def dense(shape, fan_in, per_expert=False, n=R):
        """Stacked (n, *shape), one layer (``per_expert``: one expert of
        the leading axis) at a time in float32, so a full-width model never
        holds a float32 copy of itself."""
        out = torch.empty((n, *shape), dtype=dtype, device=dev)
        if dev.type == "meta":
            return out
        part = shape[1:] if per_expert else shape
        for r in range(n):
            for e in range(shape[0] if per_expert else 1):
                w = torch.empty(part, dtype=torch.float32, device=dev)
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                            generator=generator)
                w *= 1.0 / math.sqrt(max(fan_in, 1))
                (out[r, e] if per_expert else out[r]).copy_(w)
        return out

    def embed(rows=cfg.padded_vocab):
        w = torch.randn((rows, d), generator=generator,
                        device=dev, dtype=torch.float32)
        return (w * 0.02).to(dtype)

    def norm(n=R):
        """Stacked over n layers; n None: one norm."""
        shape = (d,) if n is None else (n, d)
        p = {"scale": torch.ones(shape, dtype=dtype, device=dev)}
        if cfg.norm == "ln":
            p["bias"] = torch.zeros(shape, dtype=dtype, device=dev)
        return p

    def glu(ff, shape=(), n=R):
        return {"w_gate": dense((*shape, d, ff), d, bool(shape), n),
                "w_up": dense((*shape, d, ff), d, bool(shape), n),
                "w_down": dense((*shape, ff, d), ff, bool(shape), n)}

    def attn(n=R):
        """Self- and cross-attention alike (``init_attn``)."""
        nq, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        return {"wq": dense((d, nq, dh), d, n=n),
                "wk": dense((d, nkv, dh), d, n=n),
                "wv": dense((d, nkv, dh), d, n=n),
                "wo": dense((nq, dh, d), nq * dh, n=n)}

    def mamba():
        """``repro/models/mamba.py`` ``init_mamba``: A = -exp(A_log) with
        A_log = log(uniform(1, 16)) per head, D ones, dt_bias zeros."""
        di, N, dc = cfg.d_inner_mamba, cfg.mamba.d_state, cfg.mamba.d_conv
        H = mamba_model.dims(cfg)[1]
        a = torch.empty((R, H), dtype=torch.float32, device=dev)
        a.uniform_(1.0, 16.0, generator=generator)
        return {"w_in": dense((d, 2 * di), d), "conv": dense((dc, di), dc),
                "w_dt": dense((di, H), di),
                "dt_bias": torch.zeros((R, H), dtype=dtype, device=dev),
                "w_B": dense((di, N), di), "w_C": dense((di, N), di),
                "A_log": a.log().to(dtype),
                "D": torch.ones((R, H), dtype=dtype, device=dev),
                "w_out": dense((di, d), di)}

    def linspace_heads(H):
        return torch.linspace(3.0, 6.0, H, device=dev).to(dtype)

    def mlstm():
        """``repro/models/xlstm.py`` ``init_mlstm``: the forget half of
        ``if_bias`` is linspace(3, 6) over heads, the input half zeros."""
        di, H, dh = xlstm_model.mlstm_dims(cfg)
        cw = cfg.xlstm.conv_width
        return {"w_up": dense((d, 2 * di), d), "conv": dense((cw, di), cw),
                "w_q": dense((di, di), di), "w_k": dense((di, di), di),
                "w_if": dense((di, 2 * H), di),
                "if_bias": torch.cat([torch.zeros(H, dtype=dtype, device=dev),
                                      linspace_heads(H)]).repeat(R, 1),
                "head_norm": torch.ones((R, H, dh), dtype=dtype, device=dev),
                "w_down": dense((di, d), di)}

    def slstm():
        """``init_slstm``: bias row 2 (the forget gate) is linspace(3, 6)
        over heads.  ``ffn_gate`` and ``ffn_up`` are drawn from the same
        key there (xlstm.py:209-210), so they are equal: drawn once here
        and copied."""
        _, H, dh = xlstm_model.slstm_dims(cfg)
        ff = int(cfg.xlstm.proj_factor_slstm * d)
        bias = torch.zeros((R, 4, H, dh), dtype=dtype, device=dev)
        bias[:, 2] = linspace_heads(H)[:, None]
        gate = dense((d, ff), d)
        return {"W": dense((d, 4, H, dh), d), "R": dense((4, H, dh, dh), dh),
                "bias": bias,
                "head_norm": torch.ones((R, H, dh), dtype=dtype, device=dev),
                "ffn_gate": gate, "ffn_up": gate.clone(),
                "ffn_down": dense((ff, d), ff)}

    def moe():
        m = cfg.moe
        p = {"router": dense((d, m.num_experts), d),
             **glu(m.d_ff_expert, (m.num_experts,))}
        if m.num_shared:
            p["shared"] = glu(m.num_shared * m.d_ff_expert)
        return p

    def layer(spec, n=R):
        """One pattern position stacked over n layers (``init_layer``)."""
        p = {"norm1": norm(n=n),
             "mixer": attn(n) if spec.mixer in ("attn", "cross_attn") else
             {"mamba": mamba, "mlstm": mlstm, "slstm": slstm}[spec.mixer]()}
        if cfg.double_norm:
            p["norm1b"] = norm(n=n)
        if spec.ffn != "none":
            p["norm2"] = norm(n=n)
            if spec.ffn == "moe":
                p["ffn"] = moe()
            elif cfg.glu:
                p["ffn"] = glu(cfg.d_ff, n=n)
            else:
                p["ffn"] = {"w_in": dense((d, cfg.d_ff), d, n=n),
                            "w_out": dense((cfg.d_ff, d), cfg.d_ff, n=n)}
            if cfg.double_norm:
                p["norm2b"] = norm(n=n)
        return p

    # drawn in the reference's key order: embed, blocks, lm_head, encoder,
    # pos_embed
    params = {"embed": embed(), "final_norm": norm(None)}
    params["blocks"] = tuple(layer(spec) for spec in cfg.pattern)
    if not cfg.tie_embeddings:
        params["lm_head"] = embed()
    if cfg.is_encdec:
        params["encoder"] = {"layers": layer(lm_model.ENC_SPEC, cfg.n_enc_layers),
                             "final_norm": norm(None)}
    if cfg.rope_theta <= 0:
        params["pos_embed"] = embed(lm_model.MAX_LEARNED_POS)
    return params
