"""The plain reference of the benchmark's decoder configurations: a
causal decoder with grouped-query attention (RoPE on the two halves of
each head, theta from the file), RMSNorm (eps 1e-6) with a scale, and a
SwiGLU FFN, dense or a mixture of experts with a softmax router,
top-k and the k gates renormalised, every routed token kept (no
capacity).  Written from the configuration's ``port`` block and the
published architecture alone; it imports nothing of the program, and
reads only the weights the benchmark drew (the layout ``harness/weights``
documents).

It runs a whole sequence from position 0, layer by layer over a batch of
sequences (so a layer's weights are widened once), in float32 with TF32
off.  ``precision="fp8"`` is the control: every product with a weight
(the router's too) takes float8 (e4m3) operands, the weight scaled per
output column and the activation per token; norms, RoPE, the softmaxes
and attention stay in float32.
"""
from __future__ import annotations

import contextlib
import math

import torch

EPS = 1e-6
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 (restored on exit)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def _fp8(t, dim):
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x, w, precision):
    """x (T, i) @ w (i, o) in float32, or with float8 operands."""
    w = w.float()
    if precision == "fp8":
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def rms(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * scale.float()


def rope(x, theta):
    """x (S, H, D) at positions 0..S-1: the halves of D rotated."""
    S, _, D = x.shape
    half = D // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(port, p, h, precision, block=512):
    S, d = h.shape
    nq, nkv, dh = port["n_heads"], port["n_kv_heads"], port["d_head"]
    q = mm(h, p["wq"].reshape(d, nq * dh), precision).view(S, nq, dh)
    k = mm(h, p["wk"].reshape(d, nkv * dh), precision).view(S, nkv, dh)
    v = mm(h, p["wv"].reshape(d, nkv * dh), precision).view(S, nkv, dh)
    q, k = rope(q, port["rope_theta"]), rope(k, port["rope_theta"])
    k = k.repeat_interleave(nq // nkv, dim=1)
    v = v.repeat_interleave(nq // nkv, dim=1)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(dh)
    keys = torch.arange(S, device=h.device)
    for a in range(0, S, block):
        b = min(S, a + block)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * scale
        s = s.masked_fill(keys[None, None, :b] > torch.arange(a, b, device=h.device)[None, :, None],
                          float("-inf"))
        out[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v[:b])
    return mm(out.reshape(S, nq * dh), p["wo"].reshape(nq * dh, d), precision)


def glu(x, wg, wu, wd, precision):
    return mm(torch.nn.functional.silu(mm(x, wg, precision)) * mm(x, wu, precision), wd,
              precision)


def ffn(port, p, h, precision, block=4096):
    moe = port.get("moe")
    if not moe:
        return torch.cat([glu(h[a:a + block], p["w_gate"], p["w_up"], p["w_down"], precision)
                          for a in range(0, h.shape[0], block)])
    probs = torch.softmax(mm(h, p["router"], precision), dim=-1)
    gate, expert = torch.topk(probs, moe["top_k"], dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(moe["num_experts"]):
        tok, slot = torch.nonzero(expert == e, as_tuple=True)
        if tok.numel():
            y = glu(h[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e], precision)
            out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out


def _layer(w, r):
    blk = w["blocks"][0]
    return {"norm1": blk["norm1"]["scale"][r], "norm2": blk["norm2"]["scale"][r],
            **{k: t[r] for k, t in blk["mixer"].items()},
            **{k: t[r] for k, t in blk["ffn"].items()}}


@torch.no_grad()
def logits(port: dict, w: dict, seqs: list, first: list, precision: str = "f32") -> list:
    """float32 logits over the vocabulary at positions ``first[i]`` ..
    ``len(seqs[i]) - 1`` of each token sequence ``seqs[i]`` (each run from
    position 0): one (len - first, vocab) tensor a sequence."""
    dev = w["embed"].device
    with exact_f32():
        xs = [w["embed"][torch.as_tensor(s, device=dev)].float() for s in seqs]
        sizes = [x.shape[0] for x in xs]
        for r in range(port["n_layers"]):
            p = _layer(w, r)
            xs = [x + attention(port, p, rms(x, p["norm1"]), precision) for x in xs]
            x = torch.cat(xs)
            x = x + ffn(port, p, rms(x, p["norm2"]), precision)
            xs = list(x.split(sizes))
        head = w["lm_head"][:port["vocab"]].t()
        return [mm(rms(x[f:], w["final_norm"]["scale"]), head, precision)
                for x, f in zip(xs, first)]
