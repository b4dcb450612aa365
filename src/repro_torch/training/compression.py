"""Gradient compression for the data-parallel all-reduce, and the wire
codec for KV pages shipped between model nodes (port of
``repro/training/compression.py``).

Gradients: int8 quantization with one max-abs scale a leaf, or magnitude
top-k sparsification, each with error feedback (the part not sent is
carried into the next step's gradient).  Applied to the gradient tree
inside the train step, so its numerics are what a cluster would see.
``round`` is half to even, as ``jnp.round``; top-k keeps every element at
least as large as the k-th magnitude (ties included), as the reference.

A record is a msgpack-able dict whose bytes equal the reference's for the
same values: ``raw`` writes the arena dtype's bytes as they are (bf16
through its int16 view, and the dtype string ``"bfloat16"``), ``fp16``
casts to float16, ``int8`` quantizes with one max-abs scale per (repeat,
page).  Casts, quantization and dequantization run on the tensor's
device; only the encoded bytes cross between host and device.  A record
whose bytes do not fit its shape raises ``ValueError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.training.optimizer import tree_leaves, tree_map, tree_pick

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _bytes(t: torch.Tensor) -> bytes:
    """Little-endian bytes of ``t`` in C order (bf16 through int16)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy().tobytes()


def _tensor(data: bytes, dtype: torch.dtype, shape, device) -> torch.Tensor:
    """``data`` read as ``dtype`` of ``shape``, moved to ``device``."""
    if not isinstance(data, (bytes, bytearray)):
        raise TypeError(f"record data is {type(data).__name__}, not bytes")
    n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if min(shape, default=0) < 1 or len(data) != n:
        raise ValueError(f"{len(data)} bytes for {dtype} of shape {tuple(shape)}")
    return torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape).to(device)


def _quantize_int8(g):
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q, scale):
    return q.float() * scale


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_int8_ef(grads, err_state):
    """int8 + error feedback.  Returns (grads_as_transmitted, new_err)."""
    def one(g, e):
        g = g.float() + e
        deq = _dequantize(*_quantize_int8(g))
        return deq, g - deq
    out = tree_map(one, grads, err_state)
    return tree_pick(out, 0), tree_pick(out, 1)


def compress_topk_ef(grads, err_state, frac: float = 0.05):
    """Magnitude top-k sparsification with error feedback: each leaf sends
    its ``max(1, int(size * frac))`` largest magnitudes (and any tied with
    the smallest of them)."""
    def one(g, e):
        g = g.float() + e
        flat = g.reshape(-1)
        k = max(1, int(flat.numel() * frac))
        thresh = torch.topk(flat.abs(), k).values[-1]
        sent = g * (g.abs() >= thresh).float()
        return sent, g - sent
    out = tree_map(one, grads, err_state)
    return tree_pick(out, 0), tree_pick(out, 1)


def compression_ratio_int8(params) -> float:
    """Wire-bytes ratio vs f32 all-reduce (scale overhead included)."""
    leaves = tree_leaves(params)
    return sum(4 * p.numel() for p in leaves) / sum(p.numel() + 4 for p in leaves)


def compress_kv_blocks(blocks: torch.Tensor, mode: str = "fp16") -> dict:
    """(R, n_pages, BLOCK, nkv, h) K/V slab -> msgpack-able wire record."""
    rec = {"mode": mode, "dtype": _name(blocks.dtype), "shape": list(blocks.shape)}
    if mode == "raw":
        rec["data"] = _bytes(blocks)
    elif mode == "fp16":
        rec["data"] = _bytes(blocks.to(torch.float16))
    elif mode == "int8":
        flat = blocks.float().reshape(blocks.shape[0], blocks.shape[1], -1)
        scale = flat.abs().amax(dim=-1).clamp_min(1e-12) / 127.0
        q = torch.round(flat / scale[..., None]).clamp(-127, 127)
        rec["data"] = _bytes(q.to(torch.int8))
        rec["scale"] = _bytes(scale)
    else:
        raise ValueError(f"unknown KV wire mode {mode!r}")
    return rec


def decompress_kv_blocks(rec: dict, dtype=None, device="cpu") -> torch.Tensor:
    """Wire record -> (R, n_pages, BLOCK, nkv, h) tensor on ``device`` in
    ``dtype`` (defaults to the source arena dtype recorded at compression):
    the encoded bytes move to the device, which casts or dequantizes."""
    shape = tuple(int(s) for s in rec["shape"])
    if len(shape) < 2:
        raise ValueError(f"KV record of shape {shape}")
    out_dtype = dtype if dtype is not None else _DTYPES[rec["dtype"]]
    mode = rec["mode"]
    if mode == "raw":
        arr = _tensor(rec["data"], _DTYPES[rec["dtype"]], shape, device)
    elif mode == "fp16":
        arr = _tensor(rec["data"], torch.float16, shape, device)
    elif mode == "int8":
        q = _tensor(rec["data"], torch.int8, shape, device).float()
        scale = _tensor(rec["scale"], torch.float32, shape[:2], device)
        arr = (q.reshape(*shape[:2], -1) * scale[..., None]).reshape(shape)
    else:
        raise ValueError(f"unknown KV wire mode {mode!r}")
    return arr.to(out_dtype)

