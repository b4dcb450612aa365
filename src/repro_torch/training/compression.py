"""Wire codec for KV pages shipped between model nodes (port of
``compress_kv_blocks`` / ``decompress_kv_blocks`` of
``repro/training/compression.py``; the gradient codecs come with
training).

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

