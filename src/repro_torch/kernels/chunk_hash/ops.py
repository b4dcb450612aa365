"""HR-tree chunk hashing: the checked wrappers of ``csrc/chunk_hash.cu``.

For a CUDA tensor they launch the kernel (no fallback); for a CPU tensor
they run the plain version in ``ref.py``.  Both entries return the uint32
hashes as int64 (``0 .. 2^32 - 1``), so that arithmetic and ``.tolist()``
give the Python ints ``core/hrtree.chunk_hash`` gives."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.chunk_hash import ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _L, _P, _P, _I, _I, _I, _P, _P]
RANGED_GROUP = 32              # lanes a chunk on the ranged entry: kRangedGroup


def group_size(width: int) -> int:
    """Lanes that hash one chunk of the fixed entry (``group_size`` in
    csrc/chunk_hash.cu): enough for one 16-byte load of 4 tokens a lane to
    cover the width in one round, at most a warp."""
    g = 1
    while g < 32 and 4 * g < width:
        g *= 2
    return g


def _check_bits(bits: int):
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in 1..32, not {bits}")


def _launch(entry, tokens, starts, lens, width: int, n_chunks: int, bits: int):
    out = torch.empty((n_chunks,), dtype=torch.int64, device=tokens.device)
    if n_chunks == 0:
        return out
    fn = _build.function("chunk_hash", "chunk_hash", _ARGTYPES)
    err = fn(tokens.data_ptr(), tokens.numel(),
             None if starts is None else starts.data_ptr(),
             None if lens is None else lens.data_ptr(), width, n_chunks, bits,
             out.data_ptr(), torch.cuda.current_stream(tokens.device).cuda_stream)
    _build.check(err, "chunk_hash")
    entry.launches += 1
    return out


def chunk_hash_fixed(tokens, width: int = 64, bits: int = 8):
    """tokens: (B, S) int32 with S % width == 0 -> (B, S // width) int64
    fingerprints of the consecutive ``width``-token chunks of each row."""
    _check_bits(bits)
    if tokens.dim() != 2 or width < 1 or tokens.shape[1] % width:
        raise ValueError(f"tokens {tuple(tokens.shape)} is not (B, S) with S % {width} == 0")
    if tokens.dtype != torch.int32:
        raise TypeError(f"tokens must be int32, not {tokens.dtype}")
    if not tokens.is_cuda:
        return ref.chunk_hash_fixed_ref(tokens, width, bits)
    if not tokens.is_contiguous():
        raise ValueError("chunk hash needs contiguous tokens")
    B, S = tokens.shape
    n = S // width
    return _launch(chunk_hash_fixed, tokens, None, None, width, B * n, bits).reshape(B, n)


def chunk_hash_ranges(tokens, starts, lens, bits: int = 8):
    """tokens: (n,) int32; starts, lens: (C,) int32 on the same device ->
    (C,) int64, the fingerprint of ``tokens[starts[c]:starts[c] + lens[c]]``
    (-1 for a range outside the tokens: the kernel never reads past them)."""
    _check_bits(bits)
    for name, t in (("tokens", tokens), ("starts", starts), ("lens", lens)):
        if t.dim() != 1 or t.dtype != torch.int32 or t.device != tokens.device:
            raise TypeError(f"{name} must be 1-D int32 on {tokens.device}")
    if starts.shape != lens.shape:
        raise ValueError("starts and lens differ in length")
    if not tokens.is_cuda:
        return ref.chunk_hash_ranges_ref(tokens, starts, lens, bits)
    if not all(t.is_contiguous() for t in (tokens, starts, lens)):
        raise ValueError("chunk hash needs contiguous inputs")
    return _launch(chunk_hash_ranges, tokens, starts, lens, 0, starts.numel(), bits)


def launch_floor(n_chunks: int, device):
    """Launches an empty kernel with the ranged entry's launch shape for
    ``n_chunks`` chunks on ``device``'s current stream: its device time is
    the floor under the ranged entry's (a launch that does nothing)."""
    fn = _build.function("chunk_hash", "chunk_hash_floor", [_I, _P])
    _build.check(fn(n_chunks, torch.cuda.current_stream(device).cuda_stream),
                 "chunk_hash_floor")


chunk_hash_fixed.launches = 0
chunk_hash_ranges.launches = 0
