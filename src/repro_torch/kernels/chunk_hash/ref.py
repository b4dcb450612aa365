"""Plain PyTorch version of the chunk-hash kernel (port of
``repro/kernels/chunk_hash/ref.py``): ``core/hrtree.chunk_hash`` for many
chunks at once, on int64 with ``& 0xFFFFFFFF`` after every step (``h * M``
stays below 2^52), vectorised over chunks and looping over positions."""
from __future__ import annotations

import torch

MULT = 1_000_003
SEED = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def fold(h, bits: int):
    """xor-fold 32-bit values (int64 tensor) down to ``bits`` bits."""
    mask = (1 << bits) - 1
    out = torch.zeros_like(h)
    for _ in range(32 // bits + 1):
        out ^= h & mask
        h = h >> bits
    return out


def chunk_hash_fixed_ref(tokens, width: int, bits: int):
    """tokens: (B, S) int32, S % width == 0 -> (B, S // width) int64."""
    B, S = tokens.shape
    t = tokens.reshape(B, S // width, width).long() & MASK32
    h = torch.full((B, S // width), SEED, dtype=torch.int64, device=tokens.device)
    for j in range(width):
        h = (h * MULT + t[..., j] + 1) & MASK32
    return fold(h, bits)


def chunk_hash_ranges_ref(tokens, starts, lens, bits: int):
    """tokens: (n,) int32; starts, lens: (C,) int32 -> (C,) int64, the hash
    of ``tokens[starts[c]:starts[c] + lens[c]]``; -1 for a chunk outside
    the tokens."""
    tok = tokens.reshape(-1).long() & MASK32
    starts, lens = starts.long(), lens.long()
    ok = (starts >= 0) & (lens >= 0) & (starts + lens <= tok.numel())
    h = torch.full(starts.shape, SEED, dtype=torch.int64, device=tokens.device)
    longest = int(torch.where(ok, lens, 0).max()) if len(lens) else 0
    for j in range(longest):
        live = ok & (j < lens)
        t = tok[torch.where(live, starts + j, 0)]
        h = torch.where(live, (h * MULT + t + 1) & MASK32, h)
    return torch.where(ok, fold(h, bits), -1)
