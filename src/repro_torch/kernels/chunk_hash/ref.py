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


# The kernel's split (csrc/chunk_hash.cu), on Python ints: what the CPU
# tests hold against core/hrtree.chunk_hash before a card sees it
def _combine(a, b):
    """Pairs (p, M^n) of two consecutive runs of tokens, in order."""
    return (a[0] * b[1] + b[0]) & MASK32, (a[1] * b[1]) & MASK32


def chunk_hash_lanes(tokens, start: int, length: int, group: int, bits: int,
                     misalign: int = 0):
    """The hash of ``tokens[start:start + length]`` as ``group`` lanes of
    the kernel compute it: the chunk's tokens from start's 16-byte boundary
    (``misalign``: tokens[0]'s 4-byte slot in its 16 bytes) cut into R =
    ceil(span / 4 group) pieces of 4 a lane, lane l folding the tokens of
    pieces l R .. l R + R - 1 that lie in the chunk into its pair
    (p, M^n); the lanes' pairs combined in lane order by the shuffle tree
    (after the step of offset o, lane l, l % 2o == 0, holds lanes
    l .. l + 2o - 1); then SEED M^len + p and the fold.  ``tokens``: a
    sequence of ints (only the tokens in the chunk are read).  Returns the
    folded hash."""
    end = start + length
    first = start - ((start + misalign) & 3)
    R = -(-(end - first) // (4 * group)) if end > first else 0
    lanes = []
    for lane in range(group):
        pair = (0, 1)
        for i in range(first + 4 * R * lane, first + 4 * R * (lane + 1)):
            if start <= i < end:
                pair = _combine(pair, ((int(tokens[i]) + 1) & MASK32, MULT))
        lanes.append(pair)
    o = 1
    while o < group:
        for lane in range(0, group, 2 * o):
            lanes[lane] = _combine(lanes[lane], lanes[lane + o])
        o *= 2
    h = (SEED * lanes[0][1] + lanes[0][0]) & MASK32
    out = 0
    while h:
        out ^= h & ((1 << bits) - 1)
        h >>= bits
    return out
