"""The yardstick's arithmetic: the card's peaks, each paged kernel's least
time for one call, and the model's useful operations.

The first block is a frozen copy of the kernel bound arithmetic behind
``chip_smoke.py``'s ``kernels`` line (``HBM_BYTES_PER_S``, ``PEAK_FLOPS``,
``_paged_decode_bytes``, ``_paged_flash_cost``; repository state of commit
7c02fe2), kept unchanged; its ``bound``, which divides by the dtype's peak,
is ``least_s`` below.  The functions below it count what the
benchmark's calls need: live rows only, the real tokens of a prefill chunk
(not its padding) and the configuration's real query heads (yi's 56, not
the 64 the program pads them to).
"""
from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# frozen copy (chip_smoke.py)
# ---------------------------------------------------------------------------
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,         # dense tensor-core bf16
              torch.float32: 67e12}           # fp32 outside the tensor cores
BLK = 32


def _paged_decode_bytes(lengths, H, Hkv, D, esize):
    """Bytes the paged decode call must move for these lengths: a live
    row reads its q, its visible K/V and its page ids; every row reads its
    length and writes its output (a dead row writes zeros, reads no q)."""
    lens = lengths.tolist()
    live = sum(n > 0 for n in lens)
    return (live * H * D * esize + len(lens) * H * D * esize
            + 2 * sum(lens) * Hkv * D * esize
            + 4 * sum(-(-n // BLK) for n in lens) + 4 * len(lens))


def _paged_flash_cost(pos0, n_tok, C, H, Hkv, D, esize):
    """Bytes and FLOPs the paged flash call must move and do for these
    inputs.  Every row reads its active flag and writes its output (a dead
    row writes zeros and reads nothing else); a live row reads its q, its
    pos0, and K/V and page ids up to its last query position."""
    nbytes = len(pos0) * (C * H * D * esize + 4)          # out written, active read
    flops = 0
    for p, n in zip(pos0.tolist(), n_tok.tolist()):
        if n == 0:
            continue
        nbytes += C * H * D * esize + 4                    # q, pos0
        nbytes += 2 * (p + C) * Hkv * D * esize + 4 * -(-(p + C) // BLK)
        flops += 4 * H * D * sum(p + i + 1 for i in range(C))
    return nbytes, flops


# ---------------------------------------------------------------------------
# what the benchmark's calls need
# ---------------------------------------------------------------------------
PEAK_BF16 = PEAK_FLOPS[torch.bfloat16]


def least_s(nbytes: float, flops: float, peak: float = PEAK_BF16) -> float:
    """The least time one call can take: the larger of its operations at
    the peak rate and its bytes at the memory's rate, in seconds."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def flash_cost(rows, H, Hkv, D, esize):
    """Bytes and FLOPs of one paged flash launch over the live rows
    ``rows``, each (pos0, real tokens n): its n queries read and their
    output written, its pos0 and active flag read, its K/V and page ids up
    to its last real query, and the causal products of those n queries."""
    nbytes = flops = 0
    for p, n in rows:
        if n <= 0:
            continue
        nbytes += 2 * n * H * D * esize + 8
        nbytes += 2 * (p + n) * Hkv * D * esize + 4 * -(-(p + n) // BLK)
        flops += 4 * H * D * (n * p + n * (n + 1) // 2)
    return nbytes, flops


def decode_cost(lengths, H, Hkv, D, esize):
    """Bytes and FLOPs of one paged decode launch over the live rows'
    ``lengths`` (keys visible to each row's one query): its q read and
    output written, its K/V, page ids and length read."""
    nbytes = flops = 0
    for n in lengths:
        if n <= 0:
            continue
        nbytes += 2 * H * D * esize + 2 * n * Hkv * D * esize + 4 * -(-n // BLK) + 4
        flops += 4 * H * D * n
    return nbytes, flops


def matmul_params(port: dict) -> int:
    """Weights one token multiplies in one layer: its attention projections
    at the real heads, and its dense FFN, or its router and its top-k
    experts (the shared ones too)."""
    d, dh = port["d_model"], port["d_head"]
    nq, nkv = port["n_heads"], port["n_kv_heads"]
    n = d * nq * dh + 2 * d * nkv * dh + nq * dh * d
    moe = port.get("moe")
    if moe:
        n += d * moe["num_experts"]
        n += (moe["top_k"] + moe.get("num_shared", 0)) * 3 * d * moe["d_ff_expert"]
    else:
        n += (3 if port.get("glu", True) else 2) * d * port["d_ff"]
    return n


def token_flops(port: dict, context: int) -> int:
    """Useful FLOPs of one token through every layer, attending ``context``
    keys (itself included): the products with the active weights, and the
    scores and weighted sums over its context at the real heads."""
    per_layer = 2 * matmul_params(port) + 4 * port["n_heads"] * port["d_head"] * context
    return port["n_layers"] * per_layer


def logit_flops(port: dict) -> int:
    """One row of logits: the head over the vocabulary."""
    return 2 * port["d_model"] * port["vocab"]


def chunk_flops(port: dict, p: int, n: int) -> int:
    """A prefill chunk of ``n`` real tokens from position ``p``: each token
    attends every key up to itself."""
    L, d_att = port["n_layers"], 4 * port["n_heads"] * port["d_head"]
    return n * port["n_layers"] * 2 * matmul_params(port) + L * d_att * (n * p + n * (n + 1) // 2)
