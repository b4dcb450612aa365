"""Rabin's Information Dispersal Algorithm: systematic k-of-n erasure code
over GF(256) with a Cauchy extension matrix.

Each fragment is ~|M|/k bytes (Rabin's space optimality).  The first k rows
are the identity (fragments 0..k-1 are plain data slices — S-IDA encrypts
the payload first, so this leaks nothing), rows k..n-1 are Cauchy rows
1/(x_i ^ y_j), any k of which are invertible with the identity rows.
"""
from __future__ import annotations

import struct

import numpy as np

from repro_torch.core import gf256


def _matrix(n: int, k: int) -> np.ndarray:
    assert k <= n <= 128
    M = np.zeros((n, k), np.uint8)
    M[:k] = np.eye(k, dtype=np.uint8)
    xs = np.arange(k, n, dtype=np.uint8)          # x_i for parity rows
    ys = np.arange(128, 128 + k, dtype=np.uint8)  # y_j disjoint from xs
    denom = xs[:, None] ^ ys[None, :]
    M[k:] = gf256.inv(denom)
    return M


def split(data: bytes, n: int, k: int) -> list[tuple[int, bytes]]:
    """Fragments [(index, piece)]; original length is prepended."""
    blob = struct.pack("<I", len(data)) + data
    pad = (-len(blob)) % k
    blob += b"\0" * pad
    cols = np.frombuffer(blob, np.uint8).reshape(k, len(blob) // k)
    M = _matrix(n, k)
    frags = gf256.matmul(M, cols)                 # (n, L/k)
    return [(i, frags[i].tobytes()) for i in range(n)]


def combine(frags: list[tuple[int, bytes]], n: int, k: int) -> bytes:
    assert len(frags) >= k, "need at least k fragments"
    frags = frags[:k]
    idx = [f[0] for f in frags]
    Y = np.stack([np.frombuffer(f[1], np.uint8) for f in frags])
    M = _matrix(n, k)[idx]                        # (k, k)
    cols = gf256.matmul(gf256.mat_inv(M), Y)      # (k, L/k)
    blob = cols.reshape(-1).tobytes()
    (length,) = struct.unpack("<I", blob[:4])
    return blob[4:4 + length]
