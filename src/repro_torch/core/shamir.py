"""Shamir k-of-n secret sharing over GF(256), byte-vectorized.

Each byte of the secret gets an independent degree-(k-1) polynomial; share i
is the evaluation at x_i = i (1-based).  < k shares reveal nothing
(information-theoretic); used by S-IDA for the symmetric key.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core import gf256


def split(secret: bytes, n: int, k: int, rng=None) -> list[tuple[int, bytes]]:
    assert 1 <= k <= n <= 255
    L = len(secret)
    rnd = (np.frombuffer(os.urandom(L * (k - 1)), np.uint8)
           .reshape(k - 1, L) if rng is None else
           rng.integers(0, 256, (k - 1, L), dtype=np.uint8))
    coeffs = np.concatenate([np.frombuffer(secret, np.uint8)[None],
                             rnd.reshape(k - 1, L)], axis=0)  # (k, L)
    shares = []
    for i in range(1, n + 1):
        x = np.uint8(i)
        acc = np.zeros(L, np.uint8)
        for j in range(k - 1, -1, -1):  # Horner
            acc = gf256.mul(acc, x) ^ coeffs[j]
        shares.append((i, acc.tobytes()))
    return shares


def combine(shares: list[tuple[int, bytes]], k: int) -> bytes:
    assert len(shares) >= k
    shares = shares[:k]
    xs = np.array([s[0] for s in shares], np.uint8)
    ys = np.stack([np.frombuffer(s[1], np.uint8) for s in shares])  # (k, L)
    # Lagrange interpolation at 0: secret = sum_i y_i * prod_{j!=i} x_j/(x_i^x_j)
    L = ys.shape[1]
    out = np.zeros(L, np.uint8)
    for i in range(k):
        num = np.uint8(1)
        den = np.uint8(1)
        for j in range(k):
            if i == j:
                continue
            num = gf256.mul(num, xs[j])
            den = gf256.mul(den, xs[i] ^ xs[j])
        lam = gf256.mul(num, gf256.inv(den))
        out ^= gf256.mul(ys[i], lam)
    return out.tobytes()
