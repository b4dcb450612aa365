"""GF(2^8) arithmetic (AES polynomial 0x11B), numpy-vectorized.

Log/antilog tables over generator 3; element 0 handled explicitly.
Used by Rabin-IDA (ida.py) and Shamir secret sharing (shamir.py).
"""
from __future__ import annotations

import numpy as np

_POLY = 0x11B

EXP = np.zeros(512, np.uint8)
LOG = np.zeros(256, np.int32)
x = 1
for i in range(255):
    EXP[i] = x
    LOG[x] = i
    # multiply x by the generator 3:  3*x = (2*x) xor x
    x2 = (x << 1) ^ (_POLY if (x << 1) & 0x100 else 0)
    x = (x2 ^ x) & 0xFF
EXP[255:510] = EXP[:255]
LOG[0] = -512  # sentinel: anything + LOG[0] stays far negative


def mul(a, b):
    """Elementwise GF(256) product of uint8 arrays (broadcasting)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    la, lb = LOG[a], LOG[b]
    out = EXP[np.maximum(la + lb, 0) % 255]
    return np.where((a == 0) | (b == 0), np.uint8(0), out).astype(np.uint8)


def inv(a):
    a = np.asarray(a, np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("GF(256) inverse of 0")
    return EXP[(255 - LOG[a]) % 255].astype(np.uint8)


def matmul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """GF(256) matrix product: (m,k) @ (k,n) -> (m,n), XOR-accumulated."""
    A = np.asarray(A, np.uint8)
    B = np.asarray(B, np.uint8)
    m, k = A.shape
    k2, n = B.shape
    assert k == k2
    out = np.zeros((m, n), np.uint8)
    for j in range(k):  # k is small (the IDA threshold); vectorize over n
        out ^= mul(A[:, j][:, None], B[j][None, :])
    return out


def mat_inv(A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a (k,k) GF(256) matrix."""
    A = np.array(A, np.uint8)
    k = A.shape[0]
    aug = np.concatenate([A, np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        piv = col + int(np.nonzero(aug[col:, col])[0][0])
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        aug[[col, piv]] = aug[[piv, col]]
        aug[col] = mul(aug[col], inv(aug[col, col]))
        for r in range(k):
            if r != col and aug[r, col]:
                aug[r] ^= mul(aug[r, col], aug[col])
    return aug[:, k:]
