"""ChaCha20 stream cipher (RFC 8439), numpy-vectorized across blocks.

Stands in for AES in S-IDA (the paper says "symmetric encryption, such as
AES"; the project depends on no crypto library).  Own copy of
``repro/core/chacha.py``.  Vectorizing the 20 rounds across all 64-byte
blocks of a message gives multi-MB/s throughput in pure numpy.
"""
from __future__ import annotations

import os

import numpy as np

_CONST = np.frombuffer(b"expand 32-byte k", dtype="<u4").copy()


def _rotl(v, n):
    return (v << np.uint32(n)) | (v >> np.uint32(32 - n))


def _quarter(s, a, b, c, d):
    s[a] += s[b]
    s[d] ^= s[a]
    s[d] = _rotl(s[d], 16)
    s[c] += s[d]
    s[b] ^= s[c]
    s[b] = _rotl(s[b], 12)
    s[a] += s[b]
    s[d] ^= s[a]
    s[d] = _rotl(s[d], 8)
    s[c] += s[d]
    s[b] ^= s[c]
    s[b] = _rotl(s[b], 7)


def keystream(key: bytes, nonce: bytes, nblocks: int,
              counter: int = 0) -> np.ndarray:
    """(nblocks*64,) uint8 keystream."""
    assert len(key) == 32 and len(nonce) == 12
    k = np.frombuffer(key, "<u4")
    n = np.frombuffer(nonce, "<u4")
    state = np.zeros((16, nblocks), np.uint32)
    state[0:4] = _CONST[:, None]
    state[4:12] = k[:, None]
    state[12] = (counter + np.arange(nblocks)).astype(np.uint32)
    state[13:16] = n[:, None]
    w = state.copy()
    old = np.seterr(over="ignore")
    try:
        for _ in range(10):  # 10 double rounds = 20 rounds
            _quarter(w, 0, 4, 8, 12)
            _quarter(w, 1, 5, 9, 13)
            _quarter(w, 2, 6, 10, 14)
            _quarter(w, 3, 7, 11, 15)
            _quarter(w, 0, 5, 10, 15)
            _quarter(w, 1, 6, 11, 12)
            _quarter(w, 2, 7, 8, 13)
            _quarter(w, 3, 4, 9, 14)
        w += state
    finally:
        np.seterr(**old)
    # serialize: blocks are columns; little-endian words, word-major per block
    return w.T.astype("<u4").tobytes()


def xor_stream(data: bytes, key: bytes, nonce: bytes,
               counter: int = 0) -> bytes:
    nblocks = (len(data) + 63) // 64
    ks = np.frombuffer(keystream(key, nonce, nblocks, counter), np.uint8)
    buf = np.frombuffer(data, np.uint8) ^ ks[:len(data)]
    return buf.tobytes()


def encrypt(data: bytes, key: bytes, nonce: bytes | None = None) -> bytes:
    """nonce-prefixed ciphertext (nonce || body)."""
    nonce = nonce or os.urandom(12)
    return nonce + xor_stream(data, key, nonce, counter=1)


def decrypt(blob: bytes, key: bytes) -> bytes:
    nonce, body = blob[:12], blob[12:]
    return xor_stream(body, key, nonce, counter=1)
