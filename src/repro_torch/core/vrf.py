"""Verifiable random function from deterministic Ed25519 signatures.

beta = SHA512(sig(sk, alpha)); proof = the signature.  Uniqueness of honest
Ed25519 signatures makes the output unpredictable-but-verifiable — the
construction the committee uses for epoch leader election (§3.4): the seed
alpha is the final commit hash of the previous epoch.

Own copy of ``repro/core/vrf.py``, byte for byte in what it computes.
"""
from __future__ import annotations

import hashlib

from repro_torch.core import ed25519


def prove(sk: ed25519.SigningKey, alpha: bytes) -> tuple[bytes, bytes]:
    proof = sk.sign(b"vrf:" + alpha)
    beta = hashlib.sha512(proof).digest()
    return beta, proof


def verify(public: bytes, alpha: bytes, beta: bytes, proof: bytes) -> bool:
    if not ed25519.verify(public, b"vrf:" + alpha, proof):
        return False
    return hashlib.sha512(proof).digest() == beta


def leader_index(seeds: list[bytes], n: int) -> int:
    """Deterministic index from committee-agreed randomness."""
    h = hashlib.sha256(b"".join(seeds)).digest()
    return int.from_bytes(h[:8], "big") % n
