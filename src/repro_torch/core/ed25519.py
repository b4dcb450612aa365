"""Pure-python Ed25519 (RFC 8032) + X25519 Diffie-Hellman.

Node identities, committee list signing, and onion-hop key agreement.
Reference-style implementation (extended coordinates, deterministic
nonces); speed is adequate for overlay control-plane traffic (~ms/op).

Own copy of ``repro/core/ed25519.py``, byte for byte in what it computes.
"""
from __future__ import annotations

import hashlib
import os

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

_BX = None
_BY = 4 * pow(5, P - 2, P) % P


def _recover_x(y, sign):
    xx = (y * y - 1) * pow(D * y * y + 1, P - 2, P)
    x = pow(xx, (P + 3) // 8, P)
    if (x * x - xx) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - xx) % P != 0:
        raise ValueError("invalid point")
    if x % 2 != sign:
        x = P - x
    return x


_BX = _recover_x(_BY, 0)
B = (_BX, _BY, 1, _BX * _BY % P)  # extended coords (X, Y, Z, T)
IDENT = (0, 1, 1, 0)


def _add(p, q):
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    Bv = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dv = 2 * Z1 * Z2 % P
    E, F, G, H = Bv - A, Dv - C, Dv + C, Bv + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def _mul(s, p):
    q = IDENT
    while s > 0:
        if s & 1:
            q = _add(q, p)
        p = _add(p, p)
        s >>= 1
    return q


def _compress(p):
    X, Y, Z, _ = p
    zi = pow(Z, P - 2, P)
    x, y = X * zi % P, Y * zi % P
    return ((y | ((x & 1) << 255)).to_bytes(32, "little"))


def _decompress(b: bytes):
    v = int.from_bytes(b, "little")
    sign = v >> 255
    y = v & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    return (x, y, 1, x * y % P)


def _h(*parts) -> int:
    h = hashlib.sha512()
    for p in parts:
        h.update(p)
    return int.from_bytes(h.digest(), "little")


class SigningKey:
    def __init__(self, seed: bytes | None = None):
        self.seed = seed or os.urandom(32)
        h = hashlib.sha512(self.seed).digest()
        a = int.from_bytes(h[:32], "little")
        a &= (1 << 254) - 8
        a |= 1 << 254
        self._a = a
        self._prefix = h[32:]
        self.public = _compress(_mul(a, B))

    def sign(self, msg: bytes) -> bytes:
        r = _h(self._prefix, msg) % L
        R = _compress(_mul(r, B))
        k = _h(R, self.public, msg) % L
        s = (r + k * self._a) % L
        return R + s.to_bytes(32, "little")


def verify(public: bytes, msg: bytes, sig: bytes) -> bool:
    try:
        A = _decompress(public)
        R = _decompress(sig[:32])
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return False
        k = _h(sig[:32], public, msg) % L
        lhs = _mul(s, B)
        rhs = _add(R, _mul(k, A))
        return _compress(lhs) == _compress(rhs)
    except Exception:
        return False


# --------------------------------------------------------------------------
# X25519 (Montgomery ladder) for onion-hop key agreement
# --------------------------------------------------------------------------

def _x25519_clamp(k: bytes) -> int:
    a = bytearray(k)
    a[0] &= 248
    a[31] &= 127
    a[31] |= 64
    return int.from_bytes(bytes(a), "little")


def x25519(scalar: bytes, point: bytes = None) -> bytes:
    k = _x25519_clamp(scalar)
    u = 9 if point is None else int.from_bytes(point, "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        bit = (k >> t) & 1
        if swap ^ bit:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = bit
        A = (x2 + z2) % P
        Bv = (x2 - z2) % P
        AA = A * A % P
        BB = Bv * Bv % P
        E = (AA - BB) % P
        C = (x3 + z3) % P
        Dv = (x3 - z3) % P
        DA = Dv * A % P
        CB = C * Bv % P
        x3 = (DA + CB) % P
        x3 = x3 * x3 % P
        z3 = (DA - CB) % P
        z3 = x1 * z3 * z3 % P
        x2 = AA * BB % P
        z2 = E * (AA + 121665 * E) % P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, P - 2, P) % P
    return out.to_bytes(32, "little")


def dh_keypair(seed: bytes | None = None):
    sk = seed or os.urandom(32)
    return sk, x25519(sk)


def dh_shared(sk: bytes, peer_pub: bytes) -> bytes:
    return hashlib.sha256(x25519(sk, peer_pub)).digest()
