"""S-IDA: Secure Information Dispersal (Krawczyk '93), exactly the paper's
recipe (§3.2):

  1. encrypt M under a fresh symmetric key K           (ChaCha20 here)
  2. split {M}_K into n fragments with k-threshold Rabin IDA
  3. split K into n shares with k-threshold Shamir SSS
  4. clove_i = (i, M_i, K_i); send each clove on a distinct path
  5. any k cloves recover K (SSS) then M (IDA + decrypt)

< k cloves: the key shares reveal nothing (information-theoretic) and the
IDA fragments are ciphertext slices.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.core import chacha, ida, shamir


@dataclass(frozen=True)
class Clove:
    index: int          # 0-based fragment index
    frag: bytes         # Rabin-IDA fragment of {M}_K
    key_share: bytes    # Shamir share of K (x = index+1)
    n: int
    k: int

    def encode(self) -> bytes:
        import struct
        return (struct.pack("<BBBH", self.n, self.k, self.index,
                            len(self.key_share))
                + self.key_share + self.frag)

    @staticmethod
    def decode(blob: bytes) -> "Clove":
        import struct
        n, k, ix, klen = struct.unpack("<BBBH", blob[:5])
        return Clove(ix, blob[5 + klen:], blob[5:5 + klen], n, k)


def make_cloves(message: bytes, n: int, k: int, key: bytes | None = None
                ) -> list[Clove]:
    key = key or os.urandom(32)
    ct = chacha.encrypt(message, key)
    frags = ida.split(ct, n, k)
    shares = shamir.split(key, n, k)
    return [Clove(i, frags[i][1], shares[i][1], n, k) for i in range(n)]


def recover(cloves: list[Clove]) -> bytes:
    assert cloves, "no cloves"
    n, k = cloves[0].n, cloves[0].k
    uniq = {c.index: c for c in cloves}
    cs = list(uniq.values())
    if len(cs) < k:
        raise ValueError(f"need {k} cloves, have {len(cs)}")
    key = shamir.combine([(c.index + 1, c.key_share) for c in cs], k)
    ct = ida.combine([(c.index, c.frag) for c in cs], n, k)
    return chacha.decrypt(ct, key)
