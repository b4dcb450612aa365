"""Committee-maintained node registry (§3.1).

Verification nodes' IPs/pubkeys are public.  Users/model nodes register
(id, pubkey, region, hw_score); the committee signs the resulting lists —
a list is valid iff > 2/3 of the committee signed it.  Regions partition
large deployments (>=1000 users per region for anonymity; model groups
split at 50, §3.3).  Own copy of ``repro/overlay/registry.py``: the same
digests and signatures to the byte.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core import ed25519

MODEL_GROUP_MAX = 50
REGION_MIN_USERS = 1000


@dataclass
class NodeRecord:
    node_id: object
    pubkey: bytes = b""
    dh_pub: bytes = b""
    region: str = "r0"
    hw_score: float = 5.0
    llm: str = ""


def _digest(records: list) -> bytes:
    payload = json.dumps(
        [[str(r.node_id), r.pubkey.hex(), r.dh_pub.hex(), r.region,
          r.hw_score, r.llm] for r in sorted(records,
                                             key=lambda r: str(r.node_id))]
    ).encode()
    return hashlib.sha256(payload).digest()


@dataclass
class SignedList:
    records: list
    signatures: dict = field(default_factory=dict)  # vn_id -> sig

    def digest(self) -> bytes:
        return _digest(self.records)

    def verify(self, committee_pubs: dict) -> bool:
        d = self.digest()
        ok = sum(1 for vn, sig in self.signatures.items()
                 if vn in committee_pubs
                 and ed25519.verify(committee_pubs[vn], d, sig))
        return 3 * ok > 2 * len(committee_pubs)


class Registry:
    """In-committee registry state (replicated via the BFT layer)."""

    def __init__(self, committee_keys: dict, use_crypto: bool = True):
        self.committee_keys = committee_keys      # vn_id -> SigningKey
        self.committee_pubs = {k: v.public for k, v in committee_keys.items()}
        self.users: dict = {}
        self.models: dict = {}
        self.use_crypto = use_crypto

    def register_user(self, rec: NodeRecord):
        self.users[rec.node_id] = rec

    def register_model(self, rec: NodeRecord):
        self.models[rec.node_id] = rec

    def deregister(self, node_id):
        self.users.pop(node_id, None)
        self.models.pop(node_id, None)

    def _sign(self, records: list) -> SignedList:
        sl = SignedList(records)
        if self.use_crypto:
            d = sl.digest()
            for vn, key in self.committee_keys.items():
                sl.signatures[vn] = key.sign(d)
        return sl

    def user_list(self, region: Optional[str] = None) -> SignedList:
        recs = [r for r in self.users.values()
                if region is None or r.region == region]
        return self._sign(recs)

    def model_list(self, llm: Optional[str] = None,
                   region: Optional[str] = None) -> SignedList:
        recs = [r for r in self.models.values()
                if (llm is None or r.llm == llm)
                and (region is None or r.region == region)]
        return self._sign(recs)

    def model_groups(self, llm: str) -> list[list]:
        """Split a logical group above MODEL_GROUP_MAX (by region first)."""
        recs = [r for r in self.models.values() if r.llm == llm]
        by_region: dict = {}
        for r in recs:
            by_region.setdefault(r.region, []).append(r)
        groups = []
        for region, rs in sorted(by_region.items()):
            for i in range(0, len(rs), MODEL_GROUP_MAX):
                groups.append(rs[i:i + MODEL_GROUP_MAX])
        return groups
