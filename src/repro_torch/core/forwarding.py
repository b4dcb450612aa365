"""Overlay forwarding decision (Algorithm 2) + relative-load balancing
+ prefix-affinity routing over block-digest sketches (own copy of
``repro/core/forwarding.py``, same behaviour).

Executed by EVERY model node on receiving a user request: check the
peers' prefix sketches for the longest cached block-aligned prefix and
route to its holder unless that holder is under memory or load pressure;
otherwise search the HR-tree; on a match, filter holders above the load
threshold and pick the least (relatively) loaded; on a miss (or all
holders overloaded), fall back to global least-relative-load.  Relative
load = active requests / hardware score (1..10), per §3.3.

The sketch is a fixed-size bloom fingerprint over the chain digests that
``serving/prefix_cache.py`` registers per BLOCK of every cached stream.
It is finer-grained than the HR-tree (BLOCK=32 tokens vs the 64-token
sync chunks) and per-peer rather than aggregated, so a sibling request
whose prefix is cached on exactly one node routes there instead of
re-prefilling the same KV bytes on a load-picked stranger.  False
positives only cost a wasted co-location (the target re-prefills); they
never affect correctness, and the prefix-scan containment test keeps the
effective rate at fp^depth.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

SKETCH_BYTES = 64              # smallest bloom size on the ladder (512 bits)
SKETCH_HASHES = 4              # buckets per digest
# power-of-two ladder: a cache whose live chain-key count outgrows one
# rung rebuilds its sketch at the next (the hr_sync wire field carries
# raw bytes, so any rung deserializes); capped so a pathological cache
# cannot inflate every sync broadcast unboundedly
SKETCH_LADDER = (64, 128, 256, 512, 1024)
SKETCH_BITS_PER_KEY = 16       # >= 16 bits/key keeps fp ~ 0.2% at k=4


def sketch_size_for(n_keys: int) -> int:
    """Smallest ladder size (bytes) holding ``n_keys`` digests at the
    bounded-fp bit budget; the top rung once the budget can't be met."""
    for nbytes in SKETCH_LADDER:
        if n_keys * SKETCH_BITS_PER_KEY <= nbytes * 8:
            return nbytes
    return SKETCH_LADDER[-1]


def _sketch_buckets(digest: bytes, m_bits: int,
                    k: int = SKETCH_HASHES) -> list[int]:
    """Bucket indices for one chain digest.  Digests are SHA-256 prefixes
    (serving/prefix_cache._chain_hashes) — already uniform, so slicing
    2-byte windows gives k independent buckets without re-hashing."""
    return [int.from_bytes(digest[2 * i:2 * i + 2], "little") % m_bits
            for i in range(k)]


class PrefixSketch:
    """Bloom fingerprint over block-chain digests, sized off the ladder.

    Built by a model node over its prefix cache's registered chain keys
    (one per BLOCK depth of every cached stream) and broadcast in every
    HR-tree sync; ``decide`` probes it with the request's own chain
    digests to find the peer holding the longest cached prefix.
    ``from_bytes`` accepts any ladder size — the wire field is raw bytes,
    so peers on different rungs interoperate."""

    __slots__ = ("bits", "nbytes")

    def __init__(self, bits: int = 0, nbytes: int = SKETCH_BYTES):
        self.bits = bits
        self.nbytes = nbytes

    @classmethod
    def build(cls, digests, nbytes: Optional[int] = None) -> "PrefixSketch":
        digests = list(digests)
        s = cls(nbytes=nbytes or sketch_size_for(len(digests)))
        for d in digests:
            s.add(d)
        return s

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrefixSketch":
        return cls(int.from_bytes(data, "little"), max(len(data), 1))

    def to_bytes(self) -> bytes:
        return self.bits.to_bytes(self.nbytes, "little")

    def add(self, digest: bytes):
        for b in _sketch_buckets(digest, self.nbytes * 8):
            self.bits |= 1 << b

    def __contains__(self, digest: bytes) -> bool:
        return all(self.bits >> b & 1
                   for b in _sketch_buckets(digest, self.nbytes * 8))

    def hit_depth(self, digests: Sequence[bytes]) -> int:
        """Longest prefix of ``digests`` fully contained in the sketch.

        Chain digests are cumulative, so a true cache entry registers
        every shallower depth too — scanning forward and stopping at the
        first miss compounds the bloom false-positive rate per block."""
        d = 0
        for dg in digests:
            if dg not in self:
                break
            d += 1
        return d


@dataclass
class PeerInfo:
    node_id: object
    hw_score: float = 5.0          # 1..10 hardware capacity score
    active_requests: int = 0
    latency_ms: float = 0.0
    kv_usage: float = 0.0
    # fraction of the peer's paged-KV arena in use (0..1); 0 when the peer
    # has no paged real engine.  Broadcast by model nodes so forwarding can
    # see memory pressure, not just slot occupancy.
    kv_pressure: float = 0.0
    # fraction of speculative draft tokens the peer's engine accepted
    # (0..1; 0 until it drafts).  Broadcast alongside kv_pressure and
    # consumed by decide(): decode-heavy requests break load ties toward
    # the peer committing the most tokens per verify dispatch
    # (ForwardingConfig.accept_rate_routing).
    spec_accept_rate: float = 0.0
    # serialized PrefixSketch (SKETCH_BYTES bloom over the peer's cached
    # block-chain digests), refreshed by every hr_sync; None until the
    # peer's first broadcast — affinity then simply skips it.
    prefix_sketch: Optional[bytes] = None
    _sketch_memo: object = None    # (bytes, PrefixSketch) decode cache

    @property
    def relative_load(self) -> float:
        return self.active_requests / max(self.hw_score, 1e-6)

    def sketch(self) -> Optional[PrefixSketch]:
        """Deserialized prefix sketch, memoized per broadcast payload —
        decide() probes every peer on every request, but the sketch only
        changes when an hr_sync replaces ``prefix_sketch``."""
        raw = self.prefix_sketch
        if not raw:
            return None
        if self._sketch_memo is None or self._sketch_memo[0] is not raw:
            self._sketch_memo = (raw, PrefixSketch.from_bytes(raw))
        return self._sketch_memo[1]


@dataclass
class ForwardingConfig:
    tau_match: int = 2             # min HR-tree depth for a cache match
    load_threshold: float = 4.0    # max relative load for cache-affinity pick
    bits: int = 8
    affinity: bool = True          # sketch-based prefix-affinity routing
    affinity_min_blocks: int = 1   # min BLOCK-chain depth for an affinity pick
    kv_pressure_max: float = 0.85  # veto affinity into a nearly-full arena
    # affinity gets a TIGHTER load bound than the HR-tree holder pick:
    # concentrating siblings is only a win while the holder has slack —
    # past ~1 active request per hw point, queueing outweighs the saved
    # prefill and the balancer must take over
    affinity_load_max: float = 1.0
    # cross-node KV page replication: when every sketch hit is vetoed by
    # pressure/load, route to the least-loaded eligible peer WITH a fetch
    # hint (vetoed holder id + hit depth) so the target pulls the prefix
    # pages over the overlay instead of re-prefilling them — the
    # kv_pressure signal used in reverse: the holder sheds traffic
    # without losing the prefix.  Short prefixes re-prefill cheaper than
    # they ship; ``replicate_min_blocks`` is that floor.
    replicate: bool = True
    replicate_min_blocks: int = 2
    # a holder under extreme arena pressure refuses kv_fetch (the entry
    # is about to be evicted anyway; the importer just prefills)
    export_pressure_max: float = 0.98
    # accept-rate-aware routing: decode-heavy requests (n_out exceeds the
    # prompt length) break load ties toward peers whose speculative
    # verify rounds commit more tokens per dispatch — the decode-side
    # analogue of prefix affinity's prefill-side preference
    accept_rate_routing: bool = True


@dataclass
class Decision:
    target: object
    # "affinity" | "replicate" | "cache_hit" | "load_balance" | "self"
    reason: str
    depth: int = 0
    candidates: tuple = ()
    # replicate only: the vetoed sketch holder the target should pull
    # ``depth`` blocks of prefix pages from before admitting the request
    fetch_from: object = None


def _tiebreak(node_id, tokens) -> int:
    """Per-request pseudo-random tiebreak: equal-load nodes would otherwise
    herd onto one member between state-sync ticks."""
    import zlib
    return zlib.crc32(f"{node_id}|{list(tokens[:8])}".encode())


def _sketch_hits(cfg: ForwardingConfig, peers: dict, tokens) -> list:
    """(depth, peer) for every sketch covering at least
    ``affinity_min_blocks`` leading blocks of the request — veto-free;
    the caller partitions into routable hits and pressure/load-vetoed
    holders (which the replicate path can still pull pages from)."""
    if not any(p.prefix_sketch for p in peers.values()):
        return []               # cold start / latency-only overlay: don't
                                # pay the digest chain for nobody
    # local import: prefix_cache imports nothing from core, so the digest
    # function is reached lazily to keep this module stdlib-only at import
    from repro_torch.serving.prefix_cache import _chain_hashes
    digests = _chain_hashes(tokens)
    if not digests:
        return []
    hits = []
    for p in peers.values():
        sk = p.sketch()
        if sk is None:
            continue
        d = sk.hit_depth(digests)
        if d >= cfg.affinity_min_blocks:
            hits.append((d, p))
    return hits


def _affinity_vetoed(cfg: ForwardingConfig, p: PeerInfo) -> bool:
    """Affinity must never pile siblings onto a node that would evict the
    very prefix they came for (``kv_pressure_max``), or queue them behind
    a backlog that costs more than the prefill they skip
    (``affinity_load_max``)."""
    return (p.kv_pressure > cfg.kv_pressure_max
            or p.relative_load > cfg.affinity_load_max)


def decide(cfg: ForwardingConfig, hrtree, peers: dict, tokens,
           self_id=None, n_out: int = 0) -> Decision:
    """peers: {node_id: PeerInfo} for the whole group (state sync view).

    ``n_out`` (expected generation length) makes the load-balance
    tiebreak accept-rate-aware: a decode-heavy request, whose cost is
    verify dispatches rather than prefill, breaks load ties toward the
    peer committing the most draft tokens per dispatch."""
    live = {nid: p for nid, p in peers.items()}
    decode_heavy = bool(cfg.accept_rate_routing and n_out > len(tokens))

    def rank(p: PeerInfo):
        # accept rate sorts strictly AFTER load — it breaks ties, never
        # outvotes the balancer — and before latency/tiebreak so equal-
        # rate peers keep the exact legacy (deterministic) ordering
        spec = -p.spec_accept_rate if decode_heavy else 0.0
        return (p.relative_load, spec, p.latency_ms,
                _tiebreak(p.node_id, tokens))

    if cfg.affinity:
        hits = _sketch_hits(cfg, live, tokens)
        routable = [(d, p) for d, p in hits
                    if not _affinity_vetoed(cfg, p)]
        if routable:
            best_d = max(d for d, _ in routable)
            cands = [p for d, p in routable if d == best_d]
            best = min(cands, key=rank)
            return Decision(best.node_id, "affinity", best_d,
                            tuple(p.node_id for p in cands))
        if cfg.replicate and hits:
            # every sketch hit is vetoed: instead of silently dropping
            # the affinity and re-prefilling the hottest prefix on a
            # load-picked stranger, route to the least-loaded peer that
            # can HOST the pages and tell it where to pull them from
            best_d = max(d for d, _ in hits)
            if best_d >= cfg.replicate_min_blocks:
                holder = min((p for d, p in hits if d == best_d), key=rank)
                targets = [p for p in live.values()
                           if p.node_id != holder.node_id
                           and not _affinity_vetoed(cfg, p)]
                if targets:
                    best = min(targets, key=rank)
                    return Decision(best.node_id, "replicate", best_d,
                                    (holder.node_id,),
                                    fetch_from=holder.node_id)
    holders, depth = hrtree.search_tokens(tokens, cfg.tau_match)
    if holders:
        cands = [live[h] for h in holders if h in live]
        cands = [p for p in cands if p.relative_load <= cfg.load_threshold]
        if cands:
            best = min(cands, key=rank)
            return Decision(best.node_id, "cache_hit", depth,
                            tuple(p.node_id for p in cands))
    if not live:
        return Decision(self_id, "self", depth)
    best = min(live.values(), key=rank)
    return Decision(best.node_id, "load_balance", depth)
