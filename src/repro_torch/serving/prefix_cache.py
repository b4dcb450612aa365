"""Node-local KV-prefix cache: block-hash radix index + LRU by bytes (own
copy of ``repro/serving/prefix_cache.py``, same behaviour).

This is the *local* structure whose prefix set each model node summarizes
into its HR-tree broadcast (core/hrtree.py).  Lookup is O(len/B): the query
token stream is rolled into per-block chain hashes (strong SHA-based, no
false positives locally — the 8-bit compaction only happens in the HR-tree
sketch); entries register their KV handle at block granularity.
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

BLOCK = 32


def _chain_hashes(tokens: Sequence[int], block: int = BLOCK) -> list[bytes]:
    """Chain hash at every complete block boundary."""
    out = []
    h = hashlib.sha256()
    n = len(tokens) // block
    for b in range(n):
        chunk = tokens[b * block:(b + 1) * block]
        h.update(",".join(str(int(t)) for t in chunk).encode())
        out.append(h.digest()[:16])
    return out


@dataclass
class Entry:
    handle: object            # engine-owned KV handle (cache pytree + meta)
    length: int               # tokens covered (block-aligned)
    nbytes: int
    keys: list = field(default_factory=list)   # chain keys registered
    last_used: float = field(default_factory=time.monotonic)
    hits: int = 0


class PrefixCache:
    def __init__(self, max_bytes: int = 1 << 30, block: int = BLOCK):
        self.max_bytes = max_bytes
        self.block = block
        self._by_chain: dict[bytes, Entry] = {}
        self.used_bytes = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.total_tokens = 0
        # called with entry.handle when an entry becomes unreachable; a
        # paged engine hooks this to decref the entry's pages (pages stay
        # physically live while any in-flight request still aliases them)
        self.on_release = None
        # double-buffered sketch: the live buffer is grown incrementally
        # on insert (bloom bits are add-only), and an eviction marks it
        # dirty so the NEXT sketch_bytes() rebuilds from the surviving
        # chain keys — a sync after eviction never re-broadcasts the
        # evicted prefix's bits, and the steady state (no eviction since
        # the last sync) skips the O(entries x depths) rebuild entirely
        self._sketch = None
        self._sketch_dirty = True

    # ---- lookup ----
    def match(self, tokens: Sequence[int]) -> tuple[int, Optional[Entry]]:
        """Longest cached block-aligned prefix of ``tokens``.

        Every block depth of every inserted stream is indexed (radix
        semantics), so a request sharing only the first few blocks of a
        cached entry still reuses them."""
        chains = _chain_hashes(tokens, self.block)
        self.total_tokens += len(tokens)
        for d in range(len(chains), 0, -1):
            e = self._by_chain.get(chains[d - 1])
            if e is not None:
                e.last_used = time.monotonic()
                e.hits += 1
                self.hits += 1
                matched = min(d * self.block, e.length)
                self.hit_tokens += matched
                return matched, e
        self.misses += 1
        return 0, None

    def peek(self, tokens: Sequence[int]) -> tuple[int, Optional[Entry]]:
        """Read-only ``match``: no hit/miss counters, no LRU touch.

        For admission scans that probe many queued requests to *rank* them
        — only the winner's actual reuse should show up in stats."""
        chains = _chain_hashes(tokens, self.block)
        for d in range(len(chains), 0, -1):
            e = self._by_chain.get(chains[d - 1])
            if e is not None:
                return min(d * self.block, e.length), e
        return 0, None

    def entry_by_chain(self, digest: bytes) -> Optional[Entry]:
        """Entry registered under one chain digest, or None.  Read-only:
        no hit/miss counters, no LRU touch — the overlay's ``kv_fetch``
        handler probes by digest to decide whether a peer's replication
        request can still be served (the entry may have been evicted
        since the sketch broadcast that attracted the fetch)."""
        return self._by_chain.get(digest)

    # ---- insert ----
    def insert(self, tokens: Sequence[int], handle, nbytes: int):
        chains = _chain_hashes(tokens, self.block)
        length = (len(tokens) // self.block) * self.block
        self.insert_chains(chains, handle, nbytes, length)

    def insert_chains(self, chains: Sequence[bytes], handle, nbytes: int,
                      length: Optional[int] = None):
        """Insert an entry keyed by pre-computed BLOCK-chain digests.

        The cross-node page-migration importer lands here: ``kv_fetch``
        carried the request's digest chain, the holder's ``kv_pages``
        reply covers a prefix of it, and the importer registers the
        freshly scattered pages under those same digests — so the next
        admission's ``match`` aliases them with zero prefill work, exactly
        as if this node had prefilled the prefix itself."""
        chains = list(chains)
        if not chains:
            return
        length = (len(chains) * self.block) if length is None else length
        entry = Entry(handle, length, nbytes, keys=list(chains))
        self.used_bytes += nbytes
        for key in chains:
            old = self._by_chain.get(key)
            if old is not None and old is not entry:
                self._unlink(old, key)
            self._by_chain[key] = entry
        if self._sketch is not None and not self._sketch_dirty:
            from repro_torch.core.forwarding import sketch_size_for
            if sketch_size_for(len(self._by_chain)) != self._sketch.nbytes:
                # key count crossed a ladder rung: the live buffer is now
                # undersized for the bounded-fp target — rebuild at the
                # next sync instead of growing stale bits in place
                self._sketch_dirty = True
            else:
                for key in chains:   # grow the live buffer in place:
                    self._sketch.add(key)    # adding bits never goes stale
        self._evict()

    def _release(self, e: Entry):
        """An entry just became unreachable: return its bytes and hand its
        handle to the release hook exactly once."""
        self.used_bytes -= e.nbytes
        if self.on_release is not None and e.handle is not None:
            self.on_release(e.handle)

    def _unlink(self, e: Entry, key: bytes):
        """Take one chain key away from ``e`` (the caller re-points it);
        once an entry holds no keys it is unreachable — release its bytes
        so accounting stays exact (used_bytes == sum of live entries)."""
        try:
            e.keys.remove(key)
        except ValueError:
            return
        if not e.keys:
            self._release(e)

    def _drop(self, e: Entry):
        for k in e.keys:
            if self._by_chain.get(k) is e:
                self._by_chain.pop(k)
        e.keys.clear()
        self._release(e)
        # bloom bits cannot be cleared in place: flip to the rebuild
        # buffer so the next sketch_bytes() drops the evicted digests
        self._sketch_dirty = True

    def _evict(self):
        if self.used_bytes <= self.max_bytes:
            return
        entries = sorted({id(e): e for e in self._by_chain.values()}.values(),
                         key=lambda e: e.last_used)
        for e in entries:
            if self.used_bytes <= self.max_bytes:
                break
            self._drop(e)

    def pop_lru(self) -> bool:
        """Drop the least-recently-used entry (allocator-pressure path: a
        paged engine evicts until enough pages come free).  False if
        empty."""
        entries = {id(e): e for e in self._by_chain.values()}.values()
        if not entries:
            return False
        self._drop(min(entries, key=lambda e: e.last_used))
        return True

    # ---- HR-tree / sketch sync ----
    def sketch_bytes(self) -> bytes:
        """Serialized bloom fingerprint of this cache's chain digests
        (core/forwarding.PrefixSketch), broadcast in every hr_sync so
        peers can route sibling requests to the prefix holder.

        Double-buffered for freshness: inserts grow the live buffer
        incrementally, an eviction marks it dirty and the next call
        rebuilds from the surviving keys — an evicted prefix stops
        attracting affinity routes after the next sync instead of
        lingering as stale bloom bits.  The rebuild picks its size from
        the power-of-two ladder (``forwarding.sketch_size_for``) by live
        key count, so the false-positive rate stays bounded under churny
        working sets instead of saturating a fixed 64-byte bloom; an
        insert that crosses a ladder rung marks the live buffer dirty the
        same way an eviction does."""
        from repro_torch.core.forwarding import PrefixSketch
        if self._sketch is None or self._sketch_dirty:
            self._sketch = PrefixSketch.build(self._by_chain.keys())
            self._sketch_dirty = False
        return self._sketch.to_bytes()

    def cached_prefixes(self) -> list[tuple]:
        """(token-length, entry) view used to build HR-tree broadcasts —
        callers keep the original token streams alongside handles.
        Deduped by entry identity: an entry is indexed once per chain
        depth, and counting it once per key would inflate the node's
        advertised prefix count in every HR-tree broadcast."""
        uniq = {id(e): e for e in self._by_chain.values()}
        return [(e.length, e) for e in uniq.values()]

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    @property
    def token_hit_rate(self) -> float:
        return self.hit_tokens / self.total_tokens if self.total_tokens else 0.0
