"""Node-local KV-prefix cache: block-hash radix index + LRU by bytes (own
copy of ``repro/serving/prefix_cache.py``, same behaviour, without the
bloom-sketch upkeep that the overlay slice will bring).

Lookup is O(len/B): the token stream is rolled into per-block chain hashes
(SHA-based, no false positives); entries register their KV handle at block
granularity.
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
    for b in range(len(tokens) // block):
        chunk = tokens[b * block:(b + 1) * block]
        h.update(",".join(str(int(t)) for t in chunk).encode())
        out.append(h.digest()[:16])
    return out


@dataclass
class Entry:
    handle: object            # engine-owned KV handle
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
        # live while any in-flight request still aliases them)
        self.on_release = None

    # ---- lookup ----
    def match(self, tokens: Sequence[int]) -> tuple[int, Optional[Entry]]:
        """Longest cached block-aligned prefix of ``tokens``.  Every block
        depth of every inserted stream is indexed (radix semantics)."""
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
        """Read-only ``match``: no hit/miss counters, no LRU touch (for
        admission scans that rank queued requests)."""
        chains = _chain_hashes(tokens, self.block)
        for d in range(len(chains), 0, -1):
            e = self._by_chain.get(chains[d - 1])
            if e is not None:
                return min(d * self.block, e.length), e
        return 0, None

    # ---- insert ----
    def insert(self, tokens: Sequence[int], handle, nbytes: int):
        chains = _chain_hashes(tokens, self.block)
        if not chains:
            return
        length = len(chains) * self.block
        entry = Entry(handle, length, nbytes, keys=list(chains))
        self.used_bytes += nbytes
        for key in chains:
            old = self._by_chain.get(key)
            if old is not None and old is not entry:
                self._unlink(old, key)
            self._by_chain[key] = entry
        self._evict()

    def _release(self, e: Entry):
        """An entry just became unreachable: return its bytes and hand its
        handle to the release hook exactly once."""
        self.used_bytes -= e.nbytes
        if self.on_release is not None and e.handle is not None:
            self.on_release(e.handle)

    def _unlink(self, e: Entry, key: bytes):
        """Take one chain key away from ``e`` (the caller re-points it);
        once an entry holds no keys it is unreachable and released."""
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
        """Drop the least-recently-used entry (allocator-pressure path).
        False if empty."""
        entries = {id(e): e for e in self._by_chain.values()}.values()
        if not entries:
            return False
        self._drop(min(entries, key=lambda e: e.last_used))
        return True
