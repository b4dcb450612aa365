"""Hash-Radix tree (HR-tree): the decentralized KV-cache index (§3.3; own
copy of ``repro/core/hrtree.py``, same behaviour, hashing on a device).

Cuckoo-filter-inspired: tree nodes store *b-bit hashes* of variable-length
token chunks instead of the chunks themselves, so the aggregated KV-cache
state of every model node in a group fits in a compact structure that is
cheap to synchronize (each node periodically broadcasts its local subtree
as a list of hash paths).

Search (Algorithm 1): preprocess the prompt into chunk hashes using the
group's chunk-length array L (from the Sentry module), walk children by
hash, return (model-node pointers at the deepest matched node, depth d).
A match requires d >= tau_c; false-positive rate is (1/2^b)^d.

``chunk_hash`` and ``preprocess`` are the Python oracle.  ``HRTree`` and
model nodes hash through ``preprocess_batch``: the same chunks of many
prompts in one launch of the chunk-hash kernel on a CUDA device, or its
plain version on the CPU.  Hashes leave it as Python ints: they are dict
keys in the tree and msgpack'd in every sync broadcast.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch import require_device
from repro_torch.kernels.chunk_hash.ops import chunk_hash_ranges

# polynomial rolling hash over token ids (mirrored by kernels/chunk_hash)
_HASH_MULT = 1_000_003
_HASH_SEED = 0x9E3779B9


def chunk_hash(tokens: Sequence[int], bits: int = 8,
               seed: int = _HASH_SEED) -> int:
    h = seed
    for t in tokens:
        h = (h * _HASH_MULT + int(t) + 1) & 0xFFFFFFFF
    # xor-fold 32 -> bits
    out = 0
    x = h
    while x:
        out ^= x & ((1 << bits) - 1)
        x >>= bits
    return out


def chunk_spans(n: int, lengths: Sequence[int],
                default_chunk: int = 64) -> list[tuple[int, int]]:
    """(start, length) of each chunk of an ``n``-token prompt: the
    lengths of L in order while they fit (an ``ln <= 0`` entry or one that
    overruns the prompt ends them), then ``default_chunk``-token chunks
    from that position while whole ones fit.  So L=[100] on an 80-token
    prompt gives one chunk, tokens 0..63."""
    spans = []
    pos = 0
    for ln in lengths:
        if pos >= n or ln <= 0:
            break
        if pos + ln > n:
            break  # partial chunk: stop (prefix semantics)
        spans.append((pos, ln))
        pos += ln
    while pos + default_chunk <= n:
        spans.append((pos, default_chunk))
        pos += default_chunk
    return spans


def preprocess(tokens: Sequence[int], lengths: Sequence[int],
               bits: int = 8, default_chunk: int = 64) -> list[int]:
    """Variable-length chunking per L, then default_chunk for the tail."""
    return [chunk_hash(tokens[s:s + ln], bits)
            for s, ln in chunk_spans(len(tokens), lengths, default_chunk)]


def chunk_table(prompts: Sequence[Sequence[int]], lengths: Sequence[int],
                default_chunk: int = 64, device="cuda"):
    """The ranged chunk-hash kernel's inputs for ``prompts``: the prompts
    laid end to end and the (start, length) of each of their chunks, built
    on the host as ``preprocess`` walks them and sent to ``device`` as one
    int32 array.  Returns (tokens, starts, lens) views of it and each
    prompt's chunk count.  Token ids are taken mod 2^32, as the hash takes
    them."""
    dev = require_device(device)
    starts, lens, counts, offset = [], [], [], 0
    for p in prompts:
        spans = chunk_spans(len(p), lengths, default_chunk)
        starts += [offset + s for s, _ in spans]
        lens += [ln for _, ln in spans]
        counts.append(len(spans))
        offset += len(p)
    if offset >= 1 << 31:
        raise ValueError(f"{offset} tokens do not fit one int32 table")
    flat = np.concatenate([np.asarray(p, np.int64).reshape(-1) for p in prompts]
                          + [np.zeros(0, np.int64)])
    buf = torch.from_numpy(np.concatenate(
        [flat.astype(np.int32), np.asarray(starts, np.int32),
         np.asarray(lens, np.int32)])).to(dev)
    C = len(starts)
    return buf[:offset], buf[offset:offset + C], buf[offset + C:], counts


def preprocess_batch(prompts: Sequence[Sequence[int]], lengths: Sequence[int],
                     bits: int = 8, default_chunk: int = 64,
                     device="cuda") -> list[list[int]]:
    """``[preprocess(p, lengths, bits, default_chunk) for p in prompts]``
    in one kernel launch over ``chunk_table``, and one ``.cpu()``."""
    tokens, starts, lens, counts = chunk_table(prompts, lengths, default_chunk, device)
    if not sum(counts):
        return [[] for _ in prompts]
    hashes = chunk_hash_ranges(tokens, starts, lens, bits).cpu().tolist()
    out, i = [], 0
    for c in counts:
        out.append(hashes[i:i + c])
        i += c
    return out


@dataclass
class _Node:
    children: dict = field(default_factory=dict)     # hash -> _Node
    holders: dict = field(default_factory=dict)      # node_id -> ts


class HRTree:
    """Aggregated view of the group's cached prefixes; prompts are hashed
    on ``device`` (the chunk-hash kernel on the card, the plain version on
    the CPU)."""

    def __init__(self, lengths: Sequence[int], bits: int = 8,
                 default_chunk: int = 64, device="cuda"):
        self.lengths = list(lengths)
        self.bits = bits
        self.default_chunk = default_chunk
        self.device = require_device(device)
        self.root = _Node()

    def _hashes(self, tokens: Sequence[int]) -> list[int]:
        """The prompt's chunk hashes (``preprocess`` on the tree's device)."""
        return preprocess_batch([tokens], self.lengths, self.bits,
                                self.default_chunk, self.device)[0]

    # ---- building ----
    def insert_hashes(self, hashes: Iterable[int], holder, ts=None):
        ts = time.monotonic() if ts is None else ts
        node = self.root
        for h in hashes:
            node = node.children.setdefault(h, _Node())
            node.holders[holder] = ts

    def insert_tokens(self, tokens: Sequence[int], holder, ts=None):
        self.insert_hashes(self._hashes(tokens), holder, ts)

    # ---- search (Algorithm 1) ----
    def search_hashes(self, hashes: Sequence[int], tau: int
                      ) -> tuple[list, int]:
        node, d = self.root, 0
        for h in hashes:
            child = node.children.get(h)
            if child is None:
                break
            node, d = child, d + 1
        if d < tau:
            return [], d
        return list(node.holders.keys()), d

    def search_tokens(self, tokens: Sequence[int], tau: int
                      ) -> tuple[list, int]:
        return self.search_hashes(self._hashes(tokens), tau)

    # ---- sync ----
    def export_paths(self, holder) -> list[list[int]]:
        """Hash paths this holder appears on (leaf-deep only) — what a model
        node broadcasts in state synchronization."""
        out = []

        def walk(node, prefix):
            leafish = True
            for h, ch in node.children.items():
                if holder in ch.holders:
                    leafish = False
                    walk(ch, prefix + [h])
            if leafish and prefix:
                out.append(prefix)

        walk(self.root, [])
        return out

    def merge_paths(self, paths: Iterable[Sequence[int]], holder, ts=None):
        for p in paths:
            self.insert_hashes(p, holder, ts)

    def remove_holder(self, holder):
        def walk(node):
            node.holders.pop(holder, None)
            dead = []
            for h, ch in node.children.items():
                walk(ch)
                if not ch.holders and not ch.children:
                    dead.append(h)
            for h in dead:
                node.children.pop(h)

        walk(self.root)

    def expire(self, before_ts: float):
        def walk(node):
            for nid, ts in list(node.holders.items()):
                if ts < before_ts:
                    node.holders.pop(nid)
            dead = []
            for h, ch in node.children.items():
                walk(ch)
                if not ch.holders and not ch.children:
                    dead.append(h)
            for h in dead:
                node.children.pop(h)

        walk(self.root)

    # ---- stats ----
    def size(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            n += 1
            stack.extend(nd.children.values())
        return n

    def false_positive_rate(self, depth: int) -> float:
        return (1.0 / (1 << self.bits)) ** max(depth, 1)
