"""Host-side page allocator for the node-wide paged KV pool (own copy of
``repro/serving/page_pool.py``, same behaviour).

The device side is one ``(num_pages, BLOCK, n_kv, d_head)`` K/V arena per
layer (``models/lm.py`` ``paged_arena_zeros``); this module owns which
physical pages are live and who references them.  Pages are refcounted so
a prefix-cache entry and any number of in-flight requests can alias the
same physical pages: ``alloc`` hands a page out at refcount 1, every
additional borrower ``incref``s, and a page returns to the free list only
when the last reference ``decref``s it.

Physical page 0 is reserved as a scratch ("null") page: inactive rows
point their page tables at it so a batched dispatch has somewhere harmless
to write masked rows' K/V; it is never allocated and never read unmasked.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

NULL_PAGE = 0


class OutOfPages(RuntimeError):
    """Raised when ``alloc`` cannot satisfy a request (caller may evict
    prefix-cache entries to release pages and retry)."""


@dataclass(frozen=True)
class PagedHandle:
    """What a prefix-cache entry holds for a paged engine: physical page
    ids covering ``length`` block-aligned tokens.  Pure indices — the KV
    bytes live in the engine's arena and are never copied."""
    pages: tuple
    length: int               # tokens covered (block-aligned)

    def prefix(self, depth: int, block: int) -> "PagedHandle":
        """The handle's leading ``depth`` blocks as a new handle (pure
        index slice, no refcount movement).  Cross-node page migration
        exports by prefix: a ``kv_fetch`` may cover fewer blocks than the
        entry holds, and chain digests guarantee only the leading blocks
        match the request."""
        if not 1 <= depth <= len(self.pages):
            raise ValueError(f"depth {depth} of {len(self.pages)} pages")
        return PagedHandle(self.pages[:depth],
                           min(self.length, depth * block))


class PageAllocator:
    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the scratch page)")
        self.num_pages = num_pages
        self._refs = [0] * num_pages
        self._refs[NULL_PAGE] = -1          # scratch: never allocatable
        # LIFO free list: recently freed pages are re-handed first (warm)
        self._free = list(range(num_pages - 1, 0, -1))

    # ---- queries ----
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return (self.num_pages - 1) - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs[page]

    # ---- lifecycle ----
    def alloc(self, n: int = 1) -> list:
        """n fresh pages at refcount 1; raises OutOfPages if unavailable."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            raise OutOfPages(f"need {n} pages, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, pages: Iterable[int]):
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot reference the scratch page")
            if self._refs[p] <= 0:
                raise ValueError(f"incref of free page {p}")
            self._refs[p] += 1

    def decref(self, pages: Iterable[int]):
        """Drop one reference per page; pages hitting 0 return to the free
        list.  Decref of an already-free page is a hard error (double
        free)."""
        for p in pages:
            if p == NULL_PAGE:
                raise ValueError("cannot release the scratch page")
            if self._refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)

    def check(self):
        """Internal invariant: every non-scratch page is either free
        (refcount 0, on the free list once) or live (refcount > 0)."""
        free = set(self._free)
        assert len(free) == len(self._free), "free-list duplicate"
        for p in range(1, self.num_pages):
            if p in free:
                assert self._refs[p] == 0, f"page {p} free with refs"
            else:
                assert self._refs[p] > 0, f"page {p} leaked (refs 0, not free)"
