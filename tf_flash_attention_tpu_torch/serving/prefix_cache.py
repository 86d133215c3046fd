"""Prefix caching: refcounted shared KV pages keyed by token-chain hash.

Serving-runtime memory manager extension (no reference counterpart —
the reference is a stateless op library, SURVEY.md §5).  Two pieces:

* ``SharedPageAllocator`` — the engine's page allocator with reference
  counts, so one physical page can back the page tables of several live
  sequences (and the prefix registry) at once.  A page returns to the
  free list only when its last reference drops.

* ``PrefixCache`` — maps a *chain hash* of each page-aligned prompt
  prefix to the physical page holding its K/V.  The chain construction
  (``h_i = H(h_{i-1} || tokens of page i)``) means a hit on page ``i``
  guarantees every earlier page matched too, so lookup is a simple walk.
  Entries hold one reference each; an LRU eviction pass releases unused
  entries when the allocator runs dry.

Shared pages are always *full* prompt pages (positions ``< prompt_len``
rounded down to a page multiple), which after prefill are immutable —
decode appends land in later pages — so sharing needs no copy-on-write.
K/V contents depend only on (params, absolute positions, tokens), and a
prefix always starts at position 0, so byte-identical reuse is sound,
including the quantized payloads and their per-token scales.

Pure Python, carried over unchanged from the JAX package's
``serving/prefix_cache.py`` (same blake2b chain hash).
"""

from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Tuple

__all__ = ["SharedPageAllocator", "PrefixCache"]


class SharedPageAllocator:
    """Host-side free-list allocator with per-page reference counts."""

    def __init__(self, n_pages: int):
        self._free = list(range(n_pages - 1, -1, -1))
        self._rc: Dict[int, int] = {}
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n: int) -> List[int]:
        """Allocate ``n`` fresh pages (refcount 1) referenced by ``slot``."""
        if n > len(self._free):
            raise MemoryError(f"out of KV pages: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def share(self, slot: int, pages: List[int]) -> None:
        """Add ``slot`` as a referent of already-live ``pages``."""
        for p in pages:
            self._rc[p] += 1
        self._owned.setdefault(slot, []).extend(pages)

    def retain(self, page: int) -> None:
        """Take an extra (non-slot) reference, e.g. for the prefix registry."""
        self._rc[page] += 1

    def release(self, page: int) -> None:
        """Drop a non-slot reference taken with ``retain``."""
        self._decref(page)

    def owned(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, []))

    def release_prefix(self, slot: int, n: int) -> List[int]:
        """Drop ``slot``'s references to its first ``n`` owned pages (its
        oldest logical pages — sliding-window eviction).  Returns the
        released pages; pages still referenced elsewhere (shared prefixes,
        the registry) stay live."""
        pages = self._owned.get(slot, [])
        drop, self._owned[slot] = pages[:n], pages[n:]
        for p in drop:
            self._decref(p)
        return drop

    def free(self, slot: int) -> List[int]:
        """Drop all of ``slot``'s references; returns the pages released."""
        pages = self._owned.pop(slot, [])
        for p in reversed(pages):
            self._decref(p)
        return pages

    def _decref(self, page: int) -> None:
        rc = self._rc[page] - 1
        if rc == 0:
            del self._rc[page]
            self._free.append(page)
        else:
            self._rc[page] = rc


class PrefixCache:
    """Chain-hash registry of immutable full prompt pages."""

    def __init__(self, page_size: int):
        self.page_size = page_size
        # chain-hash -> physical page, in LRU order (oldest first)
        self._entries: "collections.OrderedDict[bytes, int]" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def _chain(self, tokens, n_pages: int):
        h = b"fa-prefix-v1"
        ps = self.page_size
        for i in range(n_pages):
            page_tokens = tokens[i * ps:(i + 1) * ps]
            payload = h + b"|" + b",".join(str(t).encode() for t in page_tokens)
            h = hashlib.blake2b(payload, digest_size=16).digest()
            yield h

    def lookup(self, tokens: List[int], max_tokens: Optional[int] = None
               ) -> Tuple[int, List[int]]:
        """Longest cached page-aligned prefix of ``tokens``.

        Returns ``(n_cached_tokens, pages)``.  ``max_tokens`` caps the hit
        (the engine always leaves at least one prompt token to prefill so
        it has logits to sample from).
        """
        limit = len(tokens) if max_tokens is None else min(max_tokens, len(tokens))
        n_full = limit // self.page_size
        pages: List[int] = []
        for i, key in enumerate(self._chain(tokens, n_full)):
            page = self._entries.get(key)
            if page is None:
                break
            self._entries.move_to_end(key)
            pages.append(page)
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return len(pages) * self.page_size, pages

    def insert(self, tokens: List[int], pages: List[int],
               alloc: SharedPageAllocator) -> None:
        """Register the full pages of a just-prefilled prompt.

        ``pages``: the physical pages backing the prompt, logical order.
        Each newly registered page takes one registry reference.
        """
        n_full = min(len(tokens) // self.page_size, len(pages))
        for i, key in enumerate(self._chain(tokens, n_full)):
            if key in self._entries:
                self._entries.move_to_end(key)
                continue
            alloc.retain(pages[i])
            self._entries[key] = pages[i]

    def evict(self, alloc: SharedPageAllocator, n_pages_needed: int) -> int:
        """Release LRU entries until ``alloc`` has ``n_pages_needed`` free
        (or nothing evictable is left).  Returns entries evicted."""
        evicted = 0
        for key in list(self._entries):
            if alloc.free_pages >= n_pages_needed:
                break
            page = self._entries.pop(key)
            alloc.release(page)
            evicted += 1
        return evicted
