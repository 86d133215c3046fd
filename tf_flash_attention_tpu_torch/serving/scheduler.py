"""Continuous-batching scheduler.

Decides which queued requests to admit into free decode slots, subject to
KV-page availability — the serving-runtime control plane (no reference
counterpart; the reference is a stateless op library).  FCFS admission
with page-budget checks; requests whose prompt cannot fit are held, not
dropped.  Pure Python, carried over unchanged from the JAX package's
``serving/scheduler.py``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List

__all__ = ["Request", "Scheduler"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    # upper bound on pages the request can hold at once; set by the engine
    # for sliding-window models (lazy paging + eviction keep the live set
    # window-bounded, so admission need not reserve full-length pages)
    pages_cap: int = -1

    def pages_needed(self, page_size: int) -> int:
        total = self.prompt_len + self.max_new_tokens
        pages = -(-total // page_size)
        return min(pages, self.pages_cap) if self.pages_cap >= 0 else pages


class Scheduler:
    """FCFS continuous-batching admission control."""

    def __init__(self, max_seqs: int, n_pages: int, page_size: int):
        self.max_seqs = max_seqs
        self.page_size = page_size
        self._queue: Deque[Request] = collections.deque()
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        self._budget = n_pages

    def enqueue(self, req: Request) -> None:
        self._queue.append(req)

    @property
    def queued(self) -> int:
        return len(self._queue)

    def admit(self) -> List[tuple]:
        """Pop (request, slot) pairs admissible right now (reserves budget)."""
        admitted = []
        while self._queue and self._free_slots:
            req = self._queue[0]
            need = req.pages_needed(self.page_size)
            if need > self._budget:
                break  # FCFS: do not skip ahead of a blocked request
            self._queue.popleft()
            slot = self._free_slots.pop()
            self._budget -= need
            admitted.append((req, slot))
        return admitted

    def release(self, slot: int, pages_held: int) -> None:
        self._free_slots.append(slot)
        self._budget += pages_held

    def refund(self, n_pages: int) -> None:
        """Return budget for pages a still-active slot released early
        (sliding-window eviction)."""
        self._budget += n_pages
