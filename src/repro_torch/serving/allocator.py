"""Host-side page allocator and the engine's backpressure error (port of
``repro/serving/batcher.py::PageAllocator`` and
``repro/serving/engine.py::CacheExhausted``).

The engine's KV pool is ``pool_pages`` pages of ``page_size`` tokens;
every slot owns an ordered page-table row (``tables[slot]``, int32, -1 =
unallocated) shared by all of its paged layers.  Admission allocates
``ceil(len / page_size)`` pages per slot, decode one page at each
page-boundary crossing, a verify round its ``spec_k + 1`` positions
ahead; the rejected suffix's pages come back (``truncate_slot``), and
compaction renames slots without moving a page (``permute_slots``).
Freed pages go back on the free list LIFO, so the port hands out the
same page ids as the JAX allocator.
"""
from __future__ import annotations

from typing import List

import numpy as np


class CacheExhausted(RuntimeError):
    """A decode or verify round cannot proceed: the named slots are out
    of KV room (at capacity, or the page pool cannot cover the round).

    Raised by ``EngineSession.decode`` / ``verify`` before any device
    work or allocator mutation, so the session stays usable after the
    caller frees the named ``slots`` (the batcher evicts them).
    """

    def __init__(self, message: str, slots=()):
        super().__init__(message)
        self.slots = tuple(int(s) for s in slots)


class PageAllocator:
    """Free-list allocator for the global KV page pool.

    Invariants (:meth:`check`): live + free pages partition the pool, no
    page appears twice, and a slot holds exactly ``ceil(tokens /
    page_size)`` pages.
    """

    def __init__(self, pool_pages: int, n_slots: int, max_pages: int,
                 page_size: int):
        if pool_pages <= 0 or page_size <= 0:
            raise ValueError(f"bad pool geometry: {pool_pages=} {page_size=}")
        self.pool_pages = int(pool_pages)
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.n_slots = int(n_slots)
        self.free: List[int] = list(range(self.pool_pages - 1, -1, -1))
        self.tables = np.full((n_slots, max_pages), -1, np.int32)
        self.counts = np.zeros(n_slots, np.int64)   # pages per slot
        self.tokens = np.zeros(n_slots, np.int64)   # tokens per slot

    @property
    def free_pages(self) -> int:
        return len(self.free)

    @property
    def live_pages(self) -> int:
        return int(self.counts.sum())

    def pages_needed(self, n_tokens: int) -> int:
        return -(-int(n_tokens) // self.page_size)

    def _check_capacity(self, slot: int, n_tokens: int) -> None:
        if n_tokens > self.max_pages * self.page_size:
            raise ValueError(
                f"slot {slot}: {n_tokens} tokens exceed the paged KV "
                f"capacity of {self.max_pages * self.page_size} tokens "
                f"({self.max_pages} pages x {self.page_size})")

    def alloc_slot(self, slot: int, n_tokens: int) -> None:
        """(Re)allocate ``slot`` to hold an ``n_tokens`` prompt."""
        self._check_capacity(slot, n_tokens)
        need = self.pages_needed(n_tokens)
        self.release_slot(slot)
        if need > len(self.free):
            raise RuntimeError(
                f"page pool exhausted: slot {slot} needs {need} pages, "
                f"{len(self.free)}/{self.pool_pages} free")
        for i in range(need):
            self.tables[slot, i] = self.free.pop()
        self.counts[slot] = need
        self.tokens[slot] = n_tokens

    def extend_slot(self, slot: int, n_tokens: int) -> None:
        """Grow ``slot`` to cover ``n_tokens`` (decode boundary crossing)."""
        self._check_capacity(slot, n_tokens)
        need = self.pages_needed(n_tokens)
        while self.counts[slot] < need:
            if not self.free:
                raise RuntimeError(
                    f"page pool exhausted growing slot {slot} to "
                    f"{n_tokens} tokens ({need} pages)")
            self.tables[slot, self.counts[slot]] = self.free.pop()
            self.counts[slot] += 1
        self.tokens[slot] = max(int(self.tokens[slot]), int(n_tokens))

    def truncate_slot(self, slot: int, n_tokens: int) -> int:
        """Shrink ``slot`` to ``n_tokens``, freeing the pages wholly past
        them (a verify round's rejected suffix); returns the number of
        pages freed.  Asking for more tokens than the slot holds
        raises."""
        n_tokens = int(n_tokens)
        if n_tokens < 0:
            raise ValueError(f"slot {slot}: cannot truncate to "
                             f"{n_tokens} tokens")
        if n_tokens > int(self.tokens[slot]):
            raise ValueError(
                f"slot {slot}: truncate_slot({n_tokens}) exceeds the "
                f"slot's {int(self.tokens[slot])} tokens — truncate "
                "only shrinks (extend_slot grows)")
        need = self.pages_needed(n_tokens)
        freed = 0
        while self.counts[slot] > need:
            self.counts[slot] -= 1
            pid = int(self.tables[slot, self.counts[slot]])
            if pid < 0:
                raise AssertionError(
                    f"slot {slot} table corrupt: entry "
                    f"{int(self.counts[slot])} unallocated inside the "
                    "counted range")
            self.tables[slot, self.counts[slot]] = -1
            self.free.append(pid)
            freed += 1
        self.tokens[slot] = n_tokens
        return freed

    def permute_slots(self, perm) -> None:
        """Reorder the slot rows: new slot i takes old slot perm[i].  Page
        ids, the pool and the free list are untouched."""
        perm = np.asarray(perm, np.int64).reshape(-1)
        if sorted(perm.tolist()) != list(range(self.n_slots)):
            raise ValueError(
                f"perm must be a permutation of range({self.n_slots}), "
                f"got {perm.tolist()}")
        self.tables = self.tables[perm].copy()
        self.counts = self.counts[perm].copy()
        self.tokens = self.tokens[perm].copy()

    def release_slot(self, slot: int) -> None:
        """Return the slot's pages to the pool (no-op on an empty slot)."""
        n = int(self.counts[slot])
        for i in range(n):
            pid = int(self.tables[slot, i])
            if pid < 0:
                raise AssertionError(
                    f"slot {slot} table corrupt: entry {i} unallocated "
                    f"inside counted range {n}")
            self.free.append(pid)
        self.tables[slot, :] = -1
        self.counts[slot] = 0
        self.tokens[slot] = 0

    def check(self) -> None:
        """Raise AssertionError if an allocator invariant is broken."""
        live = [int(p) for row, c in zip(self.tables, self.counts)
                for p in row[:int(c)]]
        if any(p < 0 for p in live):
            raise AssertionError("unallocated entry inside a counted range")
        seen = live + [int(p) for p in self.free]
        if len(seen) != self.pool_pages or len(set(seen)) != len(seen):
            raise AssertionError(
                f"pages lost or double-booked: {len(set(seen))} unique of "
                f"{len(seen)} tracked, pool is {self.pool_pages}")
        for s in range(self.n_slots):
            if int(self.counts[s]) != self.pages_needed(self.tokens[s]):
                raise AssertionError(
                    f"slot {s}: {int(self.counts[s])} pages != "
                    f"ceil({int(self.tokens[s])} / {self.page_size})")
            if (self.tables[s, int(self.counts[s]):] >= 0).any():
                raise AssertionError(f"slot {s}: pages beyond count")
