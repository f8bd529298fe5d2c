"""Block-paged KV memory: a fixed pool of fixed-size pages plus
per-sequence page tables (vLLM-style paged attention).

The dense continuous-decode layout keeps one ``[L, S, T, D]`` self-KV
buffer per slot set: every slot pays ``max_len`` positions of cache
whether its sequence uses them or not. The paged layout replaces it
with ONE pool ``[L, pool_pages, page_size, D]`` shared by every slot; a
sequence owns ``ceil(cap / page_size)`` pages for exactly as long as it
is in flight, so max concurrent sequences is bounded by **pool memory,
not slot count**.

This module is the HOST side: a pure allocator over page ids. It never
touches device memory — the device pool and the attention over page
tables live in models/nmt.py (``_decode_tokens_cached``) and
ops/paged_attention.py; the continuous scheduler (serve/continuous.py)
calls ``alloc`` at slot refill and ``free`` at retire.

Pages are **reference counted**, so one physical page can have several
logical holders: ``alloc`` grants fresh pages at refcount 1, ``share``
adds a holder, ``free`` drops one — the page returns to the pool only
when its LAST holder releases it. The ``in_use`` accounting counts each
physical page ONCE however many holders it has, so the
``serve.kv_pages_in_use`` gauge and the leak checks stay exact.

Correctness contract:

* ``alloc(n)`` either returns exactly ``n`` distinct free pages or
  raises :class:`PagePoolExhausted` **without changing any state** —
  refusal is loud and deterministic, never a partial grant;
* ``share`` / ``free`` refuse foreign ids, duplicates-in-one-call and
  over-release (a ``free`` past the last holder is the double-free of
  the ref-counted world and would let two sequences corrupt each
  other's cache);
* a reused page never leaks stale K/V into a refilled slot: the device
  step masks every cache position ``> t`` and every position ``<= t``
  is freshly written after the refill, so the allocator needs no page
  zeroing (same argument as the dense layout's slot reuse).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


class PagePoolExhausted(RuntimeError):
    """``alloc`` could not grant the request from the free pool.

    Raised deterministically (the pool state is left untouched); the
    continuous scheduler defers the refill — the request stays queued
    until a retiring sequence frees pages — counting the deferral in
    ``serve.kv_refill_deferred``.

    ``retryable`` (the serve error taxonomy): transient — pages free as
    sequences retire, so a later attempt may succeed.
    """

    retryable = True
    fatal = False


class PageAllocator:
    """Host-side ref-counted allocator over ``pool_pages`` page ids
    ``0..n-1``.

    Free pages are handed out LIFO so a just-retired sequence's pages
    are the next refill's pages — maximal reuse churn, which is exactly
    what the no-stale-visibility test needs to exercise.
    """

    def __init__(self, pool_pages: int):
        n = int(pool_pages)
        if n < 1:
            raise ValueError(f"pool_pages must be >= 1, got {pool_pages}")
        self.pool_pages = n
        self._free: List[int] = list(range(n - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        self.high_water = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Distinct physical pages with at least one holder — each
        page counts ONCE regardless of how many sequences / cache
        entries reference it (the sharing-safe accounting the
        ``serve.kv_pages_in_use`` gauge and leak checks read)."""
        return len(self._refs)

    @property
    def total_refs(self) -> int:
        """Logical holders summed over all in-use pages (>= in_use;
        equality means nothing is shared)."""
        return sum(self._refs.values())

    @property
    def shared_pages(self) -> int:
        """Pages with more than one holder right now."""
        return sum(1 for c in self._refs.values() if c > 1)

    def sharing_ratio(self) -> float:
        """``total_refs / in_use`` — 1.0 with no sharing, k when every
        page is mapped by k holders."""
        n = len(self._refs)
        return (self.total_refs / n) if n else 1.0

    def refcount(self, page: int) -> int:
        return self._refs.get(int(page), 0)

    def can_alloc(self, n: int) -> bool:
        return 0 <= n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Grant ``n`` fresh pages (refcount 1 each) or raise
        :class:`PagePoolExhausted` with the pool untouched
        (all-or-nothing)."""
        n = int(n)
        if n < 1:
            raise ValueError(f"alloc needs n >= 1, got {n}")
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} page(s), {len(self._free)} free of "
                f"{self.pool_pages} (in use: {len(self._refs)})")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        self.high_water = max(self.high_water, len(self._refs))
        return pages

    def share(self, pages: Sequence[int]) -> None:
        """Add one holder to each of ``pages`` (a new sequence's page
        table points at an already-written read-only page). Refuses
        free/foreign ids and duplicates — sharing a page nobody holds
        would hand out stale storage."""
        pages = [int(p) for p in pages]
        bad = [p for p in pages if p not in self._refs]
        if bad:
            raise ValueError(
                f"share of page(s) {bad} not currently allocated")
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in share: {pages}")
        for p in pages:
            self._refs[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Drop one holder from each of ``pages``; a page returns to
        the pool when its LAST holder releases it. Refuses
        over-release / foreign ids loudly (a silent accept would let
        two sequences share a page and corrupt each other's cache)."""
        pages = [int(p) for p in pages]
        bad = [p for p in pages if p not in self._refs]
        if bad:
            raise ValueError(
                f"free of page(s) {bad} not currently allocated "
                f"(double-free, over-release or foreign id)")
        if len(set(pages)) != len(pages):
            raise ValueError(f"duplicate page ids in free: {pages}")
        for p in pages:
            c = self._refs[p] - 1
            if c == 0:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = c

    def stats(self) -> dict:
        return {"pool_pages": self.pool_pages,
                "in_use": self.in_use,
                "free": self.free_pages,
                "total_refs": self.total_refs,
                "shared_pages": self.shared_pages,
                "sharing_ratio": round(self.sharing_ratio(), 4),
                "high_water": self.high_water}


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` positions."""
    if tokens < 1:
        raise ValueError(f"tokens must be >= 1, got {tokens}")
    return -(-int(tokens) // int(page_size))


__all__ = ["PageAllocator", "PagePoolExhausted", "pages_for"]
