"""Prefix-aware KV reuse: a radix index over finished sequences'
token prefixes, backed by ref-counted pool pages
(``parallax_tpu/serve/prefixcache.py``, ported whole: it is host code).

At serving scale the dominant exploitable structure is *shared
prefixes* — system prompts, templates, retries: identical requests
arrive milliseconds apart and each pays a full prefill plus a full
greedy decode for work an earlier request already did. The paged KV
layout (serve/paging.py) already addresses cache memory through
host-managed page tables, which is exactly the indirection prefix
reuse needs (vLLM's PagedAttention / SGLang's RadixAttention, per the
SURVEY): a new request's page table can point at pages an earlier
request WROTE, as long as nobody writes them again.

What is cached, and why it is sound here
----------------------------------------

One :class:`CacheEntry` per completed request key, holding

* the **prefill request state** (for NMT: the encoder's cross-K/V and
  ``src_valid``, exactly what ``DecodeProgram.prefill`` returned) —
  mapping it skips the whole prefill, the TTFT-dominant cost;
* the **decoded token sequence** and the **pool pages** its self-KV
  was written into — a new identical request REPLAYS the cached tokens
  instantly and continues decoding (if its cap allows more) on top of
  the cached pages.

The index is a radix trie over token ids, one root per tenant. For
this repo's encoder-decoder flagship a *partial* source-prefix match
is unsound — encoder attention is bidirectional, so sharing requires
the EXACT source key — but the *decode-side* prefix is shared at page
granularity: a mapper reuses however many cached decode pages its own
token cap covers, which is precisely the radix-prefix win restated for
seq2seq. (A decoder-only adapter can key the same trie by prompt
tokens and share partial prompt prefixes; the structure does not
care.)

Sharing rules (the guard rails are absolute):

* shared pages are **read-only by construction**: a mapper's decode
  writes land at positions ``>= replay``, which its page table maps to
  pages it owns — never to a cached page. The page holding the replay
  boundary (when ``replay % page_size != 0``) is **copy-on-write**:
  the scheduler device-copies it into a page the mapper owns before
  the first divergent write, so the cached copy is never touched.
* every mapping is ref-counted in :class:`~parallax_tpu_torch.serve.paging.
  PageAllocator` — a page returns to the pool only when the cache AND
  every mapper have released it.
* an entry being mapped is **pinned** (``mappers > 0``): eviction
  skips it, so one tenant's allocation pressure can reclaim another's
  *idle* cached prefixes (LRU first) but can never pull pages out from
  under an in-flight sequence — the multi-tenant eviction contract.
* tenants are namespaced at the trie root: a lookup NEVER sees another
  tenant's entries, so cross-tenant reuse is structurally impossible,
  not just policy-denied.

The scheduler (serve/continuous.py) owns the single-threaded call
sequence; the internal lock only protects the lazy stats gauges
sampled from other threads.

An entry's ``request_state`` must be its own: a program's ``prefill``
returns tensors it overwrites at the next prefill (on the card, the
prefill graph's outputs), so the scheduler stores a copy.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from parallax_tpu_torch.serve.paging import PageAllocator


class _Node:
    """One radix-trie node: children by token id, at most one entry."""

    __slots__ = ("children", "entry", "parent", "token")

    def __init__(self, parent=None, token=None):
        self.children: Dict[int, "_Node"] = {}
        self.entry: Optional["CacheEntry"] = None
        self.parent = parent
        self.token = token


class CacheEntry:
    """One cached prefix: the key tokens, the decoded continuation,
    the pool pages holding its self-KV, and the prefill request state
    (device arrays, kept alive by this reference)."""

    __slots__ = ("tenant", "key", "tokens", "pages", "request_state",
                 "mappers", "last_use", "positions", "_node")

    def __init__(self, tenant, key, tokens, pages, request_state,
                 positions=None):
        self.tenant = tenant
        self.key: Tuple[int, ...] = tuple(int(t) for t in key)
        self.tokens: List[int] = [int(t) for t in tokens]
        self.pages: List[int] = list(pages)
        self.request_state = request_state
        self.mappers = 0          # in-flight sequences mapping these pages
        self.last_use = 0
        # decode-buffer POSITIONS the pages hold valid KV for. For an
        # encoder-decoder program positions == len(tokens); a decoder-
        # only program's prompt occupies the buffer ahead of the
        # decoded tokens, so positions > len(tokens); an IMPORTED
        # entry (disaggregation) carries request_state only — no
        # pages, positions == 0
        self.positions: int = (len(self.tokens) if positions is None
                               else int(positions))
        self._node: Optional[_Node] = None

    @property
    def pinned(self) -> bool:
        """True while any in-flight sequence maps this entry's pages —
        eviction must not reclaim them (the mapper's page table points
        at them; the allocator refs keep the storage, the pin keeps
        the ENTRY so accounting stays explainable)."""
        return self.mappers > 0

    def snapshot(self) -> Dict[str, Any]:
        return {"tenant": self.tenant, "key_len": len(self.key),
                "tokens": len(self.tokens), "pages": len(self.pages),
                "positions": self.positions,
                "mappers": self.mappers, "last_use": self.last_use}


class RadixPrefixCache:
    """Radix index over cached prefixes + LRU eviction against the
    shared :class:`PageAllocator`.

    ``max_pages`` bounds the POOL pages the cache may hold while idle
    (pinned entries never count against evictability but do count
    toward the bound — the bound is enforced by evicting LRU unpinned
    entries, best effort). ``max_entries`` bounds the entry COUNT:
    each entry also pins its prefill request state — device arrays
    (for NMT: ``2 * L * Ts * D`` cross-K/V per entry) that the page
    accounting cannot see, so a workload of long sources with short
    decodes (many 1-page entries) would otherwise accumulate HBM
    invisible to every ``serve.kv_*`` gauge; the entry bound is the
    knob that caps that. ``None`` leaves the pool-exhaustion path as
    the only eviction trigger.
    """

    def __init__(self, allocator: PageAllocator,
                 max_pages: Optional[int] = None,
                 max_entries: Optional[int] = None):
        self._alloc = allocator
        self.max_pages = (None if max_pages is None else int(max_pages))
        if self.max_pages is not None and self.max_pages < 0:
            raise ValueError(
                f"max_pages must be >= 0 or None, got {max_pages}")
        self.max_entries = (None if max_entries is None
                            else int(max_entries))
        if self.max_entries is not None and self.max_entries < 0:
            raise ValueError(
                f"max_entries must be >= 0 or None, got {max_entries}")
        self._roots: Dict[Any, _Node] = {}
        self._entries: Dict[Tuple[Any, Tuple[int, ...]], CacheEntry] = {}
        self._clock = itertools.count(1)
        self._lock = threading.Lock()
        # counters the scheduler folds into serve.prefix.* metrics
        self.evictions = 0
        self.insertions = 0

    # -- trie plumbing -----------------------------------------------------

    def _walk(self, tenant, key, create: bool) -> Optional[_Node]:
        root = self._roots.get(tenant)
        if root is None:
            if not create:
                return None
            root = self._roots[tenant] = _Node()
        node = root
        for tok in key:
            tok = int(tok)
            nxt = node.children.get(tok)
            if nxt is None:
                if not create:
                    return None
                nxt = node.children[tok] = _Node(parent=node, token=tok)
            node = nxt
        return node

    def _prune(self, node: _Node, tenant) -> None:
        """Drop now-empty trie branches so the index does not grow
        without bound as keys churn."""
        while node is not None and node.entry is None \
                and not node.children and node.parent is not None:
            parent = node.parent
            del parent.children[node.token]
            node = parent
        root = self._roots.get(tenant)
        if root is not None and not root.children and root.entry is None:
            del self._roots[tenant]

    # -- lookup / insert ---------------------------------------------------

    def lookup(self, tenant, key: Sequence[int]) -> Optional[CacheEntry]:
        """The entry cached under ``(tenant, key)``, LRU-touched, or
        None. Exact-key semantics (the encoder-decoder soundness rule
        above); the radix structure exists for shared-prefix storage
        and prefix-walk introspection, not partial matches."""
        with self._lock:
            node = self._walk(tenant, key, create=False)
            entry = node.entry if node is not None else None
            if entry is not None:
                entry.last_use = next(self._clock)
            return entry

    def insert(self, tenant, key: Sequence[int], tokens: Sequence[int],
               pages: Sequence[int], request_state,
               positions: Optional[int] = None) -> bool:
        """Cache a completed sequence. TAKES OWNERSHIP of one allocator
        reference per page in ``pages`` (the caller transfers the
        retiring slot's refs instead of freeing them). If an entry with
        at least as many decoded tokens already exists under the key,
        the offered pages are released and the existing entry wins
        (longest-continuation-wins keeps replay maximal; an IMPORTED
        zero-token entry never displaces a real one). Returns True
        when the offered entry was installed."""
        key_t = tuple(int(t) for t in key)
        with self._lock:
            node = self._walk(tenant, key_t, create=True)
            old = node.entry
            if old is not None and len(old.tokens) >= len(tokens):
                self._alloc.free(pages)
                old.last_use = next(self._clock)
                return False
            entry = CacheEntry(tenant, key_t, tokens, pages,
                               request_state, positions=positions)
            entry.last_use = next(self._clock)
            entry._node = node
            node.entry = entry
            self._entries[(tenant, key_t)] = entry
            self.insertions += 1
            if old is not None:
                # superseded by a longer continuation of the same key:
                # the old refs release; prefix pages shared by both
                # survive on the new entry's (transferred) refs
                self._alloc.free(old.pages)
        self._enforce_budget()
        return True

    # -- pin / unpin (the scheduler's mapper bracket) ----------------------

    def pin(self, entry: CacheEntry) -> None:
        with self._lock:
            entry.mappers += 1
            entry.last_use = next(self._clock)

    def unpin(self, entry: CacheEntry) -> None:
        with self._lock:
            if entry.mappers < 1:
                raise ValueError("unpin without a matching pin")
            entry.mappers -= 1

    # -- cross-replica export bracket (disaggregation) -----------------------

    def begin_transfer(self, entry: CacheEntry) -> None:
        """Bracket the start of a cross-replica export: pins the entry
        (LRU eviction skips it) AND takes one allocator ref per page —
        a supersede by a longer continuation drops only the CACHE's
        refs, so without the extra ref a page streaming over the wire
        (including a COW boundary page) could return to the pool and
        be rewritten mid-transfer. Pair with :meth:`end_transfer`."""
        with self._lock:
            entry.mappers += 1
            entry.last_use = next(self._clock)
            self._alloc.share(entry.pages)

    def end_transfer(self, entry: CacheEntry) -> None:
        """Release the transfer pin + page refs taken by
        :meth:`begin_transfer`."""
        with self._lock:
            if entry.mappers < 1:
                raise ValueError(
                    "end_transfer without a matching begin_transfer")
            entry.mappers -= 1
            self._alloc.free(entry.pages)

    # -- eviction ----------------------------------------------------------

    def _evict_locked(self, entry: CacheEntry) -> int:
        node = entry._node
        node.entry = None
        entry._node = None
        del self._entries[(entry.tenant, entry.key)]
        self._prune(node, entry.tenant)
        # drop the cache's page refs; pages still mapped by in-flight
        # sequences stay allocated on THEIR refs (and, being gone from
        # the index, can never be mapped by a later request)
        self._alloc.free(entry.pages)
        entry.request_state = None   # release the device arrays
        self.evictions += 1
        return len(entry.pages)

    def _lru_victim_locked(self) -> Optional[CacheEntry]:
        """The least-recently-used UNPINNED entry, or None when every
        entry is pinned (an in-flight mapper) — the single victim rule
        every eviction trigger shares."""
        victim = None
        for e in self._entries.values():
            if e.pinned:
                continue
            if victim is None or e.last_use < victim.last_use:
                victim = e
        return victim

    def evict_for(self, n_pages: int) -> int:
        """Evict LRU **unpinned** entries until the allocator could
        grant ``n_pages`` or no evictable entry remains. Returns the
        number of entries evicted. Pinned entries (in-flight mappers)
        are never touched — one tenant's pressure cannot pull pages
        out from under another tenant's running sequence."""
        evicted = 0
        with self._lock:
            while not self._alloc.can_alloc(n_pages):
                victim = self._lru_victim_locked()
                if victim is None:
                    break
                self._evict_locked(victim)
                evicted += 1
        return evicted

    def _enforce_budget(self) -> None:
        if self.max_pages is None and self.max_entries is None:
            return
        with self._lock:
            while (self.max_pages is not None
                   and self.cached_pages_locked() > self.max_pages) \
                    or (self.max_entries is not None
                        and len(self._entries) > self.max_entries):
                victim = self._lru_victim_locked()
                if victim is None:
                    return
                self._evict_locked(victim)

    def clear(self) -> int:
        """Evict everything evictable (unpinned); returns entries
        dropped."""
        dropped = 0
        with self._lock:
            for e in [e for e in self._entries.values() if not e.pinned]:
                self._evict_locked(e)
                dropped += 1
        return dropped

    # -- introspection -----------------------------------------------------

    def cached_pages_locked(self) -> int:
        return sum(len(e.pages) for e in self._entries.values())

    @property
    def cached_pages(self) -> int:
        with self._lock:
            return self.cached_pages_locked()

    @property
    def num_entries(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self, tenant=None) -> Iterator[CacheEntry]:
        with self._lock:
            snap = list(self._entries.values())
        for e in snap:
            if tenant is None or e.tenant == tenant:
                yield e

    def tenants(self) -> List[Any]:
        with self._lock:
            return sorted(self._roots, key=str)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            entries = list(self._entries.values())
            return {"entries": len(entries),
                    "cached_pages": sum(len(e.pages) for e in entries),
                    "pinned_entries": sum(1 for e in entries
                                          if e.pinned),
                    "tenants": len(self._roots),
                    "insertions": self.insertions,
                    "evictions": self.evictions}


__all__ = ["RadixPrefixCache", "CacheEntry"]
