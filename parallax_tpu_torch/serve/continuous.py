"""Slot-based continuous decoding (Orca-style) over a paged KV pool, with
chunked prefill, speculative decoding and prefix reuse
(``parallax_tpu/serve/continuous.py``).

Static batching decodes a batch until its SLOWEST sequence finishes.
The continuous scheduler keeps a fixed set of ``max_batch`` *slots* over
one KV-cached decode step and treats membership as dynamic:

* every iteration runs ONE batched step for all slots (the step takes
  per-slot positions, so slots at different depths share one call);
* a slot whose sequence just emitted EOS (or hit its token budget, or
  blew its deadline) RETIRES immediately;
* the freed slot REFILLS from the request queue — the batch never
  flushes, occupancy stays high under load.

Four layers ride on top:

* **paged KV** — a :class:`~parallax_tpu_torch.serve.paging.
  PageAllocator` owns the pool: a refill allocates the program's
  ``pages_needed(cap)`` pages and a retire frees them. Exhaustion DEFERS
  the refill (the request stays queued, ``serve.kv_refill_deferred``
  counts it). A decoder-only program's prompt K/V shares the decode
  cache (``insert_pages``): its insert takes the slot's page row,
  sentinel-filled past the allocation, so padded prompt rows drop into
  the spare page.
* **chunked prefill** — with a chunked program (``num_prefill_chunks >
  1``) at most ONE prefill piece runs per iteration, so a long newcomer
  costs the decoding slots a bounded slice of latency per step.
* **speculative decoding** — with ``spec_tokens = k`` the iteration is
  the program's ``spec_step``: k draft steps and one target verify; each
  slot emits its longest agreeing prefix plus the target's correction
  (1..k+1 tokens). Exact under greedy.
* **prefix reuse** (``ServeConfig.prefix_cache``) — a retiring
  sequence's written pages and prefill state go to a radix cache
  (serve/prefixcache.py); an identical request replays the cached
  tokens, maps the cached pages read-only (a copy-on-write copy of the
  boundary page) and decodes only the continuation, or completes with no
  device work at all.

Correctness rides on per-slot independence: every per-token op
(projections, attention with per-slot position masks, layer norms,
argmax) is row-wise, so a slot's tokens equal decoding its request
alone.

The JAX scheduler compiles every device callable ahead of time. Here the
warmup hands the live state to the program's ``capture``, which on the
card captures the prefill (each chunk), and the step or the speculative
iteration as CUDA graphs (``NMTDecodeProgram.capture``); the loop then
replays them, with one device-to-host copy of the tokens an iteration.
A program without ``capture`` is warmed by running each callable once on
a throwaway state. Either way the CUDA kernels are built before the
first request.

A program serves ONE live scheduler: its captured graphs are keyed on
that scheduler's params and state, and the host-to-device staging
buffers, the reused prefill result and the pinned output buffer are the
program's own. A second scheduler built on a program another live
scheduler holds is refused (``ValueError``); the binding is released
when the holder drains (``ServeSession.close``) or dies. A fleet builds
one program per replica. (Under ``jax.jit`` one program instance is
safely shared; here sharing would either re-capture under the first
scheduler, which then replays nothing, or let two threads stage into
one buffer.)
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

import numpy as np

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.obs import trace
from parallax_tpu_torch.serve.batcher import (DeadlineExceeded, Request,
                                              ReplicaUnavailable,
                                              RequestQueue, ServeClosed)
from parallax_tpu_torch.serve.paging import PageAllocator, PagePoolExhausted


class DecodeProgram:
    """The interface a decode model exposes to the scheduler (duck
    typed — subclassing is optional; serve/adapters.py implements it).
    All shapes are FIXED per program instance.

    Attributes: ``max_len`` (decode buffer length — the per-request
    token cap), ``bos_id`` / ``eos_id`` / ``pad_id``. Optional
    capability attributes (defaults in parentheses):

    * ``paged`` (False): self-KV lives in a page pool; the program then
      exposes ``page_size``, ``pool_pages``, ``pages_per_seq`` and
      ``pages_needed(cap)``, and ``step`` / ``spec_step`` take the
      ``[slots, pages_per_seq]`` int32 page table (unallocated entries
      hold the sentinel ``pool_pages``).
    * ``num_prefill_chunks`` (1): when > 1, prefill runs through
      ``prefill_chunk(params, carry, k)`` — carry is the prepared feed
      at k=0, the request state after the last chunk.
    * ``spec_tokens`` (0): when k >= 1, the scheduler calls
      ``spec_step(params, state, tok, t, prev_tok, pages) -> (y [S,
      k+1], proposals [S, k], state)`` instead of ``step`` and accepts
      the longest agreeing prefix (``prev_tok`` is the content at
      position t-1 — the draft's catch-up input).
    * ``insert_pages`` (False): decoder-only programs whose prompt K/V
      lands in the slot's own paged decode buffer take the slot's page
      row too: ``insert(state, slot, request_state, pages_row)``; padded
      prompt rows must go to the sentinel.
    * ``kv_prefix_positions(feed) -> int`` (optional): decode-buffer
      positions the prompt occupies before the first decoded token (0
      for encoder-decoder programs); prefix sharing counts positions.
    * ``prefix_key`` / ``prefill_tokens`` / ``copy_page`` (optional):
      the prefix cache's hooks (required for ``prefix_cache``).
    * ``capture(params, state)`` (optional): warm and capture on the
      scheduler's own state.

    Core callables:

    * ``example_feed() -> dict`` — one request's feed at the padded
      shapes ``prefill`` accepts (used for warmup).
    * ``prepare_feed(feed) -> dict`` — validate/pad one request's raw
      feed onto the fixed prefill shapes.
    * ``init_state(params, slots) -> state`` — fresh device state for
      ``slots`` slots (KV caches/pool, encoder memory, masks).
    * ``prefill(params, feed) -> request_state`` — the one-time
      per-request work. The result may be overwritten by the next
      prefill: whoever keeps it copies it.
    * ``insert(state, slot, request_state) -> state`` — write one
      prefilled request into slot ``slot``.
    * ``step(params, state, tok, t[, pages]) -> (next_tok, state)`` —
      one batched decode step: ``tok``/``t`` are ``[slots]`` int32
      arrays of each slot's current token and position; returns each
      slot's next token. Inactive slots' lanes compute values the
      scheduler ignores — they must not affect other lanes.
    """


def _owned(rs):
    """A copy of a request state that no later prefill overwrites."""
    return {k: v.clone() for k, v in rs.items()}


class _Slot:
    __slots__ = ("req", "tokens", "t", "cap", "pages", "rs", "key",
                 "entry", "replayed", "base")

    def __init__(self, req: Request, cap: int, pages: List[int]):
        self.req = req
        self.tokens: List[int] = []
        self.t = 0
        self.cap = cap
        self.pages = pages
        # decode-buffer positions the PROMPT occupies ahead of the
        # decoded tokens (kv_prefix_positions; 0 for encoder-decoder
        # programs) — page-occupancy math is in positions, not tokens
        self.base = 0
        # prefix reuse: the request state (an owned copy, kept so the
        # retiring sequence can be cached), the radix key, the mapped
        # cache entry (pinned while we run), and how many of `tokens`
        # were replayed rather than decoded
        self.rs = None
        self.key = None
        self.entry = None
        self.replayed = 0


class _Prefill:
    """One in-flight chunked prefill: the reserved slot, its allocated
    pages, the carry between chunks and the next chunk index."""

    __slots__ = ("req", "slot", "pages", "carry", "k", "key")

    def __init__(self, req: Request, slot: int, pages: List[int],
                 key=None):
        self.req = req
        self.slot = slot
        self.pages = pages
        self.carry = req.feed
        self.k = 0
        self.key = key


class ContinuousScheduler:
    """Drives one :class:`DecodeProgram` over a request queue on a
    daemon thread; constructed (and owned) by
    :class:`~parallax_tpu_torch.serve.session.ServeSession`."""

    TOKENS_PER_SEC_WINDOW = 50

    def __init__(self, program, params, serve_config, metrics,
                 queue: RequestQueue,
                 name: str = "parallax-serve-decode",
                 on_deadline_breach=None, replica_id=None,
                 faults=None, on_fatal=None, on_error=None):
        self._program = program
        # fleet wiring: deterministic fault hooks consulted once per
        # loop pass, and death/error reporting for the router
        self._replica_id = replica_id
        self._bind()
        self._params = params
        self._queue = queue
        self.metrics = metrics
        self._faults = faults
        self._on_fatal = on_fatal
        self._on_error = on_error
        # the SLO-breach hook for MID-DECODE expiries (queued expiries go
        # through the queue's own on_timeout)
        self._on_deadline_breach = on_deadline_breach
        self.alive = True
        self.heartbeat = time.perf_counter()
        self._S = int(serve_config.max_batch)
        self._ttft = metrics.histogram("serve.ttft_ms")
        self._latency = metrics.histogram("serve.request_latency_ms")
        self._occupancy = metrics.histogram("serve.batch_occupancy")
        self._step_ms = metrics.histogram("serve.step_ms")
        self._tokens = metrics.counter("serve.tokens")
        self._completed = metrics.counter("serve.completed")
        self._timeouts = metrics.counter("serve.timeouts")
        self._steps = metrics.counter("serve.decode_steps")
        self._prefills = metrics.counter("serve.prefills")
        self._tok_times: collections.deque = collections.deque(
            maxlen=self.TOKENS_PER_SEC_WINDOW)
        metrics.gauge("serve.tokens_per_sec").set_fn(self.tokens_per_sec)

        # capability probes (duck-typed)
        self._paged = bool(getattr(program, "paged", False))
        self._chunks = int(getattr(program, "num_prefill_chunks", 1))
        self._spec = int(getattr(program, "spec_tokens", 0) or 0)
        self._insert_pages = bool(getattr(program, "insert_pages", False))
        self._kvpos = getattr(program, "kv_prefix_positions", None)
        if self._paged:
            self._alloc = PageAllocator(program.pool_pages)
            self._P = int(program.pages_per_seq)
            self._sentinel = int(program.pool_pages)
            self._pages = np.full((self._S, self._P), self._sentinel,
                                  np.int32)
            # serve.kv_pages_in_use counts each physical page once
            # however many sequences and cache entries map it
            self._pages_gauge = metrics.gauge("serve.kv_pages_in_use")
            self._pages_gauge.set(0)
            metrics.gauge("serve.kv_pool_pages").set(self._sentinel)
            self._defer = metrics.counter("serve.kv_refill_deferred")
            metrics.gauge("serve.kv_page_refs").set_fn(
                lambda: self._alloc.total_refs)
            metrics.gauge("serve.kv_shared_pages").set_fn(
                lambda: self._alloc.shared_pages)
            metrics.gauge("serve.kv_sharing_ratio").set_fn(
                lambda: round(self._alloc.sharing_ratio(), 4))
        else:
            self._pages = None
        self._prefix = None
        if bool(getattr(serve_config, "prefix_cache", False)):
            if not self._paged or not hasattr(program, "copy_page") \
                    or not hasattr(program, "prefix_key"):
                raise ValueError(
                    "ServeConfig.prefix_cache requires a PAGED "
                    "DecodeProgram exposing prefix_key/copy_page "
                    "(page-table indirection is what makes shared "
                    "read-only pages possible)")
            from parallax_tpu_torch.serve.prefixcache import \
                RadixPrefixCache
            self._ps = int(program.page_size)
            self._prefix = RadixPrefixCache(
                self._alloc,
                max_pages=getattr(serve_config, "prefix_cache_max_pages",
                                  None),
                max_entries=getattr(serve_config,
                                    "prefix_cache_max_entries", None))
            self._pfx_hits = metrics.counter("serve.prefix.hits")
            self._pfx_misses = metrics.counter("serve.prefix.misses")
            self._pfx_full = metrics.counter("serve.prefix.full_hits")
            self._pfx_cow = metrics.counter("serve.prefix.cow_copies")
            self._pfx_replayed = metrics.counter(
                "serve.prefix.replayed_tokens")
            self._pfx_skipped = metrics.counter(
                "serve.prefix.prefill_tokens_skipped")
            metrics.gauge("serve.prefix.hit_rate").set_fn(
                self.prefix_hit_rate)
            metrics.gauge("serve.prefix.evictions").set_fn(
                lambda: self._prefix.evictions)
            metrics.gauge("serve.prefix.cached_pages").set_fn(
                lambda: self._prefix.cached_pages)
            metrics.gauge("serve.prefix.entries").set_fn(
                lambda: self._prefix.num_entries)
            metrics.gauge("serve.prefix.shared_pages").set_fn(
                lambda: self._alloc.shared_pages)
        if self._chunks > 1:
            self._chunk_ctr = metrics.counter("serve.prefill_chunks")
        if self._spec:
            self._spec_proposed = metrics.counter("serve.spec_proposed")
            self._spec_accepted = metrics.counter("serve.spec_accepted")
            metrics.gauge("serve.spec_accept_rate").set_fn(
                self.spec_accept_rate)
        self._pending: List[_Prefill] = []
        # True while a request is popped from the queue but not yet
        # activated into a slot (or parked in _pending): idle() must not
        # report quiesced then
        self._refilling = False

        self._slots: List[Optional[_Slot]] = [None] * self._S
        self._tok = np.full((self._S,), program.pad_id, np.int32)
        # content at position t-1 per slot (the speculative catch-up
        # input; BOS right after a refill, where t == 0)
        self._prev = np.full((self._S,), program.pad_id, np.int32)
        self._t = np.zeros((self._S,), np.int32)
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._state = None
        try:
            self._warm()
        except BaseException:
            self._release()
            raise
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # -- the program binding -------------------------------------------------

    _bind_lock = threading.Lock()

    def _bind(self) -> None:
        """Take the program for this scheduler; refused while another
        live scheduler holds it (module docstring)."""
        program = self._program
        with self._bind_lock:
            owner = getattr(program, "_serve_owner", None)
            if owner is not None and owner is not self:
                raise ValueError(
                    f"this {type(program).__name__} already serves a live "
                    f"session (replica {owner._replica_id!r}): its "
                    f"captured graphs and staging buffers belong to that "
                    f"session's scheduler. Build one program per replica "
                    f"(a fleet's make_replica builds its own), or close "
                    f"the other session first")
            program._serve_owner = self

    def _release(self) -> None:
        with self._bind_lock:
            if getattr(self._program, "_serve_owner", None) is self:
                self._program._serve_owner = None

    # -- warmup ------------------------------------------------------------

    def _step(self, state, tok, t):
        if self._paged:
            return self._program.step(self._params, state, tok, t,
                                      self._pages.copy())
        return self._program.step(self._params, state, tok, t)

    def _warm(self) -> None:
        """Make the live state and prepare every callable the serving
        loop can call: through the program's ``capture`` (prefill or its
        chunks, and the step or the speculative iteration, captured as
        graphs on the card, on this state) or, for a program without one,
        by running each once on a throwaway state. The copy-on-write page
        copy is warmed too under the prefix cache. Records
        ``serve.compile_seconds``."""
        prog, params = self._program, self._params
        t0 = time.perf_counter()
        with trace.span("serve.warmup_compile", mode="decode"):
            self._state = prog.init_state(params, self._S)
            capture = getattr(prog, "capture", None)
            if capture is not None:
                capture(params, self._state)
            else:
                state = prog.init_state(params, self._S)
                feed = prog.prepare_feed(prog.example_feed())
                if self._chunks > 1:
                    rs = feed
                    for k in range(self._chunks):
                        rs = prog.prefill_chunk(params, rs, k)
                else:
                    rs = prog.prefill(params, feed)
                state = self._insert(state, 0, rs, [])
                tok = np.full((self._S,), prog.bos_id, np.int32)
                tz = np.zeros((self._S,), np.int32)
                if self._spec:
                    prog.spec_step(params, state, tok, tz, tok,
                                   self._pages.copy() if self._paged
                                   else None)
                else:
                    np.asarray(self._step(state, tok, tz)[0])
            if self._prefix is not None:
                self._state = prog.copy_page(self._state, 0, 0)
        dt = time.perf_counter() - t0
        self.metrics.histogram("serve.compile_seconds").record(dt)
        parallax_log.info(
            "serve decode warmup: prefill(%d chunk(s))/insert/%s %s in "
            "%.2fs (%d slots%s)", self._chunks,
            "spec_step" if self._spec else "step",
            "captured" if capture is not None else "ran", dt, self._S,
            f", {self._sentinel}-page pool" if self._paged else "")

    def _insert(self, state, j: int, rs, pages: List[int]):
        """The program's insert; an ``insert_pages`` program also takes
        the slot's page row, sentinel-filled past ``pages``."""
        if self._insert_pages:
            row = np.full((self._P,), self._sentinel, np.int32)
            row[:len(pages)] = pages
            return self._program.insert(state, j, rs, row)
        return self._program.insert(state, j, rs)

    # -- admission hooks (called by ServeSession) --------------------------

    def make_request(self, feed, deadline,
                     max_new_tokens: Optional[int],
                     tenant=None, slo_rank: int = 0) -> Request:
        prog = self._program
        cap = int(max_new_tokens or prog.max_len)
        if cap < 1 or cap > prog.max_len:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} outside [1, "
                f"{prog.max_len}] (the program's decode buffer)")
        return Request(prog.prepare_feed(feed), deadline=deadline,
                       max_new_tokens=cap, tenant=tenant,
                       slo_rank=slo_rank)

    def kick(self) -> None:
        self._kick.set()

    def tokens_per_sec(self) -> Optional[float]:
        window = list(self._tok_times)
        if len(window) < 2:
            return None
        dt = window[-1][0] - window[0][0]
        n = sum(c for _, c in window[1:])
        return n / dt if dt > 0 else None

    def spec_accept_rate(self) -> Optional[float]:
        if not self._spec:
            return None
        prop = self._spec_proposed.value
        return (self._spec_accepted.value / prop) if prop else None

    def prefix_hit_rate(self) -> Optional[float]:
        if self._prefix is None:
            return None
        hits = self._pfx_hits.value
        lookups = hits + self._pfx_misses.value
        return (hits / lookups) if lookups else None

    def prefix_stats(self) -> Optional[dict]:
        """The radix cache's own snapshot (entries, cached pages, pins,
        insertions and evictions), None without the cache."""
        return None if self._prefix is None else self._prefix.stats()

    # -- paging ------------------------------------------------------------

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, evicting LRU unpinned cached prefixes when
        the pool is exhausted; None when even eviction cannot free
        enough (defer)."""
        try:
            return self._alloc.alloc(n)
        except PagePoolExhausted:
            if self._prefix is not None \
                    and self._prefix.evict_for(n) > 0:
                try:
                    return self._alloc.alloc(n)
                except PagePoolExhausted:
                    return None
            return None

    def _alloc_pages(self, req: Request) -> Optional[List[int]]:
        """Pages for one refill, or None to DEFER (pool exhausted —
        retiring sequences will free pages; the request stays queued)."""
        if not self._paged:
            return []
        ids = self._try_alloc(self._program.pages_needed(
            req.max_new_tokens))
        if ids is None:
            self._defer.inc()
            return None
        self._pages_gauge.set(self._alloc.in_use)
        return ids

    def _release_pages(self, pages: List[int]) -> None:
        if self._paged and pages:
            self._alloc.free(pages)
            self._pages_gauge.set(self._alloc.in_use)

    def _clear_slot(self, j: int) -> None:
        self._tok[j] = self._program.pad_id
        self._prev[j] = self._program.pad_id
        self._t[j] = 0
        if self._paged:
            self._pages[j, :] = self._sentinel

    # -- refill / prefill --------------------------------------------------

    def _activate(self, j: int, req: Request, pages: List[int],
                  rs, key=None, entry=None, replay=()) -> None:
        if req.rec is not None:
            # prefill done, slot owned: everything from here to retire
            # is the decode phase of the request timeline
            req.rec.mark("decode")
            req.rec.kv_pages = len(pages)
        self._state = self._insert(self._state, j, rs, pages)
        slot = _Slot(req, req.max_new_tokens, pages)
        slot.key = key
        slot.entry = entry
        if self._kvpos is not None:
            slot.base = int(self._kvpos(req.feed))
        if self._prefix is not None:
            # kept so the retiring sequence can be cached: a fresh
            # prefill's result lives in the program's buffers only until
            # the next prefill, so it is copied; an entry's is its own
            slot.rs = rs if entry is not None else _owned(rs)
        if replay:
            # prefix-cache replay: the slot resumes AFTER the cached
            # tokens, its next decode step at position len(replay)
            slot.tokens = [int(t) for t in replay]
            slot.t = len(slot.tokens)
            slot.replayed = slot.t
        self._slots[j] = slot
        self._tok[j] = (int(replay[-1]) if replay
                        else self._program.bos_id)
        self._prev[j] = (int(replay[-2]) if len(replay) >= 2
                         else self._program.bos_id)
        self._t[j] = slot.t
        if self._paged:
            self._pages[j, :] = self._sentinel
            self._pages[j, :len(pages)] = pages

    def _try_prefix_admit(self, j: int, req: Request):
        """Try to serve ``req`` from the radix cache. Returns one of

        * ``("completed", None)`` — full hit: every token the request
          could emit is cached; it completed with no device work and
          slot ``j`` stays free;
        * ``("activated", None)`` — partial hit: cached tokens replayed,
          shared pages mapped read-only (+ one copy-on-write copy at the
          divergence boundary), slot ``j`` decodes the continuation;
        * ``("deferred", None)`` — hit, but the continuation's fresh
          pages are unavailable even after eviction (requeued);
        * ``("miss", key)`` — no entry; the caller runs the normal
          prefill and threads ``key`` through for retire-time insert.
        """
        prog = self._program
        key = prog.prefix_key(req.feed)
        tenant = getattr(req, "tenant", None)
        entry = self._prefix.lookup(tenant, key)
        if entry is None:
            self._pfx_misses.inc()
            return "miss", key
        cap = req.max_new_tokens
        toks = entry.tokens
        n_replay = min(len(toks), cap)
        eos = prog.eos_id
        if eos in toks[:n_replay]:
            n_replay = toks.index(eos) + 1
        # an imported entry (an exported prefill, no decoded tokens)
        # replays nothing: it exists to skip the local prefill
        full = (n_replay == cap) or (n_replay > 0
                                     and toks[n_replay - 1] == eos)
        skipped = (int(prog.prefill_tokens(req.feed))
                   if hasattr(prog, "prefill_tokens") else 0)
        base = (int(self._kvpos(req.feed))
                if self._kvpos is not None else 0)
        shared = fresh = []
        if not full:
            # continuation: map the cached FULL pages read-only, copy the
            # boundary page, own fresh pages for the rest. Sharing is
            # counted in decode-buffer positions (prompt + replayed
            # tokens)
            p_need = prog.pages_needed(cap)
            shared_pos = min(int(entry.positions), base + n_replay)
            shared_full = shared_pos // self._ps
            partial = (shared_pos % self._ps) != 0
            # pin FIRST: the fresh-page grant below may evict LRU
            # entries, and the entry being mapped must not be one
            self._prefix.pin(entry)
            fresh = self._try_alloc(p_need - shared_full)
            if fresh is None:
                self._prefix.unpin(entry)
                self._defer.inc()
                if req.rec is not None:
                    req.rec.mark("slot_wait")
                self._queue.requeue_front(req)
                return "deferred", None
            shared = [int(p) for p in entry.pages[:shared_full]]
            if shared:
                self._alloc.share(shared)
            if partial:
                # copy-on-write: the first divergent write lands inside
                # a cached page — copy it into a page this slot owns
                # first, so the cached original is never written
                self._state = prog.copy_page(
                    self._state, int(fresh[0]),
                    int(entry.pages[shared_full]))
                self._pfx_cow.inc()
            self._pages_gauge.set(self._alloc.in_use)
        self._pfx_hits.inc()
        self._pfx_replayed.inc(n_replay)
        self._pfx_skipped.inc(skipped)
        rec = req.rec
        if rec is not None:
            # the skipped prefill, attributed explicitly: a near-zero
            # prefix_replay phase plus the skipped-token counts
            rec.mark("prefix_replay")
            rec.prefill_tokens_skipped = skipped
            rec.prefix_hit_pages = (n_replay + self._ps - 1) // self._ps
        if full:
            self._pfx_full.inc()
            now = time.perf_counter()
            out = np.asarray(toks[:n_replay], np.int32)
            req.t_first_token = now
            self._ttft.record((now - req.t_enqueue) * 1e3)
            if rec is not None:
                rec.first_token(now)
                rec.tokens = n_replay
                rec.decode_steps = 0
            req._complete(out)
            self._completed.inc()
            self._latency.record((now - req.t_enqueue) * 1e3)
            trace.record_span(
                "serve.request", req.t_enqueue, now, id=req.id,
                tokens=n_replay, replica=self._replica_id,
                rid=(rec.key if rec is not None else req.id),
                hops=(len(rec.hops) if rec is not None else 1))
            return "completed", None
        with trace.span("serve.prefix_map", slot=j, id=req.id,
                        replay=n_replay):
            self._activate(j, req, shared + fresh, entry.request_state,
                           key=key, entry=entry, replay=toks[:n_replay])
        # the replayed tokens are client-visible now: TTFT is the map
        # latency. An imported entry replays nothing, so its TTFT waits
        # for the first decode step
        if n_replay > 0:
            now = time.perf_counter()
            req.t_first_token = now
            self._ttft.record((now - req.t_enqueue) * 1e3)
            if rec is not None:
                rec.first_token(now)
        return "activated", None

    def import_prefix(self, tenant, key, request_state,
                      positions: int = 0) -> bool:
        """Install an externally prefilled request state (an exported
        prefill) as a page-less prefix-cache entry: ``tokens=[]`` /
        ``pages=[]``, so a matching admission takes the hit path with
        nothing replayed — it skips the local prefill, and the insert
        re-scatters the prompt K/V from ``request_state`` into fresh
        pages. ``request_state`` must be the caller's to give (for
        example ``ServeSession.prefill_only``'s). Returns False when a
        longer local entry already covers the key."""
        if self._prefix is None:
            raise ValueError(
                "import_prefix requires ServeConfig.prefix_cache "
                "(the radix index is the import surface)")
        return self._prefix.insert(tenant, key, [], [], request_state,
                                   positions=positions)

    def _refill(self) -> None:
        """Unchunked path: fill free slots from the queue, one whole
        single-request prefill each (or a prefix-cache replay), inserted
        without touching the running slots. A full cache hit completes
        without consuming the slot, so the loop keeps draining the queue
        through it."""
        for j in range(self._S):
            if self._slots[j] is not None:
                continue
            while self._slots[j] is None:
                req = self._queue.pop(timeout=0.0)
                if req is None:
                    return
                self._refilling = True
                try:
                    key = None
                    if self._prefix is not None:
                        outcome, key = self._try_prefix_admit(j, req)
                        if outcome == "deferred":
                            return
                        if outcome == "completed":
                            continue  # slot still free: keep draining
                        if outcome == "activated":
                            break
                    if req.rec is not None:
                        req.rec.mark("prefill")
                    pages = self._alloc_pages(req)
                    if pages is None:
                        if req.rec is not None:
                            # pool exhausted: the wait back at the queue
                            # head is page pressure, not queue depth
                            req.rec.mark("slot_wait")
                        self._queue.requeue_front(req)
                        return
                    with trace.span("serve.prefill", slot=j, id=req.id):
                        rs = self._program.prefill(self._params, req.feed)
                        self._activate(j, req, pages, rs, key=key)
                    self._prefills.inc()
                finally:
                    self._refilling = False

    def _free_slot(self) -> Optional[int]:
        reserved = {pp.slot for pp in self._pending}
        for j in range(self._S):
            if self._slots[j] is None and j not in reserved:
                return j
        return None

    def _advance_prefill(self) -> None:
        """Chunked path: run at most ONE prefill piece this iteration —
        start a new prefill when none is pending (slot and pages
        permitting), else advance the oldest by one chunk; the last
        chunk's output is inserted into the reserved slot."""
        if not self._pending:
            j = self._free_slot()
            if j is None:
                return
            while True:
                req = self._queue.pop(timeout=0.0)
                if req is None:
                    return
                self._refilling = True
                try:
                    key = None
                    if self._prefix is not None:
                        outcome, key = self._try_prefix_admit(j, req)
                        if outcome == "completed":
                            continue
                        if outcome != "miss":
                            # activated (slot consumed, no chunks to
                            # run) or deferred (requeued)
                            return
                    if req.rec is not None:
                        req.rec.mark("prefill")
                    pages = self._alloc_pages(req)
                    if pages is None:
                        if req.rec is not None:
                            req.rec.mark("slot_wait")
                        self._queue.requeue_front(req)
                        return
                    self._pending.append(_Prefill(req, j, pages, key=key))
                    break
                finally:
                    self._refilling = False
        pp = self._pending[0]
        t_chunk = time.perf_counter()
        with trace.span("serve.prefill_chunk", slot=pp.slot, id=pp.req.id,
                        k=pp.k):
            pp.carry = self._program.prefill_chunk(self._params, pp.carry,
                                                   pp.k)
        if pp.req.rec is not None:
            pp.req.rec.note_prefill_chunk(
                (time.perf_counter() - t_chunk) * 1e3)
        pp.k += 1
        self._chunk_ctr.inc()
        if pp.k == self._chunks:
            self._pending.pop(0)
            self._activate(pp.slot, pp.req, pp.pages, pp.carry, key=pp.key)
            self._prefills.inc()

    # -- retire / expire / fail --------------------------------------------

    def _teardown_slot(self, slot: _Slot, cache: bool) -> None:
        """Release one slot's page holdings. With ``cache`` (a clean
        retire under the prefix cache) the refs of the WRITTEN pages
        transfer to the radix index and only the unwritten tail frees;
        otherwise every ref this slot holds is dropped. Either way the
        mapped entry's pin releases first."""
        if slot.entry is not None:
            self._prefix.unpin(slot.entry)
            slot.entry = None
        if (cache and self._prefix is not None and slot.key is not None
                and slot.t > 0 and slot.pages):
            pos = slot.base + int(slot.t)
            used = min(-(-pos // self._ps), len(slot.pages))
            self._prefix.insert(getattr(slot.req, "tenant", None),
                                slot.key, slot.tokens, slot.pages[:used],
                                slot.rs, positions=pos)
            tail = slot.pages[used:]
            if tail:
                self._alloc.free(tail)
            self._pages_gauge.set(self._alloc.in_use)
        else:
            self._release_pages(slot.pages)
        slot.rs = None

    def _retire(self, j: int, now: float) -> None:
        slot = self._slots[j]
        self._slots[j] = None
        self._teardown_slot(slot, cache=True)
        self._clear_slot(j)
        req = slot.req
        if req.rec is not None:
            req.rec.tokens = len(slot.tokens)
            req.rec.decode_steps = int(slot.t) - int(slot.replayed)
        req._complete(np.asarray(slot.tokens, np.int32))
        self._completed.inc()
        self._latency.record((now - req.t_enqueue) * 1e3)
        # ONE span per logical request, emitted by the delivering replica
        # only (a crashed hop never retires), with the final replica id
        # and the hop count
        rec = req.rec
        trace.record_span(
            "serve.request", req.t_enqueue, now, id=req.id,
            tokens=len(slot.tokens), replica=self._replica_id,
            rid=(rec.key if rec is not None else req.id),
            hops=(len(rec.hops) if rec is not None else 1))

    def _drop_slot(self, j: int, exc: BaseException) -> None:
        slot = self._slots[j]
        self._slots[j] = None
        self._teardown_slot(slot, cache=False)
        self._clear_slot(j)
        slot.req._fail(exc)

    def _expire_slots(self, now: float) -> None:
        n_expired = 0
        for j, slot in enumerate(self._slots):
            if slot is None or slot.req.deadline is None:
                continue
            if now > slot.req.deadline:
                self._timeouts.inc()
                n_expired += 1
                self._drop_slot(j, DeadlineExceeded(
                    f"request {slot.req.id} deadline expired mid-"
                    f"decode after {len(slot.tokens)} token(s)"))
        for pp in list(self._pending):
            if pp.req.deadline is not None and now > pp.req.deadline:
                self._pending.remove(pp)
                self._release_pages(pp.pages)
                self._timeouts.inc()
                n_expired += 1
                pp.req._fail(DeadlineExceeded(
                    f"request {pp.req.id} deadline expired mid-"
                    f"prefill after {pp.k} chunk(s)"))
        if n_expired and self._on_deadline_breach is not None:
            try:
                self._on_deadline_breach(n_expired, where="decode")
            except Exception:
                # forensics must never take the decode loop down
                pass

    def _fail_active(self, exc: BaseException) -> None:
        """Fail every in-flight slot and pending prefill — called ONLY
        from the scheduler thread (slot state is single-owner)."""
        for j, slot in enumerate(self._slots):
            if slot is not None:
                self._drop_slot(j, exc)
        for pp in self._pending:
            self._release_pages(pp.pages)
            pp.req._fail(exc)
        self._pending = []

    # -- the scheduling loop ----------------------------------------------

    def _active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _emit(self, j: int, token: int, now: float) -> bool:
        """Deliver one token to slot ``j``; True when the slot retired
        (EOS or cap)."""
        slot = self._slots[j]
        if slot.req.t_first_token is None:
            slot.req.t_first_token = now
            self._ttft.record((now - slot.req.t_enqueue) * 1e3)
            if slot.req.rec is not None:
                slot.req.rec.first_token(now)
        slot.tokens.append(token)
        slot.t += 1
        self._prev[j] = self._tok[j]
        self._tok[j] = token
        self._t[j] = slot.t
        if token == self._program.eos_id or len(slot.tokens) >= slot.cap:
            self._retire(j, now)
            return True
        return False

    def _plain_iteration(self, n_active: int) -> None:
        t0 = time.perf_counter()
        with trace.span("serve.step", active=n_active):
            nxt, self._state = self._step(self._state, self._tok,
                                          self._t)
            nxt = np.asarray(nxt)  # waits for the step's tokens
        now = time.perf_counter()
        self._step_ms.record((now - t0) * 1e3)
        self._steps.inc()
        self._occupancy.record(n_active / self._S)
        emitted = 0
        for j in range(self._S):
            if self._slots[j] is None:
                continue
            self._emit(j, int(nxt[j]), now)
            emitted += 1
        self._tokens.inc(emitted)
        self._tok_times.append((now, emitted))

    def _spec_iteration(self, n_active: int) -> None:
        """One speculative iteration: the draft proposes k tokens, the
        target verifies k+1 in one pass, each slot accepts its longest
        agreeing prefix (1..k+1 tokens). Proposal j is accepted iff it
        EQUALS the target's greedy choice, and the first disagreement is
        replaced by that choice — the emitted stream is the plain greedy
        stream."""
        prog = self._program
        k = self._spec
        t0 = time.perf_counter()
        with trace.span("serve.spec_step", active=n_active, k=k):
            y, props, self._state = prog.spec_step(
                self._params, self._state, self._tok, self._t, self._prev,
                self._pages.copy() if self._paged else None)
            y = np.asarray(y)            # [S, k+1]
            props = np.asarray(props)    # [S, k]
        now = time.perf_counter()
        self._step_ms.record((now - t0) * 1e3)
        self._steps.inc()
        self._occupancy.record(n_active / self._S)
        emitted = 0
        for j in range(self._S):
            if self._slots[j] is None:
                continue
            n = 1
            while n <= k and props[j, n - 1] == y[j, n - 1]:
                n += 1
            self._spec_proposed.inc(k)
            self._spec_accepted.inc(n - 1)
            for g in range(n):
                emitted += 1
                if self._emit(j, int(y[j, g]), now):
                    break
        self._tokens.inc(emitted)
        self._tok_times.append((now, emitted))

    def _loop(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:
            # a silently-dead daemon thread would hang every client on
            # result(): fail everything this scheduler holds instead
            self._fatal(e)

    def _run_loop(self) -> None:
        while True:
            self.heartbeat = time.perf_counter()
            if self._stop.is_set():
                # drain window expired: in-flight decodes are failed by
                # THIS thread (single-owner slot state)
                self._fail_active(ServeClosed(
                    "session closed mid-decode"))
                return
            if self._faults is not None:
                # chaos hook: may raise ReplicaCrash (the fatal path) or
                # sleep through an injected stall
                self._faults.on_dispatch(self._replica_id)
            self._expire_slots(time.perf_counter())
            if self._chunks > 1:
                self._advance_prefill()
            else:
                self._refill()
            n_active = self._active()
            if n_active == 0:
                if self._pending:
                    continue  # keep prefill chunks flowing
                if self._queue.closed and len(self._queue) == 0:
                    return
                self._kick.wait(0.02)
                self._kick.clear()
                continue
            if self._spec:
                self._spec_iteration(n_active)
            else:
                self._plain_iteration(n_active)

    def _fatal(self, cause: BaseException) -> None:
        """The decode loop died: fail in-flight slots, pending prefills
        and the whole queue with ReplicaUnavailable (retryable — no
        request ever delivered a result, so failover cannot
        double-serve), close admission, release the program and report
        ``on_error`` and ``on_fatal``."""
        self.alive = False
        err = ReplicaUnavailable(
            f"decode scheduler died: {type(cause).__name__}: {cause}")
        err.__cause__ = cause
        try:
            self._fail_active(err)
        except Exception:
            parallax_log.exception("failing in-flight requests after "
                                   "the scheduler died")
        self._queue.close()
        n = self._queue.fail_all(err)
        parallax_log.error(
            "serve decode loop died (%s: %s); failed %d queued "
            "request(s)", type(cause).__name__, cause, n)
        self._release()
        if self._on_error is not None:
            try:
                self._on_error(cause, n)
            except Exception:
                pass
        if self._on_fatal is not None:
            try:
                self._on_fatal(cause)
            except Exception:
                pass

    # -- quiescence and the params swap ------------------------------------

    def idle(self) -> bool:
        """No active slots, no pending prefills, nothing queued and no
        request in the popped-but-not-yet-activated refill window — the
        quiesced state a weight swap requires."""
        return (not self._refilling and self._active() == 0
                and not self._pending and len(self._queue) == 0)

    def set_params(self, placed) -> None:
        """Serve ``placed`` from the next iteration on. The session's
        swap overwrites the served leaves in place and passes the same
        object, so the captured graphs stay valid. A speculative
        program's draft params live in the program and are not swapped
        (a stale draft only lowers the accept rate)."""
        self._params = placed

    # -- teardown ----------------------------------------------------------

    def drain(self, timeout_s: float) -> None:
        """After ``queue.close()``: wait for in-flight + queued decodes
        to finish, hard-stopping at the timeout. Undrained slots are
        failed by the loop itself when it observes the stop flag."""
        if timeout_s > 0:
            self._thread.join(timeout=timeout_s)
        self._stop.set()
        self._kick.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            parallax_log.warning(
                "serve decode thread did not stop within the drain "
                "window; in-flight requests may hang until their "
                "result() timeout")
        # the prefix cache holds pages while serving; at close it
        # releases everything evictable, so "0 pages in use after the
        # last retire" stays checkable
        if self._prefix is not None:
            self._prefix.clear()
            self._pages_gauge.set(self._alloc.in_use)
        # after close the gauges read None instead of sampling a dead
        # scheduler (their set_fns would pin the device state)
        self.metrics.gauge("serve.tokens_per_sec").set_fn(None)
        if self._spec:
            self.metrics.gauge("serve.spec_accept_rate").set_fn(None)
        if self._paged:
            for name in ("serve.kv_page_refs", "serve.kv_shared_pages",
                         "serve.kv_sharing_ratio"):
                self.metrics.gauge(name).set_fn(None)
        if self._prefix is not None:
            for name in ("serve.prefix.hit_rate",
                         "serve.prefix.evictions",
                         "serve.prefix.cached_pages",
                         "serve.prefix.entries",
                         "serve.prefix.shared_pages"):
                self.metrics.gauge(name).set_fn(None)
        self._state = None
        if not self._thread.is_alive():
            self._release()


__all__ = ["DecodeProgram", "ContinuousScheduler"]
