"""Slot-based continuous decoding (Orca-style) over a paged KV pool.

Static batching decodes a batch until its SLOWEST sequence finishes.
The continuous scheduler keeps a fixed set of ``max_batch`` *slots* over
one KV-cached decode step and treats membership as dynamic:

* every iteration runs ONE batched step for all slots (the step takes
  per-slot positions, so slots at different depths share one call);
* a slot whose sequence just emitted EOS (or hit its token budget, or
  blew its deadline) RETIRES immediately;
* the freed slot REFILLS from the request queue — the batch never
  flushes, occupancy stays high under load.

With a paged program a :class:`~parallax_tpu_torch.serve.paging.
PageAllocator` owns the pool: a refill allocates the pages of the
positions its request writes and a retire frees them. Exhaustion DEFERS
the refill (the request stays queued, ``serve.kv_refill_deferred``
counts it). A decoder-only program's prompt K/V shares the decode cache
(``kv_prefix_positions``, ``insert_pages``): its insert takes the slot's
page row, sentinel-filled past the allocation, so the padded prompt rows
drop into the spare page (``parallax_tpu/serve/continuous.py:305-315``),
and a request owns ``ceil((kv_prefix_positions + cap) / page_size)``
pages, its prompt's and its cap's. The JAX scheduler allocates the
program's worst case, ``pages_needed(cap)`` (the longest prompt's), and
reads ``kv_prefix_positions`` only for the prefix cache; the tokens are
the same either way.

Correctness rides on per-slot independence: every per-token op
(projections, attention with per-slot position masks, layer norms,
argmax) is row-wise, so a slot's tokens equal decoding its request
alone.

Not ported yet (the JAX scheduler has them): chunked prefill,
speculative decoding and the prefix cache. A program or a
``ServeConfig`` that asks for one of them is refused with ``ValueError``
at construction.

The JAX scheduler compiles every device callable ahead of time
(``parallax_tpu/serve/continuous.py:318-371``). Here the warmup hands the
live state to the program's ``capture``, which on the card captures the
one-request prefill and the decode step for the slot count as CUDA
graphs (``NMTDecodeProgram.capture``); the loop then replays them, with
one device-to-host copy of the next tokens a step. A program without
``capture`` is warmed by running each callable once on a throwaway
state. Either way the CUDA kernels are built before the first request.
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
from parallax_tpu_torch.serve.paging import PageAllocator


class DecodeProgram:
    """The interface a decode model exposes to the scheduler (duck
    typed — subclassing is optional; serve/adapters.py implements it
    for NMT). All shapes are FIXED per program instance.

    Attributes: ``max_len`` (decode buffer length — the per-request
    token cap), ``bos_id`` / ``eos_id`` / ``pad_id``, and ``paged``
    (False): when True the self-KV lives in a page pool; the program
    then exposes ``page_size``, ``pool_pages``, ``pages_per_seq`` and
    ``pages_needed(cap)``, and ``step`` takes the ``[slots,
    pages_per_seq]`` int32 page table (unallocated entries hold the
    sentinel ``pool_pages``).

    Callables:

    * ``example_feed() -> dict`` — one request's feed at the padded
      shapes ``prefill`` accepts (used for warmup).
    * ``prepare_feed(feed) -> dict`` — validate/pad one request's raw
      feed onto the fixed prefill shapes.
    * ``init_state(params, slots) -> state`` — fresh device state for
      ``slots`` slots (KV caches/pool, encoder memory, masks).
    * ``prefill(params, feed) -> request_state`` — the one-time
      per-request work (e.g. the encoder + cross-attention K/V).
    * ``insert(state, slot, request_state) -> state`` — write one
      prefilled request into slot ``slot``. A program with
      ``insert_pages`` (True: decoder-only, its prompt K/V in the slot's
      own paged decode buffer) takes the slot's ``[pages_per_seq]``
      int32 page row too, sentinel-filled past the allocation, and must
      send padded prompt rows to the sentinel.
    * ``kv_prefix_positions(feed) -> int`` (optional) — the cache
      positions a prepared feed's prompt occupies before the first
      decoded token; a request then owns the pages of that many
      positions plus its cap.
    * ``step(params, state, tok, t[, pages]) -> (next_tok, state)`` —
      one batched decode step: ``tok``/``t`` are ``[slots]`` int32
      arrays of each slot's current token and position; returns each
      slot's next token. Inactive slots' lanes compute values the
      scheduler ignores — they must not affect other lanes.
    """


class _Slot:
    __slots__ = ("req", "tokens", "t", "cap", "pages")

    def __init__(self, req: Request, cap: int, pages: List[int]):
        self.req = req
        self.tokens: List[int] = []
        self.t = 0
        self.cap = cap
        self.pages = pages


def _refuse_unported(program, serve_config) -> None:
    asks = []
    if int(getattr(program, "num_prefill_chunks", 1)) > 1:
        asks.append("chunked prefill (num_prefill_chunks > 1)")
    if int(getattr(program, "spec_tokens", 0) or 0):
        asks.append("speculative decoding (spec_tokens)")
    if bool(getattr(serve_config, "prefix_cache", False)):
        asks.append("the prefix cache (ServeConfig.prefix_cache)")
    if asks:
        raise ValueError(
            "not ported to parallax_tpu_torch yet: " + ", ".join(asks))


class ContinuousScheduler:
    """Drives one :class:`DecodeProgram` over a request queue on a
    daemon thread; constructed (and owned) by
    :class:`~parallax_tpu_torch.serve.session.ServeSession`."""

    TOKENS_PER_SEC_WINDOW = 50

    def __init__(self, program, params, serve_config, metrics,
                 queue: RequestQueue):
        _refuse_unported(program, serve_config)
        self._program = program
        self._params = params
        self._queue = queue
        self.metrics = metrics
        self.alive = True
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

        self._paged = bool(getattr(program, "paged", False))
        if self._paged:
            self._alloc = PageAllocator(program.pool_pages)
            self._P = int(program.pages_per_seq)
            self._sentinel = int(program.pool_pages)
            self._pages = np.full((self._S, self._P), self._sentinel,
                                  np.int32)
            self._pages_gauge = metrics.gauge("serve.kv_pages_in_use")
            self._pages_gauge.set(0)
            metrics.gauge("serve.kv_pool_pages").set(self._sentinel)
            self._defer = metrics.counter("serve.kv_refill_deferred")
        else:
            self._pages = None
        self._insert_pages = bool(getattr(program, "insert_pages", False))
        self._kvpos = getattr(program, "kv_prefix_positions", None)

        self._slots: List[Optional[_Slot]] = [None] * self._S
        self._tok = np.full((self._S,), program.pad_id, np.int32)
        self._t = np.zeros((self._S,), np.int32)
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._state = None
        self._warm()
        self._thread = threading.Thread(target=self._loop,
                                        name="parallax-serve-decode",
                                        daemon=True)
        self._thread.start()

    # -- warmup ------------------------------------------------------------

    def _step(self, state, tok, t):
        if self._paged:
            return self._program.step(self._params, state, tok, t,
                                      self._pages.copy())
        return self._program.step(self._params, state, tok, t)

    def _warm(self) -> None:
        """Make the live state and prepare every callable the serving
        loop can call: through the program's ``capture`` (prefill and
        step captured as graphs on the card, on this state) or, for a
        program without one, by running prefill, insert and step once on
        a throwaway state. Either way the first request pays no one-time
        cost. Records ``serve.compile_seconds``."""
        prog, params = self._program, self._params
        t0 = time.perf_counter()
        with trace.span("serve.warmup_compile", mode="decode"):
            self._state = prog.init_state(params, self._S)
            capture = getattr(prog, "capture", None)
            if capture is not None:
                capture(params, self._state)
            else:
                state = prog.init_state(params, self._S)
                rs = prog.prefill(params,
                                  prog.prepare_feed(prog.example_feed()))
                state = self._insert(state, 0, rs, [])
                tok = np.full((self._S,), prog.bos_id, np.int32)
                nxt, state = self._step(state, tok,
                                        np.zeros((self._S,), np.int32))
                np.asarray(nxt)
        dt = time.perf_counter() - t0
        self.metrics.histogram("serve.compile_seconds").record(dt)
        parallax_log.info(
            "serve decode warmup: prefill/insert/step %s in %.2fs "
            "(%d slots%s)", "captured" if capture is not None else "ran",
            dt, self._S,
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

    # -- paging ------------------------------------------------------------

    def _alloc_pages(self, req: Request) -> Optional[List[int]]:
        """Pages for one refill, or None to DEFER (pool exhausted —
        retiring sequences will free pages; the request stays queued)."""
        if not self._paged:
            return []
        if self._kvpos is not None:
            # the positions this request writes: its prompt's and its cap's
            n = min(-(-(int(self._kvpos(req.feed)) + req.max_new_tokens)
                      // int(self._program.page_size)), self._P)
        else:
            n = self._program.pages_needed(req.max_new_tokens)
        if not self._alloc.can_alloc(n):
            self._defer.inc()
            return None
        ids = self._alloc.alloc(n)
        self._pages_gauge.set(self._alloc.in_use)
        return ids

    def _release_pages(self, pages: List[int]) -> None:
        if self._paged and pages:
            self._alloc.free(pages)
            self._pages_gauge.set(self._alloc.in_use)

    def _clear_slot(self, j: int) -> None:
        self._tok[j] = self._program.pad_id
        self._t[j] = 0
        if self._paged:
            self._pages[j, :] = self._sentinel

    # -- refill / prefill --------------------------------------------------

    def _activate(self, j: int, req: Request, pages: List[int],
                  rs) -> None:
        if req.rec is not None:
            req.rec.mark("decode")
            req.rec.kv_pages = len(pages)
        self._state = self._insert(self._state, j, rs, pages)
        self._slots[j] = _Slot(req, req.max_new_tokens, pages)
        self._tok[j] = self._program.bos_id
        self._t[j] = 0
        if self._paged:
            self._pages[j, :] = self._sentinel
            self._pages[j, :len(pages)] = pages

    def _refill(self) -> None:
        """Fill free slots from the queue, one single-request prefill
        each, inserted without touching the running slots."""
        for j in range(self._S):
            if self._slots[j] is not None:
                continue
            req = self._queue.pop(timeout=0.0)
            if req is None:
                return
            if req.rec is not None:
                req.rec.mark("prefill")
            pages = self._alloc_pages(req)
            if pages is None:
                if req.rec is not None:
                    # pool exhausted: the wait back at the queue head is
                    # page pressure, not queue depth
                    req.rec.mark("slot_wait")
                self._queue.requeue_front(req)
                return
            with trace.span("serve.prefill", slot=j, id=req.id):
                rs = self._program.prefill(self._params, req.feed)
                self._activate(j, req, pages, rs)
            self._prefills.inc()

    # -- retire / expire / fail --------------------------------------------

    def _retire(self, j: int, now: float) -> None:
        slot = self._slots[j]
        self._slots[j] = None
        self._release_pages(slot.pages)
        self._clear_slot(j)
        req = slot.req
        if req.rec is not None:
            req.rec.tokens = len(slot.tokens)
            req.rec.decode_steps = int(slot.t)
        req._complete(np.asarray(slot.tokens, np.int32))
        self._completed.inc()
        self._latency.record((now - req.t_enqueue) * 1e3)
        trace.record_span("serve.request", req.t_enqueue, now, id=req.id,
                          tokens=len(slot.tokens))

    def _drop_slot(self, j: int, exc: BaseException) -> None:
        slot = self._slots[j]
        self._slots[j] = None
        self._release_pages(slot.pages)
        self._clear_slot(j)
        slot.req._fail(exc)

    def _expire_slots(self, now: float) -> None:
        for j, slot in enumerate(self._slots):
            if slot is None or slot.req.deadline is None:
                continue
            if now > slot.req.deadline:
                self._timeouts.inc()
                self._drop_slot(j, DeadlineExceeded(
                    f"request {slot.req.id} deadline expired mid-"
                    f"decode after {len(slot.tokens)} token(s)"))

    def _fail_active(self, exc: BaseException) -> None:
        """Fail every in-flight slot — called ONLY from the scheduler
        thread (slot state is single-owner)."""
        for j, slot in enumerate(self._slots):
            if slot is not None:
                self._drop_slot(j, exc)

    # -- the scheduling loop ----------------------------------------------

    def _active(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def _emit(self, j: int, token: int, now: float) -> None:
        """Deliver one token to slot ``j``; retires it at EOS or cap."""
        slot = self._slots[j]
        if slot.req.t_first_token is None:
            slot.req.t_first_token = now
            self._ttft.record((now - slot.req.t_enqueue) * 1e3)
            if slot.req.rec is not None:
                slot.req.rec.first_token(now)
        slot.tokens.append(token)
        slot.t += 1
        self._tok[j] = token
        self._t[j] = slot.t
        if token == self._program.eos_id or len(slot.tokens) >= slot.cap:
            self._retire(j, now)

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

    def _loop(self) -> None:
        try:
            self._run_loop()
        except BaseException as e:
            # a silently-dead daemon thread would hang every client on
            # result(): fail everything this scheduler holds instead
            self._fatal(e)

    def _run_loop(self) -> None:
        while True:
            if self._stop.is_set():
                # drain window expired: in-flight decodes are failed by
                # THIS thread (single-owner slot state)
                self._fail_active(ServeClosed(
                    "session closed mid-decode"))
                return
            self._expire_slots(time.perf_counter())
            self._refill()
            n_active = self._active()
            if n_active == 0:
                if self._queue.closed and len(self._queue) == 0:
                    return
                self._kick.wait(0.02)
                self._kick.clear()
                continue
            self._plain_iteration(n_active)

    def _fatal(self, cause: BaseException) -> None:
        """The decode loop died: fail in-flight slots and the whole
        queue with ReplicaUnavailable and close admission."""
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
        # after close the gauge reads None instead of sampling a dead
        # scheduler (its set_fn would pin the device state)
        self.metrics.gauge("serve.tokens_per_sec").set_fn(None)
        self._state = None


__all__ = ["DecodeProgram", "ContinuousScheduler"]
