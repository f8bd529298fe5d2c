"""Bounded background prefetch: the feed's host work overlaps the step on
the card (``parallax_tpu/data/prefetch.py``).

``Prefetcher`` pulls items from an iterator on a daemon thread, runs a
``place_fn`` on each (feed conversion, bucketing, the copy to the card:
``ParallaxSession.place_batch``) and parks the results in a bounded
queue, so batch t+1 is placed while step t runs. ``skip_items`` is the
resume protocol's fast-forward.

Semantics, as in the JAX package:

* strict FIFO: results come out in iterator order;
* bounded depth: at most ``depth`` finished items wait in the queue (the
  item the worker is placing makes the pipeline depth + 1 deep);
* an exception raised by the iterator or by ``place_fn`` reaches the
  consumer where the failed item would have been yielded;
* ``close()`` (also the context manager and finalisation) stops the
  thread promptly even with the queue full.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from parallax_tpu_torch.obs import trace


def skip_items(source: Iterable, n: int) -> Iterator:
    """Fast-forward ``n`` items of ``source``: a resumed run rebuilds its
    input stream from the start and skips the ``session.data_cursor``
    batches the interrupted run consumed, so its batch t is the
    uninterrupted run's batch t. Skipping pays iteration alone (no feed
    conversion, no copy to the card).

    Raises ``ValueError`` when the stream ends inside the skip window (a
    cursor past the data is a wiring bug, not an exhausted epoch)."""
    it = iter(source)
    n = int(n)
    with trace.span("prefetch.skip", items=n):
        for i in range(n):
            try:
                next(it)
            except StopIteration:
                raise ValueError(
                    f"data stream ended after {i} item(s) while "
                    f"skipping to cursor {n}; the resume cursor "
                    f"points past the stream") from None
    return it


class _End:
    """Queue sentinel: the source iterator is exhausted."""


class _Raised:
    """Queue sentinel carrying an exception from the worker thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Prefetcher:
    """Iterate ``place_fn(item)`` for each item of ``source``, computed
    ``depth`` items ahead on a background thread."""

    def __init__(self, source: Iterable, place_fn: Optional[Callable] = None,
                 depth: int = 2, name: str = "parallax-prefetch",
                 skip: int = 0):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.depth = depth
        # the skip runs here, before the worker starts, so a cursor past
        # the stream raises at the caller's own stack
        self._source = (skip_items(source, skip) if skip
                        else iter(source))
        self._place_fn = place_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()

    # -- worker ------------------------------------------------------------

    def _worker(self):
        try:
            while True:
                # a slow source (the loader) and a slow placement (the
                # conversion and the copy) show as separate spans
                exhausted = False
                with trace.span("prefetch.source_next"):
                    try:
                        item = next(self._source)
                    except StopIteration:
                        exhausted = True
                if exhausted:
                    break
                if self._stop.is_set():
                    return
                if self._place_fn is not None:
                    with trace.span("prefetch.place"):
                        item = self._place_fn(item)
                self._put(item)
                if self._stop.is_set():
                    return
            self._put(_End)
        except BaseException as e:  # reaches the consumer
            self._put(_Raised(e))

    def _put(self, item):
        """``queue.put`` that gives up on ``close()`` instead of blocking
        on a full queue nobody drains."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer ----------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                # bounded wait: a close() from another thread must not
                # strand a consumer on a queue the worker no longer fills
                got = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set():
                    self._done = True
                    raise StopIteration from None
        if self._stop.is_set():
            # close() raced the get: closing abandons what is queued
            self._done = True
            raise StopIteration
        if got is _End:
            self._done = True
            raise StopIteration
        if isinstance(got, _Raised):
            self._done = True
            raise got.exc
        return got

    @property
    def alive(self) -> bool:
        """True while the background thread runs."""
        return self._thread.is_alive()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the worker and drop what is queued. Idempotent."""
        self._done = True
        self._stop.set()
        # drain so a _put blocked on a full queue sees the stop flag, and
        # again after the join: the first drain's room may have let that
        # _put land one more item (on the card a placed batch holds a
        # staging slot until it is dropped)
        self._drain()
        self._thread.join(timeout)
        self._drain()

    def _drain(self) -> None:
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close(timeout=0.0)
        except Exception:
            pass
