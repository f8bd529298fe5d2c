"""CUDA-graph capture: the port's counterpart of ``lower().compile()``.

The JAX package runs each step as one compiled executable per batch
signature. On the card the counterpart is one captured
``torch.cuda.CUDAGraph`` per signature: capture records every kernel the
step launches, with its arguments, into a graph whose buffers come from
a memory pool the graph owns; a replay launches the whole recording with
one host call. ``capture`` runs the callable once eagerly on a side
stream first (lazy initialisation, the kernels' first-use builds, the
allocator's warm state, the libraries' per-stream state such as cuBLAS's
workspace), then records a second call on that same stream, so nothing
is set up inside the capture. (Recorded on a stream of its own, a capture
made while another thread served sometimes failed inside cuBLAS, the
capture invalidated, or gave wrong tokens.) A capture that fails raises;
nothing falls back to running the step eagerly.

A replay reads and writes the very tensors the capture saw, so what a
graph computes from must sit in buffers that outlive it and are updated
in place: the engine's state, and static input buffers that each new
batch is copied into. A host value read during capture is frozen into
the graph; every per-step scalar therefore lives on the device
(core/optim.py), and randomness comes from a generator registered with
the graph, reseeded before each replay.

The kernel wrappers count their launches in module-level integers
(``ops/lstm.py``, ``ops/flash_attention.py``, ``ops/paged_attention.py``)
through ``count_launch``, under one lock: serving replicas launch from
several threads at once. A capture launches nothing, so the launches
recorded into it (those made while the launching thread's current stream
is capturing: the capturing thread's, and the autograd worker's in a
captured backward) are taken back and kept with the graph, while other
threads' launches meanwhile stay counted; each replay adds them again.
Captures take one lock, so two threads never capture at once.

``disable_capture()`` is the counterpart of ``jax.disable_jit()``:
inside it (in the calling thread) the engine and the serving program
run their steps eagerly on the card. Nothing chooses it silently.
"""

from __future__ import annotations

import contextlib
import contextvars
import importlib
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

# module -> its launch counters
COUNTERS = {
    "parallax_tpu_torch.ops.flash_attention": ("launches", "launches_dq",
                                               "launches_dkv"),
    "parallax_tpu_torch.ops.paged_attention": ("launches",
                                               "launches_combine"),
    "parallax_tpu_torch.ops.lstm": ("launches_fwd", "launches_fwd_res",
                                    "launches_bwd"),
}

_DISABLED: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_capture_disabled", default=False)

_COUNT_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
# the launches recorded into the capture under way: {(module, counter):
# n}, None when no capture is
_tally: Optional[Dict[Tuple[str, str], int]] = None


@contextlib.contextmanager
def disable_capture():
    """Run steps eagerly on the card inside this block (this thread):
    no graph is captured or replayed, as ``jax.disable_jit()`` turns off
    compilation. An engine or a serving program that already holds
    graphs runs eagerly too while the block is open."""
    token = _DISABLED.set(True)
    try:
        yield
    finally:
        _DISABLED.reset(token)


def capture_enabled(device) -> bool:
    """True where steps run as captured graphs: on a CUDA device, outside
    ``disable_capture()``. On the CPU there is nothing to capture."""
    return torch.device(device).type == "cuda" and not _DISABLED.get()


def read_counters() -> Dict[Tuple[str, str], int]:
    """Every kernel wrapper's launch count, by (module, name)."""
    out = {}
    for mod, names in COUNTERS.items():
        m = importlib.import_module(mod)
        for name in names:
            out[(mod, name)] = getattr(m, name)
    return out


def add_counters(delta: Dict[Tuple[str, str], int]) -> None:
    with _COUNT_LOCK:
        for (mod, name), n in delta.items():
            m = importlib.import_module(mod)
            setattr(m, name, getattr(m, name) + n)


def count_launch(module: str, name: str) -> None:
    """A kernel wrapper's one launch: its counter ``module.name`` goes up
    by one. A launch recorded into a capture (the current stream is
    capturing) is also tallied for the graph, and ``capture`` takes it
    back out."""
    m = sys.modules[module]
    with _COUNT_LOCK:
        setattr(m, name, getattr(m, name) + 1)
        if _tally is not None and torch.cuda.is_current_stream_capturing():
            _tally[(module, name)] = _tally.get((module, name), 0) + 1


class Graph:
    """One captured CUDA graph: its outputs (tensors in the graph's pool,
    overwritten by every replay), the launches it makes by counter, and
    the seconds its warm call and capture took."""

    __slots__ = ("graph", "outputs", "launches", "seconds")

    def __init__(self, graph, outputs, launches, seconds):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.seconds = seconds

    def replay(self):
        self.graph.replay()
        add_counters(self.launches)
        return self.outputs


def capture(fn: Callable[[], object], device,
            generator: Optional[torch.Generator] = None,
            warm_trace: Optional[str] = None) -> Graph:
    """Capture ``fn()`` (no arguments: it reads static buffers) as a
    graph on ``device``. ``fn`` runs once eagerly on a side stream first;
    that call's launches are real and stay counted. The CUDA
    ``generator`` that ``fn`` draws from is registered with the graph, so
    a replay draws from its seed and offset at the time of the replay.
    ``warm_trace``: the eager call runs under ``torch.profiler`` (CPU and
    CUDA activity), stopped after a synchronize and before the capture
    begins (a profiler running through a capture loses its kernels or
    breaks it), and its Chrome trace is written to that path."""
    with _CAPTURE_LOCK:
        return _capture(fn, torch.device(device), generator, warm_trace)


def _capture(fn, device, generator, warm_trace=None) -> Graph:
    global _tally
    t0 = time.perf_counter()
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        if warm_trace is None:
            fn()
        else:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize(device)
            prof.export_chrome_trace(warm_trace)
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    g = torch.cuda.CUDAGraph()
    if generator is not None:
        g.register_generator_state(generator)
    with _COUNT_LOCK:
        _tally = {}
    try:
        with torch.cuda.graph(g, stream=side,
                              capture_error_mode="thread_local"):
            outputs = fn()
    finally:
        with _COUNT_LOCK:
            launches, _tally = _tally, None
        add_counters({k: -n for k, n in launches.items()})
    torch.cuda.synchronize(device)
    return Graph(g, outputs, launches, time.perf_counter() - t0)
