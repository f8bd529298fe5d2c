"""CUDA-graph capture: the port's counterpart of ``lower().compile()``.

The JAX package runs each step as one compiled executable per batch
signature. On the card the counterpart is one captured
``torch.cuda.CUDAGraph`` per signature: capture records every kernel the
step launches, with its arguments, into a graph whose buffers come from
a memory pool the graph owns; a replay launches the whole recording with
one host call. ``capture`` runs the callable once eagerly on a side
stream first (lazy initialisation, the kernels' first-use builds, the
allocator's warm state), then records a second call. A capture that
fails raises; nothing falls back to running the step eagerly.

A replay reads and writes the very tensors the capture saw, so what a
graph computes from must sit in buffers that outlive it and are updated
in place: the engine's state, and static input buffers that each new
batch is copied into. A host value read during capture is frozen into
the graph; every per-step scalar therefore lives on the device
(core/optim.py), and randomness comes from a generator registered with
the graph, reseeded before each replay.

The kernel wrappers count their launches in module-level integers
(``ops/lstm.py``, ``ops/flash_attention.py``, ``ops/paged_attention.py``).
A capture launches nothing, so the counts it adds are taken back and
kept with the graph; each replay adds them again.

``disable_capture()`` is the counterpart of ``jax.disable_jit()``:
inside it (in the calling thread) the engine and the serving program
run their steps eagerly on the card. Nothing chooses it silently.
"""

from __future__ import annotations

import contextlib
import contextvars
import importlib
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
    for (mod, name), n in delta.items():
        m = importlib.import_module(mod)
        setattr(m, name, getattr(m, name) + n)


def _set_counters(values: Dict[Tuple[str, str], int]) -> None:
    for (mod, name), n in values.items():
        setattr(importlib.import_module(mod), name, n)


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
            generator: Optional[torch.Generator] = None) -> Graph:
    """Capture ``fn()`` (no arguments: it reads static buffers) as a
    graph on ``device``. ``fn`` runs once eagerly on a side stream first;
    that call's launches are real and stay counted. The CUDA
    ``generator`` that ``fn`` draws from is registered with the graph, so
    a replay draws from its seed and offset at the time of the replay."""
    device = torch.device(device)
    t0 = time.perf_counter()
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn()
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    g = torch.cuda.CUDAGraph()
    if generator is not None:
        g.register_generator_state(generator)
    before = read_counters()
    try:
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            outputs = fn()
        after = read_counters()
    finally:
        _set_counters(before)
    torch.cuda.synchronize(device)
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    return Graph(g, outputs, launches, time.perf_counter() - t0)
