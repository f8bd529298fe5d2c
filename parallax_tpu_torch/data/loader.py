"""Token-stream dataset with native prefetch (``parallax_tpu/data/
loader.py``).

The python face of the C++ loader ``cpp/dataloader.cc`` (a byte-for-byte
copy of the JAX package's): mmap'd int32 token files, a background
thread assembling fixed [batch, steps + 1] windows, the shard API's
mod-filter over windows, and a per-epoch ``std::mt19937_64`` shuffle, so
the native backend yields the JAX package's native batches bit for bit.

The library is built by ``g++`` at first use into
``build/parallax_tpu_torch/`` (beside the CUDA kernels), under a name
that hashes the source and the flags. ``PARALLAX_DATA_BACKEND=numpy``
chooses the numpy backend, which has the same window, shard and epoch
semantics but its own (PCG64) shuffle, as in the JAX package; a failed
build or load logs a warning and takes it too. ``TokenDataset.backend``
says which runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.data.prefetch import Prefetcher

SOURCE = Path(__file__).resolve().parent / "cpp" / "dataloader.cc"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
BACKEND_ENV = "PARALLAX_DATA_BACKEND"
_lib = None
_lib_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """Where the built loader library lives (``build/parallax_tpu_torch/``,
    or the directory ``Config.compilation_cache_dir`` set)."""
    from parallax_tpu_torch.ops import _cuda
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return Path(_cuda.BUILD_DIR) / f"libparallax_data-{digest}.so"


def _build() -> Path:
    """Compile the loader unless it is built already; raises on failure."""
    out = library_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        # a per-pid temp, renamed into place: a concurrent process never
        # loads a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def _native_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get(BACKEND_ENV) == "numpy":
            return None
        try:
            path = _build()
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            parallax_log.warning(
                "native dataloader build failed (%s %s); using the numpy "
                "backend", e, detail.decode(errors="replace")[-400:])
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            parallax_log.warning("native dataloader load failed (%s); "
                                 "using the numpy backend", e)
            return None
        lib.pl_open.restype = ctypes.c_void_p
        lib.pl_open.argtypes = [ctypes.c_char_p]
        lib.pl_num_tokens.restype = ctypes.c_long
        lib.pl_num_tokens.argtypes = [ctypes.c_void_p]
        lib.pl_start.restype = ctypes.c_int
        lib.pl_start.argtypes = [ctypes.c_void_p] + [ctypes.c_long] * 6
        lib.pl_next.restype = ctypes.c_int
        lib.pl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int32)]
        lib.pl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def write_token_file(path: str, tokens: np.ndarray) -> None:
    """Write an int32 token stream in the loader's format."""
    np.asarray(tokens, dtype=np.int32).tofile(path)


class TokenDataset:
    """Fixed-window LM batches from a token file.

    Yields ``{"x": [B, T], "y": [B, T], "w": [B, T]}``, the feed of
    examples/lm1b_driver.py (x = window[:-1], y = window[1:], w = ones).
    """

    def __init__(self, path: str, batch_size: int, num_steps: int,
                 num_shards: int = 1, shard_id: int = 0, seed: int = 0,
                 queue_depth: int = 4):
        self.path = path
        self.batch_size = batch_size
        self.num_steps = num_steps
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.seed = seed
        self._window = num_steps + 1
        self._handle = None
        self._epoch = 0
        lib = _native_lib()
        if lib is not None:
            handle = lib.pl_open(path.encode())
            if handle:
                rc = lib.pl_start(handle, batch_size, num_steps,
                                  num_shards, shard_id, seed, queue_depth)
                if rc == 0:
                    self._handle = handle
                    self._lib = lib
                    self.backend = "native"
                    return
                lib.pl_close(handle)
                if rc == -2:
                    raise ValueError(
                        f"{path}: not enough tokens for one "
                        f"[{batch_size} x {num_steps + 1}] batch on shard "
                        f"{shard_id}/{num_shards}")
        self.backend = "numpy"
        self._tokens = np.fromfile(path, dtype=np.int32)
        n_windows = len(self._tokens) // self._window
        self._mine = np.arange(shard_id, n_windows, num_shards)
        if len(self._mine) < batch_size:
            raise ValueError(
                f"{path}: not enough tokens for one "
                f"[{batch_size} x {num_steps + 1}] batch on shard "
                f"{shard_id}/{num_shards}")
        self._order = None
        self._off = 0

    @property
    def num_tokens(self) -> int:
        if self._handle is not None:
            return self._lib.pl_num_tokens(self._handle)
        return len(self._tokens)

    def next_batch(self):
        B, W = self.batch_size, self._window
        if self._handle is not None:
            buf = np.empty((B, W), np.int32)
            epoch = self._lib.pl_next(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if epoch < 0:
                raise RuntimeError("native loader stopped")
            self._epoch = epoch
            windows = buf
        else:
            if self._order is None or self._off + B > len(self._order):
                if self._order is not None:
                    self._epoch += 1
                prng = np.random.default_rng(
                    self.seed * 1000003 + self._epoch)
                self._order = prng.permutation(self._mine)
                self._off = 0
            idx = self._order[self._off:self._off + B]
            self._off += B
            windows = np.stack(
                [self._tokens[w * W:(w + 1) * W] for w in idx])
        return {"x": windows[:, :-1], "y": windows[:, 1:],
                "w": np.ones((B, W - 1), np.float32)}

    @property
    def epoch(self) -> int:
        return self._epoch

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    def close(self):
        if self._handle is not None:
            self._lib.pl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(batches: Iterable, place_fn: Callable,
                       depth: int = 2) -> Prefetcher:
    """Chain a host-batch iterator into placement on a background thread.

    ``batches`` is any iterable of feed dicts, typically a
    ``TokenDataset`` (whose native backend assembles windows on its own
    C++ thread); this adds the second stage, so the conversion and the
    copy to the card of batch t+1 overlap step t. Pass
    ``session.place_batch`` as ``place_fn`` and feed what it yields to
    ``session.run_iter(..., placed=True)``. At most ``depth`` placed
    batches are held at once. Returns a ``Prefetcher`` (an iterator and
    a context manager; ``close()`` stops the thread)."""
    return Prefetcher(batches, place_fn, depth=depth,
                      name="parallax-h2d-prefetch")
