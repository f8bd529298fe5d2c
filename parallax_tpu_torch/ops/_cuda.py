"""Build and load the port's CUDA kernels.

Each kernel is one source in ``parallax_tpu_torch/csrc/`` with a plain
``extern "C"`` launcher that returns ``cudaGetLastError()``. At first
use the source is compiled by ``nvcc`` for ``sm_90a`` into
``build/parallax_tpu_torch/`` beside the package, under a name that
hashes the source and the flags (an edited source builds anew, an
unchanged one loads from the cache), and loaded with ``ctypes``. A
failed build raises with nvcc's stderr. The ``-Xptxas -v`` report
(registers, shared memory, spills per kernel) is kept beside each
library as ``<name>-<hash>.log``.

Two scopes serve the step's byte count on meta tensors
(``Engine.count_step_bytes``, the tuner's cost inputs): ``meta_for``
names the device a meta pass stands for, so a wrapper routes a meta
tensor as it would route that device's (``routed_device``); and a
wrapper runs its plain version inside ``stand_in()``, so the count
skips the plain ops that stand in for a kernel, whose traffic its own
byte model prices.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "parallax_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("flash_attention", "flash_attention_sm90",
                  "flash_attention_f32_sm90", "flash_attention_bwd",
                  "paged_attention", "lstm", "lstm_sm90")

_libs: Dict[str, object] = {}   # loaded libraries and typed launchers
_lock = threading.Lock()

_META_FOR: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_meta_for", default=None)
_STAND_IN: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_stand_in", default=False)


@contextlib.contextmanager
def meta_for(device):
    """Inside: a meta tensor is routed as a tensor on ``device`` is."""
    token = _META_FOR.set(torch.device(device))
    try:
        yield
    finally:
        _META_FOR.reset(token)


def routed_device(device) -> torch.device:
    """``device``, or for the meta device inside ``meta_for`` the device
    the meta pass stands for."""
    device = torch.device(device)
    if device.type == "meta" and _META_FOR.get() is not None:
        return _META_FOR.get()
    return device


def kernel_route(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` takes its kernel's route: a CUDA
    tensor, or a meta one inside ``meta_for`` a CUDA device."""
    return routed_device(t.device).type == "cuda"


@contextlib.contextmanager
def stand_in():
    """Wraps a plain version run in place of its kernel."""
    token = _STAND_IN.set(True)
    try:
        yield
    finally:
        _STAND_IN.reset(token)


def standing_in() -> bool:
    return _STAND_IN.get()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, /usr/local/cuda/bin): the CUDA "
            "kernels are built from source at first use")
    return nvcc


def library_path(name: str) -> Path:
    """Where the built library of source ``name`` lives."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(
        src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, float]:
    """Compile every named source that is not built yet: one ``nvcc``
    per source, all started together. Returns ``{name: seconds}`` for
    the sources it compiled (0.0 for one found in the cache)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes) -> "ctypes._CFuncPtr":
    """The launcher ``symbol`` of source ``name``, typed: every pointer
    and the stream as ``c_void_p``, ints as ``c_int`` (an untyped
    ctypes call would pass a pointer as a 32-bit int)."""
    key = f"{name}:{symbol}"
    fn = _libs.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _libs[key] = fn
    return fn


def check(name: str, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        lib = library(name)
        lib.pt_error_string.restype = ctypes.c_char_p
        lib.pt_error_string.argtypes = [ctypes.c_int]
        msg = lib.pt_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({msg})")
