"""Atomic, verifiable, layout-agnostic checkpoint store, in the JAX
package's on-disk format (``parallax_tpu/ckpt/store.py``).

One directory per step, named by the step::

    <root>/<step>/
        shards_<rank>.npz    this rank's unique shards (flat uint8 wires)
        shards_<rank>.json   their metadata and checksums
        manifest.json        committed LAST (temp + fsync + rename): the
                             step is complete iff this file parses

* **atomic commit**: every byte of array data and metadata is written and
  fsynced before the manifest is renamed into place; a crash before that
  leaves a directory without a manifest, which restore treats as torn and
  skips, loudly.
* **verifiable**: each shard records a CRC-32 of its wire bytes; restore
  recomputes it and refuses a mismatch (``CheckpointCorrupt``), and
  ``restore_latest`` falls back to the previous complete checkpoint.
* **layout-agnostic**: the manifest describes global arrays (shape,
  dtype, the extents of the shards), so a checkpoint saved on one layout
  restores onto another, and either package reads the other's.
* **one writer per extent**: each rank writes only the pieces it is the
  first replica of; rank 0 merges every rank's metadata into the
  manifest after a barrier (``torch.distributed``, where more than one
  rank runs; a shared filesystem is assumed).
* **bounded retention**: after each commit the oldest complete
  checkpoints beyond ``max_to_keep`` go, with torn directories older than
  the newest complete one. A numeric directory in another layout is
  never deleted or overwritten.

Wire format: every shard is the flat uint8 view of its bytes, the dtype
recorded by name, so bfloat16 round-trips without numpy knowing it (the
port reads it back through ``torch.uint8`` views).

Fault injection: ``PARALLAX_CKPT_FAULT=torn_manifest`` kills the process
after the shard files are durable and before the manifest commit;
``_fault_hook`` does the same in-process for tests.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.ckpt import snapshot as snap_lib

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
FAULT_ENV = "PARALLAX_CKPT_FAULT"


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed verification (torn write, truncated shard,
    checksum mismatch, uncovered extents). Restore falls back to the
    previous complete checkpoint instead of resuming wrong weights."""


class CheckpointTreeMismatch(CheckpointCorrupt):
    """The restore template's leaves (names, shapes or dtypes) do not
    match the saved checkpoint's: a config mismatch, not disk damage, so
    ``restore_latest`` raises it instead of falling back."""


def process_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def process_count() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _barrier() -> None:
    if process_count() > 1:
        torch.distributed.barrier()


def _fsync_write(path: str, data: bytes) -> None:
    """Write ``data`` durably: temp file, fsync, atomic rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _fsync_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez`` straight into the temp file (no archive in memory),
    fsync, atomic rename."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _wire(value, index, perm=None) -> np.ndarray:
    """The flat uint8 bytes of ``value[index]`` (permuted by ``perm``; C
    order), on the host."""
    if isinstance(value, torch.Tensor):
        t = value[index].detach()
        if perm is not None:
            t = t.permute(perm)
        t = t.to("cpu").contiguous()
        return t.reshape(-1).view(torch.uint8).numpy()
    arr = np.ascontiguousarray(np.asarray(value)[index])
    return arr.reshape(-1).view(np.uint8)


def _unwire(wire: np.ndarray, dtype: str, shape) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(wire)).view(
        snap_lib.torch_dtype(dtype)).reshape(tuple(shape))


def as_leaves(tree) -> List[snap_lib.Leaf]:
    """``tree`` as checkpoint leaves: a list of ``Leaf`` as it is, any
    other tree of tensors or arrays replicated under ``keystr`` names."""
    if isinstance(tree, list) and all(isinstance(x, snap_lib.Leaf)
                                      for x in tree):
        return tree
    return snap_lib.tree_leaves(tree)


class CheckpointStore:
    """Owns one checkpoint root directory."""

    def __init__(self, root: str, max_to_keep: Optional[int] = 5,
                 registry=None):
        self.root = os.path.abspath(root)
        self.max_to_keep = max_to_keep
        if registry is None:
            from parallax_tpu_torch.obs.metrics import MetricsRegistry
            registry = MetricsRegistry()
        self._saved = registry.counter("ckpt.saved")
        self._save_seconds = registry.histogram("ckpt.save_seconds")
        self._bytes = registry.gauge("ckpt.bytes")
        self._gc_deleted = registry.counter("ckpt.gc_deleted")
        self._torn = registry.counter("ckpt.torn_detected")
        self._fallbacks = registry.counter("ckpt.restore_fallbacks")
        # test seam: fn(phase) at 'after_shards' / 'before_manifest'; the
        # environment knob covers subprocesses
        self._fault_hook: Optional[Callable[[str], None]] = None
        self._foreign_warned = False
        os.makedirs(self.root, exist_ok=True)

    # -- save --------------------------------------------------------------

    def save(self, step: int, leaves, extras: Optional[dict] = None) -> str:
        """Write one complete checkpoint of ``leaves`` (``Leaf`` records,
        or a tree) and return its directory. ``extras``: a small JSON-able
        dict committed inside the manifest (the data cursor and the rest
        of the exact-resume closure)."""
        t0 = time.perf_counter()
        step = int(step)
        leaves = as_leaves(leaves)
        d = os.path.join(self.root, str(step))
        proc = process_index()
        if proc == 0 and os.path.isdir(d):
            if not self._is_own_layout(step):
                raise CheckpointCorrupt(
                    f"step dir {d} holds an unrecognized checkpoint "
                    f"layout (saved by a pre-upgrade version?); "
                    f"refusing to overwrite — migrate or clear it")
            # a re-save of this step (a rollback rewound it, a fallback
            # resume retrains it): clear every earlier artifact, or stale
            # shard files of another rank count would merge into the new
            # manifest; manifest-less until the commit, so a crash in
            # between reads as torn
            shutil.rmtree(d, ignore_errors=True)
        _barrier()
        os.makedirs(d, exist_ok=True)
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, Any] = {"process": proc, "leaves": {}}
        for leaf in leaves:
            rows = []
            if leaf.writes:
                for extent, index in leaf.pieces:
                    key = f"{leaf.name}::" + "_".join(
                        "%d-%d" % se for se in extent)
                    wire = _wire(leaf.value, index, leaf.perm)
                    arrays[key] = wire
                    rows.append({
                        "key": key,
                        "extent": [list(se) for se in extent],
                        "crc32": zlib.crc32(wire) & 0xFFFFFFFF,
                        "nbytes": int(wire.nbytes),
                    })
            meta["leaves"][leaf.name] = {
                "shape": list(leaf.shape), "dtype": leaf.dtype,
                "shards": rows}
        shard_file = f"shards_{proc}.npz"
        _fsync_savez(os.path.join(d, shard_file), arrays)
        del arrays
        meta["file"] = shard_file
        _fsync_write(os.path.join(d, f"shards_{proc}.json"),
                     json.dumps(meta).encode())
        self._fire_fault("after_shards")
        _barrier()
        if proc == 0:
            manifest = self._merge_manifest(d, step, extras)
            self._fire_fault("before_manifest")
            _fsync_write(os.path.join(d, MANIFEST),
                         json.dumps(manifest, indent=1,
                                    default=str).encode())
            self.gc()
        _barrier()
        self._saved.inc()
        self._save_seconds.record(time.perf_counter() - t0)
        self._bytes.set(_dir_bytes(d))
        return d

    def _fire_fault(self, phase: str) -> None:
        if self._fault_hook is not None:
            self._fault_hook(phase)
        if os.environ.get(FAULT_ENV, "") == "torn_manifest" \
                and phase == "before_manifest":
            parallax_log.error(
                "PARALLAX_CKPT_FAULT=torn_manifest: dying before the "
                "manifest commit")
            os._exit(31)

    def _merge_manifest(self, d: str, step: int,
                        extras: Optional[dict]) -> dict:
        """Rank 0 merges every rank's shard metadata into one manifest of
        the global arrays."""
        leaves: Dict[str, Any] = {}
        for name in sorted(os.listdir(d)):
            if not (name.startswith("shards_") and name.endswith(".json")):
                continue
            with open(os.path.join(d, name)) as f:
                meta = json.load(f)
            for path, info in meta["leaves"].items():
                entry = leaves.setdefault(path, {
                    "shape": info["shape"], "dtype": info["dtype"],
                    "shards": []})
                for row in info["shards"]:
                    entry["shards"].append(dict(row, file=meta["file"]))
        return {
            "format_version": FORMAT_VERSION,
            "step": int(step),
            "ts": time.time(),
            "process_count": process_count(),
            "extras": extras or {},
            "leaves": leaves,
        }

    # -- enumeration -------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Every step directory, complete or not, ascending."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self.root, n)))

    def complete_steps(self) -> List[int]:
        """Steps whose manifest parses (committed saves), ascending."""
        return [s for s in self.all_steps()
                if self.read_manifest(s) is not None]

    def committed_steps(self) -> List[int]:
        """Steps whose manifest exists (published by atomic rename, so
        existence means committed), ascending."""
        return [s for s in self.all_steps()
                if os.path.exists(os.path.join(self.root, str(s),
                                               MANIFEST))]

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: int) -> Optional[dict]:
        """The step's manifest, or None when missing or unparseable."""
        path = os.path.join(self.root, str(int(step)), MANIFEST)
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _is_own_layout(self, step: int) -> bool:
        """True when the step directory holds only this format's
        artifacts (or nothing): a directory with other content is another
        layout's checkpoint, never ours to clear."""
        d = os.path.join(self.root, str(int(step)))
        try:
            names = os.listdir(d)
        except OSError:
            return False
        return all(n.startswith("shards_") or n.startswith(MANIFEST)
                   for n in names)

    def _warn_foreign(self, steps: List[int]) -> None:
        if not steps or self._foreign_warned:
            return
        self._foreign_warned = True
        parallax_log.error(
            "checkpoint dir %s holds step dir(s) %s in an UNRECOGNIZED "
            "layout: they cannot be restored by this format and will be "
            "left untouched — migrate or clear them manually",
            self.root, steps)

    # -- restore -----------------------------------------------------------

    def restore(self, step: int, leaves, verify: bool = True,
                manifest: Optional[dict] = None):
        """Restore checkpoint ``step`` into ``leaves`` (``Leaf`` records or
        a tree of tensors and arrays), in place, and return them. Raises
        ``CheckpointCorrupt`` on any integrity failure and
        ``CheckpointTreeMismatch`` when the names, shapes or dtypes
        differ."""
        if manifest is None:
            manifest = self.read_manifest(step)
        if manifest is None:
            raise CheckpointCorrupt(
                f"checkpoint {step} under {self.root} has no readable "
                f"manifest (torn or in-progress save)")
        leaves = as_leaves(leaves)
        # two-way: a leaf the checkpoint lacks and a saved leaf the
        # template would drop are both a config mismatch
        want = {leaf.name for leaf in leaves}
        have = set(manifest["leaves"])
        if want != have:
            raise CheckpointTreeMismatch(
                f"checkpoint {step}'s saved tree does not match the "
                f"restore template: missing from checkpoint "
                f"{sorted(want - have)[:8]}, absent from template "
                f"{sorted(have - want)[:8]} — a config/model change, "
                f"not corruption (sync flipped? model edited?)")
        files = _ShardFiles(os.path.join(self.root, str(int(step))))
        try:
            fulls = [(leaf, self._assemble(
                leaf, manifest["leaves"][leaf.name], files, step, verify))
                for leaf in leaves]
        finally:
            files.close()
        # verified whole before anything is written: a corrupt shard
        # leaves the live state as it was
        for leaf, full in fulls:
            leaf.assign(full)
        return leaves

    def restore_extras(self, step: int) -> dict:
        m = self.read_manifest(step)
        return (m or {}).get("extras", {}) or {}

    def restore_latest(self, leaves, verify: bool = True):
        """Restore the newest checkpoint that passes verification,
        falling back (loudly) across torn and corrupt ones. Returns
        ``(leaves, step, info)`` or None when nothing is restorable;
        ``info`` records the fallback trail."""
        skipped: List[dict] = []
        manifests = {s: self.read_manifest(s) for s in self.all_steps()}
        foreign = [s for s, m in manifests.items()
                   if m is None and not self._is_own_layout(s)]
        self._warn_foreign(foreign)
        torn = [s for s, m in manifests.items()
                if m is None and s not in foreign]
        for s in torn:
            self._torn.inc()
            parallax_log.warning(
                "checkpoint %d under %s is TORN (no committed manifest — "
                "a crash mid-save); it will not be restored", s, self.root)
        complete = [s for s, m in manifests.items() if m is not None]
        for s in sorted(complete, reverse=True):
            try:
                out = self.restore(s, leaves, verify=verify,
                                   manifest=manifests[s])
                info = {"step": s, "torn_steps": torn,
                        "fallbacks": skipped}
                if skipped or torn:
                    self._fallbacks.inc()
                    parallax_log.warning(
                        "checkpoint restore FELL BACK to step %d (torn: "
                        "%s, corrupt: %s)", s, torn,
                        [k["step"] for k in skipped])
                return out, s, info
            except CheckpointTreeMismatch:
                raise
            except CheckpointCorrupt as e:
                self._torn.inc()
                parallax_log.error(
                    "checkpoint %d FAILED verification (%s); falling "
                    "back to the previous complete checkpoint", s, e)
                skipped.append({"step": s, "error": str(e)})
        return None

    def _assemble(self, leaf: snap_lib.Leaf, entry: dict,
                  files: "_ShardFiles", step: int,
                  verify: bool) -> torch.Tensor:
        """The leaf's global array from its shards, on the host."""
        path = leaf.name
        shape = tuple(entry["shape"])
        if shape != tuple(leaf.shape):
            raise CheckpointTreeMismatch(
                f"leaf {path!r} of checkpoint {step} has shape {shape}, "
                f"template wants {tuple(leaf.shape)} — a config/model "
                f"change, not corruption")
        if entry["dtype"] != leaf.dtype:
            raise CheckpointTreeMismatch(
                f"leaf {path!r} of checkpoint {step} has dtype "
                f"{entry['dtype']}, template wants {leaf.dtype} — a "
                f"config/model change, not corruption")
        pieces = []
        numel = int(np.prod(shape, dtype=np.int64))
        for row in entry["shards"]:
            try:
                wire = files.get(row["file"], row["key"])
            except Exception as e:
                # a truncated or garbled shard file surfaces as whatever
                # np.load's zip layer raises
                raise CheckpointCorrupt(
                    f"leaf {path!r} shard {row['key']!r} of checkpoint "
                    f"{step} is unreadable: {type(e).__name__}: {e}")
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(wire)) & 0xFFFFFFFF
                if crc != row["crc32"] or wire.nbytes != row["nbytes"]:
                    raise CheckpointCorrupt(
                        f"leaf {path!r} shard {row['key']!r} of "
                        f"checkpoint {step} failed its checksum "
                        f"({wire.nbytes} bytes, crc {crc:#x} != "
                        f"recorded {row['crc32']:#x})")
            extent = tuple((int(a), int(b)) for a, b in row["extent"])
            try:
                piece = _unwire(wire, entry["dtype"],
                                [b - a for a, b in extent])
            except RuntimeError as e:
                raise CheckpointCorrupt(
                    f"leaf {path!r} shard {row['key']!r} of checkpoint "
                    f"{step} does not fit its extent: {e}")
            pieces.append((extent, piece))
        covered = sum(piece.numel() for _, piece in pieces)
        if covered != numel:
            raise CheckpointCorrupt(
                f"leaf {path!r} of checkpoint {step}: shards cover "
                f"{covered} of {numel} elements (incomplete save)")
        if len(pieces) == 1 and pieces[0][0] == snap_lib._full(shape):
            return pieces[0][1]     # one shard holds the whole leaf
        full = torch.empty(shape, dtype=snap_lib.torch_dtype(entry["dtype"]))
        for extent, piece in pieces:
            full[tuple(slice(a, b) for a, b in extent)] = piece
        return full

    # -- retention ---------------------------------------------------------

    def gc(self) -> int:
        """Apply the retention policy (rank 0 only): keep the newest
        ``max_to_keep`` complete checkpoints, drop older ones and torn
        directories older than the newest complete step. Returns the
        directories deleted."""
        if process_index() != 0:
            return 0
        complete = self.committed_steps()
        doomed = []
        if self.max_to_keep is not None and \
                len(complete) > int(self.max_to_keep):
            doomed += complete[:len(complete) - int(self.max_to_keep)]
        if complete:
            stale = [s for s in self.all_steps()
                     if s < complete[-1] and s not in complete]
            self._warn_foreign(
                [s for s in stale if not self._is_own_layout(s)])
            doomed += [s for s in stale if self._is_own_layout(s)]
        for s in sorted(set(doomed)):
            shutil.rmtree(os.path.join(self.root, str(s)),
                          ignore_errors=True)
            self._gc_deleted.inc()
        if doomed:
            parallax_log.info(
                "checkpoint GC removed %d dir(s) under %s (keep=%s)",
                len(set(doomed)), self.root, self.max_to_keep)
        return len(set(doomed))

    def total_bytes(self) -> int:
        return sum(_dir_bytes(os.path.join(self.root, str(s)))
                   for s in self.all_steps())


class _ShardFiles:
    """Lazy npz readers for one checkpoint directory."""

    def __init__(self, d: str):
        self._d = d
        self._open: Dict[str, Any] = {}

    def get(self, fname: str, key: str) -> np.ndarray:
        z = self._open.get(fname)
        if z is None:
            z = self._open[fname] = np.load(
                os.path.join(self._d, fname), allow_pickle=False)
        return z[key]

    def close(self) -> None:
        for z in self._open.values():
            z.close()
        self._open = {}


def _dir_bytes(d: str) -> int:
    total = 0
    try:
        for name in os.listdir(d):
            try:
                total += os.path.getsize(os.path.join(d, name))
            except OSError:
                pass
    except OSError:
        pass
    return total
