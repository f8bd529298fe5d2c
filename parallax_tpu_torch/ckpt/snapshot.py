"""The state as named leaves, and host snapshots of it
(``parallax_tpu/ckpt/snapshot.py``).

A checkpoint names every leaf of the state by the path JAX's ``keystr``
gives the JAX package's ``TrainState`` (``step``, ``params/...``,
``opt_state/...`` in optax's own nesting, ``rng``, ``model_state/...``,
``pending_grads/...``, ``slice_state/...``) and describes it as a
GLOBAL array: its whole shape, its dtype as numpy (and JAX) name it, and
the extents of that array this rank holds. So a checkpoint written by
either package, on any layout, restores into the other, on any layout.

``Leaf`` is one such leaf: the live tensor (or a host value), its global
shape and dtype, and its pieces, each a global extent with the local
index that holds it. A row shard is one piece (its rows of dim 0; so
are an expert shard and a rank's rows of a pipeline's stage stack,
whose global array is the stack in storage order); a column-parallel
shard of ``g`` fused blocks is ``g`` pieces (its columns of each
block); a replicated leaf is one piece covering everything. Only the
first replica of an extent writes it (``Engine.writes_split``: index 0
on every axis but the split one; rank 0 for a replicated leaf).

Two leaves have no tensor in the port's state. ``step`` is the host
counter, written as JAX's int32 scalar. ``rng`` is JAX's
``PRNGKey(seed + 1)`` (``core/engine.py:598``), which no step changes:
the port keeps the run's ``seed`` (the step generator is seeded from it
and the step counter, ``engine.step_seed``), writes the key as JAX does,
``uint32[2] = [0, (seed + 1) mod 2**32]``, and reads the seed back from
it.

One layout differs between the packages: the port keeps a convolution
kernel (a 4-d parameter: no other port model has one) OIHW, flax keeps
it HWIO. Its leaves (the kernel, its optimizer and pending state) carry
that permutation (``Leaf.perm``) and are written and read in flax's
layout.

``host_snapshot`` copies the state to host memory (pinned on the card,
into buffers it can reuse) and ``HostSnapshot.restore`` copies it back
into the live tensors in place: a captured step graph reads the same
buffers before and after.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from parallax_tpu_torch.core import classify, optim

Extent = Tuple[Tuple[int, int], ...]


def dtype_name(dtype) -> str:
    """The dtype as numpy and JAX name it (``"bfloat16"``, ``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def rng_leaf(seed: int) -> np.ndarray:
    """JAX's ``PRNGKey(seed + 1)`` (64-bit types off, JAX's default): the
    threefry key ``[0, (seed + 1) mod 2**32]``."""
    return np.array([0, (int(seed) + 1) & 0xFFFFFFFF], np.uint32)


def seed_of_rng(key, current: Optional[int] = None) -> int:
    """The run seed of a key ``rng_leaf`` (or JAX) wrote: ``current``
    when its low 32 bits give the same key (a seed of 2**32 or more
    keeps its high bits), else the key's ``lo - 1``."""
    hi, lo = (int(x) for x in np.asarray(key, np.uint32).reshape(2))
    if current is not None and np.array_equal(
            rng_leaf(current), np.array([hi, lo], np.uint32)):
        return int(current)
    return ((hi << 32) | lo) - 1


def _full(shape) -> Extent:
    return tuple((0, int(d)) for d in shape)


@dataclasses.dataclass
class Leaf:
    """One named leaf of a checkpointed tree on this rank."""

    name: str
    value: Any                  # a torch.Tensor, or a host numpy value
    shape: Tuple[int, ...]      # the global shape
    dtype: str
    # [(global extent, local index)]: the parts of the global array held
    # in ``value[local index]``
    pieces: List[Tuple[Extent, tuple]]
    writes: bool = True         # this rank is the first replica
    load: Optional[Callable] = None   # host leaves: fn(np.ndarray)
    # the global array is value.permute(perm) (a convolution kernel)
    perm: Optional[Tuple[int, ...]] = None

    def assign(self, full: torch.Tensor) -> None:
        """Write this rank's pieces of the global array ``full`` (a CPU
        tensor) into the leaf, in place."""
        if self.load is not None:
            self.load(full.numpy())
            return
        for extent, index in self.pieces:
            src = full[tuple(slice(a, b) for a, b in extent)]
            if self.perm is not None:
                src = src.permute(tuple(int(i) for i in np.argsort(self.perm)))
            if isinstance(self.value, torch.Tensor):
                with torch.no_grad():
                    self.value[index].copy_(src)
            else:
                np.copyto(self.value[index] if index else self.value,
                          src.numpy())


# port OIHW -> flax HWIO
CONV_PERM = (2, 3, 1, 0)


def replicated(name: str, value, load: Optional[Callable] = None,
               writes: bool = True,
               perm: Optional[Tuple[int, ...]] = None) -> Leaf:
    """A leaf every rank holds whole (in the global layout
    ``value.permute(perm)`` when ``perm`` is given)."""
    shape = tuple(int(s) for s in (value.shape if isinstance(
        value, torch.Tensor) else np.shape(value)))
    dtype = value.dtype if isinstance(value, torch.Tensor) \
        else np.asarray(value).dtype
    pieces = [(_full(shape), (slice(None),) * len(shape))]
    if perm is not None:
        shape = tuple(shape[i] for i in perm)
        pieces = [(_full(shape), (slice(None),) * len(shape))]
    return Leaf(name, value, shape, dtype_name(dtype), pieces, writes,
                load, perm)


def tree_leaves(tree, prefix: str = "") -> List[Leaf]:
    """Replicated leaves of a tree of tensors or numpy arrays, named as
    ``keystr`` names a pytree (``core.optim.tree_leaves``; numpy leaves
    too)."""
    out = []

    def walk(node, path):
        if isinstance(node, (torch.Tensor, np.ndarray)):
            out.append(replicated(path, node))
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for f in node._fields:
                walk(getattr(node, f), f"{path}/{f}" if path else f)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}" if path else str(i))
        elif isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], f"{path}/{k}" if path else str(k))

    walk(tree, prefix)
    return out


def _param_of(name: str, section: str, paths: Sequence[str]
              ) -> Optional[str]:
    """The parameter path a state leaf belongs to: the longest parameter
    path ``name`` ends with (``slice_state/<path>[/field]`` for the slice
    state), or None."""
    best = None
    rest = name[len(section) + 1:] if name.startswith(section + "/") \
        else name
    for p in paths:
        hit = rest == p or rest.endswith("/" + p) or (
            section == "slice_state" and rest.startswith(p + "/")
            and "/" not in rest[len(p) + 1:])
        if hit and (best is None or len(p) > len(best)):
            best = p
    return best


def _split_leaf(name: str, value: torch.Tensor, param: str, engine,
                local: Tuple[int, ...]) -> Leaf:
    """The leaf ``name`` of parameter ``param``'s state (or the parameter
    itself), described globally through the engine's plan: a leaf of the
    parameter's local shape ``local`` (with a leading ring dim at most)
    is split as the parameter is; any other (a scalar count) is
    replicated."""
    from parallax_tpu_torch.core import engine as engine_lib
    plan, mesh = engine.plan, engine.mesh
    placement = plan.placements.get(param, engine_lib.REPLICATED)
    shape = tuple(value.shape)
    lead = len(shape) - len(local)
    if placement == engine_lib.REPLICATED or lead not in (0, 1) \
            or shape[lead:] != local:
        return replicated(name, value, writes=mesh.rank == 0)
    p, s = engine.split_size(param), engine.split_group(param)[1]
    whole = slice(None)
    if placement == engine_lib.TP_COLUMN:
        g = plan.tp_groups[param]
        n = shape[-1] // g
        gshape = shape[:-1] + (shape[-1] * p,)
        pieces = []
        for b in range(g):
            extent = _full(shape[:-1]) + ((b * n * p + s * n,
                                           b * n * p + (s + 1) * n),)
            pieces.append((extent, (whole,) * (len(shape) - 1)
                           + (slice(b * n, (b + 1) * n),)))
    else:
        n = shape[lead]
        gshape = shape[:lead] + (n * p,) + shape[lead + 1:]
        extent = list(_full(shape))
        extent[lead] = (s * n, (s + 1) * n)
        pieces = [(tuple(extent), (whole,) * len(shape))]
    return Leaf(name, value, gshape, dtype_name(value.dtype), pieces,
                writes=engine.writes_split(param))


def state_leaves(state, engine=None, optimizer=None) -> List[Leaf]:
    """Every leaf of a ``TrainState`` under the JAX package's names.

    With ``engine`` the leaves are described through its plan (row and
    tensor-parallel shards as their global extents) and its optimizer
    grouping (under ``sparse_grad_mode="slices"`` the JAX engine wraps
    the model's optimizer in ``multi_transform({"slices": set_to_zero(),
    "rest": ...})``, whose state nests it under
    ``inner_states/rest/inner_state``). Without one every leaf is
    replicated and ``optimizer`` names the optimizer state."""
    out: List[Leaf] = []

    def set_step(v):
        state.step = int(np.asarray(v))

    def set_seed(v):
        state.seed = seed_of_rng(v, state.seed)

    out.append(replicated("step", np.asarray(state.step, np.int32),
                          load=set_step,
                          writes=engine is None or engine.mesh.rank == 0))
    named: List[Tuple[str, str, Any]] = []
    named += [("params", f"params/{p}", t)
              for p, t in classify.flatten(state.params)]
    tx = engine.model.optimizer if engine is not None else optimizer
    opt_prefix = "opt_state"
    if engine is not None and engine._slice_resolved:
        opt_prefix = "opt_state/inner_states/rest/inner_state"
    named += [("opt_state", f"{opt_prefix}/{p}" if p else opt_prefix, t)
              for p, t in tx.leaves(state.opt_state)]
    for section in ("model_state", "pending_grads", "slice_state"):
        tree = getattr(state, section)
        if tree is not None:
            named += [(section, f"{section}/{p}", t)
                      for p, t in optim.tree_leaves(tree)]
    local = {p: tuple(t.shape) for p, t in classify.flatten(state.params)}
    paths = list(local)
    for section, name, t in named:
        if section == "params":
            param = name[len("params/"):]
        else:
            param = _param_of(name, section, paths) \
                if section != "model_state" else None
        conv = param is not None and len(local[param]) == 4 \
            and tuple(t.shape) == local[param]
        if engine is not None and param in engine.plan.placements \
                and not conv:
            out.append(_split_leaf(name, t, param, engine, local[param]))
        else:
            out.append(replicated(
                name, t, writes=engine is None or engine.mesh.rank == 0,
                perm=CONV_PERM if conv else None))
    out.append(replicated("rng", rng_leaf(state.seed), load=set_seed,
                          writes=engine is None or engine.mesh.rank == 0))
    return out


# -- host snapshots -----------------------------------------------------------


@dataclasses.dataclass
class HostSnapshot:
    """The state's leaves copied to host memory. ``ready`` (an event on
    the card, None on the CPU) marks the copies complete; ``leaves`` are
    the live leaves the snapshot was taken from."""

    step: int
    leaves: List[Leaf]
    host: Dict[str, Any]
    nbytes: int
    ready: Any = None

    def wait(self) -> None:
        """Block until the copies to the host are complete."""
        if self.ready is not None:
            self.ready.synchronize()

    def host_leaves(self) -> List[Leaf]:
        """The leaves with their values replaced by the host copies (what
        the store's writer reads)."""
        self.wait()
        return [dataclasses.replace(leaf, value=self.host[leaf.name],
                                    load=None) for leaf in self.leaves]

    def restore(self) -> int:
        """Copy the snapshot back into the live leaves, in place; returns
        the snapshot's step."""
        with torch.no_grad():
            for leaf in self.leaves:
                saved = self.host[leaf.name]
                if leaf.load is not None:
                    leaf.load(saved)
                elif isinstance(leaf.value, torch.Tensor):
                    leaf.value.copy_(saved, non_blocking=True)
                else:
                    np.copyto(leaf.value, saved)
        return self.step


def host_snapshot(leaves: List[Leaf], step: int,
                  buffers: Optional[Dict[str, Any]] = None) -> HostSnapshot:
    """Copy every leaf to host memory. On the card the copies are
    asynchronous, into pinned buffers (``buffers``, reused when their
    shapes match: the caller keeps the dict), ordered on the current
    stream: a step dispatched after this call runs after the copies, so
    it cannot change what they read. ``HostSnapshot.wait`` (or
    ``ready``) says when they are done."""
    host: Dict[str, Any] = {}
    nbytes = 0
    ready = None
    cuda = False
    for leaf in leaves:
        v = leaf.value
        if isinstance(v, torch.Tensor):
            buf = None if buffers is None else buffers.get(leaf.name)
            on_card = v.device.type == "cuda"
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = torch.empty(v.shape, dtype=v.dtype, device="cpu",
                                  pin_memory=on_card)
                if buffers is not None:
                    buffers[leaf.name] = buf
            buf.copy_(v.detach(), non_blocking=on_card)
            cuda |= on_card
            host[leaf.name] = buf
            nbytes += buf.numel() * buf.element_size()
        else:
            host[leaf.name] = np.array(v)
            nbytes += host[leaf.name].nbytes
    if cuda:
        ready = torch.cuda.Event()
        ready.record()
    return HostSnapshot(int(step), leaves, host, nbytes, ready)
