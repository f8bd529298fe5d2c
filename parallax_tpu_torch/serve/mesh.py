"""Serving over a mesh of ranks: one leader and its followers.

The JAX ``ServeSession`` is one process over the local devices of a
``('repl', 'shard')`` mesh (it refuses ``process_count() > 1``,
``parallax_tpu/serve/session.py:89-92``): one jit call spans the mesh.
The port's mesh is a process group, one rank a card, so a session over
it is a leader and followers:

* every rank constructs the session collectively: the placement (each
  rank its rows of every row-sharded table), the warmup and its captures
  run on every rank in one order;
* rank 0, the leader, owns the request queue, the micro-batcher or the
  continuous scheduler, the metrics and the replica surface;
* before each dispatch the leader broadcasts a header over the mesh's
  world group (``Channel``): the call and its host arguments (a
  formed one-shot feed; a prompt, a slot, its page row; the tokens,
  positions and page table of a decode step). Each follower replays the
  same call on its own state, so every rank issues the same collectives
  (the sharded lookups, the output gathers) in the same order;
* ``close()`` on the leader broadcasts ``("stop",)`` and the followers'
  replay threads return.

``MeshProgram`` wraps a decode program on every rank: each device call
runs inside the sharded-lookup scope of the served row shards (the
slots whole on every rank), and on the leader each call the followers
must replay first sends its header. ``follow`` is a follower's replay
loop. At one rank there is no channel and nothing is sent.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from parallax_tpu_torch.ops import embedding

# the program calls a follower replays: their header is the call's name
# and its host arguments (never params, state or device data)
_RELAYED = ("prefill", "prefill_chunk", "insert", "step", "spec_step",
            "copy_page")
# every call that reads the params or the state on the device
_DEVICE_CALLS = _RELAYED + ("init_state", "capture")

STOP = ("stop",)


class Channel:
    """The leader's headers to its followers: one ``broadcast_object_list``
    from rank 0 a header over the mesh's world group, staged through the
    mesh's device (a card for NCCL)."""

    def __init__(self, mesh):
        self.group = mesh.world.pg
        self.device = mesh.device
        self._lock = threading.Lock()

    def send(self, msg) -> None:
        with self._lock:
            torch.distributed.broadcast_object_list(
                [msg], src=0, group=self.group, device=self.device)

    def recv(self):
        box = [None]
        torch.distributed.broadcast_object_list(
            box, src=0, group=self.group, device=self.device)
        return box[0]


def lookup_scope(mesh, tables, batch_axes=()):
    """The sharded-lookup scope of the served row shards ``tables``
    (``[(shard, whole shape, path)]``) over ``mesh`` (the collectives'
    current mesh too), the batch split over ``batch_axes`` (none: every
    rank holds the whole batch), under ``no_grad``; ``no_grad`` alone at
    one rank."""
    if mesh.size == 1:
        return torch.no_grad()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    stack.enter_context(embedding.sharded_lookup_scope(
        mesh, tables, batch_axes=tuple(batch_axes)))
    return stack


def _header(name, args):
    if name == "prefill":               # (params, feed)
        return (name, args[1])
    if name == "prefill_chunk":         # (params, carry, k)
        k = int(args[2])
        return (name, args[1] if k == 0 else None, k)
    if name == "insert":                # (state, slot, rs[, page row])
        return (name, int(args[1])) + tuple(args[3:])
    if name == "step":                  # (params, state, tok, t[, pages])
        return (name,) + tuple(args[2:])
    if name == "spec_step":             # (params, state, tok, t, prev, pages)
        return (name,) + tuple(args[2:])
    return (name,) + tuple(args[1:])    # copy_page (state, dst, src)


class MeshProgram:
    """A decode program on one rank of a serving mesh (module doc). Every
    other attribute is the program's own; the scheduler's binding
    (``_serve_owner``) is kept on the program."""

    def __init__(self, program, mesh, tables, channel=None):
        self.__dict__.update(_inner=program, _mesh=mesh, _tables=tables,
                             relay=None)
        self.__dict__["_channel"] = channel

    @property
    def _serve_owner(self):
        return getattr(self._inner, "_serve_owner", None)

    @_serve_owner.setter
    def _serve_owner(self, owner):
        self._inner._serve_owner = owner

    def start_relay(self) -> None:
        """Send a header before each replayed call from here on (the
        leader, after every rank has warmed up)."""
        self.__dict__["relay"] = self._channel

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in _DEVICE_CALLS:
            return attr

        def call(*args):
            if self.relay is not None and name in _RELAYED:
                self.relay.send(_header(name, args))
            with lookup_scope(self._mesh, self._tables):
                return attr(*args)
        return call


def follow(program: MeshProgram, params, state, channel) -> None:
    """A follower's replay loop: each header the leader sends becomes the
    same call on this rank's params and state; the request state a call
    inserts is this rank's last prefill (or chunk) result. Returns on
    ``STOP``."""
    last = None
    while True:
        msg = channel.recv()
        op, args = msg[0], msg[1:]
        if op == "stop":
            return
        if op == "prefill":
            last = program.prefill(params, *args)
        elif op == "prefill_chunk":
            carry, k = args
            last = program.prefill_chunk(params, carry if k == 0 else last,
                                         k)
        elif op == "insert":
            state = program.insert(state, args[0], last, *args[1:])
        elif op == "step":
            state = program.step(params, state, *args)[1]
        elif op == "spec_step":
            state = program.spec_step(params, state, *args)[2]
        elif op == "copy_page":
            state = program.copy_page(state, *args)
        else:
            raise ValueError(f"serving follower: unknown header {op!r}")


__all__ = ["Channel", "MeshProgram", "follow", "lookup_scope", "STOP"]
