"""Pipeline parallelism: microbatches through the stages of a ring
(``parallax_tpu/ops/pipeline.py``).

Layer stages are split over the mesh's pipeline axis (``core.mesh.
pipeline_group``: the 'pipe' axis of a three-axis mesh, else 'shard');
the engine's stage placement (``P('pipe')``) keeps each rank's own rows
of the stacked stage parameters. Microbatches flow round the ring with
one hop a tick. Where the JAX package runs one SPMD program with masked
ticks, each rank here runs the same tick loop for its own stage, with
the same tick math (``_decode_entry``): rank ``s`` is active at tick
``t`` when its schedule entry ``k = t - s`` holds a microbatch, and runs
its stage only then (an inactive tick sends zeros, as JAX's mask
makes). Every rank hops every tick, so every rank makes the same
exchanges in the same order. The hop is ``collectives.ring_pass`` over
the pipeline group; on a group of one rank it is the identity and the
loop runs with no collective.

Two schedules, as in JAX:

* ``pipeline_apply``: GPipe, differentiable end to end. Its forward runs
  the tick loop, keeping each active tick's graph (O(M) microbatch
  activations a stage, as the JAX scan's residuals); its backward runs
  the ticks in reverse, each rank receiving its output's cotangent from
  the next stage and sending its input's cotangent to the previous one
  (the transpose of the forward's hop). The output (the last stage's)
  is summed over the ring, so every stage returns it; the gradient of
  ``x`` (the first stage's) is summed over the ring too, so every stage
  gets it, as JAX's transpose of a stage-invariant input gives.
* ``pipeline_value_and_grad``: 1F1B with recompute, the loss fused into
  the last stage, a ring buffer of ``inflight_buffer_size`` stage inputs
  a chunk; each backward tick recomputes the stage forward with grad
  enabled and takes ``torch.autograd.grad`` against the received
  cotangent. Forward activations hop to ``s + 1`` and cotangents to
  ``s - 1`` in one exchange a tick.

Interleaving (``virtual_stages = V > 1``): each rank holds V chunks,
global stages ``s, S + s, ..., (V - 1) S + s``, stored device-major
(``stage_order_permutation``), so a rank's rows of the stack are its V
chunks in order; entries follow the round-robin order with M rounded up
to whole rounds of S (``_rounded_microbatches``; a ragged round runs
masked entries and warns once).

Gradients are this rank's, as autograd gives them inside the engine's
step: for its repl row's share of the batch, not averaged over 'repl'
(the engine averages every gradient over the ranks the batch is split
over). The mean over the repl group of each is the JAX function's.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.core import mesh as mesh_lib
from parallax_tpu_torch.ops import collectives


def _rounded_microbatches(M: int, S: int, V: int) -> int:
    """Schedule entries a chunk: M, rounded up to whole rounds of S when
    interleaving (ragged rounds become masked bubble entries)."""
    return M if V == 1 else -(-M // S) * S


_ragged_warned = set()


def _warn_ragged(M: int, S: int, V: int) -> None:
    """Warn once per (M, S, V) that an interleaved schedule with a ragged
    final round (M % S != 0) runs padded bubble entries. The cost model
    (``tune/costmodel.pipeline_bubble``) prices the same rounded M."""
    if V == 1 or M % S == 0:
        return
    key = (int(M), int(S), int(V))
    if key in _ragged_warned:
        return
    _ragged_warned.add(key)
    Mr = _rounded_microbatches(M, S, V)
    parallax_log.warning(
        "interleaved pipeline: num_microbatches=%d is not a multiple "
        "of num_stages=%d; the schedule pads to %d entries per chunk "
        "(%d masked bubble entries of pure waste at V=%d). Prefer "
        "M %% S == 0.", M, S, Mr, Mr - M, V)


def _decode_entry(k: int, S: int, V: int, M: int, reverse: bool = False):
    """(active, chunk, microbatch) of schedule entry ``k``: S consecutive
    microbatches a chunk, then rotate; ``reverse`` mirrors the chunk
    order for the 1F1B backward stream (last chunk first)."""
    n_entries = V * _rounded_microbatches(M, S, V)
    kc = min(max(k, 0), n_entries - 1)
    if V == 1:
        v, m = 0, kc
    else:
        v = (kc % (V * S)) // S
        if reverse:
            v = (V - 1) - v
        m = (kc // (V * S)) * S + kc % S
    active = 0 <= k < n_entries and m < M
    return active, v, min(max(m, 0), M - 1)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its leaves (in ``_leaves`` order) replaced."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(v) for v in t)
        return next(it)

    return go(tree)


def _to_device_major(stage_params, S: int, V: int):
    """[S*V, ...] device-major-stacked leaves (``p[s*V + v]`` holds
    global stage ``v*S + s``) viewed as [S, V, ...]: rank s's V chunks
    are its contiguous rows ``[s]``."""
    def tx(p):
        if p.shape[0] != S * V:
            raise ValueError(
                f"stage param leaf has leading dim {p.shape[0]}; "
                f"expected num_stages*virtual_stages = {S}*{V}")
        return p.reshape((S, V) + tuple(p.shape[1:]))
    return _rebuild(stage_params, [tx(p) for p in _leaves(stage_params)])


def stage_order_permutation(S: int, V: int):
    """Global-stage index held at device-major slot q = s*V + v. Models
    storing layers in natural order apply it once at init."""
    return [(q % V) * S + q // V for q in range(S * V)]


def stage_rows(stage_params, mesh, virtual_stages: int = 1):
    """This rank's [V, ...] rows of a whole device-major stack [S*V, ...]
    (what the engine's stage placement keeps on the rank)."""
    S, s, _ = _ring(mesh)
    rows = _to_device_major(stage_params, S, int(virtual_stages))
    return _rebuild(rows, [p[s] for p in _leaves(rows)])


def inflight_buffer_size(num_stages: int, num_microbatches: int,
                         virtual_stages: int = 1) -> int:
    """In-flight stage-input slots a chunk under 1F1B: min(M, 2S - 1) at
    V = 1 (GPipe stores all M); whole rounds of S, at most 3, when
    interleaving, so the ring index never collides while live."""
    S, M, V = num_stages, num_microbatches, virtual_stages
    if V == 1:
        return min(M, 2 * S - 1)
    return min(-(-M // S), 3) * S


def _ring(mesh):
    """(stage count S, this rank's stage s, the ring's group)."""
    if mesh is None:
        return 1, 0, None
    return (mesh_lib.pipeline_stage_count(mesh),
            mesh_lib.pipeline_index(mesh), mesh_lib.pipeline_group(mesh))


def _check(stage_params, x, M: int, V: int) -> List[torch.Tensor]:
    if M < 1 or x.shape[0] % M:
        raise ValueError(
            f"per-replica batch {x.shape[0]} must be divisible by "
            f"num_microbatches={M}")
    leaves = _leaves(stage_params)
    for p in leaves:
        if p.shape[0] != V:
            raise ValueError(
                f"stage param leaf has leading dim {p.shape[0]}; expected "
                f"virtual_stages = {V} chunk rows on this rank")
    return leaves


def _chunk(tree, leaves, v: int):
    return _rebuild(tree, [p[v] for p in leaves])


class _Schedule:
    """The static arguments of one pipelined call."""

    def __init__(self, stage_fn, tree, mesh, M, V):
        self.stage_fn, self.tree, self.M, self.V = stage_fn, tree, M, V
        self.S, self.s, self.group = _ring(mesh)
        self.n_ticks = V * _rounded_microbatches(M, self.S, V) + self.S - 1

    def hop(self, t: torch.Tensor, step: int) -> torch.Tensor:
        return collectives.ring_pass([t], self.group, self.s, [step])[0]


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, sch: _Schedule, x, *params):
        S, s, V, M = sch.S, sch.s, sch.V, sch.M
        record = any(ctx.needs_input_grad[1:])
        xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        held = [p.detach().requires_grad_(p.requires_grad) for p in params]
        act = torch.zeros_like(xm[0])
        outs = torch.zeros_like(xm)
        ticks = []
        for t in range(sch.n_ticks):
            active, v, m = _decode_entry(t - s, S, V, M)
            if not active:
                ticks.append(None)
                act = sch.hop(torch.zeros_like(act), 1)
                continue
            inp = xm[m] if s == 0 and v == 0 else act
            if record:
                inp = inp.detach().requires_grad_(True)
            with torch.set_grad_enabled(record):
                out = sch.stage_fn(_chunk(sch.tree, held, v), inp)
            ticks.append((v, m, inp, out))
            if s == S - 1 and v == V - 1:
                outs[m] = out.detach()
            act = sch.hop(out.detach(), 1)
        if S > 1:
            if s != S - 1:
                outs.zero_()
            collectives.all_reduce_(outs, sch.group)
        ctx.sch, ctx.ticks, ctx.held = sch, ticks, held
        ctx.x_meta = (x.shape, x.dtype)
        return outs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g_y):
        sch, ticks, held = ctx.sch, ctx.ticks, ctx.held
        S, s, V, M = sch.S, sch.s, sch.V, sch.M
        shape, dtype = ctx.x_meta
        g_outs = g_y.reshape((M, shape[0] // M) + tuple(shape[1:]))
        g_x = torch.zeros(g_outs.shape, dtype=dtype, device=g_y.device)
        g_params = [torch.zeros_like(p) if p.requires_grad else None
                    for p in held]
        want = [p for p in held if p.requires_grad]
        g_act = torch.zeros_like(g_outs[0])
        for t in reversed(range(sch.n_ticks)):
            # the cotangent of this tick's hop: the next stage's of what
            # it received
            g_out = sch.hop(g_act, -1)
            tick = ticks[t]
            if tick is None:
                g_act = torch.zeros_like(g_act)
                continue
            v, m, inp, out = tick
            if s == S - 1 and v == V - 1:
                g_out = g_out + g_outs[m]
            got = torch.autograd.grad(out, [inp] + want, g_out.to(out.dtype),
                                      allow_unused=True)
            it = iter(got[1:])
            for i, p in enumerate(held):
                if p.requires_grad:
                    g = next(it)
                    if g is not None:
                        g_params[i] += g
            g_inp = got[0] if got[0] is not None else torch.zeros_like(inp)
            if s == 0 and v == 0:
                g_x[m] += g_inp.to(dtype)
                g_act = torch.zeros_like(g_act)
            else:
                g_act = g_inp.to(g_act.dtype)
        ctx.ticks = None
        collectives.all_reduce_(g_x, sch.group)
        return (None, g_x.reshape(shape)) + tuple(g_params)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   num_microbatches: int,
                   virtual_stages: int = 1) -> torch.Tensor:
    """``x`` through the S*V pipelined stages of the ring (GPipe).

    * ``stage_fn(params_one_stage, activation) -> activation``: one
      stage; activation shapes match across stages.
    * ``stage_params``: this rank's chunk rows, leaves ``[V, ...]`` (its
      rows of the device-major ``[S*V, ...]`` stack, ``stage_rows``).
    * ``x``: this repl row's batch ``[B, ...]``, the same on every rank of
      the ring; B divides into ``num_microbatches``.

    Returns the ``[B, ...]`` outputs on every rank of the ring."""
    V, M = int(virtual_stages), int(num_microbatches)
    leaves = _check(stage_params, x, M, V)
    sch = _Schedule(stage_fn, stage_params, mesh, M, V)
    _warn_ragged(M, sch.S, V)
    return _GPipe.apply(sch, x, *leaves)


def pipeline_value_and_grad(stage_fn: Callable, loss_fn: Callable,
                            stage_params, x: torch.Tensor, y, mesh,
                            num_microbatches: int, head_params=None,
                            virtual_stages: int = 1):
    """The fused 1F1B forward and backward.

    * ``stage_fn`` and ``stage_params`` as in ``pipeline_apply``.
    * ``loss_fn(head_params, out_mb, y_mb) -> scalar``: a mean-style loss
      of one microbatch of last-stage outputs; ``head_params`` (replicated)
      holds the loss-side weights.
    * ``x`` ``[B, ...]`` and ``y`` (a tree of ``[B, ...]``): this repl
      row's batch, split into M microbatches.

    Returns ``(loss, (g_stage, g_head, g_x))``: the loss (the mean over
    microbatches, averaged over the repl group: the global mean on every
    rank), this rank's gradients of its stage rows, of the head (the
    last stage's, on every rank of the ring) and of ``x`` (the first
    stage's, on every rank of the ring), all of the repl row's mean loss
    (see the module doc). Peak activation memory is O(V min(M, 3S))
    microbatches."""
    V, M = int(virtual_stages), int(num_microbatches)
    leaves = _check(stage_params, x, M, V)
    S, s, group = _ring(mesh)
    _warn_ragged(M, S, V)
    Bbuf = inflight_buffer_size(S, M, V)
    n_entries = V * _rounded_microbatches(M, S, V)
    C = 2 * (S - 1) + (V - 1) * S
    head_params = head_params if head_params is not None else {}

    def slot(m):
        if V == 1:
            return m % Bbuf
        return (m // S) % (Bbuf // S) * S + m % S

    def hop(fwd, bwd):
        return collectives.ring_pass([fwd, bwd], group, s, [1, -1])

    params = [p.detach().requires_grad_(True) for p in leaves]
    head = [p.detach().requires_grad_(True) for p in _leaves(head_params)]
    head_tree = _rebuild(head_params, head)
    xm = x.detach().reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
    y_leaves = _leaves(y)
    ym = [a.reshape((M, a.shape[0] // M) + tuple(a.shape[1:]))
          for a in y_leaves]
    buf = torch.zeros((V, Bbuf) + tuple(xm.shape[1:]), dtype=xm.dtype,
                      device=xm.device)
    gacc = [torch.zeros_like(p) for p in params]
    hacc = [torch.zeros_like(p) for p in head]
    xg = torch.zeros_like(xm)
    lacc = torch.zeros((), dtype=torch.float32, device=xm.device)
    act_in = torch.zeros_like(xm[0])
    ct_in = torch.zeros_like(xm[0])
    for t in range(n_entries + C):
        # forward stream: entry t - s
        fwd_active, v_f, m_f = _decode_entry(t - s, S, V, M)
        out = torch.zeros_like(act_in)
        if fwd_active:
            inp = xm[m_f] if s == 0 and v_f == 0 else act_in
            buf[v_f, slot(m_f)] = inp
            with torch.no_grad():
                out = stage_fn(_chunk(stage_params, params, v_f), inp)
        # backward stream: entry t - (C - s), recomputed from the buffered
        # chunk input
        bwd_active, v_b, m_b = _decode_entry(t - (C - s), S, V, M,
                                             reverse=True)
        dinp = torch.zeros_like(ct_in)
        if bwd_active:
            inp_b = buf[v_b, slot(m_b)].clone().requires_grad_(True)
            with torch.enable_grad():
                out_b = stage_fn(_chunk(stage_params, params, v_b), inp_b)
            if s == S - 1 and v_b == V - 1:
                with torch.enable_grad():
                    o = out_b.detach().requires_grad_(True)
                    loss_m = loss_fn(head_tree, o,
                                     _rebuild(y, [a[m_b] for a in ym]))
                    got = torch.autograd.grad(loss_m, head + [o],
                                              allow_unused=True)
                for h, g in zip(hacc, got[:-1]):
                    if g is not None:
                        h += g / M
                lacc = lacc + loss_m.detach().float() / M
                ct = got[-1].to(ct_in.dtype) / M
            else:
                ct = ct_in
            got = torch.autograd.grad(out_b, params + [inp_b], ct,
                                      allow_unused=True)
            for acc, g in zip(gacc, got[:-1]):
                if g is not None:
                    acc += g
            dinp = got[-1].to(ct_in.dtype)
            if s == 0 and v_b == 0:
                xg[m_b] = dinp.to(xg.dtype)
        act_in, ct_in = hop(out.to(act_in.dtype), dinp)
    # the loss lives on the last stage, the head's gradient too, the
    # input's on the first: summed over the ring, each is on every rank
    flat = torch.cat([lacc.reshape(1)] + [h.reshape(-1).float()
                                          for h in hacc])
    collectives.all_reduce_(flat, group)
    collectives.all_reduce_(xg, group)
    g_head = []
    off = 1
    for h in hacc:
        g_head.append(flat[off:off + h.numel()].view_as(h).to(h.dtype))
        off += h.numel()
    loss = flat[0]
    if mesh is not None and mesh.repl_group is not None \
            and mesh.repl_group.size > 1:
        loss = collectives.all_reduce_(loss.reshape(1).clone(),
                                       mesh.repl_group)[0] \
            / mesh.repl_group.size
    return loss, (_rebuild(stage_params, gacc), _rebuild(head_params, g_head),
                  xg.reshape(x.shape))


__all__ = ["pipeline_apply", "pipeline_value_and_grad",
           "inflight_buffer_size", "stage_order_permutation", "stage_rows"]
