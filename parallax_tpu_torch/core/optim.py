"""The dense optimizer chain, written to optax's formulas.

The LM1B model trains its LSTM group with
``optax.chain(clip_by_global_norm(10), adagrad(lr,
initial_accumulator_value=1.0))`` (models/lm1b.py:219-222), the NMT
model with ``chain(clip_by_global_norm(5), adam(join_schedules([
linear_schedule(0, lr, warmup), constant_schedule(lr)], [warmup])))``
(models/nmt.py:563-567), the CNN models with
``chain(add_decayed_weights(4e-5, mask=ndim > 1), sgd(0.1,
momentum=0.9))`` (models/cnn.py), BERT with
``chain(clip_by_global_norm(1), adamw(lr, weight_decay=0.01))``
(models/bert.py:194-195), whose decay reaches every leaf. PyTorch's
own ``Adagrad`` divides by ``sqrt(acc) + eps`` where optax multiplies
by ``rsqrt(acc + eps)``,
``clip_grad_norm_`` adds 1e-6 to the norm, and its ``Adam`` and
schedulers count steps otherwise; each would break step parity with the
JAX package, so all are written out here. Schedules take the count of
earlier updates and compute in fp32, as optax does; the warmup starts at
lr 0, so the first NMT update is exactly zero in both packages.

A transformation is an ``(init, update)`` pair over a dict ``{path:
tensor}``, as in optax. ``update`` returns the updates and the state;
unlike optax it writes the state's tensors IN PLACE and returns the same
objects, so a step captured as a CUDA graph reads and writes the same
buffers at every replay (a fresh state tensor would be one the graph
never sees again). Every per-step scalar lives on the device with the
state: Adam's count and bias corrections, the schedules' counts and
values. The update tensors are fresh, or (``trace``) the state's own,
and no transformation writes its input updates. The per-leaf work runs
over lists with ``torch._foreach_*`` (one multi-tensor launch for many
leaves on the card), in optax's operation order, so each entry is
rounded as optax rounds it; ``global_norm`` alone sums per-leaf norms
rather than per-leaf sums of squares.

On a mesh the engine runs the update inside ``sharded_scope``, which
names the leaves that are a rank's part of a larger variable (row
shards, tensor-parallel column and row shards, expert and stage rows)
with the group each is split over: ``global_norm`` then adds their
squared norms over that group, so the clip sees the norm of the whole
gradient, as the JAX package's global arrays do, and
``row_sparse_adagrad`` (ops/sparse_optim.py) picks its rows from the
whole table.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

# ({name of a split leaf: the group it is split over}, their mesh) of
# the running update
_SHARDED: contextvars.ContextVar = contextvars.ContextVar(
    "parallax_optim_sharded", default=({}, None))


@contextlib.contextmanager
def sharded_scope(keys, mesh):
    """Inside, the leaves named by ``keys`` are parts of larger variables
    over ``mesh``: a sequence of names (each split over the 'shard'
    group) or ``{name: group}``."""
    if not isinstance(keys, dict):
        keys = {k: mesh.shard_group if mesh is not None else None
                for k in keys}
    token = _SHARDED.set((dict(keys), mesh))
    try:
        yield
    finally:
        _SHARDED.reset(token)


def _split_group(key):
    """The group leaf ``key`` is split over (of more than one rank), or
    None."""
    keys, mesh = _SHARDED.get()
    group = keys.get(key) if mesh is not None else None
    return group if group is not None and group.size > 1 else None


def shard_mesh(key):
    """The mesh leaf ``key`` is a row shard over 'shard' in, or None."""
    keys, mesh = _SHARDED.get()
    group = _split_group(key)
    return mesh if group is not None and group is mesh.shard_group \
        else None


def tree_leaves(tree, prefix: str = ""):
    """``[(path, tensor)]`` of a state tree, named as JAX's ``keystr``
    names a pytree: a NamedTuple's fields by name, a tuple's items by
    index, a dict's entries by key (the port's flat parameter paths
    ``a/b`` read as the nested dicts they stand for), in flattening
    order (dict keys sorted)."""
    def join(key):
        return f"{prefix}/{key}" if prefix else str(key)

    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in tree_leaves(getattr(tree, f), join(f))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in tree_leaves(v, join(i))]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree, key=str)
                for leaf in tree_leaves(tree[k], join(k))]
    return []


def _field_leaves(field: str) -> Callable:
    """Leaves of a ``{path: tensor}`` state that optax keeps as the one
    field ``field`` of its state NamedTuple."""
    return lambda state: tree_leaves(state, field)


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable
    # state -> [(path, tensor)]: the state's tensors under the paths
    # optax's own state gives them (the checkpoint's opt_state/... names)
    leaves: Callable = tree_leaves


def _empty_init(params):
    return ()


def _device_of(params) -> torch.device:
    for p in params.values():
        return p.device
    return torch.device("cpu")


def global_norm(updates: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every squared entry (optax.global_norm): the
    leaves' norms in one multi-tensor pass, then their root sum of
    squares, in fp32."""
    vals = list(updates.values())
    if not vals:
        return torch.zeros(())
    norms = [n.float() for n in torch._foreach_norm(vals)]
    groups = {}
    rest = []
    for k, n in zip(updates, norms):
        group = _split_group(k)
        if group is None:
            rest.append(n)
        else:
            groups.setdefault(group.ranks, (group, []))[1].append(n)
    if not groups:
        return torch.linalg.vector_norm(torch.stack(norms))
    from parallax_tpu_torch.ops import collectives
    total = torch.stack(rest).square().sum() if rest else 0.0
    for group, split in groups.values():
        sq = torch.stack(split).square().sum().reshape(1)
        collectives.all_reduce_(sq, group)
        total = sq[0] + total
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``max_norm / norm`` when the global norm is
    not below ``max_norm`` (optax: ``select(norm < max, t, t / norm *
    max)``, no epsilon). The select is folded into the two scalars: below
    the threshold they are 1 and 1, and ``t / 1 * 1`` is ``t`` exactly."""

    def update(updates, state, params=None):
        if not updates:
            return {}, state
        keys = list(updates)
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        one = torch.ones_like(g_norm)
        denom = torch.where(trigger, one, g_norm)
        mult = torch.where(trigger, one, torch.full_like(g_norm, max_norm))
        out = torch._foreach_div([updates[k] for k in keys], denom)
        torch._foreach_mul_(out, mult)
        return dict(zip(keys, out)), state

    return GradientTransformation(_empty_init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """acc += g^2 (in place); g *= where(acc > 0, rsqrt(acc + eps), 0)."""

    def init(params):
        return {k: torch.full_like(p, initial_accumulator_value)
                for k, p in params.items()}

    def update(updates, state, params=None):
        if not updates:
            return {}, state
        keys = list(updates)
        g = [updates[k] for k in keys]
        acc = [state[k] for k in keys]
        torch._foreach_add_(acc, torch._foreach_mul(g, g))
        inv = torch._foreach_add(acc, eps)
        torch._foreach_rsqrt_(inv)
        inv = [torch.where(a > 0, r, 0.0) for a, r in zip(acc, inv)]
        return dict(zip(keys, torch._foreach_mul(inv, g))), state

    return GradientTransformation(init, update,
                                  _field_leaves("sum_of_squares"))


def scale(factor: float) -> GradientTransformation:

    def update(updates, state, params=None):
        if not updates:
            return {}, state
        keys = list(updates)
        return dict(zip(keys, torch._foreach_mul(
            [updates[k] for k in keys], factor))), state

    return GradientTransformation(_empty_init, update)


def add_decayed_weights(weight_decay: float,
                        mask=None) -> GradientTransformation:
    """optax.add_decayed_weights: ``g + weight_decay * p`` on the leaves
    ``mask`` selects, the rest unchanged. ``mask`` is a dict ``{path:
    bool}`` or a callable that takes the params dict and returns one;
    None selects every leaf."""

    def update(updates, state, params=None):
        if params is None:
            raise ValueError("add_decayed_weights needs the params")
        chosen = mask(params) if callable(mask) else mask
        keys = [k for k in updates if chosen is None or chosen[k]]
        out = dict(updates)
        if keys:
            out.update(zip(keys, torch._foreach_add(
                [updates[k] for k in keys], torch._foreach_mul(
                    [params[k] for k in keys], weight_decay))))
        return out, state

    return GradientTransformation(_empty_init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax.trace: ``t = g + decay * t`` (in place); the update is
    ``t``, or ``g + decay * t`` with ``nesterov`` (not PyTorch's dampened
    momentum)."""

    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(updates, state, params=None):
        if not updates:
            return {}, state
        keys = list(updates)
        g = [updates[k] for k in keys]
        t = [state[k] for k in keys]
        # product and sum rounded apart, as optax's ``g + decay * t``
        torch._foreach_mul_(t, decay)
        torch._foreach_add_(t, g)
        out = torch._foreach_add(g, torch._foreach_mul(t, decay)) \
            if nesterov else t
        return dict(zip(keys, out)), state

    return GradientTransformation(init, update, _field_leaves("trace"))


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    """optax.adagrad: scale_by_rss, then scale by -learning_rate."""
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale(-learning_rate))


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax.sgd: ``trace(momentum, nesterov)`` when ``momentum`` is
    given, then scale by the (scheduled) -learning_rate."""
    by_lr = scale_by_learning_rate(learning_rate)
    if momentum is None:
        return by_lr
    return chain(trace(momentum, nesterov), by_lr)


# -- schedules: count -> value, in fp32 as optax computes them ----------------
#
# A schedule takes the int32 count of earlier updates as a 0-d tensor and
# returns a 0-d fp32 tensor on its device, computed there (the optimizer
# calls it inside the captured step). Called with a Python int, it
# returns a float, from the same arithmetic on the CPU.


def _f32(x: float) -> float:
    """``x`` rounded to fp32, so a scalar operand means the same in any
    kernel, whatever width it reads the scalar at."""
    return float(np.float32(x))


def _schedule(fn: Callable[[torch.Tensor], torch.Tensor]) -> Callable:
    def schedule(count):
        if isinstance(count, torch.Tensor):
            return fn(count)
        return float(fn(torch.tensor(count, dtype=torch.int32)))

    return schedule


def constant_schedule(value: float) -> Callable:
    v = _f32(value)
    return _schedule(lambda count: torch.full((), v, dtype=torch.float32,
                                              device=count.device))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    """optax.linear_schedule: from ``init_value`` to ``end_value`` over
    the first ``transition_steps`` counts."""
    if transition_steps <= 0:
        return constant_schedule(init_value)
    span, end = _f32(init_value - end_value), _f32(end_value)

    def fn(count):
        c = count.clamp(0, transition_steps).to(torch.float32)
        frac = 1.0 - c / float(transition_steps)
        return frac * span + end

    return _schedule(fn)


def join_schedules(schedules, boundaries) -> Callable:
    """optax.join_schedules: past each boundary the next schedule runs
    on the count less that boundary."""

    def fn(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            out = torch.where(count >= boundary, sched(count - boundary),
                              out)
        return out

    return _schedule(fn)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam: mu and nu are moving averages of g and g²,
    bias-corrected with the count after this update (``count + 1``);
    the update is ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``. The
    count is an int32 tensor on the device, and so are the bias
    corrections: nothing of the step is read on the host."""

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params)),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        keys = list(updates)
        g = [updates[k] for k in keys]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g² + b2 * nu, each
        # product rounded before the sum, as optax
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        count = state["count"]
        count.add_(1)
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(b1, cf)
        c2 = 1.0 - torch.pow(b2, cf)
        if not keys:
            return {}, state
        den = torch._foreach_div(nu, c2)
        if eps_root:
            torch._foreach_add_(den, eps_root)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        out = torch._foreach_div(torch._foreach_div(mu, c1), den)
        return dict(zip(keys, out)), state

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """Scale by ``-learning_rate``; a callable is a schedule, called
    with the device count of earlier updates (0 at the first)."""
    if not callable(learning_rate):
        return scale(-learning_rate)

    def init(params):
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=_device_of(params))}

    def update(updates, state, params=None):
        count = state["count"]
        step = learning_rate(count) * -1.0
        keys = list(updates)
        out = torch._foreach_mul([updates[k] for k in keys], step) \
            if keys else []
        count.add_(1)
        return dict(zip(keys, out)), state

    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """optax.adam: scale_by_adam, then scale by the (scheduled) -lr."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, eps_root: float = 0.0,
          weight_decay: float = 1e-4, mask=None) -> GradientTransformation:
    """optax.adamw: scale_by_adam, then add_decayed_weights(weight_decay,
    mask) (None decays every leaf), then scale by the (scheduled) -lr.
    The decay is elementwise, so a rank's shard decays as the whole
    variable would."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
                 add_decayed_weights(weight_decay, mask),
                 scale_by_learning_rate(learning_rate))


def chain(*txs: GradientTransformation) -> GradientTransformation:

    def init(params):
        return tuple(tx.init(params) for tx in txs)

    def update(updates, state, params=None):
        new_state = []
        for tx, s in zip(txs, state):
            updates, s = tx.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    def leaves(state):
        return [(f"{i}/{path}" if path else str(i), t)
                for i, (tx, s) in enumerate(zip(txs, state))
                for path, t in tx.leaves(s)]

    return GradientTransformation(init, update, leaves)


def multi_transform(transforms: Dict[str, GradientTransformation],
                    param_labels) -> GradientTransformation:
    """optax.multi_transform: each leaf goes through the transformation
    of its label; ``param_labels`` is a dict ``{path: label}`` or a
    callable that takes the params (or updates) dict and returns one."""

    def labels(tree):
        return param_labels(tree) if callable(param_labels) \
            else param_labels

    def split(tree):
        lab = labels(tree)
        return {name: {k: v for k, v in tree.items() if lab[k] == name}
                for name in transforms}

    def init(params):
        return {name: transforms[name].init(sub)
                for name, sub in split(params).items()}

    def update(updates, state, params=None):
        parts = split(updates)
        pparts = split(params) if params is not None else {}
        out = {}
        for name, sub in parts.items():
            new, state[name] = transforms[name].update(
                sub, state[name], pparts.get(name))
            out.update(new)
        return {k: out[k] for k in updates}, state

    def leaves(state):
        # optax: MultiTransformState(inner_states={label:
        # MaskedState(inner_state=...)})
        return [(f"inner_states/{name}/inner_state"
                 + (f"/{path}" if path else ""), t)
                for name in sorted(transforms)
                for path, t in transforms[name].leaves(state[name])]

    return GradientTransformation(init, update, leaves)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """params[k] += updates[k], in place (optax.apply_updates casts the
    update to the parameter's dtype the same way)."""
    if updates:
        keys = list(updates)
        torch._foreach_add_([params[k] for k in keys],
                            [updates[k].to(params[k].dtype) for k in keys])
