"""The dense optimizer chain, written to optax's formulas.

The LM1B model trains its LSTM group with
``optax.chain(clip_by_global_norm(10), adagrad(lr,
initial_accumulator_value=1.0))`` (models/lm1b.py:219-222), the NMT
model with ``chain(clip_by_global_norm(5), adam(join_schedules([
linear_schedule(0, lr, warmup), constant_schedule(lr)], [warmup])))``
(models/nmt.py:563-567). PyTorch's own ``Adagrad`` divides by
``sqrt(acc) + eps`` where optax multiplies by ``rsqrt(acc + eps)``,
``clip_grad_norm_`` adds 1e-6 to the norm, and its ``Adam`` and
schedulers count steps otherwise; each would break step parity with the
JAX package, so all are written out here. Schedules take the count of
earlier updates and compute in fp32, as optax does; the warmup starts at
lr 0, so the first NMT update is exactly zero in both packages.

A transformation is an ``(init, update)`` pair over a dict ``{path:
tensor}``, as in optax; ``update`` returns new updates and a new state
and writes nothing in place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _empty_init(params):
    return ()


def global_norm(updates: Dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every squared entry (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(u * u) for u in updates.values()))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every update by ``max_norm / norm`` when the global norm is
    not below ``max_norm`` (optax: ``select(norm < max, t, t / norm *
    max)``, no epsilon)."""

    def update(updates, state, params=None):
        g_norm = global_norm(updates)
        trigger = g_norm < max_norm
        return ({k: torch.where(trigger, u, (u / g_norm.to(u.dtype))
                                * max_norm)
                 for k, u in updates.items()}, state)

    return GradientTransformation(_empty_init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """acc += g^2; g *= where(acc > 0, rsqrt(acc + eps), 0)."""

    def init(params):
        return {k: torch.full_like(p, initial_accumulator_value)
                for k, p in params.items()}

    def update(updates, state, params=None):
        acc = {k: u * u + state[k] for k, u in updates.items()}
        out = {k: torch.where(acc[k] > 0, torch.rsqrt(acc[k] + eps),
                              torch.zeros_like(acc[k])) * u
               for k, u in updates.items()}
        return out, acc

    return GradientTransformation(init, update)


def scale(factor: float) -> GradientTransformation:

    def update(updates, state, params=None):
        return {k: u * factor for k, u in updates.items()}, state

    return GradientTransformation(_empty_init, update)


def adagrad(learning_rate: float, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> GradientTransformation:
    """optax.adagrad: scale_by_rss, then scale by -learning_rate."""
    return chain(scale_by_rss(initial_accumulator_value, eps),
                 scale(-learning_rate))


def sgd(learning_rate: float) -> GradientTransformation:
    return scale(-learning_rate)


# -- schedules: count -> value, in fp32 as optax computes them ----------------


def constant_schedule(value: float) -> Callable[[int], float]:
    return lambda count: float(np.float32(value))


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: from ``init_value`` to ``end_value`` over
    the first ``transition_steps`` counts."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count):
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac
                     + np.float32(end_value))

    return schedule


def join_schedules(schedules, boundaries) -> Callable[[int], float]:
    """optax.join_schedules: past each boundary the next schedule runs
    on the count less that boundary."""

    def schedule(count):
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> GradientTransformation:
    """optax.scale_by_adam: mu and nu are moving averages of g and g²,
    bias-corrected with the count after this update (``count + 1``);
    the update is ``mu_hat / (sqrt(nu_hat + eps_root) + eps)``. The count
    is a host integer, so the bias corrections cost no device sync."""

    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(updates, state, params=None):
        count = state["count"] + 1
        mu = {k: (1 - b1) * u + b1 * state["mu"][k]
              for k, u in updates.items()}
        nu = {k: (1 - b2) * (u * u) + b2 * state["nu"][k]
              for k, u in updates.items()}
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        out = {k: (mu[k] / c1) / (torch.sqrt(nu[k] / c2 + eps_root) + eps)
               for k in updates}
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def scale_by_learning_rate(learning_rate) -> GradientTransformation:
    """Scale by ``-learning_rate``; a callable is a schedule, called
    with the count of earlier updates (0 at the first)."""
    if not callable(learning_rate):
        return scale(-learning_rate)

    def init(params):
        return {"count": 0}

    def update(updates, state, params=None):
        step = float(np.float32(-1) * np.float32(learning_rate(
            state["count"])))
        return ({k: u * step for k, u in updates.items()},
                {"count": state["count"] + 1})

    return GradientTransformation(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, eps_root: float = 0.0) -> GradientTransformation:
    """optax.adam: scale_by_adam, then scale by the (scheduled) -lr."""
    return chain(scale_by_adam(b1, b2, eps, eps_root),
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

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """params[k] += updates[k], in place (optax.apply_updates casts the
    update to the parameter's dtype the same way)."""
    for k, u in updates.items():
        params[k].add_(u.to(params[k].dtype))
