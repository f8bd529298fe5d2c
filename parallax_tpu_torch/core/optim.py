"""The dense optimizer chain, written to optax's formulas.

The LM1B model trains its LSTM group with
``optax.chain(clip_by_global_norm(10), adagrad(lr,
initial_accumulator_value=1.0))`` (models/lm1b.py:219-222). PyTorch's
own ``Adagrad`` divides by ``sqrt(acc) + eps`` where optax multiplies by
``rsqrt(acc + eps)``, and ``clip_grad_norm_`` adds 1e-6 to the norm;
either would break step parity with the JAX package, so both are
written out here. A transformation is an ``(init, update)`` pair over a
dict ``{path: tensor}``, as in optax; ``update`` returns new updates
and a new state and writes nothing in place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple

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
