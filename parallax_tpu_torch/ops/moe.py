"""The switch / top-k mixture-of-experts layer with expert parallelism
over the mesh's 'shard' axis (``parallax_tpu/ops/moe.py``).

The router is a replicated fp32 ``[D, E]`` product, softmax and top-k
(ties to the lowest expert, as ``lax.top_k``): ``top_k=1`` is switch
routing (the gate is the winner's raw probability), ``top_k >= 2`` is
GShard routing (gates renormalised over the chosen experts, earlier
choices first in line for capacity). The load-balance loss is ``E *
sum_e f_e p_e`` with ``f_e`` the share of the (token, choice)
assignments sent to expert ``e`` and ``p_e`` its mean probability, both
over the global batch: each rank holds its rows of the batch (the
engine's default layout, dim 0 over the whole mesh), so both means are
``collectives.global_sum``s over ``mesh``, which the layer makes the
current mesh while it runs.

Expert weights ``[E, D, F]`` and ``[E, F, D]`` shard over 'shard': each
rank holds and uses E/n experts (the engine's expert placement, never
gathered); without expert parallelism (the dense path below) it holds
all E. Tokens reach their experts through a capacity-bounded tiled
``collectives.all_to_all`` over the shard group and come back through a
second one: the dispatch buffer ``[E, C, D]`` is filled by a
scatter-add at ``C = ceil(capacity_factor * k * b / E)`` slots an
expert (``b`` the rank's tokens; the JAX function divides its global
batch by the mesh size to the same count), each (token, choice) at its
rank in a cumulative count that puts every first choice ahead of every
second, and a pair past its expert's capacity adds zeros into slot 0 and
is dropped (``dropped``: the dropped pairs over k B, summed over the
mesh). Without a mesh, on a shard axis of 1, and where E does not
divide over it (with JAX's warning), every expert runs on every token
and the gates select (``_expert_compute_dense``): no capacity, nothing
dropped. The expert products are plain batched GEMMs, as in JAX, where
they are XLA einsums outside any Pallas kernel.

Nothing here reads a device value on the host, so the layer runs inside
a captured CUDA graph.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops.topk import top_k_stable

# (E, n) pairs already warned about: the JAX package warns once a trace
_WARNED: set = set()


class MoEOut(NamedTuple):
    out: torch.Tensor        # [B, D]
    aux_loss: torch.Tensor   # the load-balance loss, a 0-d fp32 tensor
    dropped: torch.Tensor    # the dropped (token, choice) share, 0-d fp32


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def switch_moe(tokens: torch.Tensor,       # [B, D], this rank's rows
               router_w: torch.Tensor,     # [D, E] replicated
               expert_w1: torch.Tensor,    # [E/n, D, F]: this rank's
               expert_w2: torch.Tensor,    # [E/n, F, D]: experts
               mesh=None,
               capacity_factor: float = 1.25,
               top_k: int = 1) -> MoEOut:
    """Top-k MoE over this rank's ``tokens`` (k = 1: switch; k >= 2:
    GShard with renormalised gates and first-choice capacity priority).
    With ``mesh`` (a ``core.mesh.Mesh`` whose shard axis divides E) the
    experts split over 'shard', each rank passes its own E/n of them, and
    tokens dispatch through ``all_to_all``; otherwise the dense path
    over all E (see the module doc)."""
    with collectives.mesh_scope(mesh, collectives.batch_on_repl()):
        return _switch_moe(tokens, router_w, expert_w1, expert_w2, mesh,
                           capacity_factor, int(top_k))


def _switch_moe(tokens, router_w, expert_w1, expert_w2, mesh,
                capacity_factor, k):
    B, D = tokens.shape
    E = router_w.shape[1]
    if not 1 <= k <= E:
        raise ValueError(f"top_k={k} must be in [1, {E}]")
    logits = tokens.float() @ router_w.float()              # [B, E]
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = top_k_stable(probs, k)             # [B, k]
    gates = top_probs if k == 1 \
        else top_probs / top_probs.sum(dim=-1, keepdim=True)

    # the load-balance loss over the global batch
    world = mesh.world.size if mesh is not None and mesh.world is not None \
        else 1
    n_tokens = B * world
    with torch.no_grad():
        counts = _one_hot(top_idx, E, torch.float32).sum(dim=(0, 1))
    density = collectives.global_sum(counts) / (n_tokens * k)
    mean_prob = collectives.global_sum(probs.sum(dim=0)) / n_tokens
    aux_loss = E * torch.sum(density * mean_prob)

    n = mesh.shard if mesh is not None else 1
    if n == 1 or E % n != 0:
        if n > 1 and (E, n) not in _WARNED:
            _WARNED.add((E, n))
            # mirrors the engine's param_specs fallback: an indivisible
            # expert count runs the replicated dense path
            parallax_log.warning(
                "switch_moe: %d experts not divisible by shard axis %d; "
                "running the replicated (non-EP) path", E, n)
        out = _expert_compute_dense(tokens, top_idx, gates, expert_w1,
                                    expert_w2)
        return MoEOut(out, aux_loss,
                      torch.zeros((), dtype=torch.float32,
                                  device=tokens.device))
    e_per = E // n
    if expert_w1.shape[0] != e_per or expert_w2.shape[0] != e_per:
        raise ValueError(
            f"switch_moe: expert weights of {expert_w1.shape[0]} and "
            f"{expert_w2.shape[0]} experts; a rank of a {n}-way shard "
            f"axis holds {e_per} of {E}")
    capacity = max(1, int(math.ceil(capacity_factor * k * B / E)))
    dt = tokens.dtype
    # flatten the choices with every first choice ahead in the cumulative
    # count, so first choices win capacity over second ones
    idx_f = top_idx.t().reshape(-1)                         # [k B]
    onehot = _one_hot(idx_f, E, torch.int32)                # [k B, E]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1
    pos_in_expert = pos.max(dim=1).values                   # [k B]
    keep = pos_in_expert < capacity
    safe_pos = torch.where(keep, pos_in_expert, 0).long()
    toks_f = tokens.repeat(k, 1)                            # [k B, D]
    disp = torch.zeros((E, capacity, D), dtype=dt, device=tokens.device)
    # a dropped pair adds zeros into slot 0 (an overwrite would clobber)
    disp = disp.index_put((idx_f, safe_pos),
                          torch.where(keep[:, None], toks_f, 0),
                          accumulate=True)
    # [E, C, D] as [n, e_per, C, D] (dim 0: the owner shard); after the
    # exchange chunk j holds member j's tokens for this rank's experts
    group = mesh.shard_group
    recv = collectives.all_to_all(disp.reshape(n, e_per, capacity, D),
                                  group)
    x_e = recv.transpose(0, 1).reshape(e_per, n * capacity, D)
    h = torch.relu(torch.bmm(x_e, expert_w1.to(dt)))
    y_e = torch.bmm(h, expert_w2.to(dt))
    back = y_e.reshape(e_per, n, capacity, D).transpose(0, 1)
    # chunk j: this rank's tokens' outputs from member j's experts
    out = collectives.all_to_all(back, group).reshape(E, capacity, D)
    got = torch.where(keep[:, None], out[idx_f, safe_pos], 0)
    gate_f = gates.t().reshape(-1)                          # [k B]
    combined = (got * gate_f[:, None].to(got.dtype)).reshape(k, B, D) \
        .sum(dim=0)
    drop_ct = (~keep).sum().to(torch.float32)
    dropped = collectives.global_sum(drop_ct.detach()) \
        / (k * n_tokens)
    return MoEOut(combined, aux_loss, dropped)


def _expert_compute_dense(tokens, top_idx, gates, w1, w2):
    """Every expert on every token, the gates selecting (the unsharded
    reference path; no capacity bound, so nothing drops)."""
    dt = tokens.dtype
    E = w1.shape[0]
    h = torch.relu(torch.einsum("bd,edf->bef", tokens, w1.to(dt)))
    out_all = torch.einsum("bef,efd->bed", h, w2.to(dt))
    sel = torch.zeros((tokens.shape[0], E), dtype=dt, device=tokens.device)
    for c in range(top_idx.shape[1]):
        sel = sel + _one_hot(top_idx[:, c], E, dt) * gates[:, c:c + 1].to(dt)
    return torch.einsum("bed,be->bd", out_all, sel)


__all__ = ["MoEOut", "switch_moe"]
