"""Megatron tensor parallelism over the mesh's 'shard' axis (the port of
``parallax_tpu/ops/tensor_parallel.py``).

Column-parallel kernels split their output features over 'shard', row-
parallel kernels their input features; each rank holds its part
(``attention_param_specs`` / ``mlp_param_specs`` declare them, and the
engine stores each as that rank's local shard, never gathered for use).
The JAX package pins activation shardings and leaves the collectives to
GSPMD; here they are written out as Megatron's operators over the mesh's
shard group (ops/collectives.py):

* f, before a column-parallel product: identity forward, all-reduce of
  the input's gradient backward (each rank's columns contribute a part);
* g, after a row-parallel product: all-reduce forward, identity backward.

So a block's forward is two all-reduces (after the attention's output
projection and after the MLP's down projection), and nothing crosses
ranks around the attention core: each rank runs its H/p heads.

Sequence parallelism (``sequence_parallel=True``, the TP x SP
composition): between blocks each rank holds T/p of the sequence
(``[B, T/p, D]``); a block's entry all-gathers the sequence (backward:
reduce-scatter of the gradient) in place of f, and its exit
reduce-scatters over the sequence (backward: all-gather) in place of g.
The JAX model pins the resting sharding after every block with
``seq_shard``; here the layout is physical, so a model splits its
activations once before the first block (``seq_shard``) and gathers
them once after the last (``seq_gather``), and a replicated parameter
applied to the sequence-sharded rows (a LayerNorm between blocks) gets a
partial gradient on each rank, which ``sequence_parallel_params`` sums
over the shard group (Megatron-SP's shared-parameter rule).

The vocab-parallel head (``vocab_parallel_nll``): an output matrix
column-sharded over the vocabulary gives each rank its V/p logit
columns, and the cross-entropy reduces over the ranks' columns with
three all-reduces of [N] (the JAX model pins the fp32 logits
``P('repl', None, 'shard')`` and lets XLA insert them,
``parallax_tpu/models/long_context.py:369-376``).

Local layouts: a fused ``wqkv`` [D, 3D] column shard is ``[q_s | k_s |
v_s]``, the q, k and v columns of rank s's heads ([D, 3D/p]; JAX stores
3D/p contiguous columns and GSPMD moves them into head order; the engine
and ``weights.rank_shard`` translate). Where the shard axis does not
divide the head count, the projections stay column-parallel and the
attention core runs replicated: each rank all-gathers the q, k and v
features and takes its own input features of the merged heads back for
the output projection.

Every function is a numeric no-op without a mesh or with a shard axis of
1, so a model calls them unconditionally. The port's mesh has one
tensor-parallel axis, 'shard', so the JAX ``tp_axis`` and ``batch_axis``
arguments have no counterpart. ``count_collectives`` counts the port's
own collective calls during one call (JAX counts HLO ops).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from parallax_tpu_torch.core.mesh import AXIS_SHARD, TPSpec
from parallax_tpu_torch.ops import collectives


def _active_mesh(mesh):
    mesh = mesh if mesh is not None else collectives.current_mesh()
    return mesh if mesh is not None and mesh.shard > 1 else None


def _group(mesh):
    """(shard group, this rank's index in it)."""
    return mesh.shard_group, mesh.coords[1]


def heads_shardable(num_heads: int, mesh=None) -> bool:
    """True when the shard axis divides the head count, so each rank can
    run its H/p heads alone."""
    amesh = _active_mesh(mesh)
    return amesh is not None and num_heads % amesh.shard == 0


def _enter(x, mesh, sequence_parallel):
    """A column-parallel product's input, whole on every rank: f, or
    under sequence parallelism the all-gather of the sequence."""
    group, index = _group(mesh)
    if sequence_parallel:
        return collectives.gather_along(x, group, index, 1, grad_sums=True)
    return collectives.copy_to(x, group)


def _leave(y, mesh, sequence_parallel):
    """A row-parallel product's partial sums combined: g, or under
    sequence parallelism the reduce-scatter over the sequence."""
    group, _ = _group(mesh)
    if sequence_parallel:
        return collectives.reduce_scatter_along(y, group, 1)
    return collectives.reduce_from(y, group)


def column_parallel(x: torch.Tensor, w: torch.Tensor, *, mesh=None,
                    sequence_parallel: bool = False) -> torch.Tensor:
    """``x @ w`` with ``w`` this rank's column shard [D, F/p]: output
    features arrive split over 'shard'. f on the input (under sequence
    parallelism ``x`` is [B, T/p, D] and is all-gathered first)."""
    mesh = _active_mesh(mesh)
    if mesh is None:
        return x @ w
    return _enter(x, mesh, sequence_parallel) @ w


def row_parallel(x: torch.Tensor, w: torch.Tensor, *, mesh=None,
                 sequence_parallel: bool = False) -> torch.Tensor:
    """``x @ w`` with ``x`` feature-split and ``w`` this rank's row shard
    [F/p, D]: each rank contracts its features and g sums them (under
    sequence parallelism a reduce-scatter over the sequence, [B, T/p,
    D])."""
    mesh = _active_mesh(mesh)
    y = x @ w
    if mesh is None:
        return y
    return _leave(y, mesh, sequence_parallel)


def _attention_core(q, k, v, num_heads, causal, kv_mask):
    """The models' scaled dot-product formula on [B, T, h*hd] (fp32
    scores divided by sqrt(hd) after the dot, -1e9 where masked, the
    softmax cast back to the compute dtype before PV)."""
    B, Tq, F = q.shape
    Tk = k.shape[1]
    hd = F // num_heads

    def heads(z, T):
        return z.reshape(B, T, num_heads, hd).transpose(1, 2)

    qh, kh, vh = heads(q, Tq), heads(k, Tk), heads(v, Tk)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    mask = None
    if kv_mask is not None:
        mask = kv_mask[:, None, None, :]
    if causal:
        tri = torch.ones((Tq, Tk), dtype=torch.bool,
                         device=q.device).tril()[None, None]
        mask = tri if mask is None else (mask & tri)
    if mask is not None:
        scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(qh.dtype)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(B, Tq, F)


def tp_attention(x_q: torch.Tensor, x_kv: torch.Tensor,
                 w: Dict[str, torch.Tensor], num_heads: int, *,
                 causal: bool = False,
                 kv_mask: Optional[torch.Tensor] = None,
                 dtype: Optional[torch.dtype] = None, mesh=None,
                 sequence_parallel: bool = False,
                 core=None) -> torch.Tensor:
    """Head-split multi-head attention, [B, Tq, D] -> [B, Tq, D] (under
    sequence parallelism [B, T/p, D] in and out).

    ``w`` holds a fused ``wqkv`` or separate ``wq``/``wk``/``wv`` (a
    cross-attention passes ``x_kv`` other than ``x_q``), each this
    rank's column shard, and ``wo``, its row shard. ``kv_mask`` [B, Tk]
    is whole on every rank. ``core(q, k, v, num_heads, causal,
    kv_mask)`` replaces the models' formula (``_attention_core``) on
    the [B, T, h*hd] projections, for a model whose attention rounds
    otherwise."""
    core = _attention_core if core is None else core
    cast = (lambda a: a.to(dtype)) if dtype is not None else (lambda a: a)
    mesh = _active_mesh(mesh)
    if mesh is None:
        if "wqkv" in w:
            q, k, v = torch.chunk(x_q @ cast(w["wqkv"]), 3, dim=-1)
        else:
            q, k, v = (x_q @ cast(w["wq"]), x_kv @ cast(w["wk"]),
                       x_kv @ cast(w["wv"]))
        merged = core(q, k, v, num_heads, causal, kv_mask)
        return merged @ cast(w["wo"])
    group, index = _group(mesh)
    xq = _enter(x_q, mesh, sequence_parallel)
    xkv = xq if x_kv is x_q else _enter(x_kv, mesh, sequence_parallel)
    if "wqkv" in w:
        q, k, v = torch.chunk(xq @ cast(w["wqkv"]), 3, dim=-1)
    else:
        q, k, v = xq @ cast(w["wq"]), xkv @ cast(w["wk"]), \
            xkv @ cast(w["wv"])
    if heads_shardable(num_heads, mesh):
        merged = core(q, k, v, num_heads // mesh.shard, causal, kv_mask)
    else:
        # the replicated core: every rank gathers the heads' features,
        # runs every head and takes back its own input features of wo
        q, k, v = (collectives.gather_along(z, group, index, -1)
                   for z in (q, k, v))
        merged = collectives.split_along(
            core(q, k, v, num_heads, causal, kv_mask), group, index, -1)
    return _leave(merged @ cast(w["wo"]), mesh, sequence_parallel)


def tp_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
           act=torch.relu, dtype: Optional[torch.dtype] = None, mesh=None,
           sequence_parallel: bool = False) -> torch.Tensor:
    """Column-parallel up projection [D, M/p], the activation on the
    local features, row-parallel down projection [M/p, D]."""
    cast = (lambda a: a.to(dtype)) if dtype is not None else (lambda a: a)
    h = act(column_parallel(x, cast(w1), mesh=mesh,
                            sequence_parallel=sequence_parallel))
    return row_parallel(h, cast(w2), mesh=mesh,
                        sequence_parallel=sequence_parallel)


class _VocabParallelNLL(torch.autograd.Function):
    """Megatron's parallel cross-entropy over a rank's logit columns."""

    @staticmethod
    def forward(ctx, logits, labels, group, index):
        N, Vp = logits.shape
        m = logits.detach().amax(dim=-1)
        collectives.all_reduce_(m, group, torch.distributed.ReduceOp.MAX)
        sumexp = torch.exp(logits - m[:, None]).sum(dim=-1)
        collectives.all_reduce_(sumexp, group)
        lse = m + torch.log(sumexp)
        local = labels - index * Vp
        mine = (local >= 0) & (local < Vp)
        rows = torch.arange(N, device=logits.device)
        target = torch.where(mine, logits[rows, local.clamp(0, Vp - 1)],
                             torch.zeros((), dtype=logits.dtype,
                                         device=logits.device))
        collectives.all_reduce_(target, group)
        ctx.save_for_backward(logits, lse, local, mine)
        return lse - target

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, mine = ctx.saved_tensors
        grad = torch.exp(logits - lse[:, None])
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, local.clamp(0, grad.shape[1] - 1)] -= mine.to(grad.dtype)
        return grad * g[:, None], None, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, *,
                       mesh=None) -> torch.Tensor:
    """Per-row cross-entropy ``-log softmax(logits)[label]`` [N] where
    each rank holds its V/p columns of the [N, V] logits (a column-
    parallel product with a vocab-sharded output matrix, the vocab-
    parallel head): the row max all-reduced with MAX, the sum of
    exponentials all-reduced, the target logit taken from the rank that
    owns its column and all-reduced; the backward is softmax less the
    one-hot on the local columns. The whole [N, V] logits never exist on
    one rank. Without a mesh, or on a shard axis of 1, the plain
    cross-entropy of the whole logits."""
    labels = labels.long()
    mesh = _active_mesh(mesh)
    if mesh is None:
        return -torch.log_softmax(logits, dim=-1).gather(
            1, labels[:, None])[:, 0]
    group, index = _group(mesh)
    return _VocabParallelNLL.apply(logits, labels, group, index)


def seq_shard(x: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """This rank's T/p of a [B, T, ...] activation that every rank of the
    shard group holds whole (the entry of the sequence-parallel region;
    the gradient is all-gathered)."""
    mesh = _active_mesh(mesh)
    if mesh is None:
        return x
    group, index = _group(mesh)
    return collectives.split_along(x, group, index, 1)


def seq_gather(x: torch.Tensor, *, mesh=None) -> torch.Tensor:
    """The whole [B, T, ...] from each rank's [B, T/p, ...] (the exit of
    the sequence-parallel region, for the layers after it, which every
    rank runs alike; the gradient is this rank's chunk)."""
    mesh = _active_mesh(mesh)
    if mesh is None:
        return x
    group, index = _group(mesh)
    return collectives.gather_along(x, group, index, 1)


def sequence_parallel_params(tree, *, mesh=None):
    """``tree`` (a dict of replicated parameters applied to sequence-
    sharded rows) as it is, each leaf's gradient summed over the shard
    group: each rank saw T/p of the rows."""
    mesh = _active_mesh(mesh)
    if mesh is None:
        return tree
    group, _ = _group(mesh)
    return {k: collectives.copy_to(v, group) for k, v in tree.items()}


# -------------------------------------------------------------------------
# param_specs helpers: the specs a Model declares so the engine's plan
# (core/engine.py:build_plan) stores each rank's part of a TP weight.
# -------------------------------------------------------------------------


def attention_param_specs(prefix: str,
                          fused_qkv: bool = True) -> Dict[str, TPSpec]:
    """Specs for one attention's weights under ``prefix`` (an fnmatch
    pattern, e.g. "blocks/*" or "enc/*/attn")."""
    col = TPSpec(None, AXIS_SHARD)
    row = TPSpec(AXIS_SHARD, None)
    if fused_qkv:
        return {f"{prefix}/wqkv": TPSpec(None, AXIS_SHARD, groups=3),
                f"{prefix}/wo": row}
    return {f"{prefix}/wq": col, f"{prefix}/wk": col,
            f"{prefix}/wv": col, f"{prefix}/wo": row}


def mlp_param_specs(prefix: str) -> Dict[str, TPSpec]:
    return {f"{prefix}/w1": TPSpec(None, AXIS_SHARD),
            f"{prefix}/w2": TPSpec(AXIS_SHARD, None)}


def count_collectives(fn, *args) -> Dict[str, int]:
    """The port's collective calls (groups of one rank make none) while
    ``fn(*args)`` runs once, by kind, with the JAX function's keys: the
    hook that pins the Megatron pattern (two all-reduces a block
    forward; under sequence parallelism reduce-scatters and all-gathers
    and no all-reduce; a ring's rotations as ``collective_permute``). A
    backward inside ``fn`` counts too."""
    with collectives.count_scope() as counts:
        fn(*args)
    return {"all_to_all": 0, **counts}
