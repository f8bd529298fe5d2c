"""Sampled softmax over a large vocabulary (``parallax_tpu.ops.
sampled_softmax``).

The reference LM1B model trains a 793k-word softmax with TF's sampled
softmax and a log-uniform (Zipfian) candidate sampler (reference:
examples/lm1b/language_model.py:33-45, :60-75). The softmax weight and
bias are touched only through ``embedding_lookup`` gathers (labels +
sampled candidates), so the classifier routes them to the sparse path.

Same numerics as the JAX package: one fused gather for labels and
candidates; the logit products take ``matmul_dtype`` operands (bf16 by
default, even when the caller's compute is fp32) with fp32 accumulation;
the log-expected-count correction, the accidental-hit mask (-1e9),
logsumexp and the loss stay fp32. The candidates come from an explicit
``torch.Generator`` and cannot reproduce JAX's threefry stream, so the
parity tests hand the JAX-drawn ids in.

On a mesh where the tables are row-sharded, every rank draws the same S
candidates. The JAX lookup takes the global ``[labels | candidates]``
vector split over every device, so each candidate crosses the wire once
over the mesh. Here each rank looks up its labels with its own S/n of
the candidates (n the mesh's rank count; rank i takes slice i), and
the candidates' rows and biases then reach every rank through one
all-gather over the world. Its backward reduce-scatters their
gradients, so each candidate's summed gradient enters the lookup's
backward once, on one rank, and reaches its row's owner from there.
Where S does not split over the ranks, each takes ceil(S/n) and the
last slices are padded with id -1, as GSPMD pads an uneven split: no
shard owns it, so its row is zero, its rows are cut off after the
gather, and no slice update touches it. The lookups then ship n
ceil(S/n) candidate ids where JAX's record counts n floor((N + S)/n) - N
(N the global labels): n more.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops


def log_uniform_candidates(gen: torch.Generator, num_samples: int,
                           vocab_size: int,
                           device: Optional[torch.device] = None
                           ) -> torch.Tensor:
    """Sample ids from the log-uniform (Zipf) distribution
    P(k) = log((k+2)/(k+1)) / log(V+1), matching TF's
    LogUniformCandidateSampler, by inverse CDF:
    k = floor(exp(u * log(V+1))) - 1. Drawn on ``device`` (default:
    ``gen``'s), as int64."""
    u = torch.rand((num_samples,), generator=gen,
                   device=device if device is not None else gen.device)
    k = torch.exp(u * math.log(float(vocab_size + 1))) - 1.0
    return k.to(torch.int32).clamp(0, vocab_size - 1).long()


def log_uniform_prob(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    ids_f = ids.to(torch.float32)
    return (torch.log((ids_f + 2.0) / (ids_f + 1.0))
            / math.log(float(vocab_size + 1)))


def _operand(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (None: its own precision), then widened
    to fp32. A product of two bf16 values is exact in fp32, so an fp32
    product of such operands is the bf16-operand product with fp32
    accumulation — with no bf16 rounding of the result, which a bf16
    ``torch.matmul`` would add."""
    return (x if dtype is None else x.to(dtype)).float()


def _matmul_f32(a: torch.Tensor, bt: torch.Tensor,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``a @ bt.T`` with both operands rounded to ``dtype`` and fp32
    accumulation."""
    return torch.matmul(_operand(a, dtype), _operand(bt, dtype).t())


def _lookup_split(softmax_w, softmax_b, labels, samples):
    """(rows, biases) of ``[labels | samples]``: one lookup of each table,
    the candidates split over the mesh where the tables are row shards
    (see the module doc)."""
    mesh = collectives.current_mesh()
    S = samples.shape[0]
    if (mesh is None or not emb_ops.is_row_shard(softmax_w)
            or collectives.batch_on_repl()):
        ids_all = torch.cat([labels, samples])
        return (emb_ops.embedding_lookup(softmax_w, ids_all),
                emb_ops.embedding_lookup(softmax_b, ids_all))
    n, k = labels.shape[0], -(-S // mesh.size)
    if S % mesh.size:
        samples = torch.cat([samples, samples.new_full(
            (k * mesh.size - S,), -1)])
    ids_all = torch.cat([labels, samples[mesh.rank * k:
                                         (mesh.rank + 1) * k]])
    rows = emb_ops.embedding_lookup(softmax_w, ids_all)
    bias = emb_ops.embedding_lookup(softmax_b, ids_all)
    mine = torch.cat([rows[n:], bias[n:].to(rows.dtype)], dim=1)
    if mine.device.type == "meta":
        both = mine.new_empty((S, mine.shape[1]))
    else:
        both = collectives.gather_along(mine, mesh.world, mesh.rank, 0,
                                        grad_sums=True)[:S]
    D = rows.shape[1]
    return (torch.cat([rows[:n], both[:, :D]]),
            torch.cat([bias[:n], both[:, D:].to(bias.dtype)]))


def sampled_softmax_loss(
    softmax_w: torch.Tensor,       # [V_padded, D]
    softmax_b: torch.Tensor,       # [V_padded, 1]
    hidden: torch.Tensor,          # [N, D]
    labels: torch.Tensor,          # [N] int
    gen: torch.Generator,
    num_samples: int,
    vocab_size: int,
    remove_accidental_hits: bool = True,
    matmul_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> torch.Tensor:
    """Per-example sampled-softmax cross-entropy, [N]."""
    # the sparse path's profiler scope (obs/xprof.py joins kernels to it)
    with torch.profiler.record_function("sampled_softmax.py"):
        return _sampled_softmax_loss(softmax_w, softmax_b, hidden, labels,
                                     gen, num_samples, vocab_size,
                                     remove_accidental_hits, matmul_dtype)


def _sampled_softmax_loss(softmax_w, softmax_b, hidden, labels, gen,
                          num_samples, vocab_size, remove_accidental_hits,
                          matmul_dtype):
    n = hidden.shape[0]
    samples = log_uniform_candidates(gen, num_samples, vocab_size,
                                     device=labels.device)
    labels = labels.long()
    rows, bias = _lookup_split(softmax_w, softmax_b, labels, samples)
    bias = bias[:, 0].float()
    w_true, w_samp = rows[:n], rows[n:]
    b_true, b_samp = bias[:n], bias[n:]

    # subtract log(expected count) so the sampled logits are an unbiased
    # estimate of the full softmax
    log_s = math.log(float(num_samples))
    logq_true = log_s + torch.log(log_uniform_prob(labels, vocab_size))
    logq_samp = log_s + torch.log(log_uniform_prob(samples, vocab_size))

    dot_true = (_operand(hidden, matmul_dtype)
                * _operand(w_true, matmul_dtype)).sum(dim=1)
    logits_true = dot_true + b_true - logq_true                    # [N]
    logits_samp = (_matmul_f32(hidden, w_samp, matmul_dtype)
                   + b_samp[None, :] - logq_samp[None, :])         # [N, S]
    if remove_accidental_hits:
        hit = samples[None, :] == labels[:, None]                  # [N, S]
        logits_samp = torch.where(hit, torch.full_like(logits_samp, -1e9),
                                  logits_samp)
    logits = torch.cat([logits_true[:, None], logits_samp], dim=1)
    # the true class is column 0
    return torch.logsumexp(logits, dim=1) - logits[:, 0]


def full_softmax_loss(softmax_w: torch.Tensor, softmax_b: torch.Tensor,
                      hidden: torch.Tensor, labels: torch.Tensor,
                      vocab_size: Optional[int] = None,
                      matmul_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """Full-vocabulary softmax loss (the eval path). ``softmax_b`` is the
    [V, 1] column of the train path. The default computes exact fp32
    logits; ``matmul_dtype=torch.bfloat16`` opts into bf16 operands with
    fp32 accumulation."""
    logits = (_matmul_f32(hidden, softmax_w, matmul_dtype)
              + softmax_b[:, 0].float()[None, :])
    if vocab_size is not None:
        logits = emb_ops.mask_padded_logits(logits, vocab_size)
    lse = torch.logsumexp(logits, dim=1)
    true_logit = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return lse - true_logit
