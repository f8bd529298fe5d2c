"""LM1B language model, the flagship sparse/hybrid training workload
(``parallax_tpu/models/lm1b.py``, training half).

Re-expression of the reference's LM1B example (reference:
examples/lm1b/language_model.py and language_model_graph.py): one LSTM
layer with projection over a 793,470-word vocabulary and a log-uniform
sampled softmax (8192 candidates). The embedding, softmax weight and
softmax bias are gather-only tables, so the classifier routes all three
to the sparse path; the LSTM stack is dense.

Kept from the JAX model: the fused [E+P, 4H] gate matrix with gate
order i|f|g|o and forget bias +1; the weights cast to the compute dtype
before the scan; ``hidden`` cast to fp32 before the softmax; fp32
parameters and tables; the slices-mode grouping (the global-norm clip
and Adagrad see only the LSTM group, the tables take scatter-only
``SliceAdagrad``, language_model_graph.py:42-58). Dropout masks come
from the step's ``torch.Generator``.

``lstm_impl``: ``"kernel"`` runs the recurrence in the CUDA kernels of
ops/lstm.py (fp32 carries; the JAX ``"pallas"``); ``"scan"`` is this
model's own plain cell loop with compute-dtype carries (the JAX
``"xla"``). In fp32 the two compute the same function.

In dense mode ``max_touched_rows`` gives the tables ``emb`` and
``softmax_w`` the scatter-style ``row_sparse_adagrad`` after the clip
(reference lm1b.py:229-245). The LSTM weights are pinned replicated
(``param_specs={"lstm/*": P()}``) in every plan, as in the JAX model.

Not ported: training the full-softmax model, and the serving adapter.

Batch contract (reference lm1b_distributed_driver.py:84-96): feeds "x"
[B, T] int32, "y" [B, T] int32, "w" [B, T] float weights; the "words"
metric is sum(w). On several ranks each feeds its share; the loss
divides by sum(w) over the global batch and "words" is the global sum
(``ops.collectives.global_sum``), as the JAX loss over the global array.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.core import optim
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.core.mesh import replicated_spec
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops
from parallax_tpu_torch.ops import lstm as lstm_ops
from parallax_tpu_torch.ops import sampled_softmax as ss_ops
from parallax_tpu_torch.ops.sparse_optim import (SliceAdagrad,
                                                  row_sparse_adagrad)

LSTM_IMPLS = ("scan", "kernel")


@dataclasses.dataclass
class LM1BConfig:
    vocab_size: int = 793470          # reference lm1b vocabulary
    emb_dim: int = 512
    hidden_dim: int = 2048
    proj_dim: int = 512
    num_samples: int = 8192
    keep_prob: float = 0.9            # reference language_model.py dropout
    max_grad_norm: float = 10.0
    learning_rate: float = 0.2
    num_partitions: Optional[int] = None  # vocab padding multiple (None: 1)
    compute_dtype: torch.dtype = torch.bfloat16
    table_dtype: torch.dtype = torch.float32
    # dense mode: Adagrad of emb and softmax_w over at most this many
    # touched rows a step (row_sparse_adagrad); None: dense Adagrad
    max_touched_rows: Optional[int] = None
    # "slices": table grads stay (ids, rows) pairs and take SliceAdagrad,
    # outside the clip; needs Config(sparse_grad_mode="slices").
    # "dense": every grad dense, the clip covers every variable.
    sparse_grad_mode: str = "dense"
    lstm_impl: str = "scan"

    def __post_init__(self):
        if self.lstm_impl not in LSTM_IMPLS:
            raise ValueError(f"unknown lstm_impl {self.lstm_impl!r}; "
                             f"expected one of {LSTM_IMPLS}")
        if self.sparse_grad_mode not in ("dense", "slices"):
            raise ValueError(f"sparse_grad_mode must be 'dense' or "
                             f"'slices', got {self.sparse_grad_mode!r}")

    @property
    def padded_vocab(self) -> int:
        return emb_ops.padded_vocab_for(self.vocab_size,
                                        self.num_partitions)


def tiny_config(**kw) -> LM1BConfig:
    """Small config for tests and dry runs."""
    defaults = dict(vocab_size=1000, emb_dim=32, hidden_dim=64,
                    proj_dim=32, num_samples=64, keep_prob=1.0,
                    learning_rate=0.1)
    defaults.update(kw)
    return LM1BConfig(**defaults)


def init_params(cfg: LM1BConfig, gen: torch.Generator, device="cuda"):
    """Uniform initial parameters from ``gen``, drawn in the JAX
    package's order: emb, lstm/w, lstm/w_proj, softmax_w; zero biases.
    ``device="meta"`` gives the shapes alone."""
    dev = device if str(device) == "meta" else resolve_device(device)
    V, E, H, P = cfg.padded_vocab, cfg.emb_dim, cfg.hidden_dim, cfg.proj_dim

    def u(shape, s):
        return torch.empty(shape, dtype=torch.float32, device=dev).uniform_(
            -s, s, generator=gen)

    td = cfg.table_dtype
    emb = u((V, E), 1.0 / math.sqrt(E)).to(td)
    w = u((E + P, 4 * H), 1.0 / math.sqrt(E + P))
    w_proj = u((H, P), 1.0 / math.sqrt(H))
    softmax_w = u((V, P), 1.0 / math.sqrt(P)).to(td)
    return {
        "emb": emb,
        "lstm": {"w": w,
                 "b": torch.zeros((4 * H,), dtype=torch.float32, device=dev),
                 "w_proj": w_proj},
        "softmax_w": softmax_w,
        "softmax_b": torch.zeros((V, 1), dtype=td, device=dev),
    }


def cell_scan(cfg: LM1BConfig, w, b, w_proj, x_seq):
    """This model's own plain scan: x_seq [T, B, E] -> [T, B, P], with
    (c, h) carried at the compute dtype."""
    T, B, _ = x_seq.shape
    H, P = cfg.hidden_dim, cfg.proj_dim
    c = torch.zeros((B, H), dtype=x_seq.dtype, device=x_seq.device)
    h = torch.zeros((B, P), dtype=x_seq.dtype, device=x_seq.device)
    hs = []
    for t in range(T):
        gates = torch.cat([x_seq[t], h], dim=-1) @ w + b
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)) @ w_proj
        hs.append(h)
    return torch.stack(hs)


def _dropout(x, keep_prob, gen):
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(mask, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def build_model(cfg: LM1BConfig, full_softmax: bool = False) -> Model:
    if full_softmax:
        raise NotImplementedError(
            "training the full-softmax LM1B baseline is not ported; "
            "ops.sampled_softmax.full_softmax_loss is")
    cdt = cfg.compute_dtype
    P = cfg.proj_dim

    def init_fn(gen, device):
        return init_params(cfg, gen, device)

    def lstm_scan(lstm, x_seq):
        w, b, w_proj = (lstm[k].to(cdt) for k in ("w", "b", "w_proj"))
        if cfg.lstm_impl == "kernel":
            return lstm_ops.lstm_scan(x_seq.to(cdt), w, b, w_proj,
                                      impl="kernel")
        return cell_scan(cfg, w, b, w_proj, x_seq)

    def loss_fn(params, batch, gen):
        x, y = batch["x"], batch["y"]
        w = batch.get("w")
        if w is None:
            w = torch.ones(x.shape, dtype=torch.float32, device=x.device)
        B, T = x.shape
        emb = emb_ops.embedding_lookup(params["emb"], x).to(cdt)  # [B, T, E]
        if cfg.keep_prob < 1.0:
            emb = _dropout(emb, cfg.keep_prob, gen)
        hs = lstm_scan(params["lstm"], emb.transpose(0, 1))      # [T, B, P]
        if cfg.keep_prob < 1.0:
            # LSTM-output dropout, independent per (t, b) position
            hs = _dropout(hs, cfg.keep_prob, gen)
        hidden = hs.transpose(0, 1).reshape(B * T, P).float()
        losses = ss_ops.sampled_softmax_loss(
            params["softmax_w"], params["softmax_b"], hidden,
            y.reshape(B * T), gen, cfg.num_samples, cfg.vocab_size)
        wf = w.reshape(B * T).float()
        words = collectives.global_sum(wf.sum())
        total_w = torch.clamp(words, min=1e-8)
        return collectives.global_sum((losses * wf).sum()) / total_w, \
            {"words": words}

    pinned = {"lstm/*": replicated_spec()}
    adagrad = optim.adagrad(cfg.learning_rate, initial_accumulator_value=1.0)
    if cfg.sparse_grad_mode == "slices":
        tx = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm),
                         adagrad)
        sl = SliceAdagrad(cfg.learning_rate, initial_accumulator_value=1.0)
        return Model(init_fn, loss_fn, optimizer=tx, param_specs=pinned,
                     slice_updaters={"emb": sl, "softmax_w": sl,
                                     "softmax_b": sl})
    if cfg.max_touched_rows:
        # the clip sees the whole gradients, then the tables take the
        # touched-rows path: dense Adagrad's trajectory
        tables = {"emb": "table", "softmax_w": "table"}
        adagrad = optim.multi_transform(
            {"table": row_sparse_adagrad(cfg.learning_rate,
                                         cfg.max_touched_rows,
                                         initial_accumulator_value=1.0),
             "rest": adagrad},
            param_labels=lambda params: {k: tables.get(k, "rest")
                                         for k in params})
    tx = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm), adagrad)
    return Model(init_fn, loss_fn, optimizer=tx, param_specs=pinned)


def make_batch(rng: np.random.Generator, batch_size: int, num_steps: int,
               vocab_size: int):
    """Synthetic Zipf-ish batch with the reference driver's feed keys."""
    x = (rng.zipf(1.3, size=(batch_size, num_steps)) - 1) % vocab_size
    y = np.roll(x, -1, axis=1)
    return {"x": x.astype(np.int32), "y": y.astype(np.int32),
            "w": np.ones((batch_size, num_steps), np.float32)}
