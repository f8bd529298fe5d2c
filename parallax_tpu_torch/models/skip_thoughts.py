"""Skip-thoughts: a GRU sentence encoder with previous- and next-sentence
GRU decoders (``parallax_tpu/models/skip_thoughts.py``; Kiros et al.
2015, uni-skip).

Same configuration fields, parameter tree (``emb``, ``encoder``,
``dec_prev`` and ``dec_next`` with their ``h0_proj``, ``out_w``,
``out_b``; fp32 leaves, ``[in, out]`` weights applied as ``x @ w`` after
a cast to ``compute_dtype``) and math as the JAX model:

* each GRU's gates come from one fused ``[in + H, 3H]`` weight in the
  order z | r | n; the reset gate multiplies only the h-side candidate
  term, ``n = tanh(x wx_n + b_n + r * (h wh_n))``, and ``h = (1 - z) n +
  z h``. The recurrence is plain torch ops, a loop over T (inside the
  step's CUDA graph on the card); the x-side products of all T steps are
  one matrix product ahead of the loop. No TPU kernel lies here: JAX
  runs ``lax.scan``.
* the encoder's last state is the thought vector; each decoder starts
  from ``tanh(thought @ h0_proj)`` and reconstructs its sentence teacher
  forced (inputs shifted right by one, a 0 first), through the shared
  embedding and the shared fp32 output projection, with the padded
  vocabulary masked out; the weights are ``prev > 0`` and ``next > 0``.
* the loss is the weighted NLL of both decoders over their total weight
  (``collectives.global_sum`` over the ranks, as the JAX loss over the
  global array); ``words`` is that weight.

``emb`` is read through ``ops.embedding.embedding_lookup`` alone, so the
classifier finds it sparse, as in JAX. The optimizer is ``chain(
clip_by_global_norm(5), adam(8e-4))``.
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
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops


@dataclasses.dataclass
class SkipThoughtsConfig:
    vocab_size: int = 20000
    emb_dim: int = 620
    hidden_dim: int = 2400
    learning_rate: float = 8e-4
    max_grad_norm: float = 5.0
    num_partitions: Optional[int] = None  # vocab padding multiple (None: 1)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        return emb_ops.padded_vocab_for(self.vocab_size,
                                        self.num_partitions)


def tiny_config(**kw) -> SkipThoughtsConfig:
    defaults = dict(vocab_size=500, emb_dim=16, hidden_dim=32)
    defaults.update(kw)
    return SkipThoughtsConfig(**defaults)


def _gru_params(gen, in_dim: int, hidden: int, device,
                with_h0_proj: bool = False):
    s = 1.0 / math.sqrt(in_dim + hidden)

    def u(shape):
        return torch.empty(shape, dtype=torch.float32, device=device) \
            .uniform_(-s, s, generator=gen)

    p = {"w": u((in_dim + hidden, 3 * hidden)),
         "b": torch.zeros((3 * hidden,), dtype=torch.float32,
                          device=device)}
    if with_h0_proj:
        # the decoders condition on the thought vector through a learned
        # projection into their initial state
        p["h0_proj"] = u((hidden, hidden))
    return p


def init_params(cfg: SkipThoughtsConfig, gen: torch.Generator,
                device="cuda"):
    """Uniform initial parameters from ``gen`` (on its device), in the
    JAX package's tree; the numbers differ from JAX's for a seed, so a
    JAX tree comes across through ``weights.skip_thoughts_params_from_
    jax``. ``device="meta"`` gives the shapes alone."""
    dev = device if str(device) == "meta" else resolve_device(device)
    V, E, H = cfg.padded_vocab, cfg.emb_dim, cfg.hidden_dim

    def u(shape, s):
        return torch.empty(shape, dtype=torch.float32, device=dev) \
            .uniform_(-s, s, generator=gen)

    return {
        "emb": u((V, E), 0.1),
        "encoder": _gru_params(gen, E, H, dev),
        "dec_prev": _gru_params(gen, E, H, dev, with_h0_proj=True),
        "dec_next": _gru_params(gen, E, H, dev, with_h0_proj=True),
        "out_w": u((H, V), 0.01),
        "out_b": torch.zeros((V,), dtype=torch.float32, device=dev),
    }


def _gru_scan(p, x_seq, h0, dtype):
    """x_seq [T, B, E], h0 [B, H] -> the states [T, B, H], at ``dtype``."""
    w = p["w"].to(dtype)
    b = p["b"].to(dtype)
    T, B, E = x_seq.shape
    H = h0.shape[-1]
    wx, wh = w[:E], w[E:]
    # the x side of every step at once: [T, B, 3H]
    gates_x = (x_seq.reshape(T * B, E) @ wx + b).reshape(T, B, 3 * H)
    h = h0.to(dtype)
    hs = []
    for t in range(T):
        gx = gates_x[t]
        gh = h @ wh
        z = torch.sigmoid(gx[:, :H] + gh[:, :H])
        r = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gx[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs)


def build_model(cfg: SkipThoughtsConfig) -> Model:
    """The JAX ``build_model``: init, the two decoders' teacher-forced
    loss with a ``{"words": total weight}`` metric, and the optimizer."""
    H = cfg.hidden_dim
    dt = cfg.compute_dtype

    def init_fn(gen, device):
        return init_params(cfg, gen, device)

    def decode_loss(params, dec, thought, tokens, weights):
        """Teacher-forced reconstruction loss of one decoder: (sum of the
        weighted NLL, sum of the weights), this rank's."""
        B, T = tokens.shape
        h0 = torch.tanh(thought @ dec["h0_proj"].to(dt))
        inp = torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]],
                        dim=1)
        x = emb_ops.embedding_lookup(params["emb"], inp).to(dt)
        hs = _gru_scan(dec, x.transpose(0, 1), h0, dt)       # [T, B, H]
        hs = hs.transpose(0, 1).reshape(B * T, H).float()
        logits = hs @ params["out_w"] + params["out_b"]
        logits = emb_ops.mask_padded_logits(logits, cfg.vocab_size)
        nll = -torch.log_softmax(logits, dim=-1).gather(
            1, tokens.reshape(B * T, 1))[:, 0]
        wf = weights.reshape(B * T)
        return (nll * wf).sum(), wf.sum()

    def loss_fn(params, batch):
        cur = batch["current"].long()
        B, _ = cur.shape
        x = emb_ops.embedding_lookup(params["emb"], cur).to(dt)
        h0 = torch.zeros((B, H), dtype=dt, device=cur.device)
        thought = _gru_scan(params["encoder"], x.transpose(0, 1), h0,
                            dt)[-1]                           # [B, H]
        prev, nxt = batch["prev"].long(), batch["next"].long()
        l_prev, n_prev = decode_loss(params, params["dec_prev"], thought,
                                     prev, (prev > 0).float())
        l_next, n_next = decode_loss(params, params["dec_next"], thought,
                                     nxt, (nxt > 0).float())
        words = collectives.global_sum(n_prev + n_next)
        loss = collectives.global_sum(l_prev + l_next) \
            / torch.clamp(words, min=1e-8)
        return loss, {"words": words}

    tx = optim.chain(optim.clip_by_global_norm(cfg.max_grad_norm),
                     optim.adam(cfg.learning_rate))
    return Model(init_fn, loss_fn, optimizer=tx)


def make_batch(rng: np.random.Generator, batch_size: int, seq_len: int,
               vocab_size: int):
    def sent():
        return rng.integers(1, vocab_size,
                            (batch_size, seq_len)).astype(np.int32)
    return {"prev": sent(), "current": sent(), "next": sent()}


__all__ = ["SkipThoughtsConfig", "tiny_config", "init_params",
           "build_model", "make_batch"]
