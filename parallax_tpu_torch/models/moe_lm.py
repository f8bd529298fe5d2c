"""The switch-MoE transformer LM: the port of ``parallax_tpu.models.moe_lm``.

A post-LN decoder-only transformer (learned positions, fp32 output head
over the padded vocabulary, the phantom classes pushed to -1e9) whose
every block's MLP is a top-k switch MoE (``ops.moe.switch_moe``). Same
configuration fields and defaults, parameter tree (a dict of fp32
tensors, ``[in, out]`` weights applied as ``x @ w`` after a cast to
``compute_dtype``; expert weights ``[E, D, F]`` and ``[E, F, D]``) and
math as the JAX model, op for op. The loss is the next-token
cross-entropy (labels shifted left, the last position weighted 0, ``sum(
nll w) / sum(w)`` over the whole mesh through ``collectives.global_sum``)
plus ``aux_loss_weight`` times the layers' mean load-balance loss; the
metrics are ``lm_loss``, ``aux_loss`` and ``moe_dropped`` (the layers'
mean dropped share). The optimizer is ``chain(clip_by_global_norm(1),
adam(learning_rate))``.

Expert parallelism: the expert weights carry ``mesh.ExpertSpec`` (the
JAX model's ``P('shard', None, None)``), so each rank of the engine's
mesh holds E/n experts and the tokens reach them through the MoE's
all-to-all over 'shard'. The batch rides the default layout (dim 0 over
the whole mesh) and ``emb`` is a sparse table the engine row-shards
under HYBRID. On one card the shard axis is 1 and ``switch_moe`` runs
its dense path: every expert on every token, as in JAX.

Attention: ``use_pallas_attention`` runs the causal flash kernels
(``ops.flash_attention``: B4 forward, B5 and B6 backward on the card);
otherwise the plain causal core (``full_attention_reference``).

Serving (``serve.adapters.MoeLMDecodeProgram``, ``parallax_tpu/models/
moe_lm.py:165-292``): ``_prefill_embed`` and ``_prefill_layers`` run the
plain causal forward over the padded prompt, capturing each layer's K/V
of the raw block input (post-LN), then ``long_context._prefill_finish``;
``_decode_step_cached`` is one batched cached step over the dense cache
or the paged pool, its attention through B7 (``attn_impl='kernel'``) or
the clip-then-mask gather, and the MoE routed per token. Without a mesh
the MoE is the dense per-token path: row-wise, no capacity, so slots are
independent and served tokens equal each request decoded alone.
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
from parallax_tpu_torch.core.mesh import AXIS_SHARD, ExpertSpec
from parallax_tpu_torch.models.long_context import (_layer_norm,
                                                    _prefill_finish,
                                                    _serve_attention)
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops
from parallax_tpu_torch.ops import flash_attention as fa_ops
from parallax_tpu_torch.ops import moe as moe_ops
from parallax_tpu_torch.ops import paged_attention as pa_ops
from parallax_tpu_torch.ops.ring_attention import full_attention_reference


@dataclasses.dataclass
class MoeLMConfig:
    vocab_size: int = 32000
    model_dim: int = 512
    num_heads: int = 8
    expert_dim: int = 1024
    num_experts: int = 16
    num_layers: int = 6
    max_len: int = 1024
    capacity_factor: float = 1.25
    # 1 = switch routing; 2 = GShard top-2 (renormalised gates,
    # first-choice capacity priority)
    top_k: int = 1
    aux_loss_weight: float = 0.01
    use_pallas_attention: bool = False
    learning_rate: float = 3e-4
    num_partitions: Optional[int] = None
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        return emb_ops.padded_vocab_for(self.vocab_size,
                                        self.num_partitions)


def tiny_config(**kw) -> MoeLMConfig:
    defaults = dict(vocab_size=512, model_dim=32, num_heads=2,
                    expert_dim=64, num_experts=8, num_layers=2,
                    max_len=32)
    defaults.update(kw)
    return MoeLMConfig(**defaults)


def init_params(cfg: MoeLMConfig, generator: torch.Generator,
                device="cuda"):
    """Random fp32 parameters in the JAX package's tree layout, drawn
    from ``generator`` (on its device) and placed on ``device``: N(0,
    1/fan_in) dense and expert weights (fan-in: dim 0, or dim 1 of an
    expert weight), N(0, 0.02²) tables, unit/zero LayerNorms. The numbers
    differ from JAX's for the same seed; carry a JAX tree across with
    ``weights.moe_lm_params_from_jax``. ``device="meta"`` gives the
    shapes alone."""
    dev = resolve_device(device)
    V, D, E, F = (cfg.padded_vocab, cfg.model_dim, cfg.num_experts,
                  cfg.expert_dim)

    def normal(shape, std):
        if dev.type == "meta":
            return torch.empty(shape, device=dev)
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * std).to(dev)

    def dense(shape, axis=0):
        return normal(shape, 1.0 / math.sqrt(shape[axis]))

    def ln():
        return {"s": torch.ones((D,), device=dev),
                "b": torch.zeros((D,), device=dev)}

    return {
        "emb": normal((V, D), 0.02),
        "pos": normal((cfg.max_len, D), 0.02),
        "out_w": dense((D, V)),
        "blocks": [{"wqkv": dense((D, 3 * D)), "wo": dense((D, D)),
                    "router": dense((D, E)),
                    "moe_w1": dense((E, D, F), axis=1),
                    "moe_w2": dense((E, F, D), axis=1),
                    "ln1": ln(), "ln2": ln()}
                   for _ in range(cfg.num_layers)],
    }


def _heads(z, num_heads):
    B, T, F = z.shape
    return z.reshape(B, T, num_heads, F // num_heads)


def build_model(cfg: MoeLMConfig) -> Model:
    """The JAX ``build_model``: init, the loss with the ``lm_loss``,
    ``aux_loss`` and ``moe_dropped`` metrics, clip + Adam, and the expert
    weights' specs."""
    V, D, Hn = cfg.padded_vocab, cfg.model_dim, cfg.num_heads
    dt = cfg.compute_dtype

    def init_fn(gen, device):
        return init_params(cfg, gen, device)

    def attention(x, p):
        B, T, _ = x.shape
        q, k, v = (_heads(z, Hn) for z in torch.chunk(
            x @ p["wqkv"].to(dt), 3, dim=-1))
        if cfg.use_pallas_attention:
            out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal=True)
        else:
            out = full_attention_reference(q, k, v, causal=True)
        return out.reshape(B, T, D) @ p["wo"].to(dt)

    def loss_fn(params, batch):
        ids = batch["ids"].long()
        B, T = ids.shape
        mesh = collectives.current_mesh()
        x = emb_ops.embedding_lookup(params["emb"], ids).to(dt)
        x = x + params["pos"][:T].to(dt)[None]
        aux_total = drop_total = 0.0
        for p in params["blocks"]:
            x = _layer_norm(x + attention(x, p), p["ln1"])
            moe_out, aux, dropped = moe_ops.switch_moe(
                x.reshape(B * T, D), p["router"], p["moe_w1"], p["moe_w2"],
                mesh, cfg.capacity_factor, top_k=cfg.top_k)
            aux_total = aux_total + aux
            drop_total = drop_total + dropped
            x = _layer_norm(x + moe_out.reshape(B, T, D).to(dt), p["ln2"])
        logits = emb_ops.mask_padded_logits(x.float() @ params["out_w"],
                                            cfg.vocab_size)
        labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])],
                           dim=1).reshape(B * T)
        w = torch.ones((B, T), dtype=torch.float32, device=ids.device)
        w[:, -1] = 0.0
        w = w.reshape(B * T)
        nll = -torch.log_softmax(logits.reshape(B * T, V), dim=-1).gather(
            1, labels[:, None])[:, 0]
        # over the global batch on several ranks (ops/collectives.py)
        lm_loss = collectives.global_sum((nll * w).sum()) \
            / collectives.global_sum(w.sum())
        aux_mean = aux_total / cfg.num_layers
        loss = lm_loss + cfg.aux_loss_weight * aux_mean
        # capacity overflow surfaces as a metric: silent drops would
        # corrupt training with no signal
        return loss, {"lm_loss": lm_loss, "aux_loss": aux_mean,
                      "moe_dropped": drop_total / cfg.num_layers}

    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adam(cfg.learning_rate))
    # the expert weights split by expert over 'shard'
    return Model(init_fn, loss_fn, optimizer=tx, param_specs={
        "blocks/*/moe_w1": ExpertSpec(AXIS_SHARD, None, None),
        "blocks/*/moe_w2": ExpertSpec(AXIS_SHARD, None, None)})


def make_batch(rng: np.random.Generator, batch_size: int, seq_len: int,
               vocab_size: int):
    return {"ids": rng.integers(1, vocab_size,
                                (batch_size, seq_len)).astype(np.int32)}


# -- KV-cached serving decode ---------------------------------------------
# The post-LN MoE blocks above, one position at a time, for
# serve/adapters.MoeLMDecodeProgram: long_context's serving construction
# (its attention and LayerNorm helpers: the same math), but attention
# reads the RAW block input and each block's MLP is the switch MoE.


def _moe(cfg: MoeLMConfig, p, x):
    """The block's MoE over the rows of ``x`` [B, T, D] (the output in
    ``x``'s shape and dtype)."""
    B, T, D = x.shape
    out, _, _ = moe_ops.switch_moe(
        x.reshape(B * T, D), p["router"], p["moe_w1"], p["moe_w2"],
        collectives.current_mesh(), cfg.capacity_factor, top_k=cfg.top_k)
    return out.reshape(B, T, D).to(x.dtype)


def _prefill_embed(cfg: MoeLMConfig, params, ids):
    """Embedding and positions over the padded prompt ``ids`` [1, Ts];
    the K/V capture stacks [L, 1, Ts, D]."""
    dt = cfg.compute_dtype
    Ts = ids.shape[1]
    x = (emb_ops.embedding_lookup(params["emb"], ids.long()).to(dt)
         + params["pos"][:Ts].to(dt)[None])
    shape = (cfg.num_layers, 1, Ts, cfg.model_dim)
    return {"x": x, "pk": torch.zeros(shape, dtype=dt, device=ids.device),
            "pv": torch.zeros(shape, dtype=dt, device=ids.device),
            "ids": ids}


def _prefill_layers(cfg: MoeLMConfig, params, carry, lo, hi):
    """Layers [lo, hi) of the prompt: each layer's K/V projections of the
    raw block input captured, then the post-LN MoE block with causal
    attention. Padded rows route through the MoE too (their K/V go to
    the spare page at insert)."""
    dt = cfg.compute_dtype
    x, pk, pv = carry["x"], carry["pk"], carry["pv"]
    B, Ts, D = x.shape
    Hn = cfg.num_heads
    for i in range(lo, hi):
        p = params["blocks"][i]
        q, k, v = torch.chunk(x @ p["wqkv"].to(dt), 3, dim=-1)
        pk[i] = k
        pv[i] = v
        out = full_attention_reference(_heads(q, Hn), _heads(k, Hn),
                                       _heads(v, Hn), causal=True)
        x = _layer_norm(x + out.reshape(B, Ts, D) @ p["wo"].to(dt),
                        p["ln1"])
        x = _layer_norm(x + _moe(cfg, p, x), p["ln2"])
    return {"x": x, "pk": pk, "pv": pv, "ids": carry["ids"]}


def _decode_step_cached(cfg: MoeLMConfig, params, tok, t, base, first,
                        kc, vc, pages=None, page_size=None, attn_impl=None):
    """One batched cached step (``long_context._decode_step_cached``'s
    row contract): post-LN blocks, the MoE routed per token over the S
    slots, padded-vocab logits masked. Returns (logits [S, V] fp32, kc,
    vc), the caches written in place."""
    dt = cfg.compute_dtype
    S = tok.shape[0]
    dev = tok.device
    paged = pages is not None
    impl = attn_impl or "kernel"
    if impl not in ("kernel", "einsum"):
        raise ValueError(f"attn_impl={attn_impl!r}: expected 'kernel' or "
                         f"'einsum'")
    if paged:
        ps = int(page_size)
        pool_pages = kc.shape[1] - 1
        Tbuf = pages.shape[1] * ps
    else:
        Tbuf = kc.shape[2]
        rows = torch.arange(S, device=dev)[:, None]
    tok_eff = torch.where(t == 0, first, tok).long()
    pos = (base + t).to(torch.int32)[:, None]                  # [S, 1]
    # a position past the table is clipped (that output is discarded)
    pos_emb = params["pos"].to(dt)[pos.long().clamp(0, cfg.max_len - 1)]
    x = (emb_ops.embedding_lookup(params["emb"], tok_eff[:, None]).to(dt)
         + pos_emb)                                            # [S, 1, D]
    mask = None
    if not paged or impl == "einsum":
        mask = (torch.arange(Tbuf, device=dev)[None, :]
                <= pos)[:, None, None, :]
    if paged:
        pg, off = pa_ops.sentinel_write_coords(pages, pos, ps, pool_pages)
    for i, p in enumerate(params["blocks"]):
        q, k_t, v_t = torch.chunk(x @ p["wqkv"].to(dt), 3, dim=-1)
        if paged:
            kc[i, pg, off] = k_t
            vc[i, pg, off] = v_t
            if impl == "kernel":
                y = pa_ops.paged_decode_attention(
                    q.contiguous(), kc[i], vc[i], pages, pos,
                    num_heads=cfg.num_heads, page_size=ps,
                    pool_pages=pool_pages)
            else:
                y = _serve_attention(q, pa_ops.paged_gather(kc[i], pages),
                                     pa_ops.paged_gather(vc[i], pages),
                                     mask, cfg.num_heads)
        else:
            kc[i, rows, pos.long()] = k_t
            vc[i, rows, pos.long()] = v_t
            y = _serve_attention(q, kc[i], vc[i], mask, cfg.num_heads)
        x = _layer_norm(x + y @ p["wo"].to(dt), p["ln1"])
        x = _layer_norm(x + _moe(cfg, p, x), p["ln2"])
    logits = x[:, 0].float() @ params["out_w"]
    return emb_ops.mask_padded_logits(logits, cfg.vocab_size), kc, vc


def _init_serve_self_cache(cfg: MoeLMConfig, batch: int, max_len: int,
                           device):
    shape = (cfg.num_layers, batch, max_len, cfg.model_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


def _init_serve_paged_cache(cfg: MoeLMConfig, pool_pages: int,
                            page_size: int, device):
    """The paged pools [L, pool_pages + 1, page_size, D]: page
    ``pool_pages`` is the spare page sentinel writes land in."""
    shape = (cfg.num_layers, pool_pages + 1, page_size, cfg.model_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


__all__ = ["MoeLMConfig", "tiny_config", "init_params", "build_model",
           "make_batch"]
