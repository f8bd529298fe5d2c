"""The long-context causal transformer LM: the port of
``parallax_tpu.models.long_context``.

A pre-LN decoder-only transformer (learned positions, fp32 output head)
trained on next-token prediction. Same configuration fields, parameter
tree (a dict of fp32 tensors, ``[in, out]`` weights applied as ``x @ w``
after a cast to ``compute_dtype``) and math as the JAX model, op for op.
Three trainable parallelisms over the engine's mesh
(``parallelism``):

* ``'ring'`` (the default): sequence parallelism. The batch rides
  'repl' and the sequence 'shard' (``batch_specs`` ``P('repl',
  'shard')``, the engine's sequence layout); each layer's attention is
  ``ops.ring_attention`` over the shard group, contiguous or zig-zag
  (``zigzag``: None = zig-zag whenever T divides 2n, as JAX's
  ``_zigzag_active``). On one card the mesh has one shard and the ring
  one block: one causal tile through the flash kernels (B4 forward, B5
  and B6 backward with the lse cotangent of the merge) on CUDA tensors,
  the plain core on CPU tensors, or the flash core everywhere with
  ``use_pallas_attention``. Without a mesh (a call outside the engine)
  the attention is the plain core, as in JAX.
* ``'tensor'``: Megatron tensor parallelism over 'shard' with the JAX
  specs (``wqkv``/``w1`` column-, ``wo``/``w2`` row-parallel, ``out_w``
  vocab-parallel: ``ops.tensor_parallel.vocab_parallel_nll``), the batch
  on 'repl' alone, the plain attention core (TP with
  ``use_pallas_attention`` is refused, as in JAX);
  ``tp_sequence_parallel`` splits the activations between blocks over
  the sequence.
* ``'data'``: data parallelism, attention unsharded.

``'pipeline'`` raises ``NotImplementedError`` (the pipeline schedules,
``ops/pipeline.py`` and the stacked ``blocks_stacked`` layout, are ROADMAP
Queue A item 5.3) after every ``ValueError`` JAX raises first.

Labels across block boundaries: the engine feeds each rank of a shard
group its repl row's whole natural-order id rows (4 bytes a token), and
every rank builds the next-token labels, the loss weights and (zig-zag)
the permutation on the whole row, then takes its own block of each. So
the last token of block i is labelled with the first id of block i + 1
exactly, with no exchange between ranks, and ``tokens`` is B (T - 1)
over the mesh. The permutation, label map and weights are built once a
(T, n, rank, device) as device tensors, outside any captured step. The
loss is ``sum(nll w) / sum(w)`` over the whole mesh through
``collectives.global_sum``.

``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``). The optimizer is ``chain(
clip_by_global_norm(1), adam(learning_rate))``.

Serving (``serve.adapters.CausalLMDecodeProgram``): ``_prefill_embed``,
``_prefill_layers`` and ``_prefill_finish`` run the plain causal forward
over the padded prompt and capture each layer's K/V;
``_decode_step_cached`` is one batched cached step over a dense
``[L, S, Tbuf, D]`` cache or the paged ``[L, pool_pages + 1, page_size,
D]`` pool (the spare page takes sentinel writes, see
``ops.paged_attention``), its attention through the paged kernel
(``attn_impl='kernel'``) or the clip-then-mask gather. The caches are
written in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.core import mesh as mesh_lib, optim
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.core.mesh import AXIS_REPL, AXIS_SHARD, P, TPSpec
from parallax_tpu_torch.models.nmt import _attention as _serve_attention
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops
from parallax_tpu_torch.ops import flash_attention as fa_ops
from parallax_tpu_torch.ops import paged_attention as pa_ops
from parallax_tpu_torch.ops import tensor_parallel as tp_ops
from parallax_tpu_torch.ops.ring_attention import (
    full_attention_reference, inverse_zigzag_permutation, ring_attention,
    zigzag_permutation)

PARALLELISMS = ("ring", "tensor", "pipeline", "data")


@dataclasses.dataclass
class LongContextConfig:
    vocab_size: int = 32000
    model_dim: int = 512
    num_heads: int = 8
    mlp_dim: int = 2048
    num_layers: int = 6
    max_len: int = 32768
    learning_rate: float = 3e-4
    # 'ring' | 'tensor' | 'pipeline' (not ported) | 'data'
    parallelism: str = "ring"
    num_microbatches: int = 4
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1
    pipeline_stages: Optional[int] = None
    # Megatron sequence parallelism composed with TP (tensor mode only)
    tp_sequence_parallel: bool = False
    # zig-zag placement in ring mode: None = whenever T divides 2*ring
    zigzag: Optional[bool] = None
    # the flash kernels as the attention core (data mode; ring blocks)
    use_pallas_attention: bool = False
    # recompute each block in the backward
    remat: bool = False
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def use_ring_attention(self) -> bool:
        return self.parallelism == "ring"


def tiny_config(**kw) -> LongContextConfig:
    defaults = dict(vocab_size=512, model_dim=32, num_heads=2, mlp_dim=64,
                    num_layers=2, max_len=64)
    if "use_ring_attention" in kw:  # back-compat alias
        kw["parallelism"] = ("ring" if kw.pop("use_ring_attention")
                             else "data")
    defaults.update(kw)
    return LongContextConfig(**defaults)


def init_params(cfg: LongContextConfig, generator: torch.Generator,
                device="cuda"):
    """Random fp32 parameters in the JAX package's tree layout (the
    per-layer ``blocks`` list): N(0, 1/fan_in) dense weights, N(0, 0.02²)
    tables, unit/zero LayerNorms, drawn from ``generator`` (on its
    device) and placed on ``device``. The numbers differ from JAX's for
    the same seed; carry a JAX tree across with
    ``weights.long_context_params_from_jax``. ``device="meta"`` gives
    the shapes alone."""
    dev = resolve_device(device)
    V, D, M = cfg.vocab_size, cfg.model_dim, cfg.mlp_dim

    def normal(shape, std):
        if dev.type == "meta":
            return torch.empty(shape, device=dev)
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * std).to(dev)

    def dense(shape):
        return normal(shape, 1.0 / math.sqrt(shape[0]))

    def ln():
        return {"s": torch.ones((D,), device=dev),
                "b": torch.zeros((D,), device=dev)}

    return {
        "emb": normal((V, D), 0.02),
        "pos": normal((cfg.max_len, D), 0.02),
        "out_w": dense((D, V)),
        "blocks": [{"wqkv": dense((D, 3 * D)), "wo": dense((D, D)),
                    "w1": dense((D, M)), "w2": dense((M, D)),
                    "ln1": ln(), "ln2": ln()}
                   for _ in range(cfg.num_layers)],
    }


def _layer_norm(x, p):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - m) * torch.rsqrt(v + 1e-6) * p["s"].to(x.dtype)
            + p["b"].to(x.dtype))


def _reference_core(q, k, v, num_heads, causal, kv_mask):
    """``full_attention_reference`` on [B, T, h*hd] projections (the
    tensor-parallel path's core, as in JAX)."""
    B, T, F = q.shape
    hd = F // num_heads
    out = full_attention_reference(*(z.reshape(B, T, num_heads, hd)
                                     for z in (q, k, v)), causal=causal)
    return out.reshape(B, T, F)


def _check(cfg: LongContextConfig) -> None:
    """The JAX ``build_model``'s ``ValueError``s, in its order."""
    if cfg.zigzag and cfg.parallelism != "ring":
        raise ValueError(
            "zigzag placement only applies to parallelism='ring'")
    if cfg.tp_sequence_parallel and cfg.parallelism != "tensor":
        raise ValueError(
            "tp_sequence_parallel only applies to parallelism='tensor'")
    if cfg.parallelism == "tensor" and cfg.use_pallas_attention:
        raise ValueError(
            "parallelism='tensor' uses the plain attention core (the flash "
            "kernel is not split over heads here); unset "
            "use_pallas_attention")
    Vp = int(cfg.virtual_stages)
    if Vp > 1:
        if cfg.parallelism != "pipeline":
            raise ValueError(
                "virtual_stages > 1 only applies to "
                "parallelism='pipeline'")
        if not cfg.pipeline_stages:
            raise ValueError(
                "virtual_stages > 1 requires pipeline_stages (the "
                "'shard' mesh axis size) so the device-major layer "
                "order is fixed at init")
        if cfg.num_layers % (cfg.pipeline_stages * Vp):
            raise ValueError(
                f"num_layers ({cfg.num_layers}) must divide into "
                f"pipeline_stages*virtual_stages = "
                f"{cfg.pipeline_stages}*{Vp}")
    if cfg.parallelism not in PARALLELISMS:
        raise ValueError(
            f"unknown parallelism {cfg.parallelism!r}; expected "
            f"'ring', 'tensor', 'pipeline' or 'data'")
    if cfg.pipeline_schedule not in ("gpipe", "1f1b"):
        raise ValueError(
            f"unknown pipeline_schedule {cfg.pipeline_schedule!r}; "
            f"expected 'gpipe' or '1f1b'")
    if cfg.parallelism == "pipeline":
        raise NotImplementedError(
            "parallelism='pipeline' is not ported to parallax_tpu_torch: "
            "the pipeline schedules (ops/pipeline.py) and the "
            "blocks_stacked layout are ROADMAP Queue A item 5.3")


def _zigzag_active(cfg: LongContextConfig, mesh, T: int) -> bool:
    if cfg.parallelism != "ring" or mesh is None or mesh.shard <= 1:
        return False
    fits = T % (2 * mesh.shard) == 0
    if cfg.zigzag is None:
        return fits
    if cfg.zigzag and not fits:
        raise ValueError(
            f"zigzag placement needs sequence length divisible by "
            f"2*ring={2 * mesh.shard}; got T={T} (set zigzag=None for auto "
            f"fallback)")
    return bool(cfg.zigzag)


class _Layout:
    """One rank's block of the global row: ``take`` gives columns
    [lo, hi) of the (permuted) row, ``pos_rows`` their real positions,
    ``label_cols`` the columns of the permuted row holding their labels
    and ``w`` [hi - lo] their loss weights; device tensors built once a
    (T, n, zigzag, rank, device)."""

    _cache: dict = {}

    def __init__(self, T, n, zig, s, device):
        if zig:
            perm = zigzag_permutation(T, n)
            inv = inverse_zigzag_permutation(T, n)
            label_map = inv[(perm + 1) % T]
            w = (perm != T - 1).astype(np.float32)
        else:
            perm = np.arange(T)
            label_map = np.minimum(perm + 1, T - 1)
            w = (perm != T - 1).astype(np.float32)
        Tl = T // n
        sl = slice(s * Tl, (s + 1) * Tl)

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=device)

        self.perm = dev(perm, torch.long) if zig else None
        self.pos_rows = dev(perm[sl], torch.long)
        self.label_cols = dev(label_map[sl], torch.long)
        self.w = dev(w[sl], torch.float32)
        self.cols = (s * Tl, (s + 1) * Tl)

    @classmethod
    def get(cls, T, n, zig, s, device):
        key = (T, n, zig, s, str(device))
        if key not in cls._cache:
            cls._cache[key] = cls(T, n, zig, s, device)
        return cls._cache[key]


def build_model(cfg: LongContextConfig) -> Model:
    """The JAX ``build_model``: init, the next-token loss with a
    ``{"tokens": sum(w)}`` metric, the optimizer, and each parallelism's
    specs."""
    _check(cfg)
    V, D, Hn = cfg.vocab_size, cfg.model_dim, cfg.num_heads
    dt = cfg.compute_dtype
    tp_mode = cfg.parallelism == "tensor"
    tp_sp = tp_mode and cfg.tp_sequence_parallel

    def init_fn(gen, device):
        return init_params(cfg, gen, device)

    def attention(x, p, mesh, zig):
        B, T, _ = x.shape
        if tp_mode:
            return tp_ops.tp_attention(x, x, p, Hn, causal=True, dtype=dt,
                                       sequence_parallel=tp_sp,
                                       core=_reference_core)
        q, k, v = (z.reshape(B, T, Hn, D // Hn) for z in torch.chunk(
            x @ p["wqkv"].to(dt), 3, dim=-1))
        if cfg.use_ring_attention and mesh is not None:
            out = ring_attention(
                q, k, v, mesh, AXIS_SHARD, causal=True,
                batch_axis=AXIS_REPL,
                placement="zigzag" if zig else "contiguous",
                block_impl="pallas" if cfg.use_pallas_attention
                else "auto")
        elif cfg.use_pallas_attention:
            out = fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                         v.contiguous(), causal=True)
        else:
            out = full_attention_reference(q, k, v, causal=True)
        return out.reshape(B, T, D) @ p["wo"].to(dt)

    def block_apply(p, x, mesh, zig):
        ln1, ln2 = p["ln1"], p["ln2"]
        if tp_sp:
            ln1 = tp_ops.sequence_parallel_params(ln1)
            ln2 = tp_ops.sequence_parallel_params(ln2)
        x = x + attention(_layer_norm(x, ln1), p, mesh, zig)
        h = _layer_norm(x, ln2)
        if tp_mode:
            return x + tp_ops.tp_mlp(h, p["w1"], p["w2"], dtype=dt,
                                     sequence_parallel=tp_sp)
        return x + torch.relu(h @ p["w1"].to(dt)) @ p["w2"].to(dt)

    def loss_fn(params, batch):
        ids = batch["ids"]
        B, T = ids.shape
        if T > cfg.max_len:
            raise ValueError(
                f"sequence length {T} exceeds max_len {cfg.max_len}")
        mesh = collectives.current_mesh()
        ring = cfg.use_ring_attention and mesh is not None
        n = mesh.shard if ring else 1
        if T % n:
            raise ValueError(
                f"sequence length {T} does not split over the {n} ranks "
                f"of the 'shard' axis")
        zig = _zigzag_active(cfg, mesh, T)
        lay = _Layout.get(T, n, zig, collectives.shard_index(mesh) if ring
                          else 0, ids.device)
        ids = ids.long()
        if lay.perm is not None:
            ids = ids[:, lay.perm]
        lo, hi = lay.cols
        labels = ids[:, lay.label_cols]
        x = emb_ops.embedding_lookup(params["emb"], ids[:, lo:hi]).to(dt)
        x = x + params["pos"][lay.pos_rows].to(dt)[None]
        if tp_sp:
            x = tp_ops.seq_shard(x)
        for p in params["blocks"]:
            if cfg.remat:
                x = torch.utils.checkpoint.checkpoint(
                    block_apply, p, x, mesh, zig, use_reentrant=False)
            else:
                x = block_apply(p, x, mesh, zig)
        if tp_sp:
            x = tp_ops.seq_gather(x)
        Tl = hi - lo
        labels = labels.reshape(B * Tl)
        if tp_mode:
            # the vocab-parallel head: this rank's V/p logit columns
            logits = tp_ops.column_parallel(x.float(), params["out_w"])
            nll = tp_ops.vocab_parallel_nll(logits.reshape(B * Tl, -1),
                                            labels)
        else:
            logits = (x.float() @ params["out_w"]).reshape(B * Tl, -1)
            nll = -torch.log_softmax(logits, dim=-1).gather(
                1, labels[:, None])[:, 0]
        w = lay.w.expand(B, Tl).reshape(-1)
        tokens = collectives.global_sum(w.sum())
        loss = collectives.global_sum((nll * w).sum()) / tokens
        return loss, {"tokens": tokens}

    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adam(cfg.learning_rate))
    dense = ("emb", "pos")
    if tp_mode:
        return Model(init_fn, loss_fn, optimizer=tx, dense_params=dense,
                     batch_specs={"ids": P(AXIS_REPL, None)},
                     param_specs={
                         **tp_ops.attention_param_specs("blocks/*"),
                         **tp_ops.mlp_param_specs("blocks/*"),
                         # the vocab-parallel output head
                         "out_w": TPSpec(None, AXIS_SHARD)})
    if cfg.parallelism == "ring":
        return Model(init_fn, loss_fn, optimizer=tx, dense_params=dense,
                     batch_specs={"ids": P(AXIS_REPL, AXIS_SHARD)})
    return Model(init_fn, loss_fn, optimizer=tx, dense_params=dense)


def make_batch(rng: np.random.Generator, batch_size: int, seq_len: int,
               vocab_size: int):
    return {"ids": rng.integers(1, vocab_size,
                                (batch_size, seq_len)).astype(np.int32)}


# -- KV-cached serving decode ---------------------------------------------
# The data-path block math above, one position at a time, for
# serve/adapters.CausalLMDecodeProgram (parallax_tpu/models/
# long_context.py:527-688). Serve-against-standalone identity holds
# because both run these functions.


def _prefill_embed(cfg: LongContextConfig, params, ids):
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


def _prefill_layers(cfg: LongContextConfig, params, carry, lo, hi):
    """Layers [lo, hi) of the prompt: each layer's K/V projections
    captured, then the pre-LN block with causal attention. Padded rows
    compute K/V that the insert routes to the spare page."""
    dt = cfg.compute_dtype
    x, pk, pv = carry["x"], carry["pk"], carry["pv"]
    B, Ts, D = x.shape
    Hn = cfg.num_heads

    def heads(z):
        return z.reshape(B, Ts, Hn, D // Hn)

    for i in range(lo, hi):
        p = params["blocks"][i]
        h = _layer_norm(x, p["ln1"])
        q, k, v = torch.chunk(h @ p["wqkv"].to(dt), 3, dim=-1)
        pk[i] = k
        pv[i] = v
        out = full_attention_reference(heads(q), heads(k), heads(v),
                                       causal=True)
        x = x + out.reshape(B, Ts, D) @ p["wo"].to(dt)
        h2 = _layer_norm(x, p["ln2"])
        x = x + torch.relu(h2 @ p["w1"].to(dt)) @ p["w2"].to(dt)
    return {"x": x, "pk": pk, "pv": pv, "ids": carry["ids"]}


def _prefill_finish(carry, pad_id: int = 0):
    """The request's decode state: ``base`` is the position of the last
    prompt token (t0 - 1), which decode step 0 consumes (``first``), so
    step t writes position base + t."""
    ids = carry["ids"]
    t0 = (ids[0] != pad_id).sum().to(torch.int32)
    base = (t0 - 1).to(torch.int32)
    # index_select with a device index: no host read (capturable)
    first = ids[0].index_select(
        0, base.clamp(0, ids.shape[1] - 1).long().reshape(1))
    return {"pk": carry["pk"], "pv": carry["pv"], "base": base.reshape(1),
            "first": first.to(torch.int32)}


def _decode_step_cached(cfg: LongContextConfig, params, tok, t, base, first,
                        kc, vc, pages=None, page_size=None, attn_impl=None):
    """One batched cached step: ``tok``/``t``/``base``/``first`` are [S]
    per-slot rows; writes each slot's K/V at position base + t in place
    and returns (logits [S, V] fp32, kc, vc). Step 0 swaps in ``first``
    for the scheduler's BOS. ``pages`` [S, P] selects the paged pool
    [L, pool_pages + 1, page_size, D] (dense: [L, S, Tbuf, D]);
    ``attn_impl`` 'kernel' (default) or 'einsum' picks the paged
    attention. Row-wise math only: slots are independent."""
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
        h = _layer_norm(x, p["ln1"])
        q, k_t, v_t = torch.chunk(h @ p["wqkv"].to(dt), 3, dim=-1)
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
        x = x + y @ p["wo"].to(dt)
        h2 = _layer_norm(x, p["ln2"])
        x = x + torch.relu(h2 @ p["w1"].to(dt)) @ p["w2"].to(dt)
    logits = x[:, 0].float() @ params["out_w"]
    return logits, kc, vc


def _init_serve_self_cache(cfg: LongContextConfig, batch: int, max_len: int,
                           device):
    shape = (cfg.num_layers, batch, max_len, cfg.model_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


def _init_serve_paged_cache(cfg: LongContextConfig, pool_pages: int,
                            page_size: int, device):
    """The paged pools [L, pool_pages + 1, page_size, D]: page
    ``pool_pages`` is the spare page sentinel writes land in."""
    shape = (cfg.num_layers, pool_pages + 1, page_size, cfg.model_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


__all__ = ["LongContextConfig", "tiny_config", "init_params", "build_model",
           "make_batch"]
