"""NMT — the Transformer encoder-decoder of ``parallax_tpu.models.nmt``.

Same configuration fields, the same parameter tree (a dict of plain
tensors, ``[in, out]`` weights applied as ``x @ w``, fp32 parameters cast
to ``compute_dtype`` at use) and the same math, op for op: post-LN
blocks, the shared embedding scaled by ``sqrt(model_dim)`` plus learned
positions, fp32 output projection with the phantom padded-vocab classes
pushed to -1e9.

Training: ``build_model(cfg)`` is the JAX ``build_model``: the causal
decoder with cross-attention over the encoder, label-smoothed
cross-entropy over the real vocabulary with a ``{"words": sum(w)}``
metric, and ``chain(clip_by_global_norm(5), adam(join_schedules([
linear_schedule(0, lr, warmup), constant_schedule(lr)], [warmup])))``
(core/optim.py). As in the JAX ``loss_fn``, no dropout is applied,
whatever ``cfg.dropout`` says. The embedding is read only through
lookups, so the classifier finds it sparse; under HYBRID with dense
sparse gradients its [V, D] gradient goes through the optimizer with
the rest.

Serving: the encoder (prefill), the per-layer cross-attention K/V, the
KV-cached decoder step over a dense or a paged self-KV cache, and the
cached greedy decode used as the standalone reference. Beam search and
tensor parallelism are not ported.

Attention executors:

* ``cfg.use_pallas_attention`` (the JAX field name is kept) runs every
  attention of ``_self_block`` through ``ops.flash_attention``: the
  encoder self-attention with the source pad mask, the decoder causal
  self-attention and the cross-attention with the source pad mask. On
  the card that is the CUDA flash forward, and under autograd the CUDA
  dq and dk/dv kernels;
* the paged decode step runs its self-attention through
  ``ops.paged_attention`` (``attn_impl='kernel'``, the default) — the
  CUDA paged-decode kernel on the card — or through the clip-then-mask
  gather and the plain ``_attention`` (``attn_impl='einsum'``);
* decode cross-attention and the dense cache use the plain
  ``_attention`` everywhere, as in the JAX package.

Rounding points are the JAX package's: ``_attention`` accumulates
scores in fp32, divides by ``sqrt(hd)`` after the dot and casts the
softmax back to the compute dtype before PV; the flash kernels scale q
in the compute dtype before the dot; the paged kernel divides its fp32
scores and keeps p in fp32.

The caches are updated IN PLACE (the JAX functions return new arrays;
here the returned tensors are the ones passed in), which keeps one copy
of the pool in device memory.
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
from parallax_tpu_torch.ops import embedding as emb_ops
from parallax_tpu_torch.ops import flash_attention as fa_ops
from parallax_tpu_torch.ops import paged_attention as pa_ops

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2


@dataclasses.dataclass
class NMTConfig:
    vocab_size: int = 32000
    model_dim: int = 512
    num_heads: int = 8
    mlp_dim: int = 2048
    num_layers: int = 6
    max_len: int = 128
    dropout: float = 0.1
    label_smoothing: float = 0.1
    learning_rate: float = 1e-3
    warmup_steps: int = 4000
    # all three attention kinds through the flash-attention kernels
    use_pallas_attention: bool = False
    # not ported: refused at construction
    tensor_parallel: bool = False
    num_partitions: Optional[int] = None
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.tensor_parallel:
            raise ValueError(
                "tensor_parallel is not ported to parallax_tpu_torch")

    @property
    def padded_vocab(self) -> int:
        return emb_ops.padded_vocab_for(self.vocab_size,
                                        self.num_partitions)


def tiny_config(**kw) -> NMTConfig:
    defaults = dict(vocab_size=512, model_dim=32, num_heads=2, mlp_dim=64,
                    num_layers=2, max_len=16, dropout=0.0)
    defaults.update(kw)
    return NMTConfig(**defaults)


def _emb_scale(cfg) -> float:
    """``sqrt(model_dim)`` rounded to the compute dtype, as the JAX
    package's dtype-typed scale is."""
    return torch.tensor(math.sqrt(cfg.model_dim),
                        dtype=cfg.compute_dtype).item()


def _attention(q, k, v, mask, num_heads):
    B, Tq, D = q.shape
    Tk = k.shape[1]
    h = num_heads
    hd = D // h

    def split(x, T):
        return x.reshape(B, T, h, hd).transpose(1, 2)

    qh, kh, vh = split(q, Tq), split(k, Tk), split(v, Tk)
    # fp32 accumulation: the inputs are widened exactly, then multiplied
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(B, Tq, D)


def _layer_norm(x, scale, bias):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    y = (x - m) * torch.rsqrt(v + 1e-6)
    return y * scale + bias


def _fused_attention(cfg, q, k, v, *, causal=False, kv_mask=None):
    """Flash attention on [B, T, D] projections split into heads."""
    D = cfg.model_dim
    B, Tq, _ = q.shape
    Tk = k.shape[1]
    h = cfg.num_heads
    hd = D // h
    out = fa_ops.flash_attention(q.reshape(B, Tq, h, hd),
                                 k.reshape(B, Tk, h, hd),
                                 v.reshape(B, Tk, h, hd),
                                 causal=causal, kv_mask=kv_mask)
    return out.reshape(B, Tq, D)


def _attend(cfg, dt, x_q, x_kv, w, *, causal=False, kv_mask=None):
    """One attention with a single (causal, kv_mask) description; the
    plain branch derives its dense mask from it."""
    q = x_q @ w["wq"].to(dt)
    k = x_kv @ w["wk"].to(dt)
    v = x_kv @ w["wv"].to(dt)
    if cfg.use_pallas_attention:
        return _fused_attention(cfg, q, k, v, causal=causal,
                                kv_mask=kv_mask)
    Tq, Tk = q.shape[1], k.shape[1]
    mask = None
    if kv_mask is not None:
        mask = kv_mask[:, None, None, :]
    if causal:
        tri = torch.ones((Tq, Tk), dtype=torch.bool,
                         device=q.device).tril()[None, None]
        mask = tri if mask is None else (mask & tri)
    if mask is None:
        mask = torch.ones((1, 1, 1, 1), dtype=torch.bool, device=q.device)
    return _attention(q, k, v, mask, cfg.num_heads)


def _self_block(cfg, dt, p, x, cross_kv=None, *, self_causal=False,
                self_kv_mask=None, cross_kv_mask=None):
    """One block: self-attention, then (decoder) cross-attention over
    ``cross_kv``, then the MLP, each post-LN."""
    a = p["attn"]
    y = _attend(cfg, dt, x, x, a, causal=self_causal,
                kv_mask=self_kv_mask) @ a["wo"].to(dt)
    x = _layer_norm(x + y, p["ln1"]["s"].to(dt), p["ln1"]["b"].to(dt))
    if cross_kv is not None:
        c = p["cross"]
        y = _attend(cfg, dt, x, cross_kv, c,
                    kv_mask=cross_kv_mask) @ c["wo"].to(dt)
        x = _layer_norm(x + y, p["ln3"]["s"].to(dt), p["ln3"]["b"].to(dt))
    m = p["mlp"]
    y = torch.relu(x @ m["w1"].to(dt)) @ m["w2"].to(dt)
    return _layer_norm(x + y, p["ln2"]["s"].to(dt), p["ln2"]["b"].to(dt))


def _encode_embed(cfg, params, src):
    """Encoder front half: embedding + positional add; returns
    (x [B, Ts, D], src_valid)."""
    dt = cfg.compute_dtype
    Ts = src.shape[1]
    pos = params["pos"].to(dt)
    x = (emb_ops.embedding_lookup(params["emb"], src).to(dt)
         * _emb_scale(cfg) + pos[None, :Ts])
    return x, (src > PAD_ID)


def _encode_layers(cfg, params, x, src_valid, lo, hi):
    """Encoder layers ``[lo, hi)`` applied to the running hidden state."""
    dt = cfg.compute_dtype
    for p in params["enc"][lo:hi]:
        x = _self_block(cfg, dt, p, x, self_kv_mask=src_valid)
    return x


def _encode(cfg, params, src):
    """Run the encoder stack; returns (enc_out [B, Ts, D], src_valid)."""
    x, src_valid = _encode_embed(cfg, params, src)
    x = _encode_layers(cfg, params, x, src_valid, 0, len(params["enc"]))
    return x, src_valid


def _decode_hidden(cfg, params, tgt_in, enc_out, src_valid):
    """Run the causal decoder stack; returns hidden states [B, Tt, D]."""
    dt = cfg.compute_dtype
    Tt = tgt_in.shape[1]
    pos = params["pos"].to(dt)
    x = (emb_ops.embedding_lookup(params["emb"], tgt_in).to(dt)
         * _emb_scale(cfg) + pos[None, :Tt])
    for p in params["dec"]:
        x = _self_block(cfg, dt, p, x, cross_kv=enc_out, self_causal=True,
                        cross_kv_mask=src_valid)
    return x


def _decode_logits(cfg, params, tgt_in, enc_out, src_valid):
    """Causal decoder + output projection; fp32 logits [B, Tt, V] with
    the phantom padded-vocab classes pushed to -1e9."""
    x = _decode_hidden(cfg, params, tgt_in, enc_out, src_valid)
    logits = x.float() @ params["out_proj"]
    return emb_ops.mask_padded_logits(logits, cfg.vocab_size)


# ----- KV-cached incremental decoding -------------------------------------


def _cross_kv(cfg, params, enc_out):
    """Per-layer cross-attention K/V, computed once per request:
    [L, B, Ts, D] stacks."""
    dt = cfg.compute_dtype
    ks, vs = [], []
    for p in params["dec"]:
        c = p["cross"]
        ks.append(enc_out @ c["wk"].to(dt))
        vs.append(enc_out @ c["wv"].to(dt))
    return torch.stack(ks), torch.stack(vs)


def _init_self_cache(cfg, batch: int, max_len: int, device):
    """Dense per-slot self-KV caches [L, batch, max_len, D] (K and V are
    separate tensors: the decode step writes them in place)."""
    shape = (cfg.num_layers, batch, max_len, cfg.model_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


def _init_paged_self_cache(cfg, pool_pages: int, page_size: int, device):
    """The paged self-KV pools [L, pool_pages + 1, page_size, D]: page
    ``pool_pages`` is the spare page sentinel writes land in (see
    ``ops.paged_attention``)."""
    shape = (cfg.num_layers, pool_pages + 1, page_size, cfg.model_dim)
    return (torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            torch.zeros(shape, dtype=cfg.compute_dtype, device=device))


def _decode_tokens_cached(cfg, params, tok, t, kc, vc, ck, cv, src_valid,
                          pages=None, page_size=None, attn_impl=None):
    """``G`` cached decoder steps in one call: ``tok`` [S, G] holds each
    slot's tokens for positions ``t[s] .. t[s]+G-1`` (``t`` [S] int32);
    writes their K/V into the caches in place and returns
    (logits [S, G, V], kc, vc). Query ``g`` attends to cache positions
    ``<= t+g``.

    ``pages`` [S, P] int32 selects the paged layout: ``kc``/``vc`` are
    the [L, pool_pages + 1, page_size, D] pools and positions map
    through the page table (sentinel ``pool_pages``). ``pages=None``
    keeps the dense [L, S, T, D] layout, which holds positions < T.

    ``attn_impl`` picks the paged self-attention executor: 'kernel'
    (default; ``ops.paged_attention``) or 'einsum' (the clip-then-mask
    gather plus the plain ``_attention``, one query at a time). Ignored
    for the dense layout and for cross-attention."""
    dt = cfg.compute_dtype
    D = cfg.model_dim
    S, G = tok.shape
    dev = tok.device
    paged = pages is not None
    impl = attn_impl or "kernel"
    if impl not in ("kernel", "einsum"):
        raise ValueError(f"attn_impl={attn_impl!r}: expected 'kernel' or "
                         f"'einsum'")
    pos = t.to(torch.int32)[:, None] + torch.arange(
        G, dtype=torch.int32, device=dev)[None, :]             # [S, G]
    # a position past the table is clipped to its last row (those
    # queries' outputs are discarded by the caller)
    pos_emb = params["pos"].to(dt)[pos.clamp(0, cfg.max_len - 1)]
    x = (emb_ops.embedding_lookup(params["emb"], tok).to(dt)
         * _emb_scale(cfg) + pos_emb)                          # [S, G, D]
    if paged:
        ps = int(page_size)
        pool_pages = kc.shape[1] - 1
        Tbuf = pages.shape[1] * ps
        # shared by every layer: sentinel/overflow positions go to the
        # spare page
        pg, off = pa_ops.sentinel_write_coords(pages, pos, ps, pool_pages)
    else:
        Tbuf = kc.shape[2]
        rows = torch.arange(S, device=dev)[:, None]
    cross_mask = src_valid[:, None, None, :]
    q_masks = None
    if not paged or impl == "einsum":
        # per-(slot, query) causal masks, one [S,1,1,Tbuf] per query
        q_masks = [(torch.arange(Tbuf, device=dev)[None, :]
                    <= pos[:, g][:, None])[:, None, None, :]
                   for g in range(G)]

    def _unrolled_attn(q, k_all, v_all, masks):
        outs = [_attention(q[:, g:g + 1], k_all, v_all, masks[g],
                           cfg.num_heads) for g in range(G)]
        return outs[0] if G == 1 else torch.cat(outs, dim=1)

    for i, p in enumerate(params["dec"]):
        a = p["attn"]
        q = x @ a["wq"].to(dt)
        k_t = x @ a["wk"].to(dt)
        v_t = x @ a["wv"].to(dt)
        if paged:
            kc[i, pg, off] = k_t
            vc[i, pg, off] = v_t
            if impl == "kernel":
                y = pa_ops.paged_decode_attention(
                    q, kc[i], vc[i], pages, pos, num_heads=cfg.num_heads,
                    page_size=ps, pool_pages=pool_pages)
            else:
                k_all = pa_ops.paged_gather(kc[i], pages)
                v_all = pa_ops.paged_gather(vc[i], pages)
                y = _unrolled_attn(q, k_all, v_all, q_masks)
        else:
            kc[i, rows, pos] = k_t
            vc[i, rows, pos] = v_t
            y = _unrolled_attn(q, kc[i], vc[i], q_masks)
        x = _layer_norm(x + y @ a["wo"].to(dt),
                        p["ln1"]["s"].to(dt), p["ln1"]["b"].to(dt))
        c = p["cross"]
        qc = x @ c["wq"].to(dt)
        yc = _unrolled_attn(qc, ck[i], cv[i], [cross_mask] * G)
        x = _layer_norm(x + yc @ c["wo"].to(dt),
                        p["ln3"]["s"].to(dt), p["ln3"]["b"].to(dt))
        m = p["mlp"]
        y2 = torch.relu(x @ m["w1"].to(dt)) @ m["w2"].to(dt)
        x = _layer_norm(x + y2,
                        p["ln2"]["s"].to(dt), p["ln2"]["b"].to(dt))
    logits = x.float() @ params["out_proj"]
    return emb_ops.mask_padded_logits(logits, cfg.vocab_size), kc, vc


def _decode_step_cached_multi(cfg, params, tok, t, kc, vc, ck, cv,
                              src_valid):
    """One cached step over the dense layout with per-slot positions:
    ``tok``/``t`` [S]; returns (logits [S, V], kc, vc). Row-wise math, so
    a slot's tokens equal decoding its request alone."""
    logits, kc, vc = _decode_tokens_cached(cfg, params, tok[:, None], t,
                                           kc, vc, ck, cv, src_valid)
    return logits[:, 0], kc, vc


def init_params(cfg: NMTConfig, generator: torch.Generator,
                device="cuda"):
    """Random fp32 parameters in the JAX package's tree layout, drawn
    from ``generator`` (on the generator's device) and placed on
    ``device``. Same distributions as the JAX ``init_fn``: N(0, 0.02²)
    embedding and positions, N(0, 1/fan_in) dense weights, unit/zero
    layer norms. The numbers differ from JAX's for the same seed; use
    ``weights.params_from_jax`` to carry a JAX tree across.
    ``device="meta"`` gives the shapes alone."""
    dev = resolve_device(device)
    V, D = cfg.padded_vocab, cfg.model_dim

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

    def block():
        return {
            "attn": {n: dense((D, D)) for n in ("wq", "wk", "wv", "wo")},
            "cross": {n: dense((D, D)) for n in ("wq", "wk", "wv", "wo")},
            "mlp": {"w1": dense((D, cfg.mlp_dim)),
                    "w2": dense((cfg.mlp_dim, D))},
            "ln1": ln(), "ln2": ln(), "ln3": ln(),
        }

    return {
        "emb": normal((V, D), 0.02),
        "pos": normal((cfg.max_len, D), 0.02),
        "enc": [block() for _ in range(cfg.num_layers)],
        "dec": [block() for _ in range(cfg.num_layers)],
        "out_proj": dense((D, V)),
    }


def greedy_decode(params, cfg: NMTConfig, src,
                  max_len: Optional[int] = None) -> torch.Tensor:
    """Greedy decode against per-layer dense K/V caches; returns int32
    [B, max_len] (PAD after EOS, EOS included). ``src`` [B, Ts] token
    ids; runs on the device of ``params``."""
    T = int(max_len or cfg.max_len)
    dev = params["emb"].device
    src = torch.as_tensor(src, device=dev).long()
    B = src.shape[0]
    enc_out, src_valid = _encode(cfg, params, src)
    ck, cv = _cross_kv(cfg, params, enc_out)
    kc, vc = _init_self_cache(cfg, B, T, dev)
    tgt = torch.full((B, T + 1), PAD_ID, dtype=torch.int32, device=dev)
    tgt[:, 0] = BOS_ID
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for t in range(T):
        tpos = torch.full((B,), t, dtype=torch.int32, device=dev)
        logits, kc, vc = _decode_step_cached_multi(
            cfg, params, tgt[:, t].long(), tpos, kc, vc, ck, cv, src_valid)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(done, PAD_ID, nxt)
        tgt[:, t + 1] = nxt
        done = done | (nxt == EOS_ID)
    return tgt[:, 1:]


def _label_smoothed_nll(cfg, logits, labels):
    """Per-token loss over [N, V] fp32 logits: label-smoothed
    cross-entropy whose smoothing mass spreads over the real vocabulary
    only, or plain cross-entropy when ``label_smoothing`` is 0."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if cfg.label_smoothing > 0:
        eps = cfg.label_smoothing
        nll = (1 - eps) * nll - eps * logp[:, :cfg.vocab_size].mean(dim=-1)
    return nll


def build_model(cfg: NMTConfig) -> Model:
    """The JAX ``build_model``: init, loss and optimizer. Batch feeds
    "src" [B, Ts], "tgt_in" and "tgt_out" [B, Tt] int32 and an optional
    "w" [B, Tt] (default: target tokens that are not PAD); the "words"
    metric is sum(w)."""
    V = cfg.padded_vocab

    def init_fn(gen, device):
        return init_params(cfg, gen, device)

    def loss_fn(params, batch, gen):
        src, tgt_in, tgt_out = batch["src"], batch["tgt_in"], batch["tgt_out"]
        w = batch.get("w")
        if w is None:
            w = (tgt_out > PAD_ID).float()
        B, Tt = tgt_in.shape
        enc_out, src_valid = _encode(cfg, params, src)
        logits = _decode_logits(cfg, params, tgt_in, enc_out,
                                src_valid).reshape(B * Tt, V)
        nll = _label_smoothed_nll(cfg, logits,
                                  tgt_out.reshape(B * Tt).long())
        wf = w.reshape(B * Tt).float()
        total_w = torch.clamp(wf.sum(), min=1e-8)
        return (nll * wf).sum() / total_w, {"words": wf.sum()}

    sched = optim.join_schedules(
        [optim.linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps),
         optim.constant_schedule(cfg.learning_rate)],
        [cfg.warmup_steps])
    tx = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(sched))
    return Model(init_fn, loss_fn, optimizer=tx)


def make_batch(rng: np.random.Generator, batch_size: int, src_len: int,
               tgt_len: int, vocab_size: int):
    """Synthetic batch with the JAX ``make_batch``'s feed keys: tokens
    uniform in [3, vocab_size), no padding."""
    src = rng.integers(3, vocab_size, (batch_size, src_len))
    tgt = rng.integers(3, vocab_size, (batch_size, tgt_len + 1))
    return {"src": src.astype(np.int32),
            "tgt_in": tgt[:, :-1].astype(np.int32),
            "tgt_out": tgt[:, 1:].astype(np.int32)}
