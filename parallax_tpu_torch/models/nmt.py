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
cached greedy decode used as the standalone reference.

Beam search (``beam_decode``, ``parallax_tpu/models/nmt.py:637-740``):
the GNMT length penalty over ``beam_width`` beams, a joint top-k over
(parent beam, token) whose ties go to the lowest flat index as
``lax.top_k``'s do (``ops.topk.top_k_stable``), finished beams extended
by PAD at no cost; the cached path reorders the per-layer K/V caches by
the winning parent beams each step, the cacheless one reruns the
decoder over the whole buffer. The loop reads nothing back to the host
until it returns. ``ids_to_tokens`` turns a decoded row into the token
list ``common.evaluation.corpus_bleu`` takes.

Tensor parallelism (``tensor_parallel=True``, training): every attention
(encoder self, decoder causal self, cross) and every MLP runs through
``ops.tensor_parallel``'s Megatron operators over the mesh's 'shard'
axis, with the JAX specs (``wq``/``wk``/``wv``/``w1`` column-,
``wo``/``w2`` row-parallel) and the batch on 'repl' alone; the plain
attention core, so TP with ``use_pallas_attention`` is refused, as in
JAX.

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
from parallax_tpu_torch.core import mesh as mesh_lib, optim
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops
from parallax_tpu_torch.ops import flash_attention as fa_ops
from parallax_tpu_torch.ops import paged_attention as pa_ops
from parallax_tpu_torch.ops import tensor_parallel as tp_ops
from parallax_tpu_torch.ops.topk import top_k_stable

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
    # Megatron tensor parallelism over the 'shard' mesh axis
    tensor_parallel: bool = False
    num_partitions: Optional[int] = None
    compute_dtype: torch.dtype = torch.bfloat16

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
    ``cross_kv``, then the MLP, each post-LN (under ``tensor_parallel``
    through ``ops.tensor_parallel``)."""
    tp = cfg.tensor_parallel

    def attn_out(x_q, x_kv, w, causal, kv_mask):
        """Attention and its output projection (row-parallel under TP)."""
        if tp:
            return tp_ops.tp_attention(x_q, x_kv, w, cfg.num_heads,
                                       causal=causal, kv_mask=kv_mask,
                                       dtype=dt)
        return _attend(cfg, dt, x_q, x_kv, w, causal=causal,
                       kv_mask=kv_mask) @ w["wo"].to(dt)

    a = p["attn"]
    y = attn_out(x, x, a, self_causal, self_kv_mask)
    x = _layer_norm(x + y, p["ln1"]["s"].to(dt), p["ln1"]["b"].to(dt))
    if cross_kv is not None:
        c = p["cross"]
        y = attn_out(x, cross_kv, c, False, cross_kv_mask)
        x = _layer_norm(x + y, p["ln3"]["s"].to(dt), p["ln3"]["b"].to(dt))
    m = p["mlp"]
    if tp:
        y = tp_ops.tp_mlp(x, m["w1"], m["w2"], dtype=dt)
    else:
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
    keeps the dense [L, S, T, D] layout, which holds positions < T (a
    write past it is dropped, as JAX's ``mode="drop"``).

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
        rows = torch.arange(S, device=dev)
        # a position past the buffer (a draft or verify window near its
        # end) keeps the value already there: JAX's mode="drop"
        in_buf = (pos < Tbuf)[..., None]
        pos_w = pos.clamp(max=Tbuf - 1)
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
            # one query at a time: a clamped position may repeat in a
            # slot, and the later write must see the earlier one
            for g in range(G):
                at = (i, rows, pos_w[:, g])
                kc[at] = torch.where(in_buf[:, g], k_t[:, g], kc[at])
                vc[at] = torch.where(in_buf[:, g], v_t[:, g], vc[at])
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


def _decode_step_logits(cfg, params, tgt_in, enc_out, src_valid, t: int):
    """Logits for position ``t`` only [B, V]: the cacheless decoder over
    the whole buffer, the output projection for slot ``t`` alone."""
    x = _decode_hidden(cfg, params, tgt_in, enc_out, src_valid)
    logits = x[:, t].float() @ params["out_proj"]
    return emb_ops.mask_padded_logits(logits, cfg.vocab_size)


def _length_penalty(length, alpha):
    # GNMT length penalty (reference inference: ((5+len)/6)^alpha)
    return ((5.0 + length) / 6.0) ** alpha


def beam_decode(params, cfg: NMTConfig, src, beam_width: int = 4,
                alpha: float = 1.0, max_len: Optional[int] = None,
                use_cache: bool = True) -> torch.Tensor:
    """Beam search with the GNMT length penalty; returns the best
    hypothesis per example, int32 [B, max_len]. ``use_cache`` decodes
    against per-layer K/V caches, reordered by the winning parent beams
    each step with the rest of the carried state. Runs on the device of
    ``params``."""
    T = int(max_len or cfg.max_len)
    K = int(beam_width)
    dev = params["emb"].device
    src = torch.as_tensor(src, device=dev).long()
    B = src.shape[0]
    V = cfg.padded_vocab
    NEG = -1e9

    # encode once, tile over beams: [B*K, Ts, D]
    enc_out, src_valid = _encode(cfg, params, src)
    enc_k = enc_out.repeat_interleave(K, dim=0)
    valid_k = src_valid.repeat_interleave(K, dim=0)
    tgt = torch.full((B, K, T + 1), PAD_ID, dtype=torch.int32, device=dev)
    tgt[:, :, 0] = BOS_ID
    # only beam 0 is live at t = 0 (all beams identical otherwise)
    logp = torch.full((B, K), NEG, dtype=torch.float32, device=dev)
    logp[:, 0] = 0.0
    done = torch.zeros((B, K), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B, K), dtype=torch.float32, device=dev)
    # finished beams may only emit PAD, at no cost
    pad_only = torch.full((V,), NEG, dtype=torch.float32, device=dev)
    pad_only[PAD_ID] = 0.0
    brow = torch.arange(B, device=dev)[:, None]

    def beam_step(t, logits, tgt, logp, done, lengths):
        """Finished-beam PAD scoring, the joint top-k over (parent beam,
        token), the parents' state reordered, the token written, lengths
        and done updated; also returns the winning parents."""
        step_logp = torch.log_softmax(logits, dim=-1).reshape(B, K, V)
        step_logp = torch.where(done[:, :, None], pad_only, step_logp)
        cand = logp[:, :, None] + step_logp                  # [B, K, V]
        top_logp, top_idx = top_k_stable(cand.reshape(B, K * V), K)
        beam_idx = top_idx // V
        tok = (top_idx % V).to(torch.int32)
        tgt = tgt[brow, beam_idx]
        done = done[brow, beam_idx]
        lengths = lengths[brow, beam_idx]
        tgt[:, :, t + 1] = tok
        lengths = torch.where(done, lengths, lengths + 1.0)
        done = done | (tok == EOS_ID)
        return tgt, top_logp, done, lengths, beam_idx

    if use_cache:
        ck, cv = _cross_kv(cfg, params, enc_k)
        kc, vc = _init_self_cache(cfg, B * K, T, dev)

        def reorder(c, beam_idx):
            L, _, Tc, D = c.shape
            return c.reshape(L, B, K, Tc, D)[:, brow, beam_idx] \
                .reshape(L, B * K, Tc, D)

        for t in range(T):
            tpos = torch.full((B * K,), t, dtype=torch.int32, device=dev)
            logits, kc, vc = _decode_step_cached_multi(
                cfg, params, tgt.reshape(B * K, T + 1)[:, t].long(), tpos,
                kc, vc, ck, cv, valid_k)
            tgt, logp, done, lengths, beam_idx = beam_step(
                t, logits, tgt, logp, done, lengths)
            kc = reorder(kc, beam_idx)
            vc = reorder(vc, beam_idx)
    else:
        for t in range(T):
            logits = _decode_step_logits(
                cfg, params, tgt.reshape(B * K, T + 1)[:, :-1].long(),
                enc_k, valid_k, t)
            tgt, logp, done, lengths, _ = beam_step(
                t, logits, tgt, logp, done, lengths)
    # only finished hypotheses are length-normalised candidates;
    # unfinished beams rank below every finished one in their own order,
    # so the best raw beam still wins when nothing finished
    score = torch.where(
        done, logp / _length_penalty(torch.clamp(lengths, min=1.0), alpha),
        logp + NEG)
    best = torch.argmax(score, dim=1)
    return tgt[torch.arange(B, device=dev), best, 1:]


def ids_to_tokens(row, id_to_token=None):
    """Strip BOS/EOS/PAD and map ids to tokens (str(ids) by default), the
    input of ``common.evaluation.corpus_bleu`` (reference:
    nmt/utils/evaluation_utils.py)."""
    out = []
    for i in np.asarray(row).tolist():
        if i == EOS_ID:
            break
        if i in (PAD_ID, BOS_ID):
            continue
        out.append(id_to_token[i] if id_to_token else str(i))
    return out


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
    metric is sum(w). Under ``tensor_parallel`` the model also declares
    the JAX package's tensor-parallel specs and batch specs."""
    V = cfg.padded_vocab
    if cfg.tensor_parallel and cfg.use_pallas_attention:
        raise ValueError(
            "tensor_parallel uses the plain attention core (the flash "
            "kernel is not split over heads here); unset one of "
            "tensor_parallel / use_pallas_attention")

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
        # over the global batch on several ranks (ops/collectives.py)
        words = collectives.global_sum(wf.sum())
        total_w = torch.clamp(words, min=1e-8)
        return collectives.global_sum((nll * wf).sum()) / total_w, \
            {"words": words}

    sched = optim.join_schedules(
        [optim.linear_schedule(0.0, cfg.learning_rate, cfg.warmup_steps),
         optim.constant_schedule(cfg.learning_rate)],
        [cfg.warmup_steps])
    tx = optim.chain(optim.clip_by_global_norm(5.0), optim.adam(sched))
    specs, bspecs = {}, {}
    if cfg.tensor_parallel:
        for stack in ("enc", "dec"):
            specs.update(tp_ops.attention_param_specs(
                f"{stack}/*/attn", fused_qkv=False))
            specs.update(tp_ops.attention_param_specs(
                f"{stack}/*/cross", fused_qkv=False))
            specs.update(tp_ops.mlp_param_specs(f"{stack}/*/mlp"))
        # the batch rides 'repl' alone: 'shard' is the TP axis
        bspecs = {k: mesh_lib.P(mesh_lib.AXIS_REPL, None)
                  for k in ("src", "tgt_in", "tgt_out", "w")}
    return Model(init_fn, loss_fn, optimizer=tx, param_specs=specs,
                 batch_specs=bspecs)


def make_batch(rng: np.random.Generator, batch_size: int, src_len: int,
               tgt_len: int, vocab_size: int):
    """Synthetic batch with the JAX ``make_batch``'s feed keys: tokens
    uniform in [3, vocab_size), no padding."""
    src = rng.integers(3, vocab_size, (batch_size, src_len))
    tgt = rng.integers(3, vocab_size, (batch_size, tgt_len + 1))
    return {"src": src.astype(np.int32),
            "tgt_in": tgt[:, :-1].astype(np.int32),
            "tgt_out": tgt[:, 1:].astype(np.int32)}
