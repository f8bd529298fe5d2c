"""BERT pretraining (MLM + NSP): the port of ``parallax_tpu.models.bert``.

BASELINE.json config 5, "BERT-large pretraining (mixed dense layers +
WordPiece sparse embeddings)": an encoder-only transformer whose
WordPiece table ``word_emb`` is read only through ``embedding_lookup``
(untied from the MLM output matrix), so the classifier routes it to the
row-sharded sparse path while the 24 dense layers ride the all-reduce
path. Same configuration fields, parameter tree (a dict of plain fp32
tensors, ``[in, out]`` weights applied as ``x @ w`` after a cast to
``compute_dtype``) and math as the JAX model, op for op: post-LN
blocks, LayerNorm with the biased variance and ``rsqrt(v + 1e-6)``,
GELU in its tanh form (``jax.nn.gelu``'s default; torch's default is
the erf form), MLM logits only at the masked positions in fp32 (dense,
GELU, LayerNorm, ``mlm/out`` plus bias, the padded vocab's phantom
classes at -1e9), NSP in fp32 from position 0, and
``chain(clip_by_global_norm(1), adamw(lr, weight_decay=0.01))`` with
every leaf decayed.

Attention executors:

* the plain core: fp32 scores divided by sqrt(hd) after the dot, -1e9 on
  padded keys (``input_ids == 0``), the softmax cast back to the compute
  dtype before PV;
* ``use_pallas_attention`` (the JAX field name is kept): the flash
  kernels of ``ops.flash_attention`` (B4 forward, B5 dq and B6 dk/dv
  under autograd) with the padding mask as their ``kv_mask``;
* ``tensor_parallel``: Megatron's column/row-parallel attention and MLP
  of ``ops.tensor_parallel`` over the mesh's 'shard' axis (heads
  computed H/p a rank; the plain core, as in JAX, which refuses TP with
  the Pallas kernel), with the JAX specs: ``wqkv``/``w1`` column-,
  ``wo``/``w2`` row-parallel, the batch on 'repl' alone. The WordPiece
  table keeps its row-sharded sparse path on the same axis.
  ``tp_sequence_parallel`` adds sequence parallelism: between blocks
  each rank holds T/p of the sequence. The JAX model pins that layout
  after every block; here the activations are split once before the
  first block and gathered once after the last (``seq_shard``,
  ``seq_gather``), and the blocks' LayerNorm parameters, applied to a
  rank's rows only, have their gradients summed over the shard group.

Losses are over the global batch on several ranks: the MLM loss divides
by ``sum(mask_weights)`` and NSP takes the mean, both through
``ops.collectives`` (over the repl group when the batch rides 'repl'
alone).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.core import mesh as mesh_lib, optim
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.ops import collectives
from parallax_tpu_torch.ops import embedding as emb_ops
from parallax_tpu_torch.ops import flash_attention as fa_ops
from parallax_tpu_torch.ops import tensor_parallel as tp_ops

BATCH_KEYS = ("input_ids", "segment_ids", "mask_positions", "mask_labels",
              "mask_weights")


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_dim: int = 1024          # BERT-large
    num_heads: int = 16
    mlp_dim: int = 4096
    num_layers: int = 24
    max_len: int = 512
    type_vocab: int = 2
    learning_rate: float = 1e-4
    # attention (with the WordPiece padding mask) through the flash
    # kernels
    use_pallas_attention: bool = False
    # Megatron tensor parallelism over the 'shard' mesh axis
    tensor_parallel: bool = False
    # TP x SP: between-block activations split over the sequence
    tp_sequence_parallel: bool = False
    num_partitions: Optional[int] = None
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def padded_vocab(self) -> int:
        return emb_ops.padded_vocab_for(self.vocab_size,
                                        self.num_partitions)


def tiny_config(**kw) -> BertConfig:
    defaults = dict(vocab_size=500, hidden_dim=32, num_heads=2,
                    mlp_dim=64, num_layers=2, max_len=32)
    defaults.update(kw)
    return BertConfig(**defaults)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _layer_norm(x, p):
    m = x.mean(dim=-1, keepdim=True)
    v = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - m) * torch.rsqrt(v + 1e-6) * p["s"].to(x.dtype)
            + p["b"].to(x.dtype))


def init_params(cfg: BertConfig, generator: torch.Generator,
                device="cuda"):
    """Random fp32 parameters in the JAX package's tree layout: N(0,
    0.02²) weights and tables, unit/zero LayerNorms and zero MLM bias,
    drawn from ``generator`` (on its device) and placed on ``device``.
    The numbers differ from JAX's for the same seed; carry a JAX tree
    across with ``weights.bert_params_from_jax``. ``device="meta"``
    gives the shapes alone."""
    dev = resolve_device(device)
    V, D, M = cfg.padded_vocab, cfg.hidden_dim, cfg.mlp_dim

    def dense(shape):
        if dev.type == "meta":
            return torch.empty(shape, device=dev)
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * 0.02).to(dev)

    def ln():
        return {"s": torch.ones((D,), device=dev),
                "b": torch.zeros((D,), device=dev)}

    return {
        "word_emb": dense((V, D)),
        "pos_emb": dense((cfg.max_len, D)),
        "type_emb": dense((cfg.type_vocab, D)),
        "emb_ln": ln(),
        "mlm": {"w": dense((D, D)), "ln": ln(), "out": dense((D, V)),
                "bias": torch.zeros((V,), device=dev)},
        "nsp": {"pool": dense((D, D)), "out": dense((D, 2))},
        "blocks": [{"wqkv": dense((D, 3 * D)), "wo": dense((D, D)),
                    "w1": dense((D, M)), "w2": dense((M, D)),
                    "ln1": ln(), "ln2": ln()}
                   for _ in range(cfg.num_layers)],
    }


def _attention(cfg, x, p, pad_mask, kv_mask):
    """One self-attention and its output projection, [B, T, D] ->
    [B, T, D] (``kv_mask``: the padding mask as the flash kernels take
    it)."""
    dt = cfg.compute_dtype
    if cfg.tensor_parallel:
        return tp_ops.tp_attention(
            x, x, p, cfg.num_heads, kv_mask=pad_mask, dtype=dt,
            sequence_parallel=cfg.tp_sequence_parallel)
    B, T, D = x.shape
    Hn = cfg.num_heads
    hd = D // Hn
    q, k, v = torch.chunk(x @ p["wqkv"].to(dt), 3, dim=-1)
    if cfg.use_pallas_attention:
        out = fa_ops.flash_attention(
            q.reshape(B, T, Hn, hd).contiguous(),
            k.reshape(B, T, Hn, hd).contiguous(),
            v.reshape(B, T, Hn, hd).contiguous(), kv_mask=kv_mask)
        return out.reshape(B, T, D) @ p["wo"].to(dt)

    def heads(z):
        return z.reshape(B, T, Hn, hd).transpose(1, 2)

    scores = torch.matmul(heads(q).float(),
                          heads(k).float().transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(pad_mask[:, None, None, :], scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(dt)
    out = torch.matmul(probs, heads(v))
    return out.transpose(1, 2).reshape(B, T, D) @ p["wo"].to(dt)


def _nll(logits, labels):
    """optax.softmax_cross_entropy_with_integer_labels on [N, C] fp32."""
    return -torch.log_softmax(logits, dim=-1).gather(
        1, labels[:, None].long())[:, 0]


def build_model(cfg: BertConfig) -> Model:
    """The JAX ``build_model``: init, the MLM + NSP loss with
    ``{"mlm_loss", "nsp_loss", "masked_tokens"}`` metrics, the optimizer,
    ``type_emb`` pinned dense, and the tensor-parallel specs."""
    V = cfg.padded_vocab
    dt = cfg.compute_dtype
    if cfg.tensor_parallel and cfg.use_pallas_attention:
        raise ValueError(
            "tensor_parallel uses the plain attention core (the flash "
            "kernel is not split over heads here); unset one of "
            "tensor_parallel / use_pallas_attention")
    if cfg.tp_sequence_parallel and not cfg.tensor_parallel:
        raise ValueError(
            "tp_sequence_parallel requires tensor_parallel=True")
    sp = cfg.tensor_parallel and cfg.tp_sequence_parallel

    def init_fn(gen, device):
        return init_params(cfg, gen, device)

    def loss_fn(params, batch):
        ids = batch["input_ids"]
        segs = batch["segment_ids"]
        B, T = ids.shape
        pad_mask = ids > 0
        kv_mask = pad_mask.to(torch.int32) if cfg.use_pallas_attention \
            else None

        x = emb_ops.embedding_lookup(params["word_emb"], ids).to(dt)
        x = x + params["pos_emb"][:T].to(dt)[None]
        x = x + F.embedding(segs.long(), params["type_emb"]).to(dt)
        x = _layer_norm(x, params["emb_ln"])
        if sp:
            x = tp_ops.seq_shard(x)

        for p in params["blocks"]:
            ln1, ln2 = p["ln1"], p["ln2"]
            if sp:
                ln1 = tp_ops.sequence_parallel_params(ln1)
                ln2 = tp_ops.sequence_parallel_params(ln2)
            x = _layer_norm(x + _attention(cfg, x, p, pad_mask, kv_mask),
                            ln1)
            if cfg.tensor_parallel:
                h = tp_ops.tp_mlp(x, p["w1"], p["w2"], act=_gelu, dtype=dt,
                                  sequence_parallel=sp)
            else:
                h = _gelu(x @ p["w1"].to(dt)) @ p["w2"].to(dt)
            x = _layer_norm(x + h, ln2)
        if sp:
            x = tp_ops.seq_gather(x)

        # MLM over the masked positions only: [B, M] gathers
        mpos = batch["mask_positions"].long()               # [B, M]
        mlabels = batch["mask_labels"]                      # [B, M]
        mw = batch["mask_weights"].float()                  # [B, M]
        D = x.shape[-1]
        hidden = torch.gather(x, 1, mpos[..., None].expand(-1, -1, D))
        hidden = hidden.float()                             # [B, M, D]
        mlm = params["mlm"]
        hidden = _gelu(hidden @ mlm["w"])
        hidden = _layer_norm(hidden, mlm["ln"])
        logits = hidden @ mlm["out"] + mlm["bias"]
        logits = emb_ops.mask_padded_logits(logits, cfg.vocab_size)
        mlm_nll = _nll(logits.reshape(-1, V), mlabels.reshape(-1))
        masked = collectives.global_sum(mw.sum())
        mlm_loss = (collectives.global_sum((mlm_nll * mw.reshape(-1)).sum())
                    / torch.clamp(masked, min=1e-8))

        # NSP from the [CLS] (position 0) vector
        cls = torch.tanh(x[:, 0].float() @ params["nsp"]["pool"])
        nsp_logits = cls @ params["nsp"]["out"]
        nsp_loss = collectives.global_mean(
            _nll(nsp_logits, batch["next_sentence_label"]))

        loss = mlm_loss + nsp_loss
        return loss, {"mlm_loss": mlm_loss, "nsp_loss": nsp_loss,
                      "masked_tokens": masked}

    tx = optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adamw(cfg.learning_rate, weight_decay=0.01))
    specs, bspecs = {}, {}
    if cfg.tensor_parallel:
        specs = {**tp_ops.attention_param_specs("blocks/*"),
                 **tp_ops.mlp_param_specs("blocks/*")}
        # the batch rides 'repl' alone: 'shard' is the TP axis
        P = mesh_lib.P
        bspecs = {k: P(mesh_lib.AXIS_REPL, None) for k in BATCH_KEYS}
        bspecs["next_sentence_label"] = P(mesh_lib.AXIS_REPL)
    # type_emb is gathered but tiny (2 rows): kept replicated rather than
    # letting the classifier shard it
    return Model(init_fn, loss_fn, optimizer=tx,
                 dense_params=("type_emb",), param_specs=specs,
                 batch_specs=bspecs)


def make_batch(rng: np.random.Generator, batch_size: int, seq_len: int,
               num_masked: int, vocab_size: int):
    """The JAX ``make_batch``: ids uniform in [5, vocab), segment 1 over
    the second half, ``num_masked`` distinct positions a row replaced by
    [MASK] (3) with their ids as labels, weights 1, random NSP labels.
    No padding: a caller sets padded tails to id 0."""
    ids = rng.integers(5, vocab_size, (batch_size, seq_len))
    segs = np.zeros((batch_size, seq_len), np.int32)
    segs[:, seq_len // 2:] = 1
    mpos = np.stack([rng.choice(seq_len, num_masked, replace=False)
                     for _ in range(batch_size)]).astype(np.int32)
    mlabels = np.take_along_axis(ids, mpos, axis=1).astype(np.int32)
    ids_masked = ids.copy()
    np.put_along_axis(ids_masked, mpos, 3, axis=1)  # [MASK]=3
    return {
        "input_ids": ids_masked.astype(np.int32),
        "segment_ids": segs,
        "mask_positions": mpos,
        "mask_labels": mlabels,
        "mask_weights": np.ones((batch_size, num_masked), np.float32),
        "next_sentence_label": rng.integers(0, 2, (batch_size,))
                                  .astype(np.int32),
    }
