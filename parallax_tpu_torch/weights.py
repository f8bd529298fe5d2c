"""Carry parameters across from the JAX package.

``simple_params_from_jax`` carries the linear regression's ``w`` and
``b``. ``cnn_params_from_jax`` turns a flax CNN's ``{"params",
"batch_stats"}`` into the port's ``(params, model_state)``: conv kernels
go from flax's HWIO to OIHW (stored channels_last), every other leaf
keeps its shape. ``lm1b_params_from_jax`` maps the JAX LM1B tree (``emb``,
``lstm/{w,b,w_proj}``, ``softmax_w``, ``softmax_b``) onto the port's
tree unchanged. ``params_from_jax`` turns the JAX NMT parameter tree (``emb``, ``pos``,
``enc``/``dec`` lists of blocks, ``out_proj``), with its leaves given as
numpy arrays, into the port's tree of fp32 tensors. The layout is kept
as it is — ``[in, out]`` weights applied as ``x @ w`` — so nothing is
transposed and each tensor is the JAX leaf of the same path.

``bert_params_from_jax`` does the same for the JAX BERT tree
(``word_emb``, ``pos_emb``, ``type_emb``, ``emb_ln``, ``mlm``, ``nsp``,
the ``blocks`` list), unchanged in layout.

``long_context_params_from_jax`` does the same for the JAX long-context
LM's tree (``emb``, ``pos``, ``out_w``, the ``blocks`` list, or the
pipeline's ``blocks_stacked``); given an engine it gives that rank's
part, its shards of the tensor-parallel leaves included (a fused
``wqkv`` as the q, k and v columns of its heads; ``gather_params`` gives
JAX's layout back) and its rows of the stage stack. For a pipeline
config a per-layer ``blocks`` tree (a data-parallel run's) is stacked
in the config's storage order (device-major when interleaving).

``skip_thoughts_params_from_jax`` does the same for the skip-thoughts
tree (``emb``, ``encoder``, ``dec_prev``, ``dec_next``, ``out_w``,
``out_b``).

``moe_lm_params_from_jax`` does the same for the JAX switch-MoE LM's
tree (``emb``, ``pos``, ``out_w``, the ``blocks`` list with ``router``,
``moe_w1`` ``[E, D, F]`` and ``moe_w2`` ``[E, F, D]``); given an engine
it gives that rank's part, its E/n experts of each expert weight.

``rank_shard`` cuts any of those whole trees down to what one rank of a
mesh holds: its rows of each leaf the engine's plan row-shards, its
shard of each tensor-parallel leaf.

``state_to_jax_names`` and ``state_from_jax_checkpoint`` carry a whole
``TrainState`` (parameters, optimizer, model, slice and pending state,
step and seed) across, under the names the JAX package's checkpoint
gives its leaves (``ckpt/snapshot.py``): the port's state as ``{name:
array}`` in the JAX layout, and such a dict (a JAX run's
``ckpt.snapshot.flatten_with_names(state)``) copied into a port state in
place.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.core.classify import flatten
from parallax_tpu_torch.models import _nn, cnn
from parallax_tpu_torch.models.bert import BertConfig
from parallax_tpu_torch.models.lm1b import LM1BConfig
from parallax_tpu_torch.models.long_context import (LongContextConfig,
                                                    stack_blocks)
from parallax_tpu_torch.models.moe_lm import MoeLMConfig
from parallax_tpu_torch.models.nmt import NMTConfig
from parallax_tpu_torch.models.skip_thoughts import SkipThoughtsConfig


def _leaf(x, shape, path, dtype, dev, who):
    a = np.asarray(x, dtype=np.float32)
    if a.shape != tuple(shape):
        raise ValueError(f"{who}: {path} has shape {a.shape}, the config "
                         f"wants {tuple(shape)}")
    return torch.from_numpy(a.copy()).to(device=dev, dtype=dtype)


def lm1b_params_from_jax(np_params, cfg: LM1BConfig, device="cuda"):
    """The port's LM1B parameters from a JAX tree of numpy arrays, on
    ``device``: the LSTM group in fp32, the tables in
    ``cfg.table_dtype``. Checks every shape against ``cfg``."""
    dev = resolve_device(device)
    V, E, H, P = cfg.padded_vocab, cfg.emb_dim, cfg.hidden_dim, cfg.proj_dim
    td, f32 = cfg.table_dtype, torch.float32
    who = "lm1b_params_from_jax"
    lstm = np_params["lstm"]
    return {
        "emb": _leaf(np_params["emb"], (V, E), "emb", td, dev, who),
        "lstm": {
            "w": _leaf(lstm["w"], (E + P, 4 * H), "lstm/w", f32, dev, who),
            "b": _leaf(lstm["b"], (4 * H,), "lstm/b", f32, dev, who),
            "w_proj": _leaf(lstm["w_proj"], (H, P), "lstm/w_proj", f32,
                            dev, who),
        },
        "softmax_w": _leaf(np_params["softmax_w"], (V, P), "softmax_w", td,
                           dev, who),
        "softmax_b": _leaf(np_params["softmax_b"], (V, 1), "softmax_b", td,
                           dev, who),
    }


def params_from_jax(np_params, cfg: NMTConfig, device="cuda"):
    """The port's NMT parameters from a JAX tree of numpy arrays, on
    ``device``. Checks every shape against ``cfg``."""
    dev = resolve_device(device)
    V, D, F = cfg.padded_vocab, cfg.model_dim, cfg.mlp_dim
    want_block = {
        "attn": {n: (D, D) for n in ("wq", "wk", "wv", "wo")},
        "cross": {n: (D, D) for n in ("wq", "wk", "wv", "wo")},
        "mlp": {"w1": (D, F), "w2": (F, D)},
        "ln1": {"s": (D,), "b": (D,)},
        "ln2": {"s": (D,), "b": (D,)},
        "ln3": {"s": (D,), "b": (D,)},
    }

    def leaf(x, shape, path):
        return _leaf(x, shape, path, torch.float32, dev, "params_from_jax")

    def block(p, path):
        return {grp: {n: leaf(p[grp][n], shape, f"{path}/{grp}/{n}")
                      for n, shape in names.items()}
                for grp, names in want_block.items()}

    for stack in ("enc", "dec"):
        if len(np_params[stack]) != cfg.num_layers:
            raise ValueError(
                f"params_from_jax: {len(np_params[stack])} {stack} "
                f"blocks, the config wants {cfg.num_layers}")
    return {
        "emb": leaf(np_params["emb"], (V, D), "emb"),
        "pos": leaf(np_params["pos"], (cfg.max_len, D), "pos"),
        "enc": [block(p, f"enc/{i}")
                for i, p in enumerate(np_params["enc"])],
        "dec": [block(p, f"dec/{i}")
                for i, p in enumerate(np_params["dec"])],
        "out_proj": leaf(np_params["out_proj"], (D, V), "out_proj"),
    }


def bert_params_from_jax(np_params, cfg: BertConfig, device="cuda"):
    """The port's BERT parameters (fp32) from a JAX tree of numpy arrays,
    on ``device``. Checks every shape against ``cfg``."""
    dev = resolve_device(device)
    V, D, M = cfg.padded_vocab, cfg.hidden_dim, cfg.mlp_dim
    ln = {"s": (D,), "b": (D,)}
    want = {
        "word_emb": (V, D), "pos_emb": (cfg.max_len, D),
        "type_emb": (cfg.type_vocab, D), "emb_ln": ln,
        "mlm": {"w": (D, D), "ln": ln, "out": (D, V), "bias": (V,)},
        "nsp": {"pool": (D, D), "out": (D, 2)},
    }
    block = {"wqkv": (D, 3 * D), "wo": (D, D), "w1": (D, M), "w2": (M, D),
             "ln1": ln, "ln2": ln}

    def carry(tree, shapes, path):
        if isinstance(shapes, dict):
            return {k: carry(tree[k], v, f"{path}/{k}" if path else k)
                    for k, v in shapes.items()}
        return _leaf(tree, shapes, path, torch.float32, dev,
                     "bert_params_from_jax")

    if len(np_params["blocks"]) != cfg.num_layers:
        raise ValueError(f"bert_params_from_jax: {len(np_params['blocks'])} "
                         f"blocks, the config wants {cfg.num_layers}")
    out = carry(np_params, want, "")
    out["blocks"] = [carry(b, block, f"blocks/{i}")
                     for i, b in enumerate(np_params["blocks"])]
    return out


def long_context_params_from_jax(np_params, cfg: LongContextConfig,
                                 device="cuda", engine=None):
    """The port's long-context LM parameters (fp32) from a JAX tree of
    numpy arrays (the per-layer ``blocks`` layout), on ``device``; with
    ``engine``, as that engine's rank holds them (``rank_shard``).
    Checks every shape against ``cfg``."""
    dev = resolve_device(device)
    V, D, M = cfg.vocab_size, cfg.model_dim, cfg.mlp_dim
    ln = {"s": (D,), "b": (D,)}
    want = {"emb": (V, D), "pos": (cfg.max_len, D), "out_w": (D, V)}
    block = {"wqkv": (D, 3 * D), "wo": (D, D), "w1": (D, M), "w2": (M, D),
             "ln1": ln, "ln2": ln}
    who = "long_context_params_from_jax"

    def carry(tree, shapes, path):
        if isinstance(shapes, dict):
            return {k: carry(tree[k], v, f"{path}/{k}" if path else k)
                    for k, v in shapes.items()}
        return _leaf(tree, shapes, path, torch.float32, dev, who)

    L = cfg.num_layers
    pipeline = cfg.parallelism == "pipeline"
    out = carry(np_params, want, "")
    if "blocks_stacked" in np_params:
        if not pipeline:
            raise ValueError(f"{who}: a pipeline tree (blocks_stacked) for "
                             f"parallelism={cfg.parallelism!r}")

        def stacked(shapes):
            if isinstance(shapes, dict):
                return {k: stacked(v) for k, v in shapes.items()}
            return (L,) + shapes

        out["blocks_stacked"] = carry(np_params["blocks_stacked"],
                                      stacked(block), "blocks_stacked")
    else:
        if "blocks" not in np_params or len(np_params["blocks"]) != L:
            raise ValueError(f"{who}: the tree needs the per-layer 'blocks' "
                             f"list of {L} (or a pipeline tree's "
                             f"blocks_stacked)")
        blocks = [carry(b, block, f"blocks/{i}")
                  for i, b in enumerate(np_params["blocks"])]
        if pipeline:
            out["blocks_stacked"] = stack_blocks(cfg, blocks)
        else:
            out["blocks"] = blocks
    return out if engine is None else rank_shard(out, engine)


def skip_thoughts_params_from_jax(np_params, cfg: SkipThoughtsConfig,
                                  device="cuda"):
    """The port's skip-thoughts parameters (fp32) from a JAX tree of numpy
    arrays, on ``device``. Checks every shape against ``cfg``."""
    dev = resolve_device(device)
    V, E, H = cfg.padded_vocab, cfg.emb_dim, cfg.hidden_dim
    who = "skip_thoughts_params_from_jax"
    gru = {"w": (E + H, 3 * H), "b": (3 * H,)}
    dec = dict(gru, h0_proj=(H, H))
    want = {"emb": (V, E), "encoder": gru, "dec_prev": dec, "dec_next": dec,
            "out_w": (H, V), "out_b": (V,)}

    def carry(tree, shapes, path):
        if isinstance(shapes, dict):
            if set(tree) != set(shapes):
                raise ValueError(f"{who}: {path or 'the tree'} has "
                                 f"{sorted(tree)}, the model "
                                 f"{sorted(shapes)}")
            return {k: carry(tree[k], v, f"{path}/{k}" if path else k)
                    for k, v in shapes.items()}
        return _leaf(tree, shapes, path, torch.float32, dev, who)

    return carry(np_params, want, "")


def moe_lm_params_from_jax(np_params, cfg: MoeLMConfig, device="cuda",
                           engine=None):
    """The port's switch-MoE LM parameters (fp32) from a JAX tree of numpy
    arrays, on ``device``; with ``engine``, as that engine's rank holds
    them (``rank_shard``: its experts of each expert weight, its rows of
    a row-sharded table). Checks every shape against ``cfg``."""
    dev = resolve_device(device)
    V, D, E, F = (cfg.padded_vocab, cfg.model_dim, cfg.num_experts,
                  cfg.expert_dim)
    ln = {"s": (D,), "b": (D,)}
    want = {"emb": (V, D), "pos": (cfg.max_len, D), "out_w": (D, V)}
    block = {"wqkv": (D, 3 * D), "wo": (D, D), "router": (D, E),
             "moe_w1": (E, D, F), "moe_w2": (E, F, D), "ln1": ln,
             "ln2": ln}
    who = "moe_lm_params_from_jax"

    def carry(tree, shapes, path):
        if isinstance(shapes, dict):
            return {k: carry(tree[k], v, f"{path}/{k}" if path else k)
                    for k, v in shapes.items()}
        return _leaf(tree, shapes, path, torch.float32, dev, who)

    if len(np_params["blocks"]) != cfg.num_layers:
        raise ValueError(f"{who}: {len(np_params['blocks'])} blocks, the "
                         f"config wants {cfg.num_layers}")
    out = carry(np_params, want, "")
    out["blocks"] = [carry(b, block, f"blocks/{i}")
                     for i, b in enumerate(np_params["blocks"])]
    return out if engine is None else rank_shard(out, engine)


def simple_params_from_jax(np_params, device="cuda"):
    """The linear regression's ``{"w", "b"}``, each of shape (1,)."""
    dev = resolve_device(device)
    return {k: _leaf(np_params[k], (1,), k, torch.float32, dev,
                     "simple_params_from_jax") for k in ("w", "b")}


def cnn_params_from_jax(np_variables, name, num_classes: int,
                        image_size: int, device="cuda"):
    """``(params, model_state)`` of a CNN from flax's ``{"params",
    "batch_stats"}`` trees of numpy arrays; ``model_state`` is None for
    a model without BatchNorm. ``name`` is a registry name
    (models/cnn.py) or a module. Each leaf is checked against the port's
    own tree (built on meta tensors); the call raises if a flax leaf is
    left over or a port leaf is not filled."""
    dev = resolve_device(device)
    who = "cnn_params_from_jax"
    module = (cnn.build_module(name, num_classes)[0]
              if isinstance(name, str) else name)
    want_params, want_stats = _nn.init(module, torch.Generator(), "meta",
                                       image_size)
    given = {}
    for coll in ("params", "batch_stats"):
        for path, leaf in flatten(np_variables.get(coll, {})):
            given[f"{coll}/{path}"] = leaf

    def carry(coll, tree):
        out = {}
        for path, want in flatten(tree):
            key = f"{coll}/{path}"
            if key not in given:
                raise ValueError(f"{who}: the JAX tree has no {key}")
            a = np.asarray(given.pop(key), dtype=np.float32)
            if want.dim() == 4:             # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            t = _leaf(a, want.shape, key, torch.float32, dev, who)
            if want.dim() == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            node = out
            *parents, last = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = t
        return out

    params = carry("params", want_params)
    stats = carry("batch_stats", want_stats)
    if given:
        raise ValueError(f"{who}: JAX leaves the port's {name!r} does not "
                         f"have: {sorted(given)}")
    return params, ({"batch_stats": stats} if want_stats else None)


def rank_shard(params, engine):
    """``params`` (a whole tree of tensors in the port's layout, e.g. from
    one of the functions above) as ``engine``'s rank holds it
    (``Engine.local_part``): the rank's rows of every leaf the plan
    row-shards, its shard of every tensor-parallel leaf (of a fused
    ``wqkv``, the q, k and v columns of its heads), its experts of every
    expert weight, every other leaf as it is. Copy the result into
    ``sess.state.params`` leaf by leaf."""
    return engine._local_tree(params)


def _host_array(a) -> torch.Tensor:
    """A CPU tensor of ``a`` (numpy, also ml_dtypes' bfloat16, or torch)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def state_to_jax_names(state, engine=None, optimizer=None):
    """``{JAX checkpoint name: CPU tensor}`` of a one-rank port
    ``TrainState``: every leaf whole, in the JAX layout (convolution
    kernels HWIO; ``step`` int32, ``rng`` JAX's key of the seed).
    ``engine`` (the session's) names the optimizer grouping; without it
    ``optimizer`` names the optimizer state."""
    from parallax_tpu_torch.ckpt import snapshot
    out = {}
    for leaf in snapshot.state_leaves(state, engine, optimizer):
        full = torch.empty(leaf.shape, dtype=snapshot.torch_dtype(leaf.dtype))
        covered = 0
        for extent, index in leaf.pieces:
            piece = _host_array(leaf.value)[index]
            if leaf.perm is not None:
                piece = piece.permute(leaf.perm)
            full[tuple(slice(a, b) for a, b in extent)] = piece
            covered += piece.numel()
        if covered != full.numel():
            raise ValueError(f"state_to_jax_names: {leaf.name} is split "
                             f"over ranks; gather it on one rank")
        out[leaf.name] = full
    return out


def state_from_jax_checkpoint(named, state, engine=None, optimizer=None):
    """Copy ``{JAX checkpoint name: array}`` (whole arrays in the JAX
    layout) into the port ``TrainState`` ``state`` in place, this rank's
    pieces of each; ``step`` and the seed come from the ``step`` and
    ``rng`` leaves. The names must match both ways, and each shape and
    dtype."""
    from parallax_tpu_torch.ckpt import snapshot
    leaves = snapshot.state_leaves(state, engine, optimizer)
    want = {leaf.name for leaf in leaves}
    if want != set(named):
        raise ValueError(
            f"state_from_jax_checkpoint: missing {sorted(want - set(named))}"
            f", unexpected {sorted(set(named) - want)}")
    for leaf in leaves:
        full = _host_array(named[leaf.name])
        if tuple(full.shape) != tuple(leaf.shape) or \
                snapshot.dtype_name(full.dtype) != leaf.dtype:
            raise ValueError(
                f"state_from_jax_checkpoint: {leaf.name} is "
                f"{tuple(full.shape)} {snapshot.dtype_name(full.dtype)}, "
                f"the port wants {leaf.shape} {leaf.dtype}")
        leaf.assign(full)
    return state
