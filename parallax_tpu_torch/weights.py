"""Carry parameters across from the JAX package.

``params_from_jax`` turns the JAX NMT parameter tree (``emb``, ``pos``,
``enc``/``dec`` lists of blocks, ``out_proj``), with its leaves given as
numpy arrays, into the port's tree of fp32 tensors. The layout is kept
as it is — ``[in, out]`` weights applied as ``x @ w`` — so nothing is
transposed and each tensor is the JAX leaf of the same path.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.models.nmt import NMTConfig


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
        a = np.asarray(x, dtype=np.float32)
        if a.shape != tuple(shape):
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{a.shape}, the config wants {shape}")
        return torch.from_numpy(a.copy()).to(dev)

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
