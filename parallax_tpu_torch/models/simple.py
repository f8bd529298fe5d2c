"""Linear-regression smoke model (``parallax_tpu/models/simple.py``).

The reference's de-facto smoke test (reference:
parallax/parallax/examples/simple/simple_driver.py:93-136): a
2-variable linear regression ``y_hat = w*x + b`` trained with SGD on
synthetic data from ``y = 10x - 5 + noise``. Both variables are dense,
so every run option trains it on the all-reduce path. The
smallest end-to-end check of ``parallel_run``.
"""

from __future__ import annotations

import numpy as np
import torch

from parallax_tpu_torch.core import optim
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.ops import collectives


def build_model(learning_rate: float = 0.01) -> Model:
    def init_fn(gen, device):
        return {
            "w": torch.randn((1,), generator=gen, device=device),
            "b": torch.randn((1,), generator=gen, device=device),
        }

    def loss_fn(params, batch):
        pred = params["w"] * batch["x"] + params["b"]
        # the mean over the global batch on several ranks
        loss = collectives.global_mean((pred - batch["y"]) ** 2)
        # copies: the engine updates the parameters in place, and a fetch
        # is read after the step; the JAX metric is the value before it
        return loss, {"w": params["w"][0].clone(),
                      "b": params["b"][0].clone()}

    return Model(init_fn, loss_fn, optimizer=optim.sgd(learning_rate))


def make_batch(rng: np.random.Generator, batch_size: int):
    x = rng.standard_normal(batch_size).astype(np.float32)
    noise = 0.1 * rng.standard_normal(batch_size).astype(np.float32)
    y = 10.0 * x - 5.0 + noise
    return {"x": x, "y": y}
