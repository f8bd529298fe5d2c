"""ResNet v1 / v1.5 (``parallax_tpu/models/resnet.py``).

The reference's ResNet-50/101/152 (reference:
examples/tf_cnn_benchmarks/models/resnet_model.py), including "v1.5",
which strides in the bottleneck's 3x3 conv instead of its first 1x1.
bf16 compute with fp32 parameters and statistics, as the JAX module
runs. The layers are models/_nn.py's flax-semantics functions, so the
parameter tree has the flax tree's paths (``conv_init``, ``bn_init``,
``BottleneckBlock_{i}/{Conv,BatchNorm}_{j}``, ``conv_proj``,
``norm_proj``, ``Dense_0``): conv kernels OIHW where flax has HWIO,
every other leaf the flax leaf as it is.

A module is a frozen dataclass whose ``__call__(scope, x)`` takes NCHW
activations in channels_last memory; ``_nn.init`` and ``_nn.apply``
drive it.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence, Tuple

import torch

from parallax_tpu_torch.models import _nn


@dataclasses.dataclass(frozen=True)
class BottleneckBlock:
    filters: int
    strides: Tuple[int, int]
    v1_5: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __call__(self, s: _nn.Scope, x):
        conv = partial(_nn.Conv, s, use_bias=False, dtype=self.dtype)
        norm = partial(_nn.BatchNorm, s, momentum=0.9, epsilon=1e-5,
                       dtype=self.dtype)
        residual = x
        y = conv(x, self.filters, (1, 1),
                 strides=(1, 1) if self.v1_5 else self.strides)
        y = norm(y).relu_()
        y = conv(y, self.filters, (3, 3),
                 strides=self.strides if self.v1_5 else (1, 1))
        y = norm(y).relu_()
        y = conv(y, self.filters * 4, (1, 1))
        y = norm(y, scale_init=_nn.zeros)
        if residual.shape != y.shape:
            residual = conv(residual, self.filters * 4, (1, 1),
                            strides=self.strides, name="conv_proj")
            residual = norm(residual, name="norm_proj")
        return (residual + y).relu_()


@dataclasses.dataclass(frozen=True)
class ResNet:
    stage_sizes: Sequence[int]
    num_classes: int = 1000
    num_filters: int = 64
    v1_5: bool = True
    dtype: torch.dtype = torch.bfloat16

    def __call__(self, s: _nn.Scope, x):
        d = self.dtype
        x = x.to(d)
        x = _nn.Conv(s, x, self.num_filters, (7, 7), strides=(2, 2),
                     padding=[(3, 3), (3, 3)], use_bias=False, dtype=d,
                     name="conv_init")
        x = _nn.BatchNorm(s, x, momentum=0.9, epsilon=1e-5, dtype=d,
                          name="bn_init").relu_()
        x = _nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        for i, block_count in enumerate(self.stage_sizes):
            for j in range(block_count):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                x = _nn.child(s, BottleneckBlock(
                    self.num_filters * 2 ** i, strides, self.v1_5, d), x)
        # jnp.mean on bf16 sums in fp32 and rounds the mean to bf16
        x = x.mean((2, 3)).to(_nn.head_dtype(d))
        return _nn.Dense(s, x, self.num_classes, dtype=_nn.head_dtype(d))


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet152 = partial(ResNet, stage_sizes=(3, 8, 36, 3))
