"""The remaining CNN-benchmark architectures
(``parallax_tpu/models/cnn_zoo.py``).

The reference's model zoo (reference: examples/tf_cnn_benchmarks/
models/): trivial, LeNet, AlexNet, VGG 11/16/19, Overfeat, GoogLeNet
(Inception-v1), Inception-v3 and DenseNet. Each is the JAX module layer
for layer, in the same order, over models/_nn.py's flax-semantics
layers, so the parameter trees have the flax paths. bf16 compute with
fp32 parameters; the flatten before the dense layers runs in NHWC
order, as flax flattens, so its width follows the image size.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Sequence

import torch

from parallax_tpu_torch.models import _nn
from parallax_tpu_torch.models._nn import Conv, Dense, avg_pool, max_pool

BF16 = torch.bfloat16


def _cat(xs):
    return torch.cat(xs, dim=1)


@dataclasses.dataclass(frozen=True)
class TrivialModel:
    """reference models/trivial_model.py: flatten -> fc."""
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        x = _nn.flatten_nhwc(x.to(self.dtype))
        x = Dense(s, x, 4096, dtype=self.dtype).relu_()
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class LeNet:
    """reference models/lenet_model.py."""
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        d = self.dtype
        x = x.to(d)
        x = Conv(s, x, 32, (5, 5), dtype=d).relu_()
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = Conv(s, x, 64, (5, 5), dtype=d).relu_()
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = _nn.flatten_nhwc(x)
        x = Dense(s, x, 512, dtype=d).relu_()
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class AlexNet:
    """reference models/alexnet_model.py."""
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        d = self.dtype
        x = x.to(d)
        x = Conv(s, x, 64, (11, 11), strides=(4, 4), padding="VALID",
                 dtype=d).relu_()
        x = max_pool(x, (3, 3), strides=(2, 2))
        x = Conv(s, x, 192, (5, 5), dtype=d).relu_()
        x = max_pool(x, (3, 3), strides=(2, 2))
        x = Conv(s, x, 384, (3, 3), dtype=d).relu_()
        x = Conv(s, x, 384, (3, 3), dtype=d).relu_()
        x = Conv(s, x, 256, (3, 3), dtype=d).relu_()
        x = max_pool(x, (3, 3), strides=(2, 2))
        x = _nn.flatten_nhwc(x)
        x = Dense(s, x, 4096, dtype=d).relu_()
        x = Dense(s, x, 4096, dtype=d).relu_()
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class VGG:
    """reference models/vgg_model.py: vgg11/16/19 by conv counts."""
    conv_counts: Sequence[int]
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        d = self.dtype
        x = x.to(d)
        for count, width in zip(self.conv_counts, (64, 128, 256, 512, 512)):
            for _ in range(count):
                x = Conv(s, x, width, (3, 3), dtype=d).relu_()
            x = max_pool(x, (2, 2), strides=(2, 2))
        x = _nn.flatten_nhwc(x)
        x = Dense(s, x, 4096, dtype=d).relu_()
        x = Dense(s, x, 4096, dtype=d).relu_()
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


VGG11 = partial(VGG, conv_counts=(1, 1, 2, 2, 2))
VGG16 = partial(VGG, conv_counts=(2, 2, 3, 3, 3))
VGG19 = partial(VGG, conv_counts=(2, 2, 4, 4, 4))


@dataclasses.dataclass(frozen=True)
class Overfeat:
    """reference models/overfeat_model.py."""
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        d = self.dtype
        x = x.to(d)
        x = Conv(s, x, 96, (11, 11), strides=(4, 4), padding="VALID",
                 dtype=d).relu_()
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = Conv(s, x, 256, (5, 5), padding="VALID", dtype=d).relu_()
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = Conv(s, x, 512, (3, 3), dtype=d).relu_()
        x = Conv(s, x, 1024, (3, 3), dtype=d).relu_()
        x = Conv(s, x, 1024, (3, 3), dtype=d).relu_()
        x = max_pool(x, (2, 2), strides=(2, 2))
        x = _nn.flatten_nhwc(x)
        x = Dense(s, x, 3072, dtype=d).relu_()
        x = Dense(s, x, 4096, dtype=d).relu_()
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class InceptionBranch:
    """A chain of conv + relu, one per ``(filters, kernel, strides,
    padding)`` spec."""
    specs: Sequence[tuple]
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        for f, k, st, p in self.specs:
            x = Conv(s, x, f, k, strides=st, padding=p,
                     dtype=self.dtype).relu_()
        return x


@dataclasses.dataclass(frozen=True)
class GoogLeNet:
    """Inception-v1 (reference models/googlenet_model.py)."""
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def inception(self, s, x, c1, c3r, c3, c5r, c5, pp):
        d = self.dtype
        one = (1, 1)
        b1 = _nn.child(s, InceptionBranch([(c1, one, one, "SAME")], d), x)
        b2 = _nn.child(s, InceptionBranch([(c3r, one, one, "SAME"),
                                           (c3, (3, 3), one, "SAME")], d), x)
        b3 = _nn.child(s, InceptionBranch([(c5r, one, one, "SAME"),
                                           (c5, (5, 5), one, "SAME")], d), x)
        b4 = max_pool(x, (3, 3), strides=one, padding="SAME")
        b4 = _nn.child(s, InceptionBranch([(pp, one, one, "SAME")], d), b4)
        return _cat([b1, b2, b3, b4])

    def __call__(self, s, x):
        d = self.dtype
        x = x.to(d)
        x = Conv(s, x, 64, (7, 7), strides=(2, 2), dtype=d).relu_()
        x = max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        x = Conv(s, x, 64, (1, 1), dtype=d).relu_()
        x = Conv(s, x, 192, (3, 3), dtype=d).relu_()
        x = max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        x = self.inception(s, x, 64, 96, 128, 16, 32, 32)
        x = self.inception(s, x, 128, 128, 192, 32, 96, 64)
        x = max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        x = self.inception(s, x, 192, 96, 208, 16, 48, 64)
        x = self.inception(s, x, 160, 112, 224, 24, 64, 64)
        x = self.inception(s, x, 128, 128, 256, 24, 64, 64)
        x = self.inception(s, x, 112, 144, 288, 32, 64, 64)
        x = self.inception(s, x, 256, 160, 320, 32, 128, 128)
        x = max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        x = self.inception(s, x, 256, 160, 320, 32, 128, 128)
        x = self.inception(s, x, 384, 192, 384, 48, 128, 128)
        x = x.mean((2, 3)).to(_nn.head_dtype(self.dtype))
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class ConvBN:
    """conv (no bias) -> BatchNorm (epsilon 1e-3) -> relu."""
    filters: int
    kernel: tuple
    strides: tuple = (1, 1)
    padding: Any = "SAME"
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        x = Conv(s, x, self.filters, self.kernel, strides=self.strides,
                 padding=self.padding, use_bias=False, dtype=self.dtype)
        return _nn.BatchNorm(s, x, momentum=0.9, epsilon=1e-3,
                             dtype=self.dtype).relu_()


@dataclasses.dataclass(frozen=True)
class InceptionV3:
    """Inception-v3 (reference models/inception_model.py): 3 blocks A,
    reduction A, 4 blocks B, reduction B, 2 blocks C; input 299x299
    (75 and up work)."""
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        d = self.dtype

        def cbn(x, *args):
            return _nn.child(s, ConvBN(*args, dtype=d), x)

        x = x.to(d)
        x = cbn(x, 32, (3, 3), (2, 2), "VALID")
        x = cbn(x, 32, (3, 3), (1, 1), "VALID")
        x = cbn(x, 64, (3, 3))
        x = max_pool(x, (3, 3), strides=(2, 2))
        x = cbn(x, 80, (1, 1), (1, 1), "VALID")
        x = cbn(x, 192, (3, 3), (1, 1), "VALID")
        x = max_pool(x, (3, 3), strides=(2, 2))

        def block_a(x, pool_f):
            b1 = cbn(x, 64, (1, 1))
            b2 = cbn(cbn(x, 48, (1, 1)), 64, (5, 5))
            b3 = cbn(cbn(cbn(x, 64, (1, 1)), 96, (3, 3)), 96, (3, 3))
            b4 = avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
            b4 = cbn(b4, pool_f, (1, 1))
            return _cat([b1, b2, b3, b4])

        x = block_a(x, 32)
        x = block_a(x, 64)
        x = block_a(x, 64)

        # reduction A
        b1 = cbn(x, 384, (3, 3), (2, 2), "VALID")
        b2 = cbn(cbn(cbn(x, 64, (1, 1)), 96, (3, 3)), 96, (3, 3), (2, 2),
                 "VALID")
        b3 = max_pool(x, (3, 3), strides=(2, 2))
        x = _cat([b1, b2, b3])

        def block_b(x, c7):
            b1 = cbn(x, 192, (1, 1))
            b2 = cbn(cbn(cbn(x, c7, (1, 1)), c7, (1, 7)), 192, (7, 1))
            b3 = cbn(x, c7, (1, 1))
            b3 = cbn(b3, c7, (7, 1))
            b3 = cbn(b3, c7, (1, 7))
            b3 = cbn(b3, c7, (7, 1))
            b3 = cbn(b3, 192, (1, 7))
            b4 = avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
            b4 = cbn(b4, 192, (1, 1))
            return _cat([b1, b2, b3, b4])

        x = block_b(x, 128)
        x = block_b(x, 160)
        x = block_b(x, 160)
        x = block_b(x, 192)

        # reduction B
        b1 = cbn(cbn(x, 192, (1, 1)), 320, (3, 3), (2, 2), "VALID")
        b2 = cbn(x, 192, (1, 1))
        b2 = cbn(b2, 192, (1, 7))
        b2 = cbn(b2, 192, (7, 1))
        b2 = cbn(b2, 192, (3, 3), (2, 2), "VALID")
        b3 = max_pool(x, (3, 3), strides=(2, 2))
        x = _cat([b1, b2, b3])

        def block_c(x):
            b1 = cbn(x, 320, (1, 1))
            b2 = cbn(x, 384, (1, 1))
            b2 = _cat([cbn(b2, 384, (1, 3)), cbn(b2, 384, (3, 1))])
            b3 = cbn(cbn(x, 448, (1, 1)), 384, (3, 3))
            b3 = _cat([cbn(b3, 384, (1, 3)), cbn(b3, 384, (3, 1))])
            b4 = avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")
            b4 = cbn(b4, 192, (1, 1))
            return _cat([b1, b2, b3, b4])

        x = block_c(x)
        x = block_c(x)
        x = x.mean((2, 3)).to(_nn.head_dtype(self.dtype))
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))


@dataclasses.dataclass(frozen=True)
class DenseNet:
    """DenseNet-121 style (reference models/densenet_model.py)."""
    stage_sizes: Sequence[int] = (6, 12, 24, 16)
    growth_rate: int = 32
    num_classes: int = 1000
    dtype: torch.dtype = BF16

    def __call__(self, s, x):
        d = self.dtype
        g = self.growth_rate

        def norm_relu(x):
            return _nn.BatchNorm(s, x, momentum=0.9, epsilon=1e-5,
                                 dtype=d).relu_()

        x = x.to(d)
        x = Conv(s, x, 2 * g, (7, 7), strides=(2, 2), use_bias=False,
                 dtype=d)
        x = norm_relu(x)
        x = max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        for i, n_blocks in enumerate(self.stage_sizes):
            for _ in range(n_blocks):
                y = norm_relu(x)
                y = Conv(s, y, 4 * g, (1, 1), use_bias=False, dtype=d)
                y = norm_relu(y)
                y = Conv(s, y, g, (3, 3), use_bias=False, dtype=d)
                x = _cat([x, y])
            if i < len(self.stage_sizes) - 1:
                x = norm_relu(x)
                x = Conv(s, x, x.shape[1] // 2, (1, 1), use_bias=False,
                         dtype=d)
                x = avg_pool(x, (2, 2), strides=(2, 2))
        x = norm_relu(x)
        x = x.mean((2, 3)).to(_nn.head_dtype(self.dtype))
        return Dense(s, x, self.num_classes,
                     dtype=_nn.head_dtype(self.dtype))
