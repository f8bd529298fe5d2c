"""CNN benchmark registry and its Model adapter
(``parallax_tpu/models/cnn.py``).

The reference's model_config registry and benchmark driver (reference:
examples/tf_cnn_benchmarks/models/model_config.py and
CNNBenchmark_distributed_driver.py:50-91): named models, per-model
default image sizes, SGD with momentum 0.9 and weight decay 4e-5 on the
leaves of more than one dimension, softmax cross-entropy and an
``accuracy`` metric.

These are dense models: through ``parallel_run`` every parameter takes
the all-reduce path. A model with BatchNorm is a stateful ``Model``: its
``model_state`` is ``{"batch_stats": ...}``, the flax collection, and
its loss returns the new statistics of the step's batch.

Images arrive NHWC float32 (``make_batch``), labels int32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from parallax_tpu_torch.core import optim
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.models import _nn, cnn_zoo, resnet
from parallax_tpu_torch.ops import collectives

# name -> (module factory, default image size)
# (reference model_config.py model name -> model class mapping)
MODEL_REGISTRY: Dict[str, Tuple[Any, int]] = {
    "trivial": (cnn_zoo.TrivialModel, 224),
    "lenet": (cnn_zoo.LeNet, 28),
    "alexnet": (cnn_zoo.AlexNet, 224),
    "vgg11": (cnn_zoo.VGG11, 224),
    "vgg16": (cnn_zoo.VGG16, 224),
    "vgg19": (cnn_zoo.VGG19, 224),
    "overfeat": (cnn_zoo.Overfeat, 231),
    "googlenet": (cnn_zoo.GoogLeNet, 224),
    "inception3": (cnn_zoo.InceptionV3, 299),
    "resnet50": (lambda **kw: resnet.ResNet50(v1_5=False, **kw), 224),
    "resnet50_v1.5": (lambda **kw: resnet.ResNet50(v1_5=True, **kw), 224),
    "resnet101": (lambda **kw: resnet.ResNet101(v1_5=False, **kw), 224),
    "resnet152": (lambda **kw: resnet.ResNet152(v1_5=False, **kw), 224),
    "densenet121": (cnn_zoo.DenseNet, 224),
}


def default_image_size(name: str) -> int:
    return MODEL_REGISTRY[name][1]


def build_module(name: str, num_classes: int = 1000,
                 image_size: Optional[int] = None):
    """``(module, image size)`` of a registry name."""
    if name not in MODEL_REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(MODEL_REGISTRY)}")
    factory, default_size = MODEL_REGISTRY[name]
    return factory(num_classes=num_classes), image_size or default_size


def build_model(name: str, num_classes: int = 1000,
                image_size: Optional[int] = None,
                learning_rate: float = 0.1, momentum: float = 0.9,
                weight_decay: float = 4e-5) -> Model:
    """A registry architecture as a Model. weight_decay=4e-5 is the
    reference benchmark's default (tf_cnn_benchmarks flags)."""
    module, size = build_module(name, num_classes, image_size)
    return module_model(module, size, learning_rate, momentum, weight_decay)


def loss_and_accuracy(logits, labels):
    """Mean softmax cross-entropy of fp32 logits against integer labels
    (optax.softmax_cross_entropy_with_integer_labels) and the top-1
    accuracy. Where the step's batch is split over more than one rank
    (equal shares) both are the global batch's, as the JAX loss over the
    global array (``collectives.global_sum``: the gradient stays the
    rank's own mean's)."""
    labels = labels.long()
    ce = F.cross_entropy(logits.to(_nn.head_dtype(logits.dtype)), labels)
    acc = (logits.argmax(-1) == labels).float().mean()
    mesh = collectives.current_mesh()
    group = collectives.batch_group(mesh) if mesh is not None else None
    if group is not None and group.size > 1:
        ce = collectives.global_sum(ce) / group.size
        acc = collectives.global_sum(acc) / group.size
    return ce, acc


def module_model(module, image_size: int, learning_rate: float = 0.1,
                 momentum: float = 0.9, weight_decay: float = 4e-5) -> Model:
    """``build_model`` for a module outside the registry (a ResNet of
    other stage sizes, another dtype)."""
    # BatchNorm statistics make the model stateful; the shapes alone
    # (meta tensors) tell
    _, meta_stats = _nn.init(module, torch.Generator(), "meta", image_size)
    stateful = bool(meta_stats)

    def init_fn(gen, device):
        params, stats = _nn.init(module, gen, device, image_size)
        if stateful:
            return params, {"batch_stats": stats}
        return params

    if stateful:
        def loss_fn(params, model_state, batch, gen):
            logits, new_stats = _nn.apply(
                module, params, model_state["batch_stats"], batch["images"])
            loss, acc = loss_and_accuracy(logits, batch["labels"])
            return loss, {"accuracy": acc}, {"batch_stats": new_stats}
    else:
        def loss_fn(params, batch, gen):
            logits, _ = _nn.apply(module, params, {}, batch["images"])
            loss, acc = loss_and_accuracy(logits, batch["labels"])
            return loss, {"accuracy": acc}

    tx = optim.chain(
        optim.add_decayed_weights(
            weight_decay, mask=lambda p: {k: v.dim() > 1
                                          for k, v in p.items()}),
        optim.sgd(learning_rate, momentum=momentum))
    return Model(init_fn, loss_fn, optimizer=tx, stateful=stateful)


def make_batch(rng: np.random.Generator, batch_size: int, image_size: int,
               num_classes: int = 1000):
    """Synthetic ImageNet-like batch (the reference benchmark's
    --data_name=synthetic mode)."""
    return {
        "images": rng.standard_normal(
            (batch_size, image_size, image_size, 3)).astype(np.float32),
        "labels": rng.integers(0, num_classes,
                               (batch_size,)).astype(np.int32),
    }
