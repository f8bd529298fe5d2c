"""Flax-semantics layers over plain tensors, for the CNN models.

The JAX package writes its CNNs as flax linen modules (``nn.Conv``,
``nn.BatchNorm``, ``nn.Dense``, ``nn.max_pool``, ``nn.avg_pool``). The
functions here compute what those compute:

* ``conv``: flax's ``SAME`` padding puts the odd pixel on the high side
  (stride 2, 3x3 on an even map pads (0, 1)), where ``nn.Conv2d`` and
  ``MaxPool2d`` pad (1, 1). An asymmetric pad is made explicit
  (``F.pad``: zeros for conv and average pool, -inf for max pool) and
  the op then runs unpadded;
* ``avg_pool`` counts the padded zeros (flax's ``count_include_pad``);
* ``batch_norm`` normalises in fp32 with the *biased* batch variance
  and returns the new running statistics as flax updates them,
  ``ra = momentum * ra + (1 - momentum) * stat``.

Activations are NCHW-shaped tensors in ``channels_last`` memory (NHWC
bytes, as the images arrive); conv weights are OIHW, also stored
``channels_last``, so cuDNN sees one layout and inserts no transposes.
Dense weights are ``[in, out]``, applied as ``x @ w``. Parameters and
statistics are fp32; each layer casts its operands to its compute dtype.

``Scope`` gives the layers flax's variable names (``Conv_0``,
``BatchNorm_1``, explicit names such as ``conv_init``), so a model's
parameter tree has the JAX tree's paths. ``init`` builds the trees by
running the forward once on meta tensors while each variable is drawn
on the target device; ``apply`` runs it on a batch.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]

# flax's truncated normal draws in [-2, 2] standard deviations and
# rescales by the truncated distribution's own deviation
_TRUNC_STD = 0.87962566103423978


# -- initialisers -------------------------------------------------------------


def lecun_normal(fan_in: int):
    """flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``: a normal truncated at two deviations with
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD

    def init(t, gen):
        return torch.nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                           generator=gen)

    return init


def ones(t, gen):
    return t.fill_(1.0)


def zeros(t, gen):
    return t.zero_()


# -- functions on tensors ----------------------------------------------------


def pads(padding: Padding, in_hw, window, strides):
    """``[(lo, hi), (lo, hi)]`` for H and W, as flax resolves
    ``padding``: ``"SAME"`` pads ``max((ceil(n/s) - 1) * s + k - n, 0)``
    with the odd pixel high, ``"VALID"`` nothing, a sequence of pairs as
    given."""
    if padding == "SAME":
        out = []
        for n, k, s in zip(in_hw, window, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return out
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    if isinstance(padding, str):
        raise ValueError(f"padding {padding!r} is not supported")
    return [tuple(p) for p in padding]


def _explicit(x, pad, value: float):
    """``(x, torch_padding)``: x padded by ``F.pad`` when ``pad`` is not
    the same on both sides, so that the op runs with the returned
    symmetric padding."""
    (hl, hh), (wl, wh) = pad
    if hl == hh and wl == wh:
        return x, (hl, wl)
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv(x, w, b=None, strides=(1, 1), padding: Padding = "SAME",
         dtype: Optional[torch.dtype] = None):
    """``nn.Conv``: x [N, C, H, W], w [O, C, kh, kw], operands cast to
    ``dtype``."""
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    x, pad = _explicit(x, pads(padding, x.shape[2:], w.shape[2:], strides),
                       0.0)
    return F.conv2d(x, w, b, tuple(strides), pad)


def max_pool(x, window, strides, padding: Padding = "VALID"):
    """``nn.max_pool`` (padding with -inf; flax's default is VALID)."""
    x, pad = _explicit(x, pads(padding, x.shape[2:], window, strides),
                       -math.inf)
    return F.max_pool2d(x, tuple(window), tuple(strides), pad)


def avg_pool(x, window, strides, padding: Padding = "VALID"):
    """``nn.avg_pool`` with its default ``count_include_pad=True``: the
    window's sum over its full size, padded zeros included."""
    x, pad = _explicit(x, pads(padding, x.shape[2:], window, strides), 0.0)
    return F.avg_pool2d(x, tuple(window), tuple(strides), pad,
                        count_include_pad=True)


def dense(x, w, b, dtype: torch.dtype):
    """``nn.Dense``: ``x @ w + b`` with w [in, out], operands cast to
    ``dtype``."""
    return torch.addmm(b.to(dtype), x.to(dtype), w.to(dtype))


def batch_norm(x, scale, bias, mean, var, train: bool, momentum: float,
               eps: float):
    """``nn.BatchNorm`` over N, H, W: ``(y, new_mean, new_var)``.

    In training it normalises by the batch's mean and biased variance,
    in fp32 whatever x's dtype, and y has x's dtype. ``F.batch_norm``
    writes the batch's own statistics into zeroed buffers (momentum 1;
    the variance it stores is unbiased, so it is scaled back by
    (n - 1) / n); the new running statistics are formed from them
    without gradient, and ``mean`` and ``var`` are left as they were.
    Out of training it normalises by ``mean`` and ``var`` and returns
    them."""
    if not train:
        return (F.batch_norm(x, mean, var, scale, bias, False, 0.0, eps),
                mean, var)
    n = x.numel() // x.shape[1]
    if n == 1:    # F.batch_norm refuses one value per channel
        return _batch_norm_one(x, scale, bias, mean, var, momentum, eps)
    batch = torch.zeros((2,) + mean.shape, dtype=mean.dtype,
                        device=mean.device)
    y = F.batch_norm(x, batch[0], batch[1], scale, bias, True, 1.0, eps)
    with torch.no_grad():
        new_mean = torch.add(mean * momentum, batch[0], alpha=1 - momentum)
        new_var = torch.add(var * momentum, batch[1],
                            alpha=(1 - momentum) * (n - 1) / n)
    return y, new_mean, new_var


def _batch_norm_one(x, scale, bias, mean, var, momentum, eps):
    """One value per channel: the batch mean is x itself and the
    variance 0, so y is the bias (and x and scale get no gradient)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (xf - xf) * (scale / math.sqrt(eps)).view(shape) + bias.view(shape)
    with torch.no_grad():
        new_mean = torch.add(mean * momentum, xf.reshape(mean.shape),
                             alpha=1 - momentum)
        new_var = var * momentum
    return y.to(x.dtype), new_mean, new_var


def head_dtype(dtype: torch.dtype) -> torch.dtype:
    """The classifier head's dtype: fp32 as in the flax modules, or
    float64 for a model that computes in float64."""
    return torch.promote_types(dtype, torch.float32)


def flatten_nhwc(x):
    """[N, C, H, W] -> [N, H*W*C], in flax's NHWC order (the dense
    layer's rows follow it)."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


# -- variable scopes -----------------------------------------------------------


class Scope:
    """One module's part of the ``params`` and ``batch_stats`` trees.

    ``child(kind, name)`` is the scope of a submodule: ``name``, or
    ``{kind}_{n}`` for the n-th unnamed ``kind`` here, as flax names
    them. While initialising (``init`` is ``(gen, device)``), ``param``
    and ``stat`` draw the variable on the device, store it and return it
    as a meta tensor, so the forward that builds the trees computes
    nothing. While applying, they read the trees, and ``set_stat``
    writes the new statistics into ``new_stats``."""

    def __init__(self, params, stats, new_stats, train: bool, init=None):
        self.params = params
        self.stats = stats
        self.new_stats = new_stats
        self.train = train
        self._init = init
        self._counts = {}

    def child(self, kind: str, name: Optional[str] = None) -> "Scope":
        if name is None:
            n = self._counts.get(kind, 0)
            self._counts[kind] = n + 1
            name = f"{kind}_{n}"
        if self._init is not None:
            params = self.params.setdefault(name, {})
            stats = self.stats.setdefault(name, {})
        else:
            params = self.params[name]
            stats = self.stats.get(name, {})
        return Scope(params, stats, self.new_stats.setdefault(name, {}),
                     self.train, self._init)

    def _make(self, tree, name, shape, fill, memory_format):
        gen, device = self._init
        t = fill(torch.empty(shape, dtype=torch.float32, device=device,
                             memory_format=memory_format), gen)
        tree[name] = t
        return t if t.device.type == "meta" else t.to("meta")

    def param(self, name: str, shape, init, channels_last: bool = False):
        if self._init is None:
            return self.params[name]
        return self._make(self.params, name, shape, init,
                          torch.channels_last if channels_last
                          else torch.contiguous_format)

    def stat(self, name: str, shape, init):
        if self._init is None:
            return self.stats[name]
        return self._make(self.stats, name, shape, init,
                          torch.contiguous_format)

    def set_stat(self, name: str, value) -> None:
        self.new_stats[name] = value


def _pruned(tree):
    """``tree`` without the empty dicts of modules that hold nothing."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _pruned(v)
            if not v:
                continue
        out[k] = v
    return out


def init(module, gen: torch.Generator, device, image_size: int):
    """``(params, batch_stats)`` of ``module`` for NHWC images of
    ``image_size``, drawn from ``gen`` on ``device`` in the order the
    forward asks for them."""
    params, stats = {}, {}
    scope = Scope(params, stats, {}, True, (gen, torch.device(device)))
    x = torch.empty((1, image_size, image_size, 3), device="meta")
    module(scope, x.permute(0, 3, 1, 2))
    return _pruned(params), _pruned(stats)


def apply(module, params, stats, images, train: bool = True):
    """``(logits, new_batch_stats)`` of ``module`` on NHWC ``images``;
    out of training the statistics come back as they were."""
    new_stats = {}
    logits = module(Scope(params, stats, new_stats, train),
                    images.permute(0, 3, 1, 2))
    return logits, (_pruned(new_stats) if train else stats)


# -- layers ------------------------------------------------------------------


def Conv(s: Scope, x, features: int, kernel_size, strides=(1, 1),
         padding: Padding = "SAME", use_bias: bool = True,
         dtype: torch.dtype = torch.bfloat16, name: Optional[str] = None):
    """``nn.Conv``: an OIHW ``kernel`` (flax's HWIO transposed), a
    ``bias`` of zeros."""
    c = s.child("Conv", name)
    kh, kw = kernel_size
    cin = x.shape[1]
    w = c.param("kernel", (features, cin, kh, kw),
                lecun_normal(cin * kh * kw), channels_last=True)
    b = c.param("bias", (features,), zeros) if use_bias else None
    return conv(x, w, b, strides, padding, dtype)


def BatchNorm(s: Scope, x, momentum: float = 0.9, epsilon: float = 1e-5,
              dtype: torch.dtype = torch.bfloat16, scale_init=ones,
              name: Optional[str] = None):
    """``nn.BatchNorm`` with fp32 ``scale``, ``bias`` and statistics;
    the output is cast to ``dtype``."""
    c = s.child("BatchNorm", name)
    ch = (x.shape[1],)
    scale = c.param("scale", ch, scale_init)
    bias = c.param("bias", ch, zeros)
    mean = c.stat("mean", ch, zeros)
    var = c.stat("var", ch, ones)
    y, new_mean, new_var = batch_norm(x, scale, bias, mean, var, s.train,
                                      momentum, epsilon)
    c.set_stat("mean", new_mean)
    c.set_stat("var", new_var)
    return y.to(dtype)


def Dense(s: Scope, x, features: int, dtype: torch.dtype = torch.bfloat16,
          name: Optional[str] = None):
    """``nn.Dense``: an ``[in, out]`` ``kernel``, a ``bias`` of zeros."""
    c = s.child("Dense", name)
    w = c.param("kernel", (x.shape[1], features), lecun_normal(x.shape[1]))
    b = c.param("bias", (features,), zeros)
    return dense(x, w, b, dtype)


def child(s: Scope, module, x, name: Optional[str] = None):
    """Run a submodule object in its own scope, named after its class."""
    return module(s.child(type(module).__name__, name), x)
