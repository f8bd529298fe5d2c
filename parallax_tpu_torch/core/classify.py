"""Dense/sparse variable classification from one recorded forward.

The reference classifies each trainable variable by the runtime type of
its gradient — `Tensor` (dense) vs `IndexedSlices` (sparse) — and a
variable gets an IndexedSlices grad exactly when it is consumed *only*
through `tf.gather`/embedding-lookup (reference: common/runner.py:40-60).
The JAX package walks a jaxpr for the same rule (core/classify.py:1-20).

Here the loss runs once under a ``TorchFunctionMode`` that records how
every parameter tensor is consumed. The parameters are ``meta`` tensors
(shapes and dtypes, no storage, no arithmetic), the counterpart of the
JAX package's abstract trace, so a full-width model classifies at no
memory cost. A parameter is SPARSE iff every use of it is as the table
operand of a gather: ``F.embedding``'s weight, ``index_select`` on dim 0
or an integer-tensor index. Dtype casts and ``detach`` pass the
parameter through (their results are charged to it). Metadata queries
(``shape``, ``dtype``, ``size()``, ...) are not uses. Any other use
makes the parameter DENSE.

The loss draws its random numbers (sampled-softmax candidates, dropout
masks) inside, which symbolic tracing would not follow; a recorded run
does.

User override: ``Model(sparse_params=[...])`` forces paths sparse and
``Model(dense_params=[...])`` forces dense.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from parallax_tpu_torch.common.lib import parallax_log
from parallax_tpu_torch.core import specs as specs_lib

_USE_GATHER_OPERAND = "gather_operand"
_USE_OTHER = "other"

# casts and copies that forward their input's value: a gather through
# one of these still yields a row-structured gradient
_PASSTHROUGH = frozenset({
    torch.Tensor.to, torch.Tensor.float, torch.Tensor.half,
    torch.Tensor.bfloat16, torch.Tensor.double, torch.Tensor.type,
    torch.Tensor.detach, torch.Tensor.contiguous, torch.Tensor.clone,
})
# metadata queries: they read no values
_METADATA = frozenset({
    torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel,
    torch.Tensor.element_size, torch.Tensor.is_contiguous,
    torch.Tensor.data_ptr, torch.Tensor.__len__, torch.Tensor.stride,
    torch.Tensor.is_floating_point,
})


def flatten(tree, prefix: str = ""):
    """``[(path, leaf)]`` of a nested dict (lists index by position), with
    canonical 'a/b/c' paths in insertion order (the JAX package's
    ``leaf_path_names``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(flatten(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def _is_index(x) -> bool:
    return isinstance(x, torch.Tensor) and not x.is_floating_point() \
        and x.dtype != torch.bool


class _UseRecorder(TorchFunctionMode):
    """Charges each torch call's tensor operands to the parameters they
    are (or were cast from)."""

    def __init__(self, param_ids: Dict[int, str]):
        super().__init__()
        self.alias = dict(param_ids)    # id(tensor) -> parameter path
        self.keep = []                  # aliases stay alive: ids stay unique
        self.uses: Dict[str, set] = {}

    def _path(self, x):
        return self.alias.get(id(x)) if isinstance(x, torch.Tensor) \
            else None

    def _use(self, path, tag):
        self.uses.setdefault(path, set()).add(tag)

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(func, "__name__", "") == "__get__" or func in _METADATA:
            return out
        if func in _PASSTHROUGH and args and self._path(args[0]):
            if isinstance(out, torch.Tensor):
                self.alias[id(out)] = self._path(args[0])
                self.keep.append(out)
            return out
        table = None     # the operand used as a gather's table, if any
        if func is F.embedding:
            table = args[1] if len(args) > 1 else kwargs.get("weight")
        elif func in (torch.index_select, torch.Tensor.index_select) \
                and len(args) > 2 and args[1] == 0:
            table = args[0]
        elif func is torch.Tensor.__getitem__ and len(args) == 2 \
                and _is_index(args[1]):
            table = args[0]
        for x in list(args) + list(kwargs.values()):
            for leaf in (x if isinstance(x, (list, tuple)) else (x,)):
                path = self._path(leaf)
                if path is not None:
                    self._use(path, _USE_GATHER_OPERAND if leaf is table
                              else _USE_OTHER)
        return out


def classify_params(loss_fn: Callable, params, example_batch,
                    *extra_args, sparse_override: Sequence[str] = (),
                    dense_override: Sequence[str] = ()
                    ) -> Dict[str, specs_lib.VariableSpec]:
    """Return {path: VariableSpec} for every leaf of ``params``.

    ``loss_fn(params, batch, *extra_args)`` runs once while its uses of
    each parameter are recorded. Pass ``meta`` tensors as ``params``
    (and the batch on the meta device) to classify without memory."""
    flat = flatten(params)
    recorder = _UseRecorder({id(leaf): path for path, leaf in flat})
    with torch.no_grad(), recorder:
        loss_fn(params, example_batch, *extra_args)
    out: Dict[str, specs_lib.VariableSpec] = {}
    for path, leaf in flat:
        leaf_uses = recorder.uses.get(path, set())
        if path in sparse_override:
            kind, reason = specs_lib.SPARSE, "user override"
        elif path in dense_override:
            kind, reason = specs_lib.DENSE, "user override"
        elif leaf_uses == {_USE_GATHER_OPERAND}:
            kind, reason = specs_lib.SPARSE, "all uses are gather operands"
        elif _USE_GATHER_OPERAND in leaf_uses:
            kind = specs_lib.DENSE
            reason = "gathered but also used densely"
        else:
            kind, reason = specs_lib.DENSE, "no gather use"
        out[path] = specs_lib.VariableSpec(path, tuple(leaf.shape),
                                           leaf.dtype, kind, reason)
    parallax_log.info("classified %s", specs_lib.summarize(out))
    return out
