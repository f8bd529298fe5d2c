"""Shape padding for fixed serving signatures (the host-feed half of
``parallax_tpu.compile.bucketing``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pad_axis0(a: np.ndarray, target: int, pad_value=0) -> np.ndarray:
    """Pad ``a`` along axis 0 up to ``target`` rows with ``pad_value``
    (sequence padding uses an explicit pad token: models mask it via
    their own pad semantics, e.g. NMT's PAD_ID -> src_valid). No-op
    when already there; refuses to truncate."""
    a = np.asarray(a)
    n = a.shape[0]
    if n == target:
        return a
    if n > target:
        raise ValueError(
            f"pad_axis0 cannot truncate: array has {n} rows, target "
            f"{target}")
    pad = np.full((target - n,) + a.shape[1:], pad_value, a.dtype)
    return np.concatenate([a, pad], axis=0)


def batch_signature(batch) -> Tuple:
    """A feed dict's shape/dtype signature, sorted by name so that
    insertion order never fakes a distinct signature. Works on numpy
    arrays and tensors alike."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))
