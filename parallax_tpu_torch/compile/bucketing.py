"""Batch-shape bucketing: pad ragged batches onto a fixed signature set
(``parallax_tpu.compile.bucketing``).

Every distinct batch-shape signature the engine sees costs one capture
of the step as a CUDA graph (the counterpart of one XLA compile). A
training stream is ragged in practice (the last partial batch of
``run_iter``, a pipeline that rebatches, an eval loop with a leftover
tail), and each ragged size is captured anew while the loop looks
healthy (the ``engine.recompiles`` counter). Bucketing bounds the
signature set: every batch is padded up to the smallest declared bucket
that fits, and a per-example weight mask is threaded into the loss so
the padded tail contributes nothing.

Mask contract (``ParallaxConfig.bucket_mask_feed``, default ``"w"``):

* when the feed already exists (the lm1b ``"w"`` per-token weights, any
  per-example weight array), its padded rows are **zeroed**: a loss
  normalized by the weight sum (``sum(loss*w)/sum(w)``) is then exactly
  the unpadded batch's loss;
* when the feed is absent, a fresh ``[bucket]`` float32 mask (ones for
  real rows, zeros for padding) is **added** under that name on every
  batch, full ones included, so the feed structure (and with it the
  signature) stays stable. Models that consume it get loss-exact padded
  tails; models that ignore it stop recapturing all the same but
  average the padded rows into the loss.

Full batches (size already a bucket) pass through **unmodified** when
the mask feed exists. Padding replicates the last real example (edge
mode) rather than writing zeros: a zero-stuffed example can give NaN or
inf inside the loss (log(0), division), and ``0 * nan`` is ``nan``;
edge rows are finite for finite data and their masked contribution is
exactly zero.

Batches larger than every declared bucket pass through unchanged (one
warning): they keep their own signature, as without bucketing.

Numpy only: it runs on host feeds before they are copied to the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from parallax_tpu_torch.common.lib import parallax_log

BucketsArg = Union[None, str, Sequence[int]]

_warned_oversize: set = set()


def resolve_buckets(shape_buckets: BucketsArg, example_batch_dim: int,
                    local_divisor: int = 1) -> Optional[Tuple[int, ...]]:
    """Validate ``Config.shape_buckets`` into an ascending size tuple.

    ``"auto"`` resolves to the example batch's leading dim: a stream of
    one batch size with a ragged tail then maps every batch onto one
    signature. Every bucket must divide evenly over the local devices
    (``local_divisor``; one card is 1)."""
    if shape_buckets is None:
        return None
    if isinstance(shape_buckets, str):
        if shape_buckets != "auto":
            raise ValueError(
                f"shape_buckets must be 'auto' or a sequence of batch "
                f"sizes, got {shape_buckets!r}")
        buckets = (int(example_batch_dim),)
    else:
        buckets = tuple(sorted({int(b) for b in shape_buckets}))
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(
                f"shape_buckets must be positive batch sizes, got "
                f"{shape_buckets!r}")
    bad = [b for b in buckets if b % local_divisor != 0]
    if bad:
        raise ValueError(
            f"shape_buckets {bad} not divisible by the {local_divisor} "
            f"local device(s); every bucketed batch must still shard "
            f"evenly on dim 0")
    return buckets


def _leading_dim(batch: Dict) -> Optional[int]:
    for v in batch.values():
        shape = np.shape(v)
        if len(shape) >= 1:
            return int(shape[0])
    return None


def bucket_batch(batch: Dict, buckets: Sequence[int],
                 mask_feed: str = "w") -> Tuple[Dict, Optional[int]]:
    """Pad ``batch`` up to its bucket; returns ``(batch, bucket)``.

    ``bucket`` is None when no declared bucket fits (the batch passes
    through unchanged and keeps its own signature). Feeds whose leading
    dim differs from the batch dim (scalars, constants) pass through
    untouched. See the module docstring for the mask contract."""
    B = _leading_dim(batch)
    if B is None:
        return batch, None
    if B == 0:
        # padding an empty batch would mix 0-row data feeds with a
        # bucket-row mask: an empty batch is an upstream bug
        raise ValueError(
            "bucket_batch got an empty batch (leading dim 0); fix the "
            "producing iterator (e.g. a drop-last off-by-one)")
    bucket = next((b for b in buckets if b >= B), None)
    if bucket is None:
        key = (B, tuple(buckets))
        if key not in _warned_oversize:
            _warned_oversize.add(key)
            parallax_log.warning(
                "batch size %d exceeds every shape bucket %s; passing "
                "through unbucketed (this size keeps its own captured "
                "signature; add a larger bucket to cover it)", B,
                tuple(buckets))
        if mask_feed not in batch:
            # keep the feed structure stable off-bucket too: a model
            # consuming the added mask must not KeyError on it
            batch = dict(batch)
            batch[mask_feed] = np.ones((B,), np.float32)
        return batch, None
    pad = bucket - B
    if pad and mask_feed in batch \
            and np.shape(batch[mask_feed])[:1] != (B,):
        # a mask feed the pad loop below cannot zero would silently
        # train the padded rows at full weight
        raise ValueError(
            f"bucket_mask_feed {mask_feed!r} has shape "
            f"{np.shape(batch[mask_feed])} whose leading dim is not "
            f"the batch dim ({B}); its padded rows cannot be zeroed. "
            f"Feed a [batch, ...]-leading weight array (or set "
            f"bucket_mask_feed to an unused name to get a fresh "
            f"[bucket] mask)")
    if pad == 0 and mask_feed in batch:
        return batch, bucket
    out = {}
    for name, v in batch.items():
        a = np.asarray(v)
        if pad and a.ndim >= 1 and a.shape[0] == B:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            if name == mask_feed:
                a[B:] = 0  # the concatenation is fresh: safe to write
        out[name] = a
    if mask_feed not in out:
        mask = np.ones((bucket,), np.float32)
        mask[B:] = 0.0
        out[mask_feed] = mask
    return out, bucket


def length_bucket(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest declared bucket >= ``n`` (None when nothing fits): the
    length analogue of ``bucket_batch``'s batch-dim rule."""
    return next((int(b) for b in sorted(buckets) if b >= n), None)


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
    """A feed dict's shape/dtype signature (the key of the engine's
    captured graphs), sorted by name so that insertion order never fakes
    a distinct signature. Works on numpy arrays, tensors and ``_Aval``s
    alike; a numpy and a torch dtype print differently, so one engine
    keys every batch in one of them (torch, after placement)."""
    return tuple(sorted(
        (k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))


def bucket_shape(shape: Tuple[int, ...], example_batch_dim: int,
                 b: int, process_scale: int = 1) -> Tuple[int, ...]:
    """The shape of one feed leaf under bucket ``b``: batch-leading dims
    re-size to the bucket; every leading dim scales by ``process_scale``
    (the number of processes the feed's dim-0 placement spans; 1 on one
    card). The one shape rule shared by warmup's static inputs and the
    pre-registered signatures (``bucket_signatures``): the two must
    agree or pre-registered signatures never match real steps."""
    if len(shape) >= 1 and shape[0] == example_batch_dim:
        return (b * process_scale,) + tuple(shape[1:])
    if len(shape) >= 1 and process_scale > 1:
        return (shape[0] * process_scale,) + tuple(shape[1:])
    return tuple(shape)


def bucket_signatures(batch_shapes: Dict, example_batch_dim: int,
                      buckets: Sequence[int],
                      process_scale=1) -> List[Tuple]:
    """The signature each declared bucket will present.

    ``batch_shapes`` is the (bucketed) example batch's shape tree
    (anything with ``shape`` and ``dtype``); leaves re-size per bucket
    under ``bucket_shape``. ``process_scale``: an int, or a callable
    ``name -> int`` for per-feed spans."""
    sigs = []
    for b in buckets:
        swapped = {
            name: _Aval(bucket_shape(
                tuple(leaf.shape), example_batch_dim, b,
                process_scale(name) if callable(process_scale)
                else process_scale), leaf.dtype)
            for name, leaf in batch_shapes.items()}
        sigs.append(batch_signature(swapped))
    return sigs


class _Aval:
    """Minimal shape/dtype carrier for signature derivation."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype
