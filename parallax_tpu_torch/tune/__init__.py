"""The mesh auto-tuner (``parallax_tpu/tune/``): a cost-model-driven
search over mesh shapes and run options.

The paper's core contribution is choosing the parallelization strategy
(AllReduce vs PS vs HYBRID) for an unmodified single-device program.
``parallel/partitions.py`` keeps the reference's 1-D partition-count
search; this package searches the ``(dp x tp [x pp])`` mesh crossed with
``run_option in {AR, SHARD, HYBRID}`` and prices it analytically, so
only a top-k shortlist pays a measured trial:

* ``costmodel`` — prices a candidate :class:`~parallax_tpu_torch.tune.
  costmodel.Plan` from one probe engine's counts (its step's FLOPs and
  bytes on meta tensors, the dense-vs-sparse wire split of its plan, the
  kernels' byte models, the card's peak) into a predicted step time
  with a per-term compute / HBM / interconnect breakdown.
* ``search`` — :class:`~parallax_tpu_torch.tune.search.MeshSearch`:
  enumerate the plans, prune equivalents, shortlist by predicted time
  (screened by the OOM preflight), and send the ``top_k`` candidates to
  measured trials, which ``ParallaxSession`` drives through its engine
  cache.
* ``calibrate`` — per-term predicted/measured ratios from a profiled
  window, in the JAX package's file format.

Enable with ``Config(tune_config=TuneConfig(...))``; ``PartitionSearch``
stays the ``tune_config=None`` path.
"""

from parallax_tpu_torch.common.config import TuneConfig
from parallax_tpu_torch.tune import calibrate
from parallax_tpu_torch.tune.costmodel import (CostInputs, Plan, PlanCost,
                                               inputs_from_engine, predict,
                                               wire_summary)
from parallax_tpu_torch.tune.search import (MeshSearch, emittable_plans,
                                            enumerate_plans)

__all__ = [
    "TuneConfig", "Plan", "PlanCost", "CostInputs", "predict",
    "inputs_from_engine", "wire_summary", "MeshSearch",
    "enumerate_plans", "emittable_plans", "calibrate",
]
