"""`parallel_run` — the single entry point (``parallax_tpu/runner.py``).

Reference: common/runner.py:139-193 — the user hands over an unmodified
single-device model plus a resource file and gets back
``(sess, num_workers, worker_id, num_replicas_per_worker)``:

    sess, num_workers, worker_id, num_replicas = parallel_run(
        model, parallax_config=Config(run_option="HYBRID",
                                      sparse_grad_mode="slices"))
    loss = sess.run("loss", feed_dict=batch)

This slice runs one process on one card, so it returns ``(sess, 1, 0,
1)``. A resource file that names more than one host, a partition count
above 1 and ``sync=False`` raise ``NotImplementedError`` until the
multi-rank slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import parallax_log, parse_resource_info
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.session import ParallaxSession


def parallel_run(model: Model,
                 resource_info: Optional[str] = None,
                 sync: bool = True,
                 parallax_config: Optional[ParallaxConfig] = None,
                 seed: int = 0,
                 num_partitions: Optional[int] = None,
                 device="cuda") -> Tuple[ParallaxSession, int, int, int]:
    """Build the session for ``model`` on ``device`` (the card unless the
    caller asks for the CPU)."""
    config = parallax_config or ParallaxConfig()
    config.set_sync(sync)
    if not sync:
        raise NotImplementedError(
            "sync=False (bounded-staleness delayed-gradient training) is "
            "not ported; pass sync=True")
    hosts = parse_resource_info(resource_info)
    if len(hosts) > 1:
        raise NotImplementedError(
            f"resource_info names {len(hosts)} hosts; multi-rank training "
            f"is not ported (one process on one card)")
    config.set_resource_info(hosts)
    if num_partitions not in (None, 1):
        raise NotImplementedError(
            f"num_partitions={num_partitions}: one card holds one shard")
    sess = ParallaxSession(model, config, num_workers=1, worker_id=0,
                           num_replicas_per_worker=1, seed=seed,
                           device=device)
    parallax_log.info("parallel_run ready: 1 worker, 1 replica on %s, "
                      "run_option=%s", device, config.run_option)
    return sess, 1, 0, 1
