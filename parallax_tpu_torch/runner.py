"""`parallel_run` — the single entry point (``parallax_tpu/runner.py``).

Reference: common/runner.py:139-193 — the user hands over an unmodified
single-device model plus a resource spec and gets back
``(sess, num_workers, worker_id, num_replicas_per_worker)``:

    sess, num_workers, worker_id, num_replicas = parallel_run(
        model, resource_info="localhost:0,1,2,3",
        parallax_config=Config(run_option="HYBRID",
                               sparse_grad_mode="slices"))
    loss = sess.run("loss", feed_dict=my_share_of_the_batch)

Each rank is one process on one card (one process on the CPU). On the
master, a spec naming more than one local chip starts one worker per
chip, each re-running the calling script (launcher.py), and exits with
their return code, as the reference master does. A worker joins the
process group (NCCL on its card, gloo with ``device="cpu"``) and returns
``(sess, world size, rank, 1)``; each rank feeds its own share of the
global batch. With no spec, or one chip, the master runs alone.
``num_partitions`` is the shard-axis width, snapped to a divisor of the
rank count. Hosts other than this one raise ``NotImplementedError``
(the ssh launcher and elastic restart are not ported).
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import torch

from parallax_tpu_torch import launcher, shard as shard_lib
from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.config import ParallaxConfig
from parallax_tpu_torch.common.lib import (deserialize_resource_info,
                                           parallax_log,
                                           parse_resource_info,
                                           rank_layout, resolve_device)
from parallax_tpu_torch.core.engine import Model
from parallax_tpu_torch.session import ParallaxSession


def parallel_run(model: Model,
                 resource_info: Optional[str] = None,
                 sync: bool = True,
                 parallax_config: Optional[ParallaxConfig] = None,
                 seed: int = 0,
                 num_partitions: Optional[int] = None,
                 device="cuda") -> Tuple[ParallaxSession, int, int, int]:
    """Build this rank's session for ``model`` on ``device`` (the card
    unless the caller asks for the CPU); on the master of several local
    chips, start the ranks and exit with their return code."""
    config = parallax_config or ParallaxConfig()
    config.set_sync(sync)
    dev_type = torch.device(device).type
    if os.environ.get(consts.PARALLAX_RUN_OPTION) == "WORKER":
        hosts = deserialize_resource_info(
            os.environ[consts.PARALLAX_RESOURCE_INFO])
        config.set_resource_info(hosts)
        rank, world, chip = launcher.init_worker_distributed(dev_type)
        if dev_type == "cuda":
            device = torch.device("cuda", chip)
    else:
        hosts = parse_resource_info(resource_info)
        config.set_resource_info(hosts)
        layout = rank_layout(hosts, dev_type) \
            if resource_info is not None else [("localhost", 0)]
        if len(layout) > 1:
            sys.exit(launcher.launch_workers(hosts, layout))
        dist = torch.distributed
        on = dist.is_available() and dist.is_initialized()
        rank, world = (dist.get_rank(), dist.get_world_size()) if on \
            else (0, 1)
    resolve_device(device)
    shard_lib._install(world, rank)
    sess = ParallaxSession(model, config, num_workers=world,
                           worker_id=rank, num_replicas_per_worker=1,
                           seed=seed, device=device,
                           num_partitions=num_partitions)
    parallax_log.info("parallel_run ready: rank %d of %d on %s, "
                      "run_option=%s", rank, world, device,
                      config.run_option)
    return sess, world, rank, 1
