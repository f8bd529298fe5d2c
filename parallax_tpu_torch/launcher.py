"""Local multi-rank launch: one process per (host, chip) of this machine
(the local part of ``parallax_tpu/launcher.py``).

``parallel_run`` on the master re-runs the user's own script once per
rank, with the rank, the world size, the rank's chip, the serialized
resource spec and a rendezvous in each process's environment (the
reference injects ``PARALLAX_*`` the same way, runner.py:139-193), waits
for them and exits with their return code: the first non-zero one, as
soon as any rank fails, after stopping the rest. Each worker joins the
process group with ``init_worker_distributed`` (NCCL on its card, gloo
on the CPU), with a timeout, so a rank that dies cannot leave the others
waiting forever.

Not ported: the ssh launch of remote hosts and elastic restart.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence, Tuple

import torch

from parallax_tpu_torch.common import consts
from parallax_tpu_torch.common.lib import (HostInfo, parallax_log,
                                           serialize_resource_info)


def dist_timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=float(os.environ.get(
        consts.PARALLAX_DIST_TIMEOUT, consts.DIST_TIMEOUT_DEFAULT_S)))


def launch_workers(hosts: Sequence[HostInfo],
                   layout: List[Tuple[str, int]]) -> int:
    """Start one worker per rank of ``layout`` (``[(host, chip)]``, all
    on this machine), each re-running ``sys.argv`` under this Python;
    return the first non-zero exit code (0 when every rank succeeded).
    A failing rank stops the others."""
    rdv_dir = tempfile.mkdtemp(prefix="parallax_rdv_")
    rendezvous = "file://" + os.path.join(rdv_dir, "store")
    serialized = serialize_resource_info(hosts)
    procs = []
    for rank, (host, chip) in enumerate(layout):
        env = dict(os.environ)
        env.update({consts.PARALLAX_RUN_OPTION: "WORKER",
                    consts.PARALLAX_RANK: str(rank),
                    consts.PARALLAX_WORLD_SIZE: str(len(layout)),
                    consts.PARALLAX_LOCAL_CHIP: str(chip),
                    consts.PARALLAX_RESOURCE_INFO: serialized,
                    consts.PARALLAX_RENDEZVOUS: rendezvous})
        parallax_log.info("launching rank %d on %s chip %d", rank, host,
                          chip)
        procs.append(subprocess.Popen([sys.executable] + sys.argv,
                                      env=env))
    rc = 0
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                rc = bad[0]
                parallax_log.error("a rank exited with %d; stopping the "
                                   "others", rc)
                break
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    except KeyboardInterrupt:
        rc = 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        try:
            for name in os.listdir(rdv_dir):
                os.remove(os.path.join(rdv_dir, name))
            os.rmdir(rdv_dir)
        except OSError:
            pass
    return rc


def init_worker_distributed(device_type: str) -> Tuple[int, int, int]:
    """Join the process group from the launcher's environment: NCCL on
    ``cuda:<chip>`` (made the current device), gloo on the CPU. Returns
    (rank, world size, chip). A process group the caller already
    initialised is used as it is."""
    rank = int(os.environ[consts.PARALLAX_RANK])
    world = int(os.environ[consts.PARALLAX_WORLD_SIZE])
    chip = int(os.environ.get(consts.PARALLAX_LOCAL_CHIP, "0"))
    dist = torch.distributed
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), chip
    if device_type == "cuda":
        torch.cuda.set_device(chip)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=os.environ[consts.PARALLAX_RENDEZVOUS],
        rank=rank, world_size=world, timeout=dist_timeout())
    parallax_log.info("rank %d of %d joined the %s process group", rank,
                      world, backend)
    return rank, world, chip
