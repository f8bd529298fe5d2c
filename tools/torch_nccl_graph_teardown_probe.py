"""Does a live CUDA graph that recorded an NCCL collective block
``destroy_process_group``?

Spawns one rank per card (four by default) twice. Each rank joins an
NCCL group, captures a graph holding one ``all_reduce`` and replays it;
in the ``alive`` arm the graph is still referenced when the rank calls
``destroy_process_group()``, in the ``released`` arm it was reset just
before. A rank still inside ``destroy_process_group`` after
``--deadline`` seconds dumps its stacks and exits with code 1
(``faulthandler``), so neither arm can hang. Prints one JSON line a arm:
the ranks' exit codes and the seconds each teardown took.

    python tools/torch_nccl_graph_teardown_probe.py [--world 4]
"""

from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import multiprocessing
import os
import socket
import sys
import time


def _rank(rank, world, port, arm, deadline, out_dir):
    import torch
    torch.cuda.set_device(rank)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    x = torch.ones(1024, device="cuda")
    torch.distributed.all_reduce(x)           # the communicator exists
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        torch.distributed.all_reduce(x)
    g.replay()
    torch.cuda.synchronize()
    if arm == "released":
        g.reset()
    faulthandler.dump_traceback_later(deadline, exit=True)
    t0 = time.perf_counter()
    torch.distributed.destroy_process_group()
    seconds = time.perf_counter() - t0
    faulthandler.cancel_dump_traceback_later()
    with open(os.path.join(out_dir, f"{arm}{rank}.json"), "w") as f:
        json.dump({"seconds": seconds, "x0": float(x[0])}, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--out_dir", default="chiprun_out/nccl_graph_teardown")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    for arm in ("released", "alive"):
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(
            r, args.world, port, arm, args.deadline, args.out_dir))
            for r in range(args.world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(args.deadline + 120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        seconds = []
        for r in range(args.world):
            path = os.path.join(args.out_dir, f"{arm}{r}.json")
            seconds.append(json.load(open(path))["seconds"]
                           if os.path.exists(path) else None)
        print(json.dumps({"arm": arm, "exit_codes": [p.exitcode
                                                     for p in procs],
                          "teardown_s": seconds,
                          "returned": all(s is not None for s in seconds)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
