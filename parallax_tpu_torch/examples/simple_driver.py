"""Simple linear-regression driver — the smoke-test example
(``examples/simple_driver.py``): train y = w*x + b on synthetic data from
y = 10x - 5 + noise via parallel_run, printing a converging loss.

    python -m parallax_tpu_torch.examples.simple_driver --device cpu
"""

import argparse

import numpy as np

import parallax_tpu_torch as parallax
from parallax_tpu_torch.models import simple


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--resource_info", default=None,
                    help="path to a resource_info file (host[: chip,...] "
                         "per line); default: local devices")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--run_option", default="HYBRID",
                    choices=["AR", "SHARD", "HYBRID", "MPI", "PS"])
    ap.add_argument("--trace_path", default=None,
                    help="write a chrome://tracing JSON of the host "
                         "pipeline spans at close")
    ap.add_argument("--metrics_path", default=None,
                    help="append metrics-registry snapshots as JSONL")
    ap.add_argument("--monitor_health", action="store_true",
                    help="in-graph loss-finite + grad-norm monitoring")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = simple.build_model(learning_rate=0.1)
    config = parallax.Config(run_option=args.run_option,
                             search_partitions=False,
                             trace_path=args.trace_path,
                             metrics_path=args.metrics_path,
                             monitor_health=args.monitor_health)
    sess, num_workers, worker_id, num_replicas = parallax.parallel_run(
        model, args.resource_info, sync=True, parallax_config=config,
        device=args.device)
    print(f"workers={num_workers} worker_id={worker_id} "
          f"replicas_per_worker={num_replicas}")

    rng = np.random.default_rng(worker_id)
    for i in range(args.steps):
        batch = simple.make_batch(rng, args.batch_size)
        loss, step = sess.run(["loss", "global_step"],
                              feed_dict={"x": batch["x"], "y": batch["y"]})
        # host-side log gate: reading the lazy `step` fetch every
        # iteration would block dispatch on step t retiring
        if (i + 1) % 10 == 0 or i == 0:
            print(f"step {step}: loss {loss:.6f}")
    out = sess.run(None, feed_dict=batch)
    print(f"learned w={out['w']:.3f} (true 10.0)  "
          f"b={out['b']:.3f} (true -5.0)")
    sps = sess.steps_per_sec  # None with obs disabled (PARALLAX_OBS=0)
    if sps is not None:
        print(f"steps/sec: {sps:.1f}  "
              f"(full snapshot: sess.metrics_snapshot())")
    if args.monitor_health:
        print("health:", sess.health.report())
    sess.close()


if __name__ == "__main__":
    main()
