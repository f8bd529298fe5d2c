"""CNN benchmark driver (``examples/cnn_benchmark_driver.py``): pick a
model by name, train on synthetic data through parallel_run, log
steps/sec (and images/sec).

    python -m parallax_tpu_torch.examples.cnn_benchmark_driver
"""

import argparse
import time

import numpy as np

import parallax_tpu_torch as parallax
from parallax_tpu_torch.models import cnn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50_v1.5",
                    choices=sorted(cnn.MODEL_REGISTRY))
    ap.add_argument("--resource_info", default=None)
    ap.add_argument("--batch_size", type=int, default=256,
                    help="global batch size")
    ap.add_argument("--image_size", type=int, default=None)
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--log_frequency", type=int, default=10)
    ap.add_argument("--run_option", default="HYBRID")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--save_ckpt_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    size = args.image_size or cnn.default_image_size(args.model)
    model = cnn.build_model(args.model, num_classes=args.num_classes,
                            image_size=size)
    sess, num_workers, worker_id, num_replicas = parallax.parallel_run(
        model, args.resource_info,
        parallax_config=parallax.Config(
            run_option=args.run_option, search_partitions=False,
            ckpt_config=parallax.CheckPointConfig(
                ckpt_dir=args.ckpt_dir,
                save_ckpt_steps=args.save_ckpt_steps)),
        device=args.device)
    print(f"model={args.model} image={size} workers={num_workers} "
          f"replicas={num_replicas}")

    rng = np.random.default_rng(worker_id)
    batches = [cnn.make_batch(rng, args.batch_size, size,
                              args.num_classes) for _ in range(4)]
    t_last, steps_done = time.perf_counter(), 0
    losses = []
    for i in range(args.max_steps):
        loss, acc, step = sess.run(["loss", "accuracy", "global_step"],
                                   feed_dict=batches[i % 4])
        steps_done += 1
        # host-side log gate: reading the lazy `step` fetch every
        # iteration would block dispatch on step t retiring
        if (i + 1) % args.log_frequency == 0:
            # materialize BEFORE reading the clock: the window must
            # cover execution, not just dispatch, of its steps
            loss_v, acc_v = float(loss), float(acc)
            now = time.perf_counter()
            sps = steps_done / (now - t_last)
            t_last, steps_done = now, 0
            losses.append(loss_v)
            print(f"step {step}: loss {loss_v:.4f} acc {acc_v:.3f}  "
                  f"{sps:.2f} steps/sec ({sps * args.batch_size:,.0f} "
                  f"images/sec)")
    sess.close()
    return losses


if __name__ == "__main__":
    main()
