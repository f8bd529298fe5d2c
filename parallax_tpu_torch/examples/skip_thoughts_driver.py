"""Skip-thoughts driver (``examples/skip_thoughts_driver.py``):
file-level data sharding with ``shard.create_num_shards_and_shard_id()``
— each worker takes every num_shards-th input shard.

    python -m parallax_tpu_torch.examples.skip_thoughts_driver
"""

import argparse
import time

import numpy as np

import parallax_tpu_torch as parallax
from parallax_tpu_torch import shard
from parallax_tpu_torch.models import skip_thoughts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--resource_info", default=None)
    ap.add_argument("--vocab_size", type=int, default=20000)
    ap.add_argument("--emb_dim", type=int, default=620)
    ap.add_argument("--hidden_dim", type=int, default=2400)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--seq_len", type=int, default=30)
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--log_frequency", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = skip_thoughts.SkipThoughtsConfig(vocab_size=args.vocab_size,
                                           emb_dim=args.emb_dim,
                                           hidden_dim=args.hidden_dim)
    sess, num_workers, worker_id, _ = parallax.parallel_run(
        skip_thoughts.build_model(cfg), args.resource_info,
        device=args.device)

    # file-level sharding, the reference input_ops pattern: each worker
    # takes every num_shards-th input shard
    num_shards, shard_id = shard.create_num_shards_and_shard_id()
    all_files = [f"synthetic-{i:05d}" for i in range(256)]
    my_files = list(shard.shard(all_files))
    print(f"worker {shard_id}/{num_shards} owns {len(my_files)} shards")

    rng = np.random.default_rng(worker_id)
    t_last = time.perf_counter()
    losses = []
    for i in range(args.max_steps):
        batch = skip_thoughts.make_batch(rng, args.batch_size,
                                         args.seq_len, cfg.vocab_size)
        loss, step = sess.run(["loss", "global_step"], feed_dict=batch)
        # host-side log gate: reading the lazy `step` fetch every
        # iteration would block dispatch on step t retiring
        if (i + 1) % args.log_frequency == 0:
            # materialize BEFORE reading the clock: the window must
            # cover execution, not just dispatch, of its steps
            loss_v = float(loss)
            now = time.perf_counter()
            sps = args.log_frequency / (now - t_last)
            t_last = now
            losses.append(loss_v)
            print(f"step {step}: loss {loss_v:.4f}  {sps:.2f} steps/sec")
    sess.close()
    return losses


if __name__ == "__main__":
    main()
