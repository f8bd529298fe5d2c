"""LM1B distributed driver (``examples/lm1b_driver.py``): builds the
LM1B model with partitioned vocab tables, runs it through parallel_run,
feeds (x, y, w) batches, and logs words/sec every --log_frequency steps.

Data: --data_path points to an int32 token file (see
parallax_tpu_torch/data/loader.py); without it a synthetic Zipf stream is
used so the driver doubles as a throughput benchmark. ``--lstm_impl
pallas`` runs the recurrence in the CUDA LSTM kernels (ops/lstm.py),
``xla`` in plain PyTorch cells.

    python -m parallax_tpu_torch.examples.lm1b_driver --lstm_impl pallas
"""

import argparse
import time

import numpy as np

import parallax_tpu_torch as parallax
from parallax_tpu_torch.models import lm1b

# the JAX driver's --lstm_impl names -> the port's routes
LSTM_IMPLS = {"xla": "scan", "pallas": "kernel"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--resource_info", default=None)
    ap.add_argument("--batch_size", type=int, default=128)
    ap.add_argument("--num_steps", type=int, default=20)
    ap.add_argument("--vocab_size", type=int, default=793470)
    ap.add_argument("--emb_dim", type=int, default=512)
    ap.add_argument("--hidden_dim", type=int, default=2048)
    ap.add_argument("--proj_dim", type=int, default=512)
    ap.add_argument("--num_samples", type=int, default=8192)
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--log_frequency", type=int, default=10)
    ap.add_argument("--run_option", default="HYBRID")
    ap.add_argument("--data_path", default=None,
                    help="int32 token file (parallax_tpu_torch.data "
                         "format); default: synthetic Zipf stream")
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--save_ckpt_steps", type=int, default=None)
    ap.add_argument("--save_ckpt_secs", type=float, default=None)
    ap.add_argument("--partitions", type=int, default=None,
                    help="embedding partitions (reference "
                         "get_partitioner(32)); default auto")
    ap.add_argument("--sparse_grad_mode", default="slices",
                    choices=["dense", "slices"],
                    help="'slices' = reference IndexedSlices semantics "
                         "(tables outside the clip, scatter-only "
                         "adagrad)")
    ap.add_argument("--lstm_impl", default="xla",
                    choices=sorted(LSTM_IMPLS),
                    help="'pallas' = the CUDA LSTM kernels "
                         "(ops/lstm.py); 'xla' = plain PyTorch cells")
    ap.add_argument("--trace_path", default=None,
                    help="write a chrome://tracing JSON of the host "
                         "pipeline (dispatch/prefetch/fetch spans) at "
                         "close")
    ap.add_argument("--metrics_path", default=None,
                    help="append metrics-registry snapshots as JSONL "
                         "every --metrics_interval_s seconds")
    ap.add_argument("--metrics_interval_s", type=float, default=10.0)
    ap.add_argument("--monitor_health", action="store_true",
                    help="loss-finiteness + grad-norm monitoring "
                         "(lazily fetched; warns on NaN)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    num_partitions = parallax.get_partitioner(args.partitions)
    cfg = lm1b.LM1BConfig(
        vocab_size=args.vocab_size, emb_dim=args.emb_dim,
        hidden_dim=args.hidden_dim, proj_dim=args.proj_dim,
        num_samples=args.num_samples, num_partitions=num_partitions,
        sparse_grad_mode=args.sparse_grad_mode,
        lstm_impl=LSTM_IMPLS[args.lstm_impl])
    model = lm1b.build_model(cfg)
    config = parallax.Config(
        run_option=args.run_option,
        sparse_grad_mode=args.sparse_grad_mode,
        trace_path=args.trace_path,
        metrics_path=args.metrics_path,
        metrics_interval_s=args.metrics_interval_s,
        monitor_health=args.monitor_health,
        ckpt_config=parallax.CheckPointConfig(
            ckpt_dir=args.ckpt_dir,
            save_ckpt_steps=args.save_ckpt_steps,
            save_ckpt_secs=args.save_ckpt_secs))
    sess, num_workers, worker_id, num_replicas = parallax.parallel_run(
        model, args.resource_info, parallax_config=config,
        num_partitions=num_partitions, device=args.device)
    print(f"workers={num_workers} replicas={num_replicas} "
          f"padded_vocab={cfg.padded_vocab}")

    dataset = None
    if args.data_path:
        from parallax_tpu_torch.data import TokenDataset
        dataset = TokenDataset(args.data_path, args.batch_size,
                               args.num_steps,
                               num_shards=num_workers,
                               shard_id=worker_id)
        print(f"data: {dataset.num_tokens:,} tokens "
              f"({dataset.backend} backend)")

    rng = np.random.default_rng(worker_id)

    def feed():
        for _ in range(args.max_steps):
            yield (dataset.next_batch() if dataset
                   else lm1b.make_batch(rng, args.batch_size,
                                        args.num_steps, cfg.vocab_size))

    pending_words, t_last = [], time.perf_counter()
    losses = []
    # pipelined loop: batch t+1 is assembled and staged on the device by
    # the session's prefetch thread while step t runs; fetches stay lazy
    # until the log step
    for i, (loss, words, step) in enumerate(sess.run_iter(
            feed(), ["loss", "words", "global_step"])):
        pending_words.append(words)
        if (i + 1) % args.log_frequency == 0:
            words_acc = sum(float(w) for w in pending_words)
            now = time.perf_counter()
            wps = words_acc / (now - t_last)
            pending_words, t_last = [], now
            losses.append(float(loss))
            print(f"step {step}: loss {loss:.4f}  {wps:,.0f} words/sec")
    if args.monitor_health:
        import json
        print("health:", json.dumps(sess.health.report()))
    sess.close()
    return losses


if __name__ == "__main__":
    main()
