"""Long-context LM driver (``examples/long_context_driver.py``):
sequence-parallel training with ring attention — the sequence dimension
shards over the mesh's 'shard' axis and attention runs as ring
attention over the ranks, so max_len scales with the number of cards —
or tensor, pipeline or data parallelism.

    python -m parallax_tpu_torch.examples.long_context_driver
"""

import argparse
import time

import numpy as np

import parallax_tpu_torch as parallax
from parallax_tpu_torch.models import long_context as lc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--resource_info", default=None)
    ap.add_argument("--vocab_size", type=int, default=32000)
    ap.add_argument("--model_dim", type=int, default=512)
    ap.add_argument("--num_layers", type=int, default=6)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--seq_len", type=int, default=8192)
    ap.add_argument("--max_steps", type=int, default=50)
    ap.add_argument("--log_frequency", type=int, default=10)
    ap.add_argument("--partitions", type=int, default=None,
                    help="shard-axis size (sp or tp degree)")
    ap.add_argument("--parallelism", default="ring",
                    choices=["ring", "tensor", "pipeline", "data"],
                    help="ring=sequence parallel, tensor=Megatron TP, "
                         "pipeline=GPipe stages, data=pure dp")
    ap.add_argument("--num_microbatches", type=int, default=4,
                    help="pipeline mode microbatches")
    ap.add_argument("--pipeline_schedule", default="gpipe",
                    choices=["gpipe", "1f1b"],
                    help="pipeline mode: gpipe (O(M) activations) or "
                         "1f1b (O(S) activations, fused fwd+bwd)")
    ap.add_argument("--virtual_stages", type=int, default=1,
                    help="pipeline mode: interleaved chunks per rank "
                         "(>1 needs --partitions; bubble shrinks "
                         "virtual_stages-fold)")
    ap.add_argument("--pallas_attention", action="store_true",
                    help="attention through the CUDA flash kernels "
                         "(data/tensor modes)")
    # tri-state on purpose: omitting the flag leaves zigzag=None so the
    # config's auto heuristic picks balanced placement for causal ring
    # attention
    ap.add_argument("--zigzag", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="balanced causal placement for ring mode "
                         "(default: auto — zigzag when causal; "
                         "--zigzag/--no-zigzag force)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize blocks in the backward "
                         "(torch.utils.checkpoint): O(1)-block "
                         "activations")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.virtual_stages > 1 and not args.partitions:
        ap.error("--virtual_stages > 1 requires --partitions (the "
                 "stage count fixes the device-major layer order)")
    cfg = lc.LongContextConfig(vocab_size=args.vocab_size,
                               model_dim=args.model_dim,
                               num_layers=args.num_layers,
                               max_len=args.seq_len,
                               parallelism=args.parallelism,
                               zigzag=args.zigzag,
                               num_microbatches=args.num_microbatches,
                               pipeline_schedule=args.pipeline_schedule,
                               virtual_stages=args.virtual_stages,
                               pipeline_stages=(args.partitions
                                                if args.virtual_stages > 1
                                                else None),
                               remat=args.remat,
                               use_pallas_attention=args.pallas_attention)
    sess, _, worker_id, _ = parallax.parallel_run(
        lc.build_model(cfg), args.resource_info,
        parallax_config=parallax.Config(search_partitions=False),
        num_partitions=args.partitions, device=args.device)

    rng = np.random.default_rng(worker_id)
    pending, t_last = [], time.perf_counter()
    losses = []
    for i in range(args.max_steps):
        batch = lc.make_batch(rng, args.batch_size, args.seq_len,
                              cfg.vocab_size)
        loss, tk, step = sess.run(["loss", "tokens", "global_step"],
                                  feed_dict=batch)
        # host-side log gate and deferred reads: reading any fetch every
        # iteration would block dispatch on step t retiring
        pending.append(tk)
        if (i + 1) % args.log_frequency == 0:
            tokens = sum(float(x) for x in pending)
            now = time.perf_counter()
            losses.append(float(loss))
            print(f"step {step}: loss {loss:.4f}  "
                  f"{tokens / (now - t_last):,.0f} tokens/sec")
            pending, t_last = [], now
    sess.close()
    return losses


if __name__ == "__main__":
    main()
