"""NMT driver (``examples/nmt_driver.py``): the transformer seq2seq with
the shared embedding on the sparse path; a synthetic parallel corpus, or
a file vocab and parallel corpus via --vocab_file/--src_file/--tgt_file
(parallax_tpu_torch/data/nmt_data.py). ``--pallas_attention`` runs the
attention in the CUDA flash kernels (forward, dq, dk/dv).

    python -m parallax_tpu_torch.examples.nmt_driver --pallas_attention
"""

import argparse
import time

import numpy as np

import parallax_tpu_torch as parallax
from parallax_tpu_torch.models import nmt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--resource_info", default=None)
    ap.add_argument("--vocab_size", type=int, default=32000)
    ap.add_argument("--model_dim", type=int, default=512)
    ap.add_argument("--num_layers", type=int, default=6)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--src_len", type=int, default=64)
    ap.add_argument("--tgt_len", type=int, default=64)
    ap.add_argument("--max_steps", type=int, default=100)
    ap.add_argument("--log_frequency", type=int, default=10)
    ap.add_argument("--run_option", default="HYBRID")
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--pallas_attention", action="store_true",
                    help="all three attention types through the CUDA "
                         "flash kernels")
    ap.add_argument("--tensor_parallel", action="store_true",
                    help="Megatron TP over the 'shard' mesh axis "
                         "(ops/tensor_parallel.py)")
    ap.add_argument("--vocab_file", default=None)
    ap.add_argument("--src_file", default=None)
    ap.add_argument("--tgt_file", default=None)
    ap.add_argument("--ckpt_dir", default=None,
                    help="save checkpoints here for nmt_eval (as "
                         "lm1b_driver's flag; the JAX driver has none)")
    ap.add_argument("--save_ckpt_steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # the three file flags only make sense as a group: a partial set
    # falling back to the synthetic corpus would look like a file run
    file_flags = {"--vocab_file": args.vocab_file,
                  "--src_file": args.src_file,
                  "--tgt_file": args.tgt_file}
    if any(file_flags.values()) and not all(file_flags.values()):
        missing = [k for k, v in file_flags.items() if not v]
        ap.error("file-based data needs --vocab_file, --src_file and "
                 f"--tgt_file together (missing: {', '.join(missing)})")

    num_partitions = parallax.get_partitioner(args.partitions)
    vocab, batches = None, None
    vocab_size = args.vocab_size
    if args.vocab_file:
        from parallax_tpu_torch.data import nmt_data
        vocab = nmt_data.Vocab.load(args.vocab_file)
        vocab_size = len(vocab)
    cfg = nmt.NMTConfig(vocab_size=vocab_size,
                        model_dim=args.model_dim,
                        num_layers=args.num_layers,
                        max_len=max(args.src_len, args.tgt_len),
                        use_pallas_attention=args.pallas_attention,
                        tensor_parallel=args.tensor_parallel,
                        num_partitions=num_partitions)
    sess, num_workers, worker_id, _ = parallax.parallel_run(
        nmt.build_model(cfg), args.resource_info,
        parallax_config=parallax.Config(
            run_option=args.run_option,
            ckpt_config=parallax.CheckPointConfig(
                ckpt_dir=args.ckpt_dir,
                save_ckpt_steps=args.save_ckpt_steps)),
        num_partitions=num_partitions, device=args.device)

    if args.src_file:
        from parallax_tpu_torch.data import nmt_data
        pairs = nmt_data.load_parallel_corpus(
            args.src_file, args.tgt_file, vocab, cfg.max_len)
        it = nmt_data.NMTBatchIterator(
            pairs, batch_size=args.batch_size, max_len=cfg.max_len,
            num_shards=num_workers, shard_index=worker_id)

        def batches():
            epoch = 0
            while True:
                n = 0
                for b in it.epoch(epoch):
                    n += 1
                    yield b
                if n == 0:
                    raise ValueError(
                        f"corpus yields no batches at batch_size="
                        f"{args.batch_size} (corpus {len(pairs)} pairs); "
                        f"lower --batch_size")
                epoch += 1
        batches = batches()

    rng = np.random.default_rng(worker_id)
    pending, t_last = [], time.perf_counter()
    # --batch_size is the GLOBAL batch in both modes: the file iterator
    # row-stripes it across workers, and the synthetic path feeds
    # batch_size/num_workers rows per worker to match
    if args.batch_size % max(num_workers, 1):
        raise ValueError(
            f"--batch_size {args.batch_size} must divide by the "
            f"{num_workers} workers")
    local_bs = args.batch_size // max(num_workers, 1)
    losses = []
    for i in range(args.max_steps):
        batch = (next(batches) if batches is not None
                 else nmt.make_batch(rng, local_bs, args.src_len,
                                     args.tgt_len, cfg.vocab_size))
        loss, w, step = sess.run(["loss", "words", "global_step"],
                                 feed_dict=batch)
        # host-side log gate and deferred reads: reading any fetch every
        # iteration would block dispatch on step t retiring
        pending.append(w)
        if (i + 1) % args.log_frequency == 0:
            words = sum(float(x) for x in pending)
            now = time.perf_counter()
            losses.append(float(loss))
            print(f"step {step}: loss {loss:.4f}  "
                  f"{words / (now - t_last):,.0f} target words/sec")
            pending, t_last = [], now
    sess.close()
    return losses


if __name__ == "__main__":
    main()
