"""LM1B evaluation (``examples/lm1b_eval.py``): restore a checkpoint,
report the full-softmax perplexity — the exact softmax over the whole
vocabulary instead of the sampled one, in fp32, under ``torch.no_grad()``
with the CUDA LSTM forward kernel (B1) on the card.

    python -m parallax_tpu_torch.examples.lm1b_eval --ckpt_dir DIR
"""

import argparse
import dataclasses

import numpy as np
import torch

import parallax_tpu_torch as parallax
from parallax_tpu_torch.checkpoint import (CheckpointStore,
                                          restore_train_state)
from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.models import lm1b


def restore_params(ckpt_dir: str, cfg: lm1b.LM1BConfig, device="cuda"):
    """Restore the latest training checkpoint's params tree. The state is
    restored into the layout the training engine gives the checkpoint's
    ``sparse_grad_mode``, read from its manifest (the slices mode, the
    driver's default, keeps the tables' optimizer state apart)."""
    store = CheckpointStore(ckpt_dir, max_to_keep=None)
    manifest = store.read_manifest(store.latest_step()) or {}
    slices = any(p.startswith("slice_state/")
                 for p in manifest.get("leaves", {}))
    mode = "slices" if slices else "dense"
    train_cfg = dataclasses.replace(cfg, sparse_grad_mode=mode)
    example = lm1b.make_batch(np.random.default_rng(0), 1, 1,
                              cfg.vocab_size)
    restored, latest = restore_train_state(
        ckpt_dir, lm1b.build_model(train_cfg), example_batch=example,
        config=parallax.Config(sparse_grad_mode=mode), device=device)
    return restored.params, latest


def evaluate(params, cfg: lm1b.LM1BConfig, batches) -> float:
    """Mean full-softmax perplexity over an iterable of (x, y, w)."""
    eval_model = lm1b.build_model(cfg, full_softmax=True)
    device = params["emb"].device
    gen = torch.Generator(device=device).manual_seed(0)
    total_nll, total_w = 0.0, 0.0
    with torch.no_grad():
        for batch in batches:
            feed = {k: torch.as_tensor(np.asarray(v)).to(device)
                    for k, v in batch.items()}
            loss, metrics, _ = eval_model.call_loss(params, feed, gen)
            total_nll += float(loss) * float(metrics["words"])
            total_w += float(metrics["words"])
    return float(np.exp(total_nll / max(total_w, 1.0)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--vocab_size", type=int, default=793470)
    ap.add_argument("--emb_dim", type=int, default=512)
    ap.add_argument("--hidden_dim", type=int, default=2048)
    ap.add_argument("--proj_dim", type=int, default=512)
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--num_steps", type=int, default=20)
    ap.add_argument("--eval_batches", type=int, default=20)
    ap.add_argument("--data_path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = lm1b.LM1BConfig(
        vocab_size=args.vocab_size, emb_dim=args.emb_dim,
        hidden_dim=args.hidden_dim, proj_dim=args.proj_dim,
        num_partitions=parallax.get_partitioner(args.partitions),
        keep_prob=1.0,
        # published perplexities must be reference-comparable: full fp32
        # eval, no bf16 matmuls
        compute_dtype=torch.float32, lstm_impl="kernel")
    params, step = restore_params(args.ckpt_dir, cfg,
                                  resolve_device(args.device))
    print(f"restored step {step}")

    if args.data_path:
        from parallax_tpu_torch.data import TokenDataset
        ds = TokenDataset(args.data_path, args.batch_size, args.num_steps)
        batches = [ds.next_batch() for _ in range(args.eval_batches)]
    else:
        rng = np.random.default_rng(123)
        batches = [lm1b.make_batch(rng, args.batch_size, args.num_steps,
                                   cfg.vocab_size)
                   for _ in range(args.eval_batches)]
    ppl = evaluate(params, cfg, batches)
    print(f"eval perplexity: {ppl:.2f}")
    return ppl


if __name__ == "__main__":
    main()
