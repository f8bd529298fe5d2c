"""NMT evaluation (``examples/nmt_eval.py``): restore a checkpoint,
decode (greedy, or beam search with the GNMT length penalty), score with
corpus BLEU. With ``--pallas_attention`` the encoder runs the CUDA flash
forward kernel (B4).

    python -m parallax_tpu_torch.examples.nmt_eval --ckpt_dir DIR
"""

import argparse

import numpy as np
import torch

from parallax_tpu_torch.checkpoint import restore_train_state
from parallax_tpu_torch.common.evaluation import corpus_bleu
from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.models import nmt


def restore_params(ckpt_dir: str, cfg: nmt.NMTConfig, device="cuda"):
    restored, latest = restore_train_state(ckpt_dir, nmt.build_model(cfg),
                                           device=device)
    return restored.params, latest


def decode_and_bleu(params, cfg: nmt.NMTConfig, eval_pairs,
                    beam_width: int = 0, alpha: float = 1.0,
                    max_len=None):
    """``eval_pairs`` iterable of (src [B,Ts] int32, ref_tgt [B,Tt]
    int32, with PAD=0/BOS=1/EOS=2). Returns (bleu, hypotheses)."""
    device = params["emb"].device
    refs, hyps = [], []
    with torch.no_grad():
        for src, ref in eval_pairs:
            s = torch.from_numpy(np.asarray(src, np.int32)).to(device)
            if beam_width and beam_width > 1:
                out = nmt.beam_decode(params, cfg, s, beam_width=beam_width,
                                      alpha=alpha, max_len=max_len)
            else:
                out = nmt.greedy_decode(params, cfg, s, max_len=max_len)
            for r, h in zip(np.asarray(ref), out.cpu().numpy()):
                refs.append(nmt.ids_to_tokens(r))
                hyps.append(nmt.ids_to_tokens(h))
    return corpus_bleu(refs, hyps), hyps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--vocab_size", type=int, default=32000)
    ap.add_argument("--model_dim", type=int, default=512)
    ap.add_argument("--num_heads", type=int, default=8)
    ap.add_argument("--mlp_dim", type=int, default=2048)
    ap.add_argument("--num_layers", type=int, default=6)
    ap.add_argument("--max_len", type=int, default=128)
    ap.add_argument("--partitions", type=int, default=None)
    ap.add_argument("--beam_width", type=int, default=4)
    ap.add_argument("--length_penalty", type=float, default=1.0)
    ap.add_argument("--eval_batches", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--pallas_attention", action="store_true",
                    help="the encoder's attention through the CUDA flash "
                         "forward kernel (as nmt_driver's flag)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = nmt.NMTConfig(
        vocab_size=args.vocab_size, model_dim=args.model_dim,
        num_heads=args.num_heads, mlp_dim=args.mlp_dim,
        num_layers=args.num_layers, max_len=args.max_len,
        num_partitions=args.partitions,
        use_pallas_attention=args.pallas_attention)
    params, step = restore_params(args.ckpt_dir, cfg,
                                  resolve_device(args.device))
    print(f"restored step {step}")

    # synthetic eval set (plug a real tokenized corpus here); the
    # reference translation is the identity copy task (tgt = src), the
    # standard smoke target for seq2seq decode paths — a model trained
    # on copy pairs scores ~100, anything else ~0
    rng = np.random.default_rng(123)
    pairs = []
    for _ in range(args.eval_batches):
        src = rng.integers(3, cfg.vocab_size,
                           (args.batch_size, args.max_len // 2)
                           ).astype(np.int32)
        eos = np.full((args.batch_size, 1), nmt.EOS_ID, np.int32)
        pairs.append((src, np.concatenate([src, eos], axis=1)))
    bleu, _ = decode_and_bleu(params, cfg, pairs,
                              beam_width=args.beam_width,
                              alpha=args.length_penalty)
    print(f"BLEU: {bleu:.2f}")
    return bleu


if __name__ == "__main__":
    main()
