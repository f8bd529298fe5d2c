"""CNN evaluation (``examples/cnn_eval.py``): restore a checkpoint,
report the top-1 accuracy in inference mode (BatchNorm with the running
statistics).

    python -m parallax_tpu_torch.examples.cnn_eval --ckpt_dir DIR
"""

import argparse

import numpy as np
import torch

from parallax_tpu_torch.checkpoint import restore_train_state
from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.core import classify
from parallax_tpu_torch.models import _nn, cnn


def evaluate(module_name: str, num_classes: int, state, batches,
             image_size=None) -> float:
    """Top-1 accuracy in inference mode (running BatchNorm stats)."""
    module, _ = cnn.build_module(module_name, num_classes, image_size)
    params = state.params
    stats = (state.model_state or {}).get("batch_stats", {})
    device = next(leaf for _, leaf in classify.flatten(params)).device
    correct = total = 0
    with torch.no_grad():
        for batch in batches:
            images = torch.from_numpy(np.asarray(batch["images"])).to(device)
            logits, _ = _nn.apply(module, params, stats, images,
                                  train=False)
            labels = torch.from_numpy(np.asarray(batch["labels"])).to(device)
            correct += int((logits.argmax(-1) == labels).sum())
            total += batch["labels"].shape[0]
    return correct / max(total, 1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--model", default="resnet50_v1.5",
                    choices=sorted(cnn.MODEL_REGISTRY))
    ap.add_argument("--num_classes", type=int, default=1000)
    ap.add_argument("--image_size", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--eval_batches", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    size = args.image_size or cnn.default_image_size(args.model)
    model = cnn.build_model(args.model, num_classes=args.num_classes,
                            image_size=size)
    state, step = restore_train_state(args.ckpt_dir, model,
                                      device=resolve_device(args.device))
    print(f"restored step {step}")
    rng = np.random.default_rng(123)
    batches = [cnn.make_batch(rng, args.batch_size, size,
                              args.num_classes)
               for _ in range(args.eval_batches)]
    acc = evaluate(args.model, args.num_classes, state, batches, size)
    print(f"top-1 accuracy: {acc:.4f}")
    return acc


if __name__ == "__main__":
    main()
