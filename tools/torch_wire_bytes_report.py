"""Wire bytes of the port's LM1B flagship step on an (r, p) mesh, counted
from shapes alone.

``Engine.sparse_wire_bytes_per_step`` reads one record per sharded
lookup, written while the step's loss runs. The records depend only on
shapes, so this script builds the flagship engine (793,470-word LM1B,
HYBRID, slices mode, 128 x 20 words a rank) over a mesh record of the
given shape with no process group, runs the loss once on meta tensors
(no memory, no collective) under the engine's lookup scope, and prints
the accounting as one JSON line: the port's counterpart of
``tools/wire_bytes_report.py``.

Run: python tools/torch_wire_bytes_report.py [--repl 1] [--shard 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def flagship_accounting(repl: int = 1, shard: int = 8,
                        batch_per_rank: int = 128, num_steps: int = 20):
    import numpy as np
    import torch

    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import classify, engine as engine_lib
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.models import lm1b

    cfg = lm1b.LM1BConfig(num_partitions=8, sparse_grad_mode="slices")
    model = lm1b.build_model(cfg)
    batch = lm1b.make_batch(np.random.default_rng(0), batch_per_rank,
                            num_steps, cfg.vocab_size)
    mesh = mesh_lib.Mesh(torch.device("cpu"), repl, shard)
    eng = engine_lib.Engine(model, mesh, pt.Config(
        run_option="HYBRID", sparse_grad_mode="slices"), batch)
    params, _ = model.call_init(torch.Generator(), "meta")
    flat = dict(classify.flatten(params))
    records = []
    with torch.no_grad(), eng._lookup_scope(flat, records):
        model.call_loss(params, engine_lib._to_meta(batch),
                        torch.Generator())
    eng._lookup_records = records
    out = eng.sparse_wire_bytes_per_step()
    out.update(mesh=[repl, shard], batch_per_rank=batch_per_rank,
               num_steps=num_steps, vocab=cfg.vocab_size,
               num_samples=cfg.num_samples)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repl", type=int, default=1)
    ap.add_argument("--shard", type=int, default=8)
    args = ap.parse_args(argv)
    print(json.dumps(flagship_accounting(args.repl, args.shard)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
