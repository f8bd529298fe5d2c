#!/usr/bin/env python3
"""How complete and how busy is a profile window of LM1B replays?

Run from the root of a checkout on a machine with one CUDA card:

    python3 tools/torch_profile_window_probe.py [--rounds 5] [--steps 10]

It builds the kernels, trains ``chip_smoke.py``'s LM1B (``LM1BConfig()``,
128 x 20, bf16 B2/B3, every step a replay of the captured graph) and opens
``--rounds`` windows of ``--steps`` steps each way: the steps lazy (the
loop never reads the loss) and blocking (it reads each step's loss, as the
JAX session blocks a profiled step). For each window it prints one JSON
line: B2's and B3's kernels in the trace against the window's steps, the
device events, the kernels each graph launch shows (by correlation id),
and the parser's coverage and device wall (``obs.xprof.attribute``); then
the card's name and power limit. Nothing of JAX is imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def window(torch, sess, batches, steps, block):
    from parallax_tpu_torch.obs import xprof
    outdir = sess.profile_steps(steps)
    # the window's warm-up step on the card, then the traced ones
    for i in range(steps + 1):
        loss = sess.run("loss", feed_dict=batches[i % 4])
        if block:
            float(loss)
    torch.cuda.synchronize()
    doc, _ = xprof.load_trace(outdir)
    events = doc["traceEvents"]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in events
                      if e.get("ph") == "X"
                      and e.get("name") == "cudaGraphLaunch")
    per = {corr: 0 for _, corr in launches}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") == "kernel" and corr in per:
            per[corr] += 1
    kernels = xprof.kernel_counts(doc)
    a = xprof.attribute(doc, steps=steps)
    sess.profile_summary()     # clears the pending window
    return {"block": block, "steps": steps,
            "b2": sum(n for k, n in kernels.items()
                      if "lstm_fwd_kernel_sm90" in k),
            "b3": sum(n for k, n in kernels.items()
                      if "lstm_bwd_kernel_sm90" in k),
            "device_events": a.events,
            "kernels_per_launch": [per[c] for _, c in launches],
            "coverage": a.coverage, "wall_ms": a.wall_ms}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as c
    torch.backends.cuda.matmul.allow_tf32 = False
    c.phase_build(torch)
    cfg, sess = c.lm1b_session(torch)
    batches = c.lm1b_batches(cfg)
    sess.prepare(batches[0])
    sess.warmup(batch_sizes=[c.TRAIN["batch"]])
    for i in range(3):
        float(sess.run("loss", feed_dict=batches[i % 4]))
    rows = []
    for _ in range(args.rounds):
        for block in (False, True):
            row = window(torch, sess, batches, args.steps, block)
            rows.append(row)
            print(json.dumps(row), flush=True)
    sess.close()
    for block in (False, True):
        cov = [r["coverage"] for r in rows if r["block"] == block]
        print(json.dumps({"block": block, "coverage_min": min(cov),
                          "coverage_max": max(cov),
                          "complete": all(r["b2"] == r["b3"] == args.steps
                                          for r in rows
                                          if r["block"] == block)}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
