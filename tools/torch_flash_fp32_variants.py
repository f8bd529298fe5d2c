"""The fp32 split-operand flash kernels against their build variants and
the first fp32 kernels, on one card.

``csrc/flash_attention_f32_sm90.cu`` is built three ways with nvcc (the
port's flags), from the source and from two edited copies of it: as the
port builds it; ``cvt`` (the ``cvt.rna.tf32.f32`` instruction in place of
the two integer operations that round the same way); ``direct_sums``
(the products fed into the running output and dk/dv sums by the tensor
core directly, not summed from zero first). Prints one JSON line a
case:

* whether the cvt variant gives the port's bits (forward and dk/dv);
* each variant's largest error against the plain versions (fp32, TF32
  off) and against a float64 computation, beside the card tests'
  tolerance (2e-5; 2e-5 of max(1, peak) for dk and dv);
* each variant's device time (profiler) and the first fp32 kernels'
  (``pt_flash_fwd``, ``pt_flash_dkv``) at chip_smoke.py's fp32 shapes.

    python tools/torch_flash_fp32_variants.py [--out chiprun_out/...]

Needs a CUDA card, nvcc and the sources; the variants are built under
``build/parallax_tpu_torch/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from parallax_tpu_torch.ops import _cuda  # noqa: E402
from parallax_tpu_torch.ops import flash_attention as fa  # noqa: E402

# variant -> [(text of the source, its replacement)]
VARIANTS = {
    "port": [],
    "cvt": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
             "  uint32_t r;\n"
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n"
             "  return r;")],
    "direct_sums": [("  float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
                     "  mma3(t, a, b0, b1);\n"
                     "  d[0] += t[0];\n  d[1] += t[1];\n"
                     "  d[2] += t[2];\n  d[3] += t[3];",
                     "  mma3(d, a, b0, b1);")],
}
# (label, B, T, H, hd, causal, mask): chip_smoke.py's fp32 cases and the
# long causal sums
ACCURACY = [("t512", 8, 512, 8, 64, False, None),
            ("t512_causal", 8, 512, 8, 64, True, None),
            ("t2048_causal", 2, 2048, 8, 64, True, None),
            ("t4096_causal", 1, 4096, 2, 64, True, None),
            ("hd128", 4, 256, 4, 128, False, "pad")]
TIMING = [("t512", 8, 512, 8, 64, False, None),
          ("t512_causal", 8, 512, 8, 64, True, None),
          ("train_enc", 64, 64, 8, 64, False, "pad"),
          ("nmt_beam", 16, 64, 8, 64, False, "full"),
          ("oneshot", 32, 64, 8, 64, False, "pad"),
          ("t2048_causal", 2, 2048, 8, 64, True, None)]


def build_variants():
    out_dir = _cuda.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    text = (_cuda.CSRC / "flash_attention_f32_sm90.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        body = text
        for old, new in edits:
            if old not in body:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old!r}")
            body = body.replace(old, new)
        src = out_dir / f"flash_attention_f32_sm90-{name}.cu"
        src.write_text(body)
        so = src.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fwd = lib.pt_flash_fwd_tf32x3
        dkv = lib.pt_flash_dkv_tf32x3
        for fn, types in ((fwd, fa._ARGTYPES), (dkv, fa._DKV_ARGTYPES)):
            fn.restype = ctypes.c_int
            fn.argtypes = types
        libs[name] = (fwd, dkv)
    return libs


def inputs(B, T, H, hd, mask_kind, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=g, device="cuda")
                     for _ in range(4))
    mask = None
    if mask_kind == "full":
        mask = torch.ones((B, T), dtype=torch.int32, device="cuda")
    elif mask_kind == "pad":
        lengths = np.random.default_rng(seed).integers(min(16, T), T + 1, B)
        mask = (torch.arange(T, device="cuda")[None, :] < torch.as_tensor(
            lengths, device="cuda")[:, None]).to(torch.int32)
    return q, k, v, dout, mask


def calls(fwd, dkv, q, k, v, dout, mask, lse, delta, causal):
    """The two launchers as callables on fresh outputs: (fwd, dkv,
    (out, lse), (dk, dv))."""
    B, T, H, hd = q.shape
    mp = None if mask is None else mask.data_ptr()
    scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream().cuda_stream
    out, lse_out = torch.empty_like(q), torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)

    def f():
        assert fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), mp,
                   out.data_ptr(), lse_out.data_ptr(), B, H, T, T, hd,
                   scale, int(causal), stream) == 0

    def d():
        assert dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), mp,
                   dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                   dk.data_ptr(), dv.data_ptr(), B, H, T, T, hd, scale,
                   int(causal), stream) == 0
    return f, d, (out, lse_out), (dk, dv)


def float64_reference(q, k, v, dout, mask, causal):
    """out, dk and dv in float64 (δ from the float64 out)."""
    q, k, v, dout = (x.double() for x in (q, k, v, dout))
    T = q.shape[1]
    qs = q / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    ok = torch.ones((q.shape[0], 1, T, T), dtype=torch.bool, device="cuda")
    if mask is not None:
        ok = ok & (mask > 0)[:, None, None, :]
    if causal:
        ok = ok & torch.ones((T, T), dtype=torch.bool, device="cuda").tril()
    s = torch.where(ok, s, -1e300)
    p = torch.where(ok, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-300)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v)
    delta = (dout * out).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dout, v) - delta)
    return (out, torch.einsum("bhqk,bqhd->bkhd", ds, qs),
            torch.einsum("bhqk,bqhd->bkhd", p, dout))


def err(a, b):
    return (a.double() - b.double()).abs().max().item()


def device_ms(fn, names, calls_n=20):
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls_n):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for e in prof.key_averages():
        if any(n in e.key for n in names):
            total += getattr(e, "device_time_total", 0.0)
            count += e.count
    return total / count / 1e3 if count else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="chiprun_out/flash_fp32_variants.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    _cuda.build(["flash_attention", "flash_attention_bwd"])
    first = (_cuda.function("flash_attention", "pt_flash_fwd", fa._ARGTYPES),
             _cuda.function("flash_attention_bwd", "pt_flash_dkv",
                            fa._DKV_ARGTYPES))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    for label, B, T, H, hd, causal, mk in ACCURACY:
        q, k, v, dout, mask = inputs(B, T, H, hd, mk)
        ref, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            kv_mask=mask)
        delta = fa.flash_delta(ref, dout)
        ref_dk, ref_dv = fa.flash_dkv_plain(q, k, v, mask, dout, lse, delta,
                                            causal)
        o64, dk64, dv64 = float64_reference(q, k, v, dout, mask, causal)
        row = {"case": label, "shape": [B, T, H, hd, causal, mk],
               "tol_out": 2e-5,
               "tol_dk": 2e-5 * max(1.0, ref_dk.abs().max().item()),
               "tol_dv": 2e-5 * max(1.0, ref_dv.abs().max().item()),
               "plain_vs_f64": {"out": err(ref, o64), "dk": err(ref_dk, dk64),
                                "dv": err(ref_dv, dv64)}}
        got = {}
        for name, (fwd, dkv) in libs.items():
            f, d, (out, _), (dk, dv) = calls(fwd, dkv, q, k, v, dout, mask,
                                             lse, delta, causal)
            f()
            d()
            torch.cuda.synchronize()
            got[name] = (out.clone(), dk.clone(), dv.clone())
            row[name] = {"vs_plain": {"out": err(out, ref),
                                      "dk": err(dk, ref_dk),
                                      "dv": err(dv, ref_dv)},
                         "vs_f64": {"out": err(out, o64), "dk": err(dk, dk64),
                                    "dv": err(dv, dv64)}}
        row["cvt_bitwise"] = all(torch.equal(a, b) for a, b in
                                 zip(got["port"], got["cvt"]))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del o64, dk64, dv64
    for label, B, T, H, hd, causal, mk in TIMING:
        q, k, v, dout, mask = inputs(B, T, H, hd, mk)
        out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            kv_mask=mask)
        delta = fa.flash_delta(out, dout)
        row = {"timing": label, "shape": [B, T, H, hd, causal, mk]}
        for name, (fwd, dkv) in {**libs, "first": first}.items():
            f, d, _, _ = calls(fwd, dkv, q, k, v, dout, mask, lse, delta,
                               causal)
            row[name] = {"fwd_device_ms": device_ms(f, ("flash_fwd_kernel",)),
                         "dkv_device_ms": device_ms(d, ("flash_dkv_kernel",))}
        print(json.dumps(row), flush=True)
        rows.append(row)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    with open(args.out, "w") as fh:
        for row in rows:
            fh.write(json.dumps({**row, "card": card}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
