"""The port's profile parser (``parallax_tpu_torch/obs/xprof.py``, Kineto
Chrome traces) held to the JAX package's (``jax.profiler`` traces).

One synthetic event set is written twice: as a JAX-style trace (HLO op
names, ``args.hlo_op``) and as the trace ``torch.profiler`` exports
(``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` events on a device track,
named as CUDA names them: NCCL kernels, ``Memcpy HtoD`` and so on). Both
parsers give equal ``Attribution`` numbers: wall, busy, residual,
coverage, category and collective totals, the ranked ops' times, and
the layer and dense-sparse splits under matching indices. The sets are
the JAX package's golden fixture and seeded random ones with nesting
(resolved by containment) across two tracks. Also: the CPU fallback
track (``cpu_op`` events), the empty trace, the Kineto taxonomy, and
the scope join (``build_scope_index``) on a synthetic trace and on a
real CPU trace of a small LM1B step.
"""

import json
import os

import numpy as np
import pytest
import torch

from parallax_tpu.obs import xprof as jxprof
from parallax_tpu_torch.obs import xprof as txprof

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_trace.json")

# kind -> (JAX HLO name, Kineto name, Kineto category)
KINDS = {
    "while": ("while", "lstm_fwd_kernel_sm90", "kernel"),
    "dot": ("dot.1", "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize"
            "128x128x64", "kernel"),
    "fusion": ("fusion.3", "void at::native::vectorized_elementwise_kernel"
               "<4, at::native::CUDAFunctor_add<float>>", "kernel"),
    "all-reduce": ("all-reduce", "ncclDevKernel_AllReduce_Sum_f32_RING_LL"
                   "(ncclDevKernelArgsStorage<4096ul>)", "kernel"),
    "all-gather": ("all-gather.1", "ncclDevKernel_AllGather_RING_LL"
                   "(ncclDevKernelArgsStorage<4096ul>)", "kernel"),
    "reduce-scatter": ("reduce-scatter.2",
                       "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL"
                       "(ncclDevKernelArgsStorage<4096ul>)", "kernel"),
    "permute": ("collective-permute.4", "ncclDevKernel_SendRecv"
                "(ncclDevKernelArgsStorage<4096ul>)", "kernel"),
    "copy": ("copy.2", "Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
    "memset": ("copy.5", "Memset (Device)", "gpu_memset"),
    "infeed": ("infeed", "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy"),
    "outfeed": ("outfeed.1", "Memcpy DtoH (Device -> Pageable)",
                "gpu_memcpy"),
}


def _golden_events():
    """The JAX golden fixture's op events as (track, ts, dur, kind)."""
    by_name = {j: k for k, (j, _, _) in KINDS.items()}
    with open(GOLDEN) as f:
        doc = json.load(f)
    return [(e["tid"], e["ts"], e["dur"], by_name[e["name"]])
            for e in doc["traceEvents"]
            if (e.get("args") or {}).get("hlo_op")]


def _random_events(seed, steps=3):
    """Seeded events on two tracks: per step a few top-level ops, some
    holding nested children (a 'while' container), with host gaps
    between the steps."""
    rng = np.random.default_rng(seed)
    kinds = [k for k in KINDS if k != "while"]
    out = []
    t0 = 0.0
    for _ in range(steps):
        for track in (7, 8):
            t = t0 + float(rng.uniform(0, 5))
            for _ in range(int(rng.integers(3, 7))):
                dur = float(rng.integers(5, 60))
                if rng.uniform() < 0.3:
                    out.append((track, t, dur + 40.0, "while"))
                    c = t + 3.0
                    for _ in range(2):
                        cd = float(rng.integers(2, 15))
                        out.append((track, c, cd,
                                    kinds[int(rng.integers(len(kinds)))]))
                        c += cd + 2.0
                    t += dur + 40.0 + float(rng.uniform(0, 4))
                else:
                    out.append((track, t, dur,
                                kinds[int(rng.integers(len(kinds)))]))
                    t += dur + float(rng.uniform(0, 4))
        t0 = t + 500.0 + float(rng.uniform(0, 300))
    return out


def jax_trace(events):
    evs = [{"ph": "M", "pid": 1, "name": "process_name",
            "args": {"name": "/host:CPU"}},
           {"ph": "X", "pid": 9, "tid": 90, "ts": 0, "dur": 1e6,
            "name": "PjitFunction(step)"}]
    for tid, ts, dur, kind in events:
        name = KINDS[kind][0]
        evs.append({"ph": "X", "pid": 1, "tid": tid, "ts": ts, "dur": dur,
                    "name": name, "args": {"hlo_module": "jit_step",
                                           "hlo_op": name}})
    return {"traceEvents": evs}


def kineto_trace(events):
    evs = [{"ph": "M", "pid": 0, "name": "process_name",
            "args": {"name": "python"}},
           {"ph": "X", "cat": "cpu_op", "pid": 4242, "tid": 4242, "ts": 0,
            "dur": 1e6, "name": "aten::mm"},
           {"ph": "X", "cat": "cuda_runtime", "pid": 4242, "tid": 4242,
            "ts": 1, "dur": 3, "name": "cudaGraphLaunch",
            "args": {"correlation": 1}}]
    for i, (tid, ts, dur, kind) in enumerate(events):
        _, name, cat = KINDS[kind]
        evs.append({"ph": "X", "cat": cat, "pid": 0, "tid": tid, "ts": ts,
                    "dur": dur, "name": name,
                    "args": {"device": 0, "stream": tid,
                             "correlation": 1000 + i}})
    return {"traceEvents": evs}


def cpu_trace(events):
    """The same intervals as a CPU-only trace's ``cpu_op`` events."""
    evs = []
    for tid, ts, dur, kind in events:
        evs.append({"ph": "X", "cat": "cpu_op", "pid": 77, "tid": tid,
                    "ts": ts, "dur": dur, "name": f"aten::{kind}"})
    evs.append({"ph": "X", "cat": "user_annotation", "pid": 77, "tid": 1,
                "ts": 0, "dur": 10, "name": "lm1b.py"})
    return {"traceEvents": evs}


def _index_pair(events, sources):
    """Matching indices: JAX's by HLO name, the port's by Kineto name."""
    jidx, tidx = {}, {}
    for kind, src in sources.items():
        jname, tname, _ = KINDS[kind]
        jidx[jname] = {"opcode": jname, "source_file": f"x/ops/{src}"}
        tidx[tname] = {"opcode": tname, "source_file": src}
    return jidx, tidx


SETS = {"golden": _golden_events(),
        **{f"seed{s}": _random_events(s) for s in (0, 1, 2, 3)}}
SOURCES = {"dot": "lm1b.py", "all-gather": "embedding.py",
           "fusion": "sampled_softmax.py", "copy": "engine.py"}


def _numbers(a):
    """An Attribution's numbers, with the op names left out."""
    d = a.as_dict()
    d.pop("source")
    d.pop("track_basis")
    d["by_module"] = round(sum(d["by_module"].values()), 3)
    d["top_ops"] = sorted((r["category"], r["self_ms"], r["count"],
                           r["layer"], r["split"]) for r in d["top_ops"])
    return d


@pytest.mark.parametrize("steps", [None, 1, 2, 3])
@pytest.mark.parametrize("name", list(SETS))
def test_attribution_equals_jax(name, steps):
    events = SETS[name]
    jidx, tidx = _index_pair(events, SOURCES)
    want = jxprof.attribute(jax_trace(events), steps=steps,
                            hlo_index=jidx)
    got = txprof.attribute(kineto_trace(events), steps=steps,
                           scope_index=tidx)
    assert got.track_basis == "device" and want.track_basis == "hlo_op"
    assert got.events == want.events == len(events)
    assert _numbers(got) == _numbers(want)
    # grouped by stream, not by executable: the same total
    assert set(got.by_module) <= {"stream 7", "stream 8", "stream 10",
                                  "stream 11"}
    # the unindexed split: everything unmapped, never guessed
    bare = txprof.attribute(kineto_trace(events), steps=steps)
    assert bare.dense_sparse == _numbers(jxprof.attribute(
        jax_trace(events), steps=steps))["dense_sparse"]
    assert bare.dense_sparse["sparse_self_ms"] == 0.0


@pytest.mark.parametrize("name", list(SETS))
def test_cpu_fallback_track_equals_jax(name):
    """A trace with no device events attributes its ``cpu_op`` events,
    says so in ``track_basis``, and counts as the JAX parser counts the
    same intervals."""
    events = SETS[name]
    got = txprof.attribute(cpu_trace(events), steps=2)
    want = jxprof.attribute(jax_trace(events), steps=2)
    assert got.track_basis == "cpu_op"
    for k in ("events", "tracks", "wall_ms", "window_span_ms",
              "inter_step_ms", "attributed_ms", "residual_ms", "coverage"):
        assert getattr(got, k) == getattr(want, k), k
    assert sum(r["self_ms"] for r in got.by_category.values()) == \
        pytest.approx(sum(r["self_ms"]
                          for r in want.by_category.values()), abs=1e-3)


def test_golden_numbers_hold():
    """The JAX package's hand-computed golden numbers, through the
    port's parser on the Kineto form of the fixture."""
    a = txprof.attribute(kineto_trace(SETS["golden"]), steps=2)
    assert a.attributed_ms == pytest.approx(0.200, abs=1e-6)
    assert a.wall_ms == pytest.approx(0.220, abs=1e-6)
    assert a.residual_ms == pytest.approx(0.020, abs=1e-6)
    assert a.coverage == pytest.approx(200 / 220, abs=1e-3)
    assert a.inter_step_ms == pytest.approx(1.080, abs=1e-6)
    ops = {r["op"]: r for r in a.top_ops}
    # the container's 100 us holds 30 + 20 us of children: self 50
    assert ops[KINDS["while"][1]]["self_ms"] == pytest.approx(0.050,
                                                              abs=1e-6)
    assert ops[KINDS["dot"][1]]["count"] == 2
    assert a.by_category["collective"]["self_ms"] == pytest.approx(
        0.070, abs=1e-6)
    assert a.collectives["all-reduce"]["self_ms"] == pytest.approx(
        0.020, abs=1e-6)


def test_empty_trace_reports_nothing():
    for pkg in (txprof, jxprof):
        a = pkg.attribute({"traceEvents": []}, steps=4)
        assert a.events == 0 and a.coverage is None
        assert a.as_dict()["step_wall_ms"] is None


@pytest.mark.parametrize("name,cat,kind", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)", "collective",
     "all-reduce"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t(x)", "collective",
     "all-gather"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL", "collective",
     "reduce-scatter"),
    ("ncclDevKernel_SendRecv(x)", "collective", "collective-permute"),
    ("ncclDevKernel_Broadcast_RING_LL(x)", "collective",
     "collective-broadcast"),
    ("c10d::allreduce_", "collective", "all-reduce"),
    ("c10d::_allgather_base_", "collective", "all-gather"),
    ("c10d::_reduce_scatter_base_", "collective", "reduce-scatter"),
    ("c10d::alltoall_base_", "collective", "collective-permute"),
    ("gloo:all_reduce", "collective", "all-reduce"),
    ("Memcpy HtoD (Pinned -> Device)", "infeed", None),
    ("Memcpy DtoH (Device -> Pageable)", "outfeed", None),
    ("Memcpy DtoD (Device -> Device)", "copy", None),
    ("Memset (Device)", "copy", None),
    ("aten::copy_", "copy", None),
    ("lstm_bwd_kernel_sm90", "compute", None),
    ("void at::native::vectorized_elementwise_kernel<4>", "compute", None),
    ("aten::mm", "compute", None),
])
def test_kineto_taxonomy(name, cat, kind):
    assert txprof.categorize(name) == (cat, kind)


def test_shared_pieces_equal_jax():
    ivs = [(0, 10), (5, 7), (9, 15), (20, 25), (24, 30), (40, 41)]
    assert txprof.merge_intervals(ivs) == jxprof.merge_intervals(ivs)
    assert txprof.CATEGORIES == jxprof.CATEGORIES
    assert txprof.SPARSE_SOURCES == jxprof.SPARSE_SOURCES
    for meta in ({"source_file": "a/embedding.py"},
                 {"source_file": "a/lm1b.py"}, {"opcode": "x"}, None,
                 {"op_name": "jit(s)/transpose(jvp(f))/mul"},
                 {"op_name": "jit(s)/layer_a/dot", "source_file": "b.py"}):
        assert txprof.sparse_split(meta) == jxprof.sparse_split(meta)
        assert txprof.layer_of(meta) == jxprof.layer_of(meta)
        assert txprof.direction_of(meta) == jxprof.direction_of(meta)


def test_trace_files_load_alike(tmp_path):
    import gzip
    doc = kineto_trace(SETS["golden"])
    d = tmp_path / "plugins" / "profile" / "t0"
    d.mkdir(parents=True)
    with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
        json.dump(doc, f)
    got, path = txprof.load_trace(str(tmp_path))
    assert got == doc and path.endswith(".trace.json.gz")
    assert jxprof.find_trace_file(str(tmp_path)) == \
        txprof.find_trace_file(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        txprof.load_trace(str(tmp_path / "plugins" / "none"))
    assert txprof.kernel_counts(doc)[KINDS["dot"][1]] == 2


# -- the scope join ------------------------------------------------------------


def _scoped_trace():
    """Host thread 1: scopes lm1b.py > embedding.py, two launches in
    embedding.py (gather, then gemm), a gemm launch in lm1b.py, and the
    forward op ``aten::embedding`` whose ``fwdbwd`` flow leads to a
    backward node on thread 2 that launches the scatter kernel. Stream 7
    runs the kernels by correlation."""
    host = [
        ("user_annotation", "lm1b.py", 1, 0, 1000, None),
        ("user_annotation", "embedding.py", 1, 10, 200, None),
        ("cpu_op", "aten::embedding", 1, 20, 100, None),
        ("cuda_runtime", "cudaLaunchKernel", 1, 30, 5, 1),
        ("cuda_runtime", "cudaLaunchKernel", 1, 50, 5, 2),
        ("cuda_runtime", "cudaLaunchKernel", 1, 400, 5, 3),
        ("cpu_op", "EmbeddingBackward0", 2, 2000, 100, None),
        ("cuda_runtime", "cudaLaunchKernel", 2, 2010, 5, 4),
        ("cuda_runtime", "cudaLaunchKernel", 2, 2050, 5, 5),
    ]
    evs = [{"ph": "X", "cat": c, "name": n, "pid": 5, "tid": t, "ts": ts,
            "dur": d, **({"args": {"correlation": k}} if k else {})}
           for c, n, t, ts, d, k in host]
    evs += [{"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 9,
             "pid": 5, "tid": 1, "ts": 20},
            {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 9,
             "pid": 5, "tid": 2, "ts": 2000, "bp": "e"}]
    for k, name, ts in ((1, "indexSelectLargeIndex", 100),
                        (2, "gemm_nt", 130), (3, "gemm_nt", 500),
                        (4, "indexing_backward_kernel", 2100),
                        (5, "elementwise_kernel", 2150)):
        evs.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0,
                    "tid": 7, "ts": ts, "dur": 20,
                    "args": {"correlation": k}})
    # a launch no scope covers: its kernel name stays unmapped
    evs += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "pid": 5, "tid": 1, "ts": 3000, "dur": 5,
             "args": {"correlation": 6}},
            {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
             "pid": 0, "tid": 7, "ts": 3100, "dur": 20,
             "args": {"correlation": 6}}]
    return {"traceEvents": evs}


def test_scope_index_joins_launches_scopes_and_flows():
    idx = txprof.build_scope_index(_scoped_trace())
    assert idx["indexSelectLargeIndex"]["source_file"] == "embedding.py"
    # the backward inherits its forward op's scope through the flow
    assert idx["indexing_backward_kernel"]["source_file"] == "embedding.py"
    # under two scopes (embedding.py, lm1b.py) or none: unmapped
    assert "gemm_nt" not in idx
    assert "elementwise_kernel" not in idx
    a = txprof.attribute(_scoped_trace(), steps=1, scope_index=idx)
    assert a.dense_sparse["sparse_self_ms"] == pytest.approx(0.040)
    assert a.dense_sparse["unmapped_self_ms"] == pytest.approx(0.080)
    assert a.layers["embedding.py"] == pytest.approx(0.040)


def test_scope_index_of_a_cpu_lm1b_window():
    """A small LM1B's profiled window on the CPU: its ops join the
    source scopes (the sparse path's sampled softmax and lookups, the
    LSTM and the optimizer), so the split has sparse and dense time."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import lm1b
    cfg = lm1b.tiny_config(compute_dtype=torch.float32, lstm_impl="kernel",
                           sparse_grad_mode="slices")
    sess, *_ = pt.parallel_run(lm1b.build_model(cfg), parallax_config=pt.
                               Config(run_option="HYBRID",
                                      sparse_grad_mode="slices"),
                               device="cpu")
    try:
        rng = np.random.default_rng(0)
        feed = lm1b.make_batch(rng, 8, 5, cfg.vocab_size)
        sess.run("loss", feed_dict=feed)
        outdir = sess.profile_steps(2)
        for _ in range(2):
            sess.run("loss", feed_dict=feed)
        doc, _ = txprof.load_trace(outdir)
        idx = txprof.build_scope_index(doc)
        scopes = {v["source_file"] for v in idx.values()}
        assert {"embedding.py", "sampled_softmax.py", "sparse_optim.py",
                "lstm.py"} <= scopes
        a = sess.profile_summary()
        assert a["track_basis"] == "cpu_op" and a["steps"] == 2
        assert a["dense_sparse"]["sparse_self_ms"] > 0
        assert a["dense_sparse"]["dense_self_ms"] > 0
        assert a["layers"]["sampled_softmax.py"] > 0
    finally:
        sess.close()
