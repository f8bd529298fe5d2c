"""One-shot serving and the serving fleet on the card.

An NMT of D 128 (2 heads of 64), 2 layers, vocab 1000, with the
flash-attention kernel in the encoder (B4) and the paged-decode kernel
(B7) in the decode replicas; sources up to 32 tokens, pages of 16.

* One-shot: ``ServeSession(infer_fn=greedy_decode, ...)`` captures one
  graph a (batch, length) signature at warmup; 8 requests replayed on
  those graphs against the same session built under
  ``compile.disable_capture()`` (eager): outputs bitwise equal, nothing
  captured at serve time, B4 launched once a layer a batch beyond the
  warmup's.
* Two decode replicas on the card, each with its own program (a
  program serves one live session: a second session on it is refused):
  each captured its own graphs, and the fleet's tokens equal one
  replica's.
* A crash on one replica mid-traffic fails its requests over, tokens
  unchanged; then ``push_weights`` under traffic swaps both replicas in
  place: nothing is captured again, and the tokens after the swap equal
  a fresh session's on the new weights.
* ``scale_up`` under traffic: the newcomer captures on its own thread
  while the other replica replays, and every token stays equal.

The token comparisons run in fp32 with TF32 off. Every test needs a
CUDA card and skips without one; run them with ``python -m pytest
--noconftest tests/test_torch_fleet_gpu.py -m gpu``.
"""

import threading
import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

SLOTS, TS, T, PAGE = 4, 32, 24, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _nmt(cuda, seed=0, dtype=torch.float32):
    from parallax_tpu_torch.models import nmt
    cfg = nmt.NMTConfig(vocab_size=1000, model_dim=128, num_heads=2,
                        mlp_dim=256, num_layers=2, max_len=64,
                        num_partitions=1, use_pallas_attention=True,
                        compute_dtype=dtype)
    params = nmt.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(seed), device=cuda)
    return cfg, params


def _srcs(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 1000, (int(rng.integers(4, TS + 1)),))
            .astype(np.int32) for _ in range(n)]


def test_one_shot_graphs_bitwise_against_eager(cuda):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.compile import graphs
    from parallax_tpu_torch.models import nmt
    from parallax_tpu_torch.ops import flash_attention as fa
    cfg, params = _nmt(cuda, dtype=torch.bfloat16)

    def infer_fn(p, batch):
        return {"tokens": nmt.greedy_decode(p, cfg, batch["src"],
                                            max_len=T)}

    def session():
        return pt.ServeSession(
            infer_fn, params, device=cuda,
            example_feed={"src": np.zeros((TS,), np.int32)},
            ragged_feeds=("src",), pad_value=nmt.PAD_ID,
            config=pt.Config(serve_config=pt.ServeConfig(
                max_batch=4, length_buckets=[16, 32], max_wait_ms=20)))

    srcs = _srcs(8)

    def serve(sess):
        reqs = [sess.submit({"src": s}) for s in srcs]
        return [r.result(120)["tokens"] for r in reqs]

    fa.launches = 0
    sess = session()
    try:
        warm = fa.launches
        got = serve(sess)
        stats = sess.stats()
    finally:
        sess.close()
    # 3 batch buckets x 2 lengths, each captured once at warmup (its
    # eager warm call launches B4 once a layer)
    assert stats["serve.graph_captures"] == 6
    assert warm == 6 * cfg.num_layers
    assert stats["serve.recompiles"] == 0
    assert fa.launches - warm == stats["serve.batches"] * cfg.num_layers
    with graphs.disable_capture():
        eager_sess = session()
        try:
            want = serve(eager_sess)
        finally:
            eager_sess.close()
    assert eager_sess.stats()["serve.graph_captures"] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _program(cfg, cuda):
    import parallax_tpu_torch as pt
    return pt.NMTDecodeProgram(cfg, max_src_len=TS, max_len=T,
                               page_size=PAGE,
                               pool_pages=SLOTS * (T // PAGE),
                               attn_impl="kernel", device=cuda)


def _factory(cfg, params, cuda, programs):
    import parallax_tpu_torch as pt
    sc = pt.Config(serve_config=pt.ServeConfig(max_batch=SLOTS,
                                               max_queue=512))

    def make_replica(rid, **kw):
        prog = _program(cfg, cuda)
        programs[rid] = prog
        return pt.ServeSession(program=prog, params=params, config=sc,
                               device=cuda, **kw)
    return make_replica


def _one_replica(cfg, params, cuda, srcs):
    programs = {}
    with _factory(cfg, params, cuda, programs)(0) as sess:
        reqs = [sess.submit({"src": s}, max_new_tokens=T) for s in srcs]
        return [r.result(120).tolist() for r in reqs]


def test_two_replicas_own_programs_equal_one_replica(cuda):
    import parallax_tpu_torch as pt
    cfg, params = _nmt(cuda)
    srcs = _srcs(16, seed=2)
    want = _one_replica(cfg, params, cuda, srcs)
    programs = {}
    make = _factory(cfg, params, cuda, programs)
    fleet = pt.ServeFleet(make, config=pt.FleetConfig(num_replicas=2))
    try:
        with pytest.raises(ValueError, match="one program per replica"):
            pt.ServeSession(program=programs[0], params=params,
                            device=cuda)
        reqs = [fleet.submit({"src": s}, max_new_tokens=T) for s in srcs]
        got = [r.result(120).tolist() for r in reqs]
        placed = {r.replicas[0] for r in reqs}
    finally:
        fleet.close()
    assert got == want
    assert placed == {0, 1}
    for prog in programs.values():
        assert prog._graphs is not None and prog.captures == 2


def test_crash_failover_then_hot_swap_without_capture(cuda):
    import parallax_tpu_torch as pt
    cfg, params = _nmt(cuda, seed=0)
    _, params_b = _nmt(cuda, seed=1)
    srcs = _srcs(16, seed=3)
    want = _one_replica(cfg, params, cuda, srcs)
    want_b = _one_replica(cfg, params_b, cuda, srcs)
    inj = pt.FaultInjector()
    programs = {}
    fleet = pt.ServeFleet(_factory(cfg, params, cuda, programs),
                          config=pt.FleetConfig(num_replicas=3),
                          faults=inj)
    try:
        inj.arm(0, "stall", seconds=0.3)
        t_end = time.perf_counter() + 5.0
        while inj.fired("stall") == 0 and time.perf_counter() < t_end:
            time.sleep(0.002)
        reqs = [fleet.submit({"src": s}, max_new_tokens=T) for s in srcs]
        inj.arm(0, "crash")
        got = [r.result(120).tolist() for r in reqs]
        assert any(len(r.replicas) == 2 for r in reqs)
        captures = {rid: p.captures for rid, p in programs.items()}
        # the swap under traffic: requests keep flowing through the
        # replica not rotated out
        reqs = [fleet.submit({"src": s}, max_new_tokens=T) for s in srcs]
        outcome = fleet.push_weights(params_b)
        for r in reqs:
            r.result(120)
        after = [fleet.submit({"src": s}, max_new_tokens=T)
                 .result(120).tolist() for s in srcs]
        stats = fleet.stats()
    finally:
        fleet.close()
    assert got == want
    assert stats["fleet.failed"] == 0 and stats["fleet.failovers"] >= 1
    assert outcome[0].startswith("skipped")
    assert stats["fleet.hotswaps"] == 2
    assert {rid: p.captures for rid, p in programs.items()} == captures
    assert fleet.recompiles() == 0
    assert after == want_b


def test_scale_up_under_traffic_keeps_tokens(cuda):
    import parallax_tpu_torch as pt
    cfg, params = _nmt(cuda)
    srcs = _srcs(24, seed=4)
    want = _one_replica(cfg, params, cuda, srcs)
    programs = {}
    fleet = pt.ServeFleet(_factory(cfg, params, cuda, programs),
                          config=pt.FleetConfig(num_replicas=1,
                                                max_replicas=2))
    got = [None] * len(srcs)
    try:
        def traffic():
            for i, s in enumerate(srcs):
                got[i] = fleet.submit({"src": s}, max_new_tokens=T)
                time.sleep(0.005)

        th = threading.Thread(target=traffic)
        th.start()
        rid = fleet.scale_up()
        th.join(60)
        out = [r.result(120).tolist() for r in got]
        placed = {r.replicas[-1] for r in got}
    finally:
        fleet.close()
    assert rid == 1 and programs[1].captures == 2
    assert out == want
    assert 0 in placed
