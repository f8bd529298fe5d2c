"""The port's continuous-decode serving against the JAX package's.

Both packages serve the same 8 mixed requests through
``ServeSession(program=NMTDecodeProgram(...))`` on one tiny fp32 config
(paged KV, kernel paged attention, flash encoder attention) with 4
slots, from one JAX parameter tree carried across with
``params_from_jax``: every request's tokens are identical. Then the
port's admission contract: shedding past ``max_queue``, ``ServeClosed``
after close, deadlines, bad ``max_new_tokens``, a fault on the
scheduler thread failing requests instead of hanging them, the device
default, and JAX's validations of chunked prefill, speculative decoding
and the prefix cache (the features themselves are held to JAX in
test_torch_adapters.py, test_torch_spec_decode.py and
test_torch_prefix_cache.py).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parallax_tpu as jpx
from parallax_tpu.models import nmt as jnmt
from parallax_tpu.serve import NMTDecodeProgram as JNMTDecodeProgram
from parallax_tpu.serve import ServeSession as JServeSession
import parallax_tpu_torch as tpx
from parallax_tpu_torch.compile import bucketing
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.serve import (DeadlineExceeded,
                                      ReplicaUnavailable, ServeClosed,
                                      ServeOverloaded)
from parallax_tpu_torch.weights import params_from_jax

CFG = dict(vocab_size=64, model_dim=16, num_heads=2, mlp_dim=32,
           num_layers=2, max_len=16, num_partitions=1,
           use_pallas_attention=True)
PROG = dict(max_src_len=8, max_len=16, page_size=4, pool_pages=16,
            attn_impl="kernel")
LENGTHS = (6, 4, 8, 5, 7, 3, 2, 8)
CAPS = (12, 5, 9, 16, 4, 8, 16, 10)


def _tcfg():
    return tnmt.tiny_config(**CFG, compute_dtype=torch.float32)


def _tparams(cfg):
    return tnmt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _session(cfg, params, program=None, **serve_kw):
    serve_kw.setdefault("max_batch", 4)
    serve_kw.setdefault("max_queue", 64)
    prog = program or tpx.NMTDecodeProgram(cfg, **PROG, device="cpu")
    return tpx.ServeSession(
        program=prog, params=params, device="cpu",
        config=tpx.Config(serve_config=tpx.ServeConfig(**serve_kw)))


def _requests():
    rng = np.random.default_rng(11)
    return [rng.integers(3, 64, (n,)).astype(np.int32) for n in LENGTHS]


def test_served_tokens_identical_to_jax():
    jcfg = jnmt.tiny_config(**CFG, compute_dtype=jnp.float32)
    jparams = jnmt.build_model(jcfg).init_fn(jax.random.PRNGKey(0))
    tcfg = _tcfg()
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    srcs = _requests()

    jprog = JNMTDecodeProgram(jcfg, **PROG)
    jsess = JServeSession(program=jprog, params=jparams,
                          config=jpx.Config(serve_config=jpx.ServeConfig(
                              max_batch=4, max_queue=64)))
    try:
        jreqs = [jsess.submit({"src": s}, max_new_tokens=c)
                 for s, c in zip(srcs, CAPS)]
        jout = [r.result(timeout=300) for r in jreqs]
    finally:
        jsess.close()

    with _session(tcfg, tparams) as tsess:
        treqs = [tsess.submit({"src": s}, max_new_tokens=c)
                 for s, c in zip(srcs, CAPS)]
        tout = [r.result(timeout=300) for r in treqs]
    stats = tsess.stats()
    for j, t in zip(jout, tout):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, np.asarray(j))
    assert stats["serve.completed"] == len(srcs)
    assert stats["serve.prefills"] == len(srcs)
    assert stats["serve.kv_pages_in_use"] == 0
    assert stats["serve.batch_occupancy"]["max"] == 1.0
    assert stats["serve.recompiles"] == 0
    # 8 requests over 4 slots: slots retired and refilled
    assert stats["serve.decode_steps"] < sum(CAPS)


def test_served_tokens_equal_standalone_greedy():
    cfg = _tcfg()
    params = _tparams(cfg)
    srcs = _requests()
    with _session(cfg, params) as sess:
        outs = [sess.submit({"src": s}, max_new_tokens=c).result(60)
                for s, c in zip(srcs, CAPS)]
    for src, cap, out in zip(srcs, CAPS, outs):
        ref = tnmt.greedy_decode(params, cfg, src[None],
                                 max_len=cap)[0].tolist()
        if tnmt.EOS_ID in ref:
            ref = ref[:ref.index(tnmt.EOS_ID) + 1]
        assert out.tolist() == ref
    recs = sess.request_records()
    assert len(recs) == len(srcs)
    assert all(r["outcome"] == "completed" for r in recs)


class _GatedProgram(tpx.NMTDecodeProgram):
    """Steps block on ``gate`` once warmup is over, so the test controls
    when the scheduler is busy."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()
        self.stepping = threading.Event()
        self.armed = False

    def step(self, *a, **kw):
        if self.armed:
            self.stepping.set()
            assert self.gate.wait(60)
        return super().step(*a, **kw)


def test_sheds_past_max_queue_and_refuses_after_close():
    cfg = _tcfg()
    prog = _GatedProgram(cfg, **PROG, device="cpu")
    sess = _session(cfg, _tparams(cfg), program=prog, max_batch=1,
                    max_queue=2)
    src = _requests()[0]
    prog.armed = True
    try:
        first = sess.submit({"src": src}, max_new_tokens=2)
        assert prog.stepping.wait(60)        # `first` holds the one slot
        queued = [sess.submit({"src": src}, max_new_tokens=2)
                  for _ in range(2)]
        with pytest.raises(ServeOverloaded):
            sess.submit({"src": src}, max_new_tokens=2)
        assert sess.stats()["serve.shed"] == 1
    finally:
        prog.gate.set()
        sess.close()
    for r in [first] + queued:
        assert len(r.result(60)) == 2
    with pytest.raises(ServeClosed):
        sess.submit({"src": src})


def test_deadline_and_bad_requests():
    cfg = _tcfg()
    with _session(cfg, _tparams(cfg)) as sess:
        src = _requests()[0]
        with pytest.raises(ValueError, match="max_new_tokens"):
            sess.submit({"src": src}, max_new_tokens=PROG["max_len"] + 1)
        with pytest.raises(ValueError, match="max_src_len"):
            sess.submit({"src": np.arange(3, 13, dtype=np.int32)})
        late = sess.submit({"src": src}, deadline_ms=1e-6)
        with pytest.raises(DeadlineExceeded):
            late.result(60)
    assert sess.stats()["serve.timeouts"] >= 1
    assert sess.stats()["serve.kv_pages_in_use"] == 0


def test_cuda_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    cfg = _tcfg()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpx.NMTDecodeProgram(cfg, max_src_len=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnmt.init_params(cfg, torch.Generator().manual_seed(0))
    prog = tpx.NMTDecodeProgram(cfg, **PROG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpx.ServeSession(program=prog, params=_tparams(cfg))


@pytest.mark.parametrize("kw", [dict(spec_tokens=2),
                                dict(prefill_chunk_layers=1)])
def test_unported_program_options_raise(kw):
    """The options are ported now; what stays refused is what JAX's
    program refuses: speculative decoding without a draft (or with a
    draft of another vocabulary, or too short a positional table), and a
    layer chunk outside [1, num_layers]."""
    cfg = _tcfg()
    L = cfg.num_layers
    if "spec_tokens" in kw:
        with pytest.raises(ValueError, match="without draft_cfg"):
            tpx.NMTDecodeProgram(cfg, **PROG, device="cpu", **kw)
        dcfg, dparams = tpx.serve.layer_skip_draft(cfg, _tparams(cfg))
        for bad, match in ((dict(vocab_size=32), "vocab"),
                           (dict(max_len=8), "positional table")):
            with pytest.raises(ValueError, match=match):
                tpx.NMTDecodeProgram(
                    cfg, **PROG, device="cpu", **kw, draft_params=dparams,
                    draft_cfg=dataclasses.replace(dcfg, **bad))
        with pytest.raises(ValueError, match="outside"):
            tpx.serve.layer_skip_draft(cfg, _tparams(cfg), L + 1)
        prog = tpx.NMTDecodeProgram(cfg, **PROG, device="cpu", **kw,
                                    draft_cfg=dcfg, draft_params=dparams)
        assert prog.spec_tokens == 2 and dcfg.num_layers == 1
    else:
        for c in (0, L + 1):
            with pytest.raises(ValueError, match="outside"):
                tpx.NMTDecodeProgram(cfg, **PROG, device="cpu",
                                     prefill_chunk_layers=c)
        prog = tpx.NMTDecodeProgram(cfg, **PROG, device="cpu", **kw)
        assert prog.num_prefill_chunks == L + 1


def test_unported_scheduler_options_raise():
    """The prefix cache is ported; it still needs a paged program with
    the prefix hooks, as in JAX."""
    cfg = _tcfg()
    dense = tpx.NMTDecodeProgram(cfg, max_src_len=8, max_len=16,
                                 device="cpu")
    with pytest.raises(ValueError, match="PAGED"):
        _session(cfg, _tparams(cfg), program=dense, prefix_cache=True)
    with _session(cfg, _tparams(cfg), prefix_cache=True) as sess:
        out = sess.submit({"src": _requests()[0]},
                          max_new_tokens=4).result(60)
    assert len(out) <= 4 and sess.prefix_stats()["entries"] == 0


def test_bucketing_matches_jax():
    from parallax_tpu.compile import bucketing as jbucketing
    row = np.arange(3, 8, dtype=np.int32)
    np.testing.assert_array_equal(bucketing.pad_axis0(row, 9, 0),
                                  jbucketing.pad_axis0(row, 9, 0))
    with pytest.raises(ValueError, match="truncate"):
        bucketing.pad_axis0(row, 2)
    feed = {"src": np.zeros((4, 8), np.int32),
            "w": np.ones((4,), np.float32)}
    assert bucketing.batch_signature(feed) == \
        jbucketing.batch_signature(feed)


class _FailingProgram(tpx.NMTDecodeProgram):
    """Steps raise once warmup is over: a fault on the scheduler thread."""

    armed = False

    def step(self, *a, **kw):
        if self.armed:
            raise RuntimeError("injected step fault")
        return super().step(*a, **kw)


def test_scheduler_fault_fails_requests_instead_of_hanging():
    cfg = _tcfg()
    prog = _FailingProgram(cfg, **PROG, device="cpu")
    sess = _session(cfg, _tparams(cfg), program=prog)
    prog.armed = True
    try:
        req = sess.submit({"src": _requests()[0]}, max_new_tokens=4)
        with pytest.raises(ReplicaUnavailable, match="injected step fault"):
            req.result(60)
        assert not sess._scheduler.alive
        with pytest.raises(ServeClosed):
            sess.submit({"src": _requests()[0]})
    finally:
        sess.close()
    assert sess.stats()["serve.kv_pages_in_use"] == 0
