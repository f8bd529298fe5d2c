"""Serving over a mesh of cards: ``ServeSession(..., model=, mesh=)`` on
NCCL ranks, one a card (a (2, 2) mesh on four cards, (1, 2) on two or
three), rank 0 leading and the others replaying its dispatches.

* NMT decode (D 128, 2 heads of 64, bf16, the flash encoder B4 and the
  paged decode B7 in captured graphs whose sharded lookups of ``emb``
  are NCCL collectives): every request's tokens equal to one card's
  session on the whole table, bitwise.
* LM1B decode in fp32 with the softmax table row-sharded: tokens equal
  to one card's (the argmax over the ranks' (max, id) pairs).
* One-shot serving of an fp32 lookup-and-project model, buckets split
  over the ranks and whole: outputs within 1e-5 of one card's.

Each rank holds V/p rows of every sharded table, every rank returns
from ``close()``, and then from ``destroy_process_group()``. Needs two CUDA cards or more and skips with fewer; run
it with ``python -m pytest --noconftest tests/test_torch_serve_mesh_gpu.py
-m gpu`` on a machine with four.
"""

import datetime
import faulthandler
import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

DEADLINE_S = 300
NMT = dict(vocab_size=1000, model_dim=128, num_heads=2, mlp_dim=256,
           num_layers=2, max_len=64, num_partitions=2,
           use_pallas_attention=True)
PROG = dict(max_src_len=32, max_len=32, page_size=16, pool_pages=64,
            attn_impl="kernel")


def _srcs(n, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 1000, (int(rng.integers(4, 33)),))
            .astype(np.int32) for _ in range(n)]


def _infer(params, batch):
    from parallax_tpu_torch.ops import embedding
    h = embedding.embedding_lookup(params["emb"], batch["ids"]) \
        @ params["w"]
    return {"h": h}


def _toy_model():
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import optim

    def loss_fn(params, batch):
        return (_infer(params, batch)["h"] ** 2).mean()

    return pt.Model(lambda gen, device: None, loss_fn,
                    optimizer=optim.sgd(0.1))


def _serve_all(sess, feeds, caps=None):
    reqs = [sess.submit(f, max_new_tokens=c) if caps else sess.submit(f)
            for f, c in zip(feeds, caps or [None] * len(feeds))]
    return [r.result(timeout=300) for r in reqs]


def _sessions(mesh, rank):
    """(name, session factory, feeds, caps, rows leaf) for each case, the
    factory building the session on ``mesh`` (None: one card)."""
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.core import mesh as mesh_lib
    from parallax_tpu_torch.models import lm1b, nmt

    dev = torch.device("cuda", rank)
    g = torch.Generator(device=dev)
    ncfg = nmt.NMTConfig(**NMT)
    nparams = nmt.init_params(ncfg, g.manual_seed(0), device=dev)
    lcfg = lm1b.tiny_config(compute_dtype=torch.float32, num_partitions=2)
    lparams = lm1b.init_params(lcfg, g.manual_seed(3), dev)
    tparams = {"emb": torch.randn((64, 16), generator=g.manual_seed(5),
                                  device=dev),
               "w": torch.randn((16, 8), generator=g, device=dev)}
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, lcfg.vocab_size, (int(n),)).astype(np.int32)
               for n in rng.integers(2, 9, 12)]
    ids = [rng.integers(0, 64, (3,)).astype(np.int32) for _ in range(24)]

    def config(**sc):
        return pt.Config(serve_config=pt.ServeConfig(**sc))

    def on(m, **kw):
        # one card: a mesh of this rank alone (the default mesh would span
        # the process group, collectively)
        return dict(mesh=m, **kw) if m is not None \
            else dict(mesh=mesh_lib.Mesh(dev))

    return [
        ("nmt", lambda m: pt.ServeSession(
            program=pt.NMTDecodeProgram(ncfg, **PROG, device=dev),
            params=nparams, config=config(max_batch=8, max_queue=64),
            **on(m, model=nmt.build_model(ncfg))),
         [{"src": s} for s in _srcs(24)], [32] * 24, "emb"),
        ("lm1b", lambda m: pt.ServeSession(
            program=pt.LM1BDecodeProgram(lcfg, 8, 8, device=dev),
            params=lparams, config=config(max_batch=8, max_queue=64),
            **on(m, model=lm1b.build_model(lcfg))),
         [{"ids": p} for p in prompts], [8] * 12, "softmax_w"),
        ("oneshot", lambda m: pt.ServeSession(
            _infer, tparams, example_feed={"ids": np.zeros(3, np.int32)},
            config=config(max_batch=8, max_wait_ms=20.0),
            **on(m, model=_toy_model())),
         [{"ids": i} for i in ids], None, "emb"),
    ]


def _rank(rank, world, shape, store, out_dir):
    # a rank still running near the deadline prints every thread's stack
    faulthandler.dump_traceback_later(DEADLINE_S - 30)
    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        from parallax_tpu_torch.core import mesh as mesh_lib
        from parallax_tpu_torch.ops import flash_attention as fa
        from parallax_tpu_torch.ops import paged_attention as pa
        mesh = mesh_lib.build_mesh(f"cuda:{rank}", shape=shape)
        out = {}
        for name, make, feeds, caps, leaf in _sessions(mesh, rank):
            fa.launches = pa.launches = 0
            sess = make(mesh)
            rows = tuple(sess._params[leaf].shape)
            got = _serve_all(sess, feeds, caps) if rank == 0 else None
            sess.close()
            out[name] = {"rows": rows, "got": got,
                         "launches": (fa.launches, pa.launches)}
            if rank == 0:
                one = make(None)
                out[name]["want"] = _serve_all(one, feeds, caps)
                one.close()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        traceback.print_exc()
        os._exit(1)
    # every session is closed (the last one still referenced here): the
    # teardown returns on every rank, since close() destroyed the graphs
    # that held the mesh's NCCL communicators
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two CUDA cards or more")
    shape = (2, 2) if n >= 4 else (1, 2)
    world = shape[0] * shape[1]
    tmp = tmp_path_factory.mktemp("serve_mesh_gpu")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, world, shape,
                                             str(tmp / "store"), str(tmp)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    assert not alive, f"ranks still running after {DEADLINE_S}s"
    assert [p.exitcode for p in procs] == [0] * world
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return shape, out


def test_decode_tokens_equal_one_card(ranks):
    _, out = ranks
    for name in ("nmt", "lm1b"):
        for g, w in zip(out[0][name]["got"], out[0][name]["want"]):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_oneshot_outputs_match_one_card(ranks):
    _, out = ranks
    for g, w in zip(out[0]["oneshot"]["got"], out[0]["oneshot"]["want"]):
        np.testing.assert_allclose(g["h"], w["h"], rtol=1e-5, atol=1e-6)


def test_each_rank_holds_its_rows_and_launches_the_kernels(ranks):
    shape, out = ranks
    p = shape[1]
    for r in out:
        assert r["nmt"]["rows"] == (1000 // p, 128)
        assert r["lm1b"]["rows"] == (1000 // p, 32)
        assert r["oneshot"]["rows"] == (64 // p, 16)
        fa_n, pa_n = r["nmt"]["launches"]
        assert fa_n > 0 and pa_n > 0
