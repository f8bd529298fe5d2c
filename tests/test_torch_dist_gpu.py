"""The multi-rank engine on the card: a one-rank NCCL process group.

LM1B-tiny (HYBRID, slices mode, dropout on) runs 3 steps through
``parallel_run`` inside a one-rank NCCL group twice from one seed:
eagerly (``compile.disable_capture()``) and as replays of the step's
captured CUDA graph, whose dense-gradient all-reduce is NCCL's. The
losses and every parameter after the steps agree bitwise. Needs a CUDA
card and skips without one; run it with ``python -m pytest --noconftest
tests/test_torch_dist_gpu.py -m gpu``.
"""

import contextlib
import datetime

import numpy as np
import pytest
import torch

import parallax_tpu_torch as pt
from parallax_tpu_torch.compile import graphs
from parallax_tpu_torch.core.classify import flatten
from parallax_tpu_torch.models import lm1b

pytestmark = pytest.mark.gpu


@pytest.fixture
def nccl_group(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.set_device(0)
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    yield
    torch.distributed.destroy_process_group()


def _run(cfg, batches, capture):
    sess, world, rank, _ = pt.parallel_run(
        lm1b.build_model(cfg),
        parallax_config=pt.Config(run_option="HYBRID",
                                  sparse_grad_mode="slices"), seed=0)
    assert (world, rank) == (1, 0)
    assert sess.mesh.distributed and sess.mesh.world.size == 1
    mode = contextlib.nullcontext() if capture else graphs.disable_capture()
    with mode:
        losses = [float(sess.run("loss", feed_dict=b)) for b in batches]
    params = {p: t.detach().clone() for p, t in flatten(sess.state.params)}
    graphs_held = sum(g is not None for g in sess.engine._executables.values())
    sess.close()
    return losses, params, graphs_held


def test_one_rank_nccl_step_replays_equal_eager(nccl_group):
    assert torch.distributed.get_backend() == "nccl"
    cfg = lm1b.tiny_config(sparse_grad_mode="slices", keep_prob=0.9)
    rng = np.random.default_rng(0)
    batches = [lm1b.make_batch(rng, 8, 5, cfg.vocab_size) for _ in range(3)]
    eager, eager_params, none = _run(cfg, batches, capture=False)
    graph, graph_params, held = _run(cfg, batches, capture=True)
    assert (none, held) == (0, 1)
    assert graph == eager
    for path, want in eager_params.items():
        assert torch.equal(graph_params[path], want), path
