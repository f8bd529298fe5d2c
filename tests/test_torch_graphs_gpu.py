"""The kernel wrappers inside captured CUDA graphs, on the card.

For each wrapper of the training and serving paths (B2 and B3, the
cooperative persistent LSTM kernels, at the LM1B shape; B4, B5 and B6,
the TMA-fed flash kernels, at NMT's training shape; B7, the paged
decode, at the serving shape) a call is captured once on static input
buffers (``compile.graphs.capture``), then replayed three times on new
inputs copied into those buffers. Each replay equals the eager call on
the same inputs bitwise, and advances the launch counters by what the
capture recorded, once a replay. Between replays the test allocates and
frees other tensors, so a host-encoded TMA descriptor pointing anywhere
but at a buffer the graph owns would read the wrong memory; the
persistent kernels' grid-barrier counter, a ``torch.zeros`` inside the
call, is reset by each replay or the barrier would not hold. A captured
persistent launch keeps its cooperative attribute in the graph. Every
test here needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_graphs_gpu.py -m gpu``.
"""

import ctypes

import numpy as np
import pytest
import torch

from parallax_tpu_torch.compile import graphs
from parallax_tpu_torch.ops import flash_attention as fa
from parallax_tpu_torch.ops import lstm
from parallax_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.gpu

REPLAYS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _replays_equal_eager(cuda, fn, inputs, fresh):
    """Capture ``fn(*inputs)`` on the static ``inputs``; then
    ``REPLAYS`` times copy ``fresh(i)`` in, replay, and hold the outputs
    to an eager call on the same values (bitwise) and the counters to
    the captured launches. Returns the graph."""
    g = graphs.capture(lambda: fn(*inputs), cuda)
    assert g.launches and all(n > 0 for n in g.launches.values())
    for i in range(REPLAYS):
        for buf, new in zip(inputs, fresh(i)):
            buf.copy_(new)
        # churn the allocator between replays
        junk = [torch.randn((1 << 20,), device=cuda) for _ in range(4)]
        del junk
        before = graphs.read_counters()
        out = g.replay()
        torch.cuda.synchronize()
        after = graphs.read_counters()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == g.launches
        with graphs.disable_capture():
            want = fn(*[t.clone() for t in inputs])
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        wants = want if isinstance(want, tuple) else (want,)
        for got, ref in zip(outs, wants):
            assert torch.equal(got, ref), i
    return g


def _lstm_inputs(cuda, seed, T=20, B=128, H=2048, P=512):
    gen = torch.Generator(device=cuda).manual_seed(seed)

    def r(shape, scale, dt=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(dt)
    return (r((T, B, 4 * H), 1.0), r((P, 4 * H), 1.0 / np.sqrt(P)),
            r((H, P), 1.0 / np.sqrt(H)), r((T, B, P), 1.0, torch.float32))


def test_lstm_sm90_forward_replays_equal_eager(cuda):
    xw, w_h, w_proj, _ = _lstm_inputs(cuda, 0)
    assert lstm.device_fwd_route(xw, w_proj).source == "lstm_sm90"
    g = _replays_equal_eager(
        cuda, lambda a, b, c: lstm.lstm_recurrence(a, b, c, residuals=True),
        [xw, w_h, w_proj], lambda i: _lstm_inputs(cuda, i + 1)[:3])
    assert g.launches == {("parallax_tpu_torch.ops.lstm",
                           "launches_fwd_res"): 1}


def test_lstm_sm90_backward_replays_equal_eager(cuda):
    xw, w_h, w_proj, gout = _lstm_inputs(cuda, 0)
    _, gates, cseq = lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                                residuals=True)
    assert lstm.device_bwd_route(gout, w_proj).source == "lstm_sm90"

    def fresh(i):
        x2, wh2, wp2, g2 = _lstm_inputs(cuda, i + 1)
        _, ga2, c2 = lstm.lstm_recurrence_plain(x2, wh2, wp2,
                                                residuals=True)
        return g2, ga2, c2, wh2, wp2

    g = _replays_equal_eager(cuda, lstm.lstm_bwd_recurrence,
                             [gout, gates, cseq, w_h, w_proj], fresh)
    assert g.launches == {("parallax_tpu_torch.ops.lstm",
                           "launches_bwd"): 1}


def _flash_inputs(cuda, seed, B=64, T=64, H=8, hd=64):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=gen, device=cuda,
                                 dtype=torch.bfloat16) for _ in range(4))
    mask = (torch.rand((B, T), generator=gen, device=cuda) < 0.8).int()
    mask[:, 0] = 1
    return q, k, v, mask, dout


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_and_backward_replay_equal_eager(cuda, causal):
    """B4, then B5 and B6 through autograd, as the NMT step runs them."""
    def fn(q, k, v, mask, dout):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(q, k, v, causal=causal, kv_mask=mask)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
        return out.detach(), dq, dk, dv

    g = _replays_equal_eager(cuda, fn, list(_flash_inputs(cuda, 0)),
                             lambda i: _flash_inputs(cuda, i + 1))
    mod = "parallax_tpu_torch.ops.flash_attention"
    assert g.launches == {(mod, "launches"): 1, (mod, "launches_dq"): 1,
                          (mod, "launches_dkv"): 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_replays_equal_eager(cuda, dtype):
    """B7 at the serving shape: 64 slots, 8 heads of 64, pages of 16, a
    512-page pool, 8 pages a slot; the table and positions change at
    every replay."""
    S, H, hd, ps, P, pool = 64, 8, 64, 16, 8, 512

    def inputs(seed):
        rng = np.random.default_rng(seed)
        pages = np.full((S, P), pool, np.int32)
        pos = np.zeros((S, 1), np.int32)
        perm = rng.permutation(pool)
        for s in range(S):
            n = int(rng.integers(0, P + 1))
            pages[s, :n] = perm[(s * P) % pool:(s * P) % pool + n]
            pos[s, 0] = max(n * ps - 1 - int(rng.integers(0, ps)), 0)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        q = torch.randn((S, 1, H * hd), generator=gen, device=cuda,
                        dtype=dtype)
        kp = torch.randn((pool + 1, ps, H * hd), generator=gen,
                         device=cuda, dtype=dtype)
        vp = torch.randn((pool + 1, ps, H * hd), generator=gen,
                         device=cuda, dtype=dtype)
        return [q, kp, vp, torch.from_numpy(pages).to(cuda),
                torch.from_numpy(pos).to(cuda)]

    kw = dict(num_heads=H, page_size=ps, pool_pages=pool)
    g = _replays_equal_eager(
        cuda, lambda *a: pa.paged_decode_attention(*a, **kw), inputs(0),
        lambda i: inputs(i + 1))
    assert g.launches[("parallax_tpu_torch.ops.paged_attention",
                       "launches")] == 1


def _cudart():
    for name in ("libcudart.so.12", "libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    pytest.fail("libcudart not found to read the graph's nodes")


def _cooperative_kernel_nodes(raw_graph: int):
    """(kernel nodes, cooperative kernel nodes) of a ``cudaGraph_t``."""
    rt = _cudart()
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(ctypes.c_void_p(raw_graph), None,
                                ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert rt.cudaGraphGetNodes(ctypes.c_void_p(raw_graph), nodes,
                                ctypes.byref(n)) == 0
    kernels = coop = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        if kind.value != 0:                     # cudaGraphNodeTypeKernel
            continue
        kernels += 1
        value = (ctypes.c_byte * 64)()          # cudaLaunchAttributeValue
        # cudaLaunchAttributeCooperative = 2
        assert rt.cudaGraphKernelNodeGetAttribute(
            ctypes.c_void_p(node), 2, value) == 0
        coop += int(ctypes.cast(value, ctypes.POINTER(ctypes.c_int))[0] != 0)
    return kernels, coop


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_captured_persistent_launch_stays_cooperative(cuda, which):
    """The graph node of a captured B2 or B3 launch carries the
    cooperative attribute (its grid barrier needs every block resident);
    no other node of the capture does."""
    xw, w_h, w_proj, gout = _lstm_inputs(cuda, 0)
    _, gates, cseq = lstm.lstm_recurrence_plain(xw, w_h, w_proj,
                                                residuals=True)
    if which == "fwd":
        def fn():
            return lstm.lstm_recurrence(xw, w_h, w_proj, residuals=True)
    else:
        def fn():
            return lstm.lstm_bwd_recurrence(gout, gates, cseq, w_h, w_proj)
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    kernels, coop = _cooperative_kernel_nodes(g.raw_cuda_graph())
    assert kernels >= 2 and coop == 1, (kernels, coop)
