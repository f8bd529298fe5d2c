"""BERT on the card: B4-B6 at BERT-large's attention shape, and the
captured BERT training step against the eager one.

* The bf16 flash forward (B4), dq (B5) and dk/dv (B6) at B 32, T 512,
  16 heads of 64, non-causal, with a padding mask whose lengths are
  drawn in [384, 512] (``chip_smoke.py``'s ``bert`` case), against their
  plain versions within 2e-2 of the plain result's peak (the bf16
  kernels' budget); each wrapper's launch counter advances by one a
  call. Padded query rows still see every real key, so their outputs
  are finite.
* A BERT with BERT-large's head width (hd 64, 2 layers, D 128, batch 4
  x 128, bf16, flash attention) trained 3 steps eagerly
  (``compile.disable_capture()``) and 3 steps as replays of the step's
  captured graph, from fresh sessions of one seed on the same batches:
  losses and every state tensor bitwise equal.

Every test needs a CUDA card and skips without one; run them with
``python -m pytest --noconftest tests/test_torch_bert_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

BF16_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bert_inputs(cuda, B=32, T=512, H=16, hd=64):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, dout = (torch.randn((B, T, H, hd), generator=g, device=cuda,
                                 dtype=torch.bfloat16) for _ in range(4))
    lengths = np.random.default_rng(0).integers(384, T + 1, B)
    mask = (torch.arange(T, device=cuda)[None, :] < torch.as_tensor(
        lengths, device=cuda)[:, None]).to(torch.int32)
    return q, k, v, dout, mask


def _close(got, want):
    peak = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= BF16_REL * max(peak, 1e-6), (err, peak)
    assert bool(torch.isfinite(got.float()).all())


def test_flash_kernels_at_bert_shape_match_plain(cuda):
    from parallax_tpu_torch.ops import flash_attention as fa
    q, k, v, dout, mask = _bert_inputs(cuda)
    scale = 1.0 / 8.0
    before = (fa.launches, fa.launches_dq, fa.launches_dkv)
    out, lse = fa.flash_attention_lse(q, k, v, kv_mask=mask)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, kv_mask=mask)
    _close(out, ref)
    assert (lse - ref_lse).abs().max().item() <= \
        1e-2 * max(ref_lse.abs().max().item(), 1.0)
    delta = fa.flash_delta(ref, dout)
    args = (q, k, v, mask, dout, ref_lse, delta, False, scale)
    _close(fa.flash_dq(*args), fa.flash_dq_plain(*args))
    for got, want in zip(fa.flash_dkv(*args), fa.flash_dkv_plain(*args)):
        _close(got, want)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == tuple(
        n + 1 for n in before)


def _session(cuda):
    import parallax_tpu_torch as pt
    from parallax_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=1000, hidden_dim=128, num_heads=2,
                          mlp_dim=256, num_layers=2, max_len=128,
                          num_partitions=1, use_pallas_attention=True)
    sess, *_ = pt.parallel_run(
        bert.build_model(cfg), parallax_config=pt.Config(run_option="HYBRID"),
        seed=0, device=cuda)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        b = bert.make_batch(rng, 4, 128, 10, cfg.vocab_size)
        b["input_ids"][1, 100:] = 0
        batches.append(b)
    return sess, batches


def test_captured_bert_step_replays_bitwise_against_eager(cuda):
    from parallax_tpu_torch.compile import graphs
    from parallax_tpu_torch.core.engine import state_tensors
    runs = {}
    for mode in ("eager", "graph"):
        sess, batches = _session(cuda)
        sess.prepare(batches[0])
        if mode == "eager":
            with graphs.disable_capture():
                losses = [float(sess.run("loss", feed_dict=b))
                          for b in batches]
        else:
            losses = [float(sess.run("loss", feed_dict=b)) for b in batches]
        captured = sum(g is not None
                       for g in sess.engine._executables.values())
        assert captured == (mode == "graph")
        runs[mode] = (losses, [t.detach().clone()
                               for t in state_tensors(sess.state)])
        sess.close()
    (le, se), (lg, sg) = runs["eager"], runs["graph"]
    assert all(np.isfinite(le)) and le == lg
    assert len(se) == len(sg)
    for a, b in zip(se, sg):
        assert torch.equal(a, b)
