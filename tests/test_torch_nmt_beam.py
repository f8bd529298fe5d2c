"""The port's NMT beam search and corpus BLEU against the JAX package's.

fp32, the tiny NMT (vocab 512, D 32, 2 heads, 2 + 2 layers), one JAX
parameter tree carried across with ``params_from_jax``; 6 sources of 9
ids (two padded), at most 12 decoded tokens.

Random weights rarely emit EOS, so the ``eos`` tree adds a direction to
the last decoder LayerNorm's bias and the same direction to EOS's output
column: beams finish at different lengths and the length penalty picks
among them (alpha 0 and 1 choose differently). The ``tie`` tree also
gives tokens 5 and 6 one output column, boosted toward the top: their
logits are equal bit for bit at every step, so the joint top-k meets
exact ties, and ``lax.top_k``'s order (the lowest flat index first) must
be the port's. ``plain`` is the tree as drawn (nothing finishes: the
best raw beam wins).

(a) ``beam_decode``, cached and cacheless, against JAX's at beam 1, 3 and
    4 and alpha 0, 0.6 and 1.0 (``eos``), the ties (``tie``, beam 3 and
    4) and ``plain``: identical ids.
(b) ``ids_to_tokens`` and ``corpus_bleu`` (smoothed and not, max order 4
    and 2, the length mismatch error) against JAX's on the same token
    lists: equal to the last bit.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallax_tpu.common import evaluation as jeval
from parallax_tpu.models import nmt as jnmt
from parallax_tpu_torch.common import evaluation as teval
from parallax_tpu_torch.models import nmt as tnmt
from parallax_tpu_torch.weights import params_from_jax

MAX_LEN = 12


def _trees():
    jcfg = jnmt.tiny_config(compute_dtype=jnp.float32)
    base = jax.tree.map(np.asarray,
                        jnmt.build_model(jcfg).init_fn(jax.random.PRNGKey(0)))
    u = np.random.default_rng(1).standard_normal(jcfg.model_dim) \
        .astype(np.float32)
    u /= np.linalg.norm(u)
    eos = copy.deepcopy(base)
    eos["dec"][-1]["ln2"]["b"] = 2.0 * u
    eos["out_proj"][:, jnmt.EOS_ID] += 4.0 * u
    tie = copy.deepcopy(eos)
    tie["out_proj"][:, 5] += 3.8 * u
    tie["out_proj"][:, 6] = tie["out_proj"][:, 5]
    return jcfg, {"plain": base, "eos": eos, "tie": tie}


@pytest.fixture(scope="module")
def setup():
    jcfg, trees = _trees()
    tcfg = tnmt.tiny_config(compute_dtype=torch.float32)
    carried = {k: params_from_jax(v, tcfg, "cpu") for k, v in trees.items()}
    src = np.random.default_rng(0).integers(3, jcfg.vocab_size, (6, 9)) \
        .astype(np.int32)
    src[1, 6:] = 0
    src[3, 4:] = 0
    return jcfg, trees, tcfg, carried, src


CASES = ([("eos", k, a) for k in (1, 3, 4) for a in (0.0, 0.6, 1.0)]
         + [("tie", 3, 0.6), ("tie", 4, 0.6), ("plain", 4, 1.0)])


@pytest.mark.parametrize("use_cache", [True, False],
                         ids=["cached", "cacheless"])
@pytest.mark.parametrize("tree,beam,alpha", CASES,
                         ids=[f"{t}-k{k}-a{a}" for t, k, a in CASES])
def test_beam_decode_matches_jax(setup, tree, beam, alpha, use_cache):
    jcfg, trees, tcfg, carried, src = setup
    want = np.asarray(jnmt.beam_decode(trees[tree], jcfg, src,
                                       beam_width=beam, alpha=alpha,
                                       max_len=MAX_LEN, use_cache=use_cache))
    got = tnmt.beam_decode(carried[tree], tcfg, src, beam_width=beam,
                           alpha=alpha, max_len=MAX_LEN, use_cache=use_cache)
    assert got.dtype == torch.int32 and got.shape == (6, MAX_LEN)
    np.testing.assert_array_equal(got.numpy(), want)
    if tree == "tie":
        assert ((want == 5) | (want == 6)).any()
    if tree == "eos":
        assert (want == jnmt.EOS_ID).any()


def test_length_penalty_changes_the_choice(setup):
    """The ``eos`` tree is where alpha matters (the cases above would
    pass with the penalty ignored otherwise)."""
    jcfg, trees, tcfg, carried, src = setup
    outs = [tnmt.beam_decode(carried["eos"], tcfg, src, beam_width=4,
                             alpha=a, max_len=MAX_LEN).numpy()
            for a in (0.0, 1.0)]
    assert not np.array_equal(*outs)


def test_ids_to_tokens_and_corpus_bleu_match_jax(setup):
    jcfg, trees, tcfg, carried, src = setup
    rows = tnmt.beam_decode(carried["eos"], tcfg, src, beam_width=4,
                            alpha=0.6, max_len=MAX_LEN).numpy()
    rows = np.concatenate([rows, [[1, 7, 0, 9, 2, 8], [7, 8, 9, 10, 11, 2]]
                           + [[0] * 6] * 4], axis=1)
    greedy = tnmt.greedy_decode(carried["eos"], tcfg, src,
                                max_len=MAX_LEN).numpy()
    names = {i: f"w{i}" for i in range(jcfg.vocab_size)}
    for row in list(rows) + list(greedy):
        assert tnmt.ids_to_tokens(row) == jnmt.ids_to_tokens(row)
        assert tnmt.ids_to_tokens(row, names) == \
            jnmt.ids_to_tokens(row, names)
    hyps = [tnmt.ids_to_tokens(r) for r in rows]
    refs = [tnmt.ids_to_tokens(r) for r in greedy]
    rng = np.random.default_rng(9)
    long_refs = [[str(t) for t in rng.integers(3, 12, 20)] for _ in range(8)]
    long_hyps = [r[:15] + [str(t) for t in rng.integers(3, 12, 4)]
                 for r in long_refs]
    for r, h in ((refs, hyps), (long_refs, long_hyps), (long_hyps, long_refs)):
        for kw in ({}, {"smooth": True}, {"max_order": 2}):
            assert teval.corpus_bleu(r, h, **kw) == \
                jeval.corpus_bleu(r, h, **kw)
    assert 0.0 < teval.corpus_bleu(long_refs, long_hyps) < 100.0
    assert teval.corpus_bleu(long_refs, long_refs) == 100.0
    with pytest.raises(ValueError, match="references"):
        teval.corpus_bleu(refs, hyps[:-1])
