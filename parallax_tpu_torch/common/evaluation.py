"""Corpus-level evaluation metrics (``parallax_tpu/common/evaluation.py``,
kept here as the port's own copy).

Reference: examples/nmt/utils/evaluation_utils.py — Moses-style corpus
BLEU (clipped modified n-gram precision, geometric mean over 1..4-grams,
brevity penalty). Pure Python; token sequences are lists of hashables
(strings or ids), e.g. ``models.nmt.ids_to_tokens`` of decoded rows.
"""

from __future__ import annotations

import collections
import math
from typing import List, Sequence


def _ngrams(tokens: Sequence, n: int) -> collections.Counter:
    return collections.Counter(
        tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(references: List[Sequence], hypotheses: List[Sequence],
                max_order: int = 4, smooth: bool = False) -> float:
    """Corpus BLEU in [0, 100]. ``references[i]`` is the single reference
    for ``hypotheses[i]``."""
    if len(references) != len(hypotheses):
        raise ValueError(
            f"got {len(references)} references for "
            f"{len(hypotheses)} hypotheses")
    matches = [0] * max_order
    possible = [0] * max_order
    ref_len = hyp_len = 0
    for ref, hyp in zip(references, hypotheses):
        ref, hyp = list(ref), list(hyp)
        ref_len += len(ref)
        hyp_len += len(hyp)
        for n in range(1, max_order + 1):
            overlap = sum((_ngrams(hyp, n) & _ngrams(ref, n)).values())
            matches[n - 1] += overlap
            possible[n - 1] += max(len(hyp) - n + 1, 0)
    precisions = []
    for n in range(max_order):
        if smooth:
            p = (matches[n] + 1.0) / (possible[n] + 1.0)
        elif possible[n] > 0 and matches[n] > 0:
            p = matches[n] / possible[n]
        else:
            p = 0.0
        precisions.append(p)
    if min(precisions) <= 0:
        return 0.0
    geo_mean = math.exp(
        sum(math.log(p) for p in precisions) / max_order)
    if hyp_len == 0:
        return 0.0
    ratio = hyp_len / max(ref_len, 1)
    bp = 1.0 if ratio > 1.0 else math.exp(1.0 - 1.0 / max(ratio, 1e-9))
    return 100.0 * geo_mean * bp


__all__ = ["corpus_bleu"]
