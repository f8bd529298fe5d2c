"""File-based NMT vocab, parallel-corpus loading and batching
(``parallax_tpu/data/nmt_data.py``, same semantics and same batches).

* vocab: one token per line; PAD/BOS/EOS/UNK are forced to the fixed ids
  the model uses (models/nmt.py PAD_ID/BOS_ID/EOS_ID, UNK_ID here),
  prepended when the file does not carry them;
* batching: a captured step wants static shapes, so sentences are
  bucketed into a fixed set of length buckets (multiples of
  ``bucket_width`` up to ``max_len``) and every batch is padded to its
  bucket bound: a handful of signatures, stable across epochs;
* sharding: ``num_shards``/``shard_index`` take row stripes of one global
  batch stream, so every rank sees the same shapes at the same steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID, BOS_ID, EOS_ID, UNK_ID = 0, 1, 2, 3
_SPECIALS = ("<pad>", "<s>", "</s>", "<unk>")


class Vocab:
    """Token <-> id mapping with UNK fallback and forced special ids."""

    def __init__(self, tokens: Sequence[str]):
        toks = list(tokens)
        # force the model's fixed special ids (prepend missing ones —
        # the reference's check_vocab writes a corrected copy instead;
        # same semantics, no file churn)
        if toks[:len(_SPECIALS)] != list(_SPECIALS):
            n_present = sum(t in _SPECIALS for t in toks)
            toks = [t for t in _SPECIALS] + [
                t for t in toks if t not in _SPECIALS]
            # the remap shifts every token id relative to the file's
            # line numbers; unlike the reference we don't rewrite the
            # file, so externally pre-encoded data keyed by line index
            # would silently mislabel — say so
            import logging
            logging.getLogger("parallax").warning(
                "vocab: %d special token(s) prepended, %d moved to ids "
                "0-3; token ids no longer match the file's line "
                "numbers", len(_SPECIALS) - n_present, n_present)
        self.id_to_token: List[str] = toks
        self.token_to_id: Dict[str, int] = {
            t: i for i, t in enumerate(toks)}

    def __len__(self) -> int:
        return len(self.id_to_token)

    @classmethod
    def load(cls, path: str) -> "Vocab":
        # rstrip CR too: a CRLF vocab file would otherwise carry '\r' in
        # every token and silently encode the whole corpus to UNK
        with open(path, encoding="utf-8") as f:
            return cls([line.rstrip("\r\n") for line in f
                        if line.strip()])

    def encode(self, text: str) -> List[int]:
        return [self.token_to_id.get(t, UNK_ID) for t in text.split()]

    def decode(self, ids: Sequence[int]) -> List[str]:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in (PAD_ID, BOS_ID):
                continue
            out.append(self.id_to_token[i] if 0 <= i < len(self)
                       else _SPECIALS[UNK_ID])
        return out


def load_parallel_corpus(src_path: str, tgt_path: str, vocab: Vocab,
                         max_len: int,
                         tgt_vocab: Optional[Vocab] = None
                         ) -> List[Tuple[List[int], List[int]]]:
    """Read paired src/tgt files -> [(src_ids, tgt_ids)], dropping empty
    pairs and pairs longer than ``max_len`` after the BOS/EOS the model
    adds (the reference's tf.logical_and length filter,
    iterator_utils.py)."""
    import itertools

    tv = tgt_vocab or vocab
    pairs = []
    with open(src_path, encoding="utf-8") as fs, \
            open(tgt_path, encoding="utf-8") as ft:
        for i, (s_line, t_line) in enumerate(
                itertools.zip_longest(fs, ft)):
            if s_line is None or t_line is None:
                # silent zip-truncation is THE classic paired-corpus
                # data-loss bug; misaligned files must be an error
                # (streaming check: O(1) memory on huge corpora)
                short = src_path if s_line is None else tgt_path
                raise ValueError(
                    f"parallel corpus line-count mismatch: {short} "
                    f"ends at line {i} before its pair file")
            s, t = vocab.encode(s_line), tv.encode(t_line)
            # tgt gets BOS prepended (input) and EOS appended (output)
            if s and t and len(s) <= max_len and len(t) + 1 <= max_len:
                pairs.append((s, t))
    return pairs


@dataclasses.dataclass
class NMTBatchIterator:
    """Static-shape bucketing batch iterator over a parallel corpus.

    Each epoch: shuffle (seeded, epoch-keyed), mod-shard, group into
    length buckets (bucket bound = smallest multiple of ``bucket_width``
    holding both sides), emit batches padded to the bucket bound. Feed
    dict matches the model contract (models/nmt.py): "src" [B, Ts],
    "tgt_in" [B, Tt] (BOS-prefixed), "tgt_out" [B, Tt] (EOS-suffixed),
    "w" [B, Tt] (1.0 on real target tokens incl. EOS).
    """

    pairs: List[Tuple[List[int], List[int]]]
    batch_size: int
    max_len: int
    bucket_width: int = 8
    num_shards: int = 1
    shard_index: int = 0
    seed: int = 0
    drop_remainder: bool = True

    def _bucket_of(self, s: List[int], t: List[int]) -> int:
        longest = max(len(s), len(t) + 1)  # +1: BOS/EOS on the tgt side
        b = -(-longest // self.bucket_width) * self.bucket_width
        return min(b, self.max_len)

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Sharding happens by ROW SLICE of one global batch stream: the
        shuffle/bucketing runs identically on every worker (seed- and
        epoch-keyed), and each worker takes its ``shard_index``-th row
        stripe of every emitted batch — so all workers see the SAME
        batch shapes at the SAME steps (the SPMD multi-host program
        requires lockstep shapes), while the data is still partitioned
        mod-``num_shards`` like the reference's Dataset.shard."""
        if self.batch_size % self.num_shards:
            raise ValueError(
                f"batch_size {self.batch_size} must divide by "
                f"num_shards {self.num_shards}")
        rng = np.random.default_rng((self.seed, epoch))
        order = rng.permutation(len(self.pairs))
        buckets: Dict[int, List[int]] = {}
        for i in order:
            s, t = self.pairs[i]
            b = self._bucket_of(s, t)
            buckets.setdefault(b, []).append(i)
            if len(buckets[b]) == self.batch_size:
                yield self._shard(self._emit(buckets.pop(b), b))
        if not self.drop_remainder:
            for b, idxs in sorted(buckets.items()):
                # pad the ragged tail batch up to batch_size with
                # repeats, zero-weighted via "w"
                yield self._shard(
                    self._emit(idxs, b, pad_to=self.batch_size))

    def _shard(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self.num_shards == 1:
            return batch
        return {k: v[self.shard_index::self.num_shards]
                for k, v in batch.items()}

    def _emit(self, idxs: List[int], bound: int,
              pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        n = pad_to or len(idxs)
        src = np.full((n, bound), PAD_ID, np.int32)
        tgt_in = np.full((n, bound), PAD_ID, np.int32)
        tgt_out = np.full((n, bound), PAD_ID, np.int32)
        w = np.zeros((n, bound), np.float32)
        for row in range(n):
            real = row < len(idxs)
            s, t = self.pairs[idxs[row if real else 0]]
            src[row, :len(s)] = s
            tgt_in[row, 0] = BOS_ID
            tgt_in[row, 1:len(t) + 1] = t
            tgt_out[row, :len(t)] = t
            tgt_out[row, len(t)] = EOS_ID
            if real:
                w[row, :len(t) + 1] = 1.0
        return {"src": src, "tgt_in": tgt_in, "tgt_out": tgt_out, "w": w}
