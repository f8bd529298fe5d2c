"""Model adapters: DecodeProgram implementations over existing models.

The continuous scheduler (serve/continuous.py) is model-agnostic; an
adapter binds it to one model family's prefill/step math. The NMT
adapter reuses models/nmt.py's encoder, cross-attention K/V precompute
and the per-slot-position cached decoder step — the KV-cached math
``greedy_decode`` runs, restructured from "one loop per batch" into
"one step per scheduler iteration" — plus the serving features of
``parallax_tpu/serve/adapters.py``:

* **paged self-KV** (``page_size``/``pool_pages``): one pool addressed
  through host-managed page tables (serve/paging.py);
* **chunked prefill** (``prefill_chunk_layers``): the encoder runs in
  layer pieces the scheduler interleaves with decode steps — a long
  newcomer costs at most one chunk per iteration;
* **speculative decoding** (``spec_tokens`` + ``draft_cfg`` /
  ``draft_params``): a small draft NMT proposes k tokens per iteration,
  the target verifies all k (+1 bonus) in one pass over the pool (the
  paged kernel at ``G = k + 1`` queries a slot), and the scheduler
  accepts the longest agreeing prefix — exact under greedy because the
  verify is the same math as k+1 single steps;
* **prefix reuse** hooks (``prefix_key``, ``prefill_tokens``,
  ``copy_page``) for serve/prefixcache.py.

``CausalLMDecodeProgram`` does the same for the decoder-only
long-context LM (models/long_context.py), whose prompt K/V lands in the
same cache the decode steps write: its insert scatters the prompt rows
through the slot's page table (``insert_pages``). ``MoeLMDecodeProgram``
serves the switch-MoE LM (models/moe_lm.py) the same way, and
``LM1BDecodeProgram`` the LSTM LM (models/lm1b.py), whose cache is the
LSTM carry itself. ``standalone_greedy`` decodes one request through a
program's own device math outside any scheduler: the reference served
tokens are held to. The registry at the end (``registered_adapters``)
holds one tiny fp32 fixture per adapter for the conformance tests.

On the card the scheduler's warmup calls ``capture``: the one-request
prefill (or each prefill chunk), and the decode step (or the whole
speculative iteration) for its slot count become CUDA graphs
(compile/graphs.py) over static buffers, and every later call copies its
host inputs in and replays. The counterpart of the JAX package compiling
every signature ahead of serving.

A prefill's result is the program's to overwrite: it lives in the
prefill graph's pool (or, run eagerly, in one buffer the program reuses)
until the next prefill. Whoever keeps a request state past that — the
prefix cache, an exported prefill — keeps a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.compile import bucketing, graphs as graphs_lib
from parallax_tpu_torch.models import lm1b, long_context, moe_lm, nmt
from parallax_tpu_torch.ops import paged_attention as pa_ops
from parallax_tpu_torch.serve.continuous import DecodeProgram
from parallax_tpu_torch.serve.paging import pages_for


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_pairs(a, b):
    """The leaves of two trees of one structure, side by side."""
    if isinstance(a, dict):
        for k in a:
            yield from _tree_pairs(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            yield from _tree_pairs(x, y)
    else:
        yield a, b


class _Graphs:
    """What one ``capture`` made: the graphs, and the params object, the
    state and the cast copy of the params they read (kept alive here, as
    the graphs hold their addresses)."""

    __slots__ = ("params", "state", "cast", "prefill", "chunks", "step",
                 "spec")

    def __init__(self, params, state, cast):
        self.params = params
        self.state = state
        self.cast = cast
        self.prefill = self.chunks = self.step = self.spec = None


class _ServeProgram(DecodeProgram):
    """The plumbing every adapter here shares: host int32 staging into
    static device buffers, the compute-dtype copy of the params made once
    per params object, the reused eager prefill result, the one pinned
    device-to-host copy of a step's tokens, graph capture and the in-place
    refresh of a swapped params object."""

    _graphs: Optional[_Graphs] = None
    num_prefill_chunks = 1
    spec_tokens = 0

    def _init_plumbing(self, device):
        self.device = resolve_device(device)
        self._cast_of = None        # (params object, its cast copy)
        self._graphs = None
        self._held = None           # the eager prefill's reused result
        self._out = None            # pinned host buffer of step outputs
        self.captures = 0           # graphs captured by this program

    def _ints(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int32), device=self.device)

    def _stage(self, buf: torch.Tensor, a) -> None:
        """Copy host int32 data into the device buffer ``buf``: from
        pinned memory without waiting, on the card."""
        t = torch.from_numpy(np.ascontiguousarray(a, np.int32)).reshape(
            buf.shape)
        if self.device.type == "cuda":
            buf.copy_(t.pin_memory(), non_blocking=True)
        else:
            buf.copy_(t)

    def _cast(self, params):
        """``params`` with the leaves the compute dtype reads cast to it
        (the bits each use sees are the same as casting at the use)."""
        raise NotImplementedError

    def _compute_params(self, params):
        g = self._graphs
        if g is not None and g.params is params:
            return g.cast
        if self._cast_of is None or self._cast_of[0] is not params:
            self._cast_of = (params, self._cast(params))
        return self._cast_of[1]

    def refresh_params(self, params) -> None:
        """After ``params``' leaves were overwritten in place (a hot
        swap), bring its cast copies up to date in place: every captured
        graph keeps reading the same addresses, so nothing is captured
        again."""
        casts = []
        if self._graphs is not None and self._graphs.params is params:
            casts.append(self._graphs.cast)
        if self._cast_of is not None and self._cast_of[0] is params \
                and all(self._cast_of[1] is not c for c in casts):
            casts.append(self._cast_of[1])
        with torch.no_grad():
            for cast in casts:
                for src, dst in _tree_pairs(params, cast):
                    if dst is not src:
                        dst.copy_(src)

    def _on_device(self, rs):
        """A request state's leaves as tensors on the program's device.
        An imported prefill (serve/disagg.py) arrives as host arrays,
        bf16 leaves widened to fp32 on the wire; the inserting writes
        cast them to the cache dtype."""
        return {k: v if isinstance(v, torch.Tensor)
                else torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in rs.items()}

    def _hold(self, rs: Dict[str, torch.Tensor]):
        """An eager prefill's result, copied into the buffer the program
        reuses for every eager prefill: the same lifetime a graph's
        output has."""
        h = self._held
        if h is None or h.keys() != rs.keys() or any(
                h[k].shape != v.shape or h[k].dtype != v.dtype
                for k, v in rs.items()):
            self._held = {k: v.clone() for k, v in rs.items()}
        else:
            for k, v in rs.items():
                h[k].copy_(v)
        return self._held

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """``x`` on the host: one copy into pinned memory on the card."""
        if self.device.type != "cuda":
            return x.numpy().copy()
        if self._out is None or self._out.shape != x.shape:
            self._out = torch.empty(x.shape, dtype=x.dtype,
                                    pin_memory=True)
        self._out.copy_(x, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out.numpy().copy()

    def _capture(self, fn) -> graphs_lib.Graph:
        g = graphs_lib.capture(fn, self.device)
        self.captures += 1
        return g

    def _live(self, params, state=None) -> Optional[_Graphs]:
        """The graphs, when they were captured on ``params`` (and
        ``state``) and capture is on in this thread."""
        g = self._graphs
        if g is None or g.params is not params or (
                state is not None and g.state is not state) \
                or not graphs_lib.capture_enabled(self.device):
            return None
        return g

    def _check_chunks(self, prefill_chunk_layers, L: int) -> None:
        if prefill_chunk_layers is not None:
            c = int(prefill_chunk_layers)
            if not 1 <= c <= L:
                raise ValueError(
                    f"prefill_chunk_layers={prefill_chunk_layers} "
                    f"outside [1, num_layers={L}]")
            self._layer_chunks = [(k * c, min((k + 1) * c, L))
                                  for k in range(-(-L // c))]
            # + the final piece (cross K/V, draft prefill / the request's
            # decode scalars)
            self.num_prefill_chunks = len(self._layer_chunks) + 1
        else:
            self._layer_chunks = None
            self.num_prefill_chunks = 1

    def _check_paged(self, page_size, pool_pages, width: int,
                     what: str) -> None:
        self.paged = page_size is not None
        if self.paged:
            if pool_pages is None:
                raise ValueError(
                    "page_size given without pool_pages; the pool size "
                    "is the memory bound and must be declared")
            self.page_size = int(page_size)
            self.pool_pages = int(pool_pages)
            if self.page_size < 1 or self.pool_pages < 1:
                raise ValueError(
                    f"page_size={page_size} / pool_pages={pool_pages} "
                    f"must be >= 1")
            if width % self.page_size != 0:
                raise ValueError(
                    f"page_size={page_size} must divide {what}")
            self.pages_per_seq = width // self.page_size
            if self.pool_pages < self.pages_per_seq:
                raise ValueError(
                    f"pool_pages={pool_pages} cannot hold even one "
                    f"max-length sequence ({self.pages_per_seq} pages)")
        elif pool_pages is not None:
            raise ValueError("pool_pages given without page_size")

    # -- chunked prefill, shared ---------------------------------------------

    def prefill_chunk(self, params, carry, k: int):
        """Advance one prefill by one piece: ``carry`` is the prepared
        feed for ``k == 0`` and the previous chunk's output after; chunk
        ``num_prefill_chunks - 1`` returns the request state ``insert``
        accepts. On the card each piece replays its own graph, chunk k
        reading chunk k - 1's outputs."""
        n = self.num_prefill_chunks
        if n < 2:
            raise ValueError("prefill_chunk on a program without "
                             "prefill_chunk_layers")
        g = self._live(params)
        if g is not None:
            if k == 0:
                self._stage(self._in, np.asarray(carry[self._feed_key])[None])
            else:
                prev = g.chunks[k - 1].outputs
                for name, v in carry.items():
                    if v is not prev[name]:
                        prev[name].copy_(v)
            return g.chunks[k].replay()
        if k == 0:
            carry = {self._feed_key:
                     self._ints(carry[self._feed_key])[None]}
        out = self._chunk_device(k, params, carry)
        return self._hold(out) if k == n - 1 else out

    def _run_chunks(self, params, ids):
        carry = {self._feed_key: ids}
        for k in range(self.num_prefill_chunks):
            carry = self._chunk_device(k, params, carry)
        return carry

    def _capture_prefill(self, g: _Graphs, params):
        """Capture the prefill on the example feed staged in ``_in``,
        replay it once and return that request state (the one the warmup
        inserts: real values, as the step's warm call reads tokens and
        positions from it). Each chunk's graph is replayed after its
        capture, so the next chunk's warm call reads real values too."""
        if self.num_prefill_chunks > 1:
            g.chunks = []
            carry = {self._feed_key: self._in}
            for k in range(self.num_prefill_chunks):
                gk = self._capture(
                    lambda k=k, c=carry: self._chunk_device(k, params, c))
                carry = gk.replay()
                g.chunks.append(gk)
            return carry
        g.prefill = self._capture(
            lambda: self._prefill_device(params, self._in))
        return g.prefill.replay()

    def prefill(self, params, feed):
        """The whole per-request one-time work (every chunk in order, for
        a chunked program)."""
        if self.num_prefill_chunks > 1:
            carry = feed
            for k in range(self.num_prefill_chunks):
                carry = self.prefill_chunk(params, carry, k)
            return carry
        g = self._live(params)
        if g is not None:
            self._stage(self._in, np.asarray(feed[self._feed_key])[None])
            return g.prefill.replay()
        return self._hold(self._prefill_device(
            params, self._ints(feed[self._feed_key])[None]))

    def prefill_owned(self, params, feed):
        """The prefill of one prepared feed, run eagerly into tensors the
        caller owns (no graph buffer is touched, so it may run on another
        thread while a scheduler serves): the exported-prefill path."""
        ids = self._ints(feed[self._feed_key])[None]
        if self.num_prefill_chunks > 1:
            return self._run_chunks(params, ids)
        return self._prefill_device(params, ids)


# -- NMT ----------------------------------------------------------------------


def _nmt_cast(params, dt):
    """Every leaf but the fp32 ``out_proj`` cast to ``dt``."""
    return {k: (v if k == "out_proj" else _tree_map(lambda x: x.to(dt), v))
            for k, v in params.items()}


class NMTDecodeProgram(_ServeProgram):
    """Greedy KV-cached NMT decoding for the continuous scheduler.

    ``max_src_len`` fixes the prefill shape: every request's ``src`` is
    padded to it with PAD (the encoder's ``src_valid`` mask makes padded
    positions inert). ``max_len`` fixes the decode buffer ``T`` (the
    per-request token cap).

    Dense state layout per slot set ``S``: cross K/V ``[L, S, Ts, D]``
    written at prefill, self K/V caches ``[L, S, T, D]`` written one
    position per step, ``src_valid [S, Ts]``. A freed slot's stale
    cache needs no zeroing — positions beyond a slot's own ``t`` are
    masked, and every position ``<= t`` is freshly written after a
    refill. The state is updated in place.

    Paged layout (``page_size`` set): the self caches become the
    ``[L, pool_pages + 1, page_size, D]`` pool (one spare page that
    sentinel writes land in; see ops/paged_attention.py); the scheduler
    passes each step a ``[S, pages_per_seq]`` int32 page table whose
    unallocated entries hold the sentinel ``pool_pages``.
    ``page_size`` must divide ``max_len``.

    ``attn_impl`` ('kernel' | 'einsum', None = 'kernel') picks the paged
    self-attention executor: 'kernel' is ops/paged_attention (the CUDA
    paged-decode kernel on the card), 'einsum' the full-width gather;
    'kernel' without paging is refused. ``cfg.use_pallas_attention``
    sends the encoder's attention through the flash-attention kernel.

    ``prefill_chunk_layers`` splits the encoder into pieces of that many
    layers plus a last piece (the cross K/V and the draft's prefill),
    each run by ``prefill_chunk``. ``spec_tokens = k`` with ``draft_cfg``
    and ``draft_params`` (``layer_skip_draft``) adds the draft's state
    (its cross K/V and a dense self cache per slot, decoded with the
    plain attention) and ``spec_step``: the draft's catch-up step, k
    draft steps and the target's verify of ``k + 1`` queries a slot, with
    nothing read back to the host in between.

    ``device`` is where the state lives and the steps run (default the
    card; ``"cpu"`` must be asked for). Every weight but the fp32 output
    projection is cast to the compute dtype once per params object.
    ``step`` and ``spec_step`` take their tokens, positions and page
    table through one static int32 buffer of the state, filled by one
    copy from pinned host memory. After ``capture(params, state)`` (on
    the card, outside ``compile.disable_capture()``) the prefill (or each
    chunk) and the step (or the whole speculative iteration) on that
    params object and state replay graphs.
    """

    _feed_key = "src"

    def __init__(self, cfg: nmt.NMTConfig, max_src_len: int,
                 max_len: Optional[int] = None, *,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_layers: Optional[int] = None,
                 spec_tokens: int = 0,
                 draft_cfg: Optional[nmt.NMTConfig] = None,
                 draft_params: Any = None,
                 attn_impl: Optional[str] = None,
                 device="cuda"):
        self._init_plumbing(device)
        self.cfg = cfg
        self.Ts = int(max_src_len)
        self.max_len = int(max_len or cfg.max_len)
        if self.max_len > cfg.max_len:
            raise ValueError(
                f"max_len={max_len} exceeds the model's positional "
                f"table ({cfg.max_len})")
        if self.Ts > cfg.max_len:
            raise ValueError(
                f"max_src_len={max_src_len} exceeds the model's "
                f"positional table ({cfg.max_len})")
        self.bos_id = nmt.BOS_ID
        self.eos_id = nmt.EOS_ID
        self.pad_id = nmt.PAD_ID
        self._check_paged(page_size, pool_pages, self.max_len,
                          f"max_len={self.max_len}")

        if attn_impl is not None and attn_impl not in ("kernel", "einsum"):
            raise ValueError(
                f"attn_impl={attn_impl!r}: expected 'kernel' or 'einsum'")
        if attn_impl == "kernel" and not self.paged:
            raise ValueError(
                "attn_impl='kernel' requires the paged KV layout "
                "(page_size/pool_pages): the kernel's operand is the "
                "page-table-addressed pool")
        self.attn_impl = attn_impl
        self._check_chunks(prefill_chunk_layers, cfg.num_layers)

        self.spec_tokens = int(spec_tokens or 0)
        if self.spec_tokens:
            if self.spec_tokens < 1:
                raise ValueError(
                    f"spec_tokens={spec_tokens} must be >= 1")
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "spec_tokens set without draft_cfg/draft_params — "
                    "speculative decoding needs the small draft model")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {draft_cfg.vocab_size} != target "
                    f"vocab {cfg.vocab_size}; proposals must share the "
                    f"token id space")
            if draft_cfg.max_len < self.max_len:
                raise ValueError(
                    f"draft max_len {draft_cfg.max_len} < decode "
                    f"buffer {self.max_len}; the draft's positional "
                    f"table must cover every decode position")
            self.draft_cfg = draft_cfg
            self.draft_params = draft_params
        else:
            self.draft_cfg = None
            self.draft_params = None
        self._draft_cast = None
        self._in = None             # the prefill graphs' static input

    # -- feed contract -----------------------------------------------------

    def example_feed(self) -> Dict[str, np.ndarray]:
        return {"src": np.full((self.Ts,), self.pad_id, np.int32)}

    def prepare_feed(self, feed: Dict[str, Any]) -> Dict[str, np.ndarray]:
        src = np.asarray(feed["src"], np.int32)
        if src.ndim != 1:
            raise ValueError(
                f"decode feed 'src' must be one request's [T] token "
                f"row, got shape {src.shape}")
        if src.shape[0] > self.Ts:
            raise ValueError(
                f"src length {src.shape[0]} exceeds max_src_len "
                f"{self.Ts}")
        return {"src": bucketing.pad_axis0(src, self.Ts, self.pad_id)}

    def pages_needed(self, cap: int) -> int:
        """Pages one request with token cap ``cap`` owns while in
        flight (the scheduler allocates exactly this many at refill)."""
        return pages_for(cap, self.page_size)

    # -- prefix-reuse hooks (serve/prefixcache.py) ---------------------------

    def prefix_key(self, feed) -> tuple:
        """The radix-cache key of one prepared feed: the padded source
        row as a token tuple. Exact-key semantics — encoder attention is
        bidirectional, so only an identical source shares encoder
        state."""
        return tuple(int(t) for t in feed["src"])

    def prefill_tokens(self, feed) -> int:
        """Source tokens a prefill of ``feed`` would encode — the work a
        prefix-cache hit skips (``prefill_tokens_skipped``)."""
        return int((np.asarray(feed["src"]) != self.pad_id).sum())

    def copy_page(self, state, dst, src):
        """Device-side copy of page ``src`` onto page ``dst`` in both
        self-KV pools, in place: the prefix cache's copy-on-write, made
        before a mapper's first divergent write into a shared page."""
        for name in ("kc", "vc"):
            state[name][:, int(dst)] = state[name][:, int(src)]
        return state

    # -- device programs ---------------------------------------------------

    def _cast(self, params):
        return _nmt_cast(params, self.cfg.compute_dtype)

    def _draft_compute_params(self):
        """The draft's params on the device, cast once. They are the
        program's own: a hot swap of the target's leaves leaves them as
        they were (a stale draft lowers the accept rate, never the
        tokens)."""
        if self._draft_cast is None:
            dev = self.device
            self._draft_cast = _nmt_cast(
                _tree_map(lambda x: torch.as_tensor(x).to(dev).clone(),
                          self.draft_params),
                self.draft_cfg.compute_dtype)
        return self._draft_cast

    def init_state(self, params, slots: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        L, D, dt = cfg.num_layers, cfg.model_dim, cfg.compute_dtype
        dev = self.device
        shape = (L, slots, self.Ts, D)
        state = {"ck": torch.zeros(shape, dtype=dt, device=dev),
                 "cv": torch.zeros(shape, dtype=dt, device=dev),
                 "src_valid": torch.zeros((slots, self.Ts),
                                          dtype=torch.bool, device=dev)}
        if self.paged:
            state["kc"], state["vc"] = nmt._init_paged_self_cache(
                cfg, self.pool_pages, self.page_size, dev)
        else:
            state["kc"], state["vc"] = nmt._init_self_cache(
                cfg, slots, self.max_len, dev)
        if self.spec_tokens:
            dcfg = self.draft_cfg
            dshape = (dcfg.num_layers, slots, self.Ts, dcfg.model_dim)
            ddt = dcfg.compute_dtype
            state["d_ck"] = torch.zeros(dshape, dtype=ddt, device=dev)
            state["d_cv"] = torch.zeros(dshape, dtype=ddt, device=dev)
            # the draft's self cache stays dense per slot: the draft is
            # the small model, its cache is not what the pool is for
            state["d_kc"], state["d_vc"] = nmt._init_self_cache(
                dcfg, slots, self.max_len, dev)
        # the step's inputs, one buffer: tok [S] | t [S] | prev [S] (spec
        # only) | pages [S, P]
        P = self.pages_per_seq if self.paged else 0
        n = 3 if self.spec_tokens else 2
        state["inputs"] = torch.zeros((slots * (n + P),), dtype=torch.int32,
                                      device=dev)
        return state

    def _step_inputs(self, state):
        """(tok, t, prev, pages) views of the state's input buffer."""
        buf = state["inputs"]
        S = state["src_valid"].shape[0]
        n = 3 if self.spec_tokens else 2
        prev = buf[2 * S:3 * S] if self.spec_tokens else None
        pages = buf[n * S:].view(S, -1) if self.paged else None
        return buf[:S], buf[S:2 * S], prev, pages

    def _draft_prefill(self, src):
        dcp = self._draft_compute_params()
        d_enc, _ = nmt._encode(self.draft_cfg, dcp, src.long())
        d_ck, d_cv = nmt._cross_kv(self.draft_cfg, dcp, d_enc)
        return {"d_ck": d_ck, "d_cv": d_cv}

    def _prefill_device(self, params, src):
        cp = self._compute_params(params)
        enc_out, src_valid = nmt._encode(self.cfg, cp, src.long())
        ck, cv = nmt._cross_kv(self.cfg, cp, enc_out)        # [L,1,Ts,D]
        rs = {"ck": ck, "cv": cv, "src_valid": src_valid}
        if self.spec_tokens:
            rs.update(self._draft_prefill(src))
        return rs

    # chunked prefill: the same encoder math split at layer boundaries —
    # identical ops in identical order, so the request state is the
    # whole prefill's bit for bit
    def _chunk_device(self, k, params, carry):
        cfg = self.cfg
        cp = self._compute_params(params)
        if k == 0:
            src = carry["src"]
            x, src_valid = nmt._encode_embed(cfg, cp, src.long())
            x = nmt._encode_layers(cfg, cp, x, src_valid, 0,
                                   self._layer_chunks[0][1])
            return {"x": x, "src_valid": src_valid, "src": src}
        if k < self.num_prefill_chunks - 1:
            lo, hi = self._layer_chunks[k]
            return {"x": nmt._encode_layers(cfg, cp, carry["x"],
                                            carry["src_valid"], lo, hi),
                    "src_valid": carry["src_valid"], "src": carry["src"]}
        ck, cv = nmt._cross_kv(cfg, cp, carry["x"])
        rs = {"ck": ck, "cv": cv, "src_valid": carry["src_valid"]}
        if self.spec_tokens:
            rs.update(self._draft_prefill(carry["src"]))
        return rs

    def _step_device(self, params, state):
        cp = self._compute_params(params)
        tok, t, _, pages = self._step_inputs(state)
        tok = tok.long()
        if self.paged:
            logits, _, _ = nmt._decode_tokens_cached(
                self.cfg, cp, tok[:, None], t, state["kc"], state["vc"],
                state["ck"], state["cv"], state["src_valid"], pages=pages,
                page_size=self.page_size, attn_impl=self.attn_impl)
            logits = logits[:, 0]
        else:
            logits, _, _ = nmt._decode_step_cached_multi(
                self.cfg, cp, tok, t, state["kc"], state["vc"],
                state["ck"], state["cv"], state["src_valid"])
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def _draft_step(self, dcp, state, tok, t):
        logits, _, _ = nmt._decode_tokens_cached(
            self.draft_cfg, dcp, tok.long()[:, None], t, state["d_kc"],
            state["d_vc"], state["d_ck"], state["d_cv"],
            state["src_valid"])
        return torch.argmax(logits[:, 0], dim=-1).to(torch.int32)

    def _spec_device(self, params, state):
        """One speculative iteration on the device: the draft's catch-up
        step at t - 1, k draft steps at t + j, the target's verify of
        ``[tok, p_0 .. p_{k-1}]``. Returns ``[S, 2k + 1]``: y then the
        proposals."""
        cp = self._compute_params(params)
        dcp = self._draft_compute_params()
        tok, t, prev, pages = self._step_inputs(state)
        self._draft_step(dcp, state, prev, (t - 1).clamp(min=0))
        cur = tok
        props = []
        for j in range(self.spec_tokens):
            cur = self._draft_step(dcp, state, cur, t + j)
            props.append(cur)
        proposals = torch.stack(props, dim=1)                 # [S, k]
        toks = torch.cat([tok[:, None], proposals], dim=1)    # [S, k+1]
        logits, _, _ = nmt._decode_tokens_cached(
            self.cfg, cp, toks.long(), t, state["kc"], state["vc"],
            state["ck"], state["cv"], state["src_valid"],
            pages=pages if self.paged else None,
            page_size=self.page_size if self.paged else None,
            attn_impl=self.attn_impl)
        y = torch.argmax(logits, dim=-1).to(torch.int32)      # [S, k+1]
        return torch.cat([y, proposals], dim=1)

    def capture(self, params, state) -> None:
        """Warm the prefill (or each chunk), the insert and the step (or
        the speculative iteration) on ``state`` (the scheduler's own)
        and, on the card outside ``compile.disable_capture()``, capture
        them as graphs over static buffers. The warm calls write slot 0
        and the spare page; the state is zeroed after, as fresh."""
        self._graphs = None
        self._in = torch.zeros((1, self.Ts), dtype=torch.int32,
                               device=self.device)
        self._stage(self._in,
                    self.prepare_feed(self.example_feed())["src"][None])
        tok, t, prev, pages = self._step_inputs(state)
        tok.fill_(self.bos_id)
        t.zero_()
        if prev is not None:
            prev.fill_(self.bos_id)
        if pages is not None:
            pages.fill_(self.pool_pages)
        step = self._spec_device if self.spec_tokens else self._step_device
        if graphs_lib.capture_enabled(self.device):
            # the cast copies exist before any capture: a graph must not
            # allocate what outlives it
            g = _Graphs(params, state, self._compute_params(params))
            if self.spec_tokens:
                self._draft_compute_params()
            self.insert(state, 0, self._capture_prefill(g, params))
            graph = self._capture(lambda: step(params, state))
            if self.spec_tokens:
                g.spec = graph
            else:
                g.step = graph
            self._graphs = g
        else:
            ids = self._in
            rs = self._run_chunks(params, ids) \
                if self.num_prefill_chunks > 1 \
                else self._prefill_device(params, ids)
            self.insert(state, 0, rs)
            step(params, state)
        for v in state.values():
            v.zero_()

    def insert(self, state, slot, request_state):
        """Write one prefilled request into slot ``slot`` (in place)."""
        j = int(slot)
        rs = self._on_device(request_state)
        state["ck"][:, j] = rs["ck"][:, 0]
        state["cv"][:, j] = rs["cv"][:, 0]
        state["src_valid"][j] = rs["src_valid"][0]
        if self.spec_tokens:
            state["d_ck"][:, j] = rs["d_ck"][:, 0]
            state["d_cv"][:, j] = rs["d_cv"][:, 0]
        return state

    def _stage_step(self, state, tok, t, prev, pages):
        host = [np.asarray(tok, np.int32), np.asarray(t, np.int32)]
        if self.spec_tokens:
            host.append(np.zeros(len(tok), np.int32) if prev is None
                        else np.asarray(prev, np.int32))
        if self.paged:
            host.append(np.asarray(pages, np.int32).reshape(-1))
        self._stage(state["inputs"], np.concatenate(host))

    def step(self, params, state, tok, t, pages=None):
        self._stage_step(state, tok, t, None, pages)
        g = self._live(params, state)
        nxt = g.step.replay() if g is not None and g.step is not None \
            else self._step_device(params, state)
        return self._fetch(nxt), state

    def spec_step(self, params, state, tok, t, prev_tok, pages=None):
        """One speculative iteration: k sequential draft steps propose
        tokens, one target pass verifies all k (+1 bonus).

        ``prev_tok`` is the sequence content at position ``t - 1`` (BOS
        at ``t == 0``): the first draft step re-writes that position
        before proposing. When the previous iteration accepted everything
        including the bonus token, the draft never cached the bonus
        position — the catch-up fills that hole; otherwise it rewrites
        the values already there with the same bits.

        Returns ``(y [S, k+1], proposals [S, k], state)``: ``y[:, j]`` is
        the target's greedy token after input j of ``[tok, p_0 ..
        p_{k-1}]``. One replay and one device-to-host copy on the card."""
        self._stage_step(state, tok, t, prev_tok, pages)
        g = self._live(params, state)
        out = g.spec.replay() if g is not None and g.spec is not None \
            else self._spec_device(params, state)
        out = self._fetch(out)
        k = self.spec_tokens
        return out[:, :k + 1], out[:, k + 1:], state


def layer_skip_draft(cfg: nmt.NMTConfig, params, layers: int = 1):
    """The zero-training draft model for speculative decoding: the
    target's first ``layers`` encoder/decoder blocks with the shared
    embedding, positional and output tables (layer-skip drafting).
    Returns ``(draft_cfg, draft_params)`` for ``NMTDecodeProgram(
    spec_tokens=..., draft_cfg=, draft_params=)``; the verify keeps the
    output exactly greedy whatever the draft proposes."""
    layers = int(layers)
    if not 1 <= layers <= cfg.num_layers:
        raise ValueError(
            f"layer_skip_draft layers={layers} outside "
            f"[1, num_layers={cfg.num_layers}]")
    draft_cfg = dataclasses.replace(cfg, num_layers=layers)
    draft_params = {"emb": params["emb"], "pos": params["pos"],
                    "enc": params["enc"][:layers],
                    "dec": params["dec"][:layers],
                    "out_proj": params["out_proj"]}
    return draft_cfg, draft_params


# -- decoder-only causal LMs --------------------------------------------------


class _CausalKVDecodeProgram(_ServeProgram):
    """Greedy KV-cached decode for decoder-only causal LMs
    (``parallax_tpu/serve/adapters.py:490-781``).

    ``max_src_len`` (= Ts) fixes the padded prompt buffer; ``max_len``
    is the per-request new-token cap. The cache holds ``Tbuf = Ts +
    max_len`` positions: the prompt's K/V at [0, t0), written by
    ``insert``, and decode step ``t`` writing position ``base + t`` with
    ``base = t0 - 1`` (step 0 consumes the last prompt token and emits
    the first new one). ``Ts + max_len`` must not pass ``cfg.max_len``.

    Paged layout (``page_size``): the ``[L, pool_pages + 1, page_size,
    D]`` pool of ``NMTDecodeProgram`` (one spare page for sentinel
    writes), ``page_size`` dividing ``Tbuf``, and the prompt inserted
    through the slot's page row (``insert_pages``): position j < t0
    lands in page ``row[j // page_size]``, the padded rows go to the
    spare page, so a slot never writes outside its own pages (a prefix
    hit's shared pages included). A request owns ``pages_needed(cap)``
    pages, the longest prompt's worst case, as in JAX.

    ``attn_impl`` ('kernel', 'einsum'; None and 'auto' = 'kernel')
    picks the paged attention as in ``NMTDecodeProgram``; the prompt's
    prefill runs the plain causal attention, as in JAX.
    ``prefill_chunk_layers`` splits the prompt's layers into pieces run
    by ``prefill_chunk``, the last piece making ``base`` and ``first``.
    Token ids: 0 is PAD, BOS and EOS at once; prompts use ids in [1,
    vocab), and a generated 0 retires the request. Speculative decoding
    is NMT's alone, as in JAX.

    As in ``NMTDecodeProgram``, every weight but the fp32 ``out_w`` (and
    the block leaves ``_fp32_leaves`` names, which the model reads in
    fp32) is cast to the compute dtype once per params object, ``step``
    takes its inputs through one static int32 buffer of the state, and
    after ``capture(params, state)`` on the card the prefill (or each
    chunk) and ``step`` replay CUDA graphs."""

    _mod = None          # the model module with the serve decode section
    _fp32_leaves = ()    # block leaves kept in fp32 (the MoE router)
    _feed_key = "ids"

    def __init__(self, cfg, max_src_len: int, max_len: int, *,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_layers: Optional[int] = None,
                 attn_impl: Optional[str] = None,
                 device="cuda"):
        self._init_plumbing(device)
        self.cfg = cfg
        self.Ts = int(max_src_len)
        self.max_len = int(max_len)
        if self.Ts < 1 or self.max_len < 1:
            raise ValueError(
                f"max_src_len={max_src_len} / max_len={max_len} must "
                f"be >= 1")
        self.Tbuf = self.Ts + self.max_len
        if self.Tbuf > cfg.max_len:
            raise ValueError(
                f"max_src_len + max_len = {self.Tbuf} exceeds the "
                f"model's positional table ({cfg.max_len}): every "
                f"decode position base + t must have an embedding row")
        self.bos_id = self.eos_id = self.pad_id = 0
        self._check_paged(page_size, pool_pages, self.Tbuf,
                          f"max_src_len + max_len = {self.Tbuf}")
        self.insert_pages = self.paged

        if attn_impl not in (None, "auto", "kernel", "einsum"):
            raise ValueError(
                f"attn_impl={attn_impl!r}: expected 'auto', 'kernel' "
                f"or 'einsum'")
        if attn_impl == "kernel" and not self.paged:
            raise ValueError(
                "attn_impl='kernel' requires the paged KV layout "
                "(page_size/pool_pages): the kernel's operand is the "
                "page-table-addressed pool")
        self.attn_impl = "kernel" if attn_impl in (None, "auto") \
            else attn_impl
        self._check_chunks(prefill_chunk_layers, cfg.num_layers)
        self._in = None             # the prefill graphs' static input

    # -- feed contract -----------------------------------------------------

    def example_feed(self) -> Dict[str, np.ndarray]:
        return {"ids": np.ones((1,), np.int32)}

    def prepare_feed(self, feed: Dict[str, Any]) -> Dict[str, np.ndarray]:
        ids = np.asarray(feed["ids"], np.int32)
        if ids.ndim != 1:
            raise ValueError(
                f"decode feed 'ids' must be one request's [T] prompt "
                f"row, got shape {ids.shape}")
        if not 1 <= ids.shape[0] <= self.Ts:
            raise ValueError(
                f"prompt length {ids.shape[0]} outside [1, "
                f"max_src_len={self.Ts}]")
        if (ids < 1).any() or (ids >= self.cfg.vocab_size).any():
            raise ValueError(
                "prompt ids must lie in [1, vocab_size): 0 is the "
                "PAD/BOS/EOS sentinel")
        return {"ids": bucketing.pad_axis0(ids, self.Ts, self.pad_id)}

    def pages_needed(self, cap: int) -> int:
        """Worst-case pages of a request with new-token cap ``cap``: the
        longest prompt occupies Ts - 1 positions before step 0, and step
        cap - 1 writes position Ts - 2 + cap."""
        return pages_for(self.Ts - 1 + int(cap), self.page_size)

    def kv_prefix_positions(self, feed) -> int:
        """Cache positions a prepared feed's prompt occupies before the
        first decode step writes (base = t0 - 1; step 0 rewrites the last
        prompt position): the scheduler's page accounting for prefix
        sharing."""
        t0 = int((np.asarray(feed["ids"]) != self.pad_id).sum())
        return max(t0 - 1, 0)

    # -- prefix-reuse hooks --------------------------------------------------

    def prefix_key(self, feed) -> tuple:
        """Exact-key semantics like the NMT adapter: the padded prompt
        row as a token tuple."""
        return tuple(int(t) for t in feed["ids"])

    def prefill_tokens(self, feed) -> int:
        return int((np.asarray(feed["ids"]) != self.pad_id).sum())

    copy_page = NMTDecodeProgram.copy_page

    # -- device programs ---------------------------------------------------

    def _cast(self, params):
        dt = self.cfg.compute_dtype
        cast = {k: v.to(dt) for k, v in params.items()
                if k not in ("out_w", "blocks")}
        cast["out_w"] = params["out_w"]
        cast["blocks"] = [
            {k: ({n: t.to(dt) for n, t in v.items()}
                 if isinstance(v, dict) else
                 v if k in self._fp32_leaves else v.to(dt))
             for k, v in b.items()} for b in params["blocks"]]
        return cast

    def init_state(self, params, slots: int) -> Dict[str, torch.Tensor]:
        mod = self._mod
        if self.paged:
            kc, vc = mod._init_serve_paged_cache(
                self.cfg, self.pool_pages, self.page_size, self.device)
        else:
            kc, vc = mod._init_serve_self_cache(self.cfg, slots, self.Tbuf,
                                                self.device)
        P = self.pages_per_seq if self.paged else 0
        ints = dict(dtype=torch.int32, device=self.device)
        # the step's inputs, one buffer: tok [S] | t [S] | pages [S, P]
        return {"kc": kc, "vc": vc,
                "base": torch.zeros((slots,), **ints),
                "first": torch.zeros((slots,), **ints),
                "inputs": torch.zeros((slots * (2 + P),), **ints)}

    def _step_inputs(self, state):
        buf = state["inputs"]
        S = state["base"].shape[0]
        pages = buf[2 * S:].view(S, -1) if self.paged else None
        return buf[:S], buf[S:2 * S], pages

    def _prefill_device(self, params, ids):
        cp = self._compute_params(params)
        mod = self._mod
        carry = mod._prefill_embed(self.cfg, cp, ids)
        carry = mod._prefill_layers(self.cfg, cp, carry, 0,
                                    self.cfg.num_layers)
        return mod._prefill_finish(carry, self.pad_id)

    def _chunk_device(self, k, params, carry):
        cp = self._compute_params(params)
        mod = self._mod
        if k == 0:
            carry = mod._prefill_embed(self.cfg, cp, carry["ids"])
            return mod._prefill_layers(self.cfg, cp, carry, 0,
                                       self._layer_chunks[0][1])
        if k < self.num_prefill_chunks - 1:
            lo, hi = self._layer_chunks[k]
            return mod._prefill_layers(self.cfg, cp, carry, lo, hi)
        return mod._prefill_finish(carry, self.pad_id)

    def _step_device(self, params, state):
        cp = self._compute_params(params)
        tok, t, pages = self._step_inputs(state)
        logits, _, _ = self._mod._decode_step_cached(
            self.cfg, cp, tok, t, state["base"], state["first"],
            state["kc"], state["vc"], pages=pages,
            page_size=self.page_size if self.paged else None,
            attn_impl=self.attn_impl)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def capture(self, params, state) -> None:
        """Warm prefill (or each chunk), insert and step on ``state`` (the
        scheduler's) and, on the card outside
        ``compile.disable_capture()``, capture them as graphs over static
        buffers. The warm calls write slot 0 and the spare page; the state
        is zeroed after."""
        self._graphs = None
        self._in = torch.zeros((1, self.Ts), dtype=torch.int32,
                               device=self.device)
        self._stage(self._in,
                    self.prepare_feed(self.example_feed())["ids"][None])
        tok, t, pages = self._step_inputs(state)
        tok.fill_(self.bos_id)
        t.zero_()
        if pages is not None:
            pages.fill_(self.pool_pages)
        row = np.full((self.pages_per_seq,), self.pool_pages, np.int32) \
            if self.paged else None
        if graphs_lib.capture_enabled(self.device):
            g = _Graphs(params, state, self._compute_params(params))
            self.insert(state, 0, self._capture_prefill(g, params), row)
            g.step = self._capture(lambda: self._step_device(params, state))
            self._graphs = g
        else:
            rs = self._run_chunks(params, self._in) \
                if self.num_prefill_chunks > 1 \
                else self._prefill_device(params, self._in)
            self.insert(state, 0, rs, row)
            self._step_device(params, state)
        for v in state.values():
            v.zero_()

    def insert(self, state, slot, request_state, pages=None):
        """Write one prefilled request into slot ``slot`` (in place): the
        prompt's K/V through the slot's page row ``pages`` (paged; the
        padded rows to the spare page) or into the slot's rows (dense),
        then its ``base`` and ``first``."""
        j = int(slot)
        rs = self._on_device(request_state)
        if self.insert_pages:
            row = self._ints(pages).reshape(1, -1)
            t0 = rs["base"][0] + 1
            jpos = torch.arange(self.Ts, dtype=torch.int32,
                                device=self.device)
            pos = torch.where(jpos < t0, jpos, self.Tbuf)[None]
            pg, off = pa_ops.sentinel_write_coords(row, pos, self.page_size,
                                                   self.pool_pages)
            state["kc"][:, pg[0], off[0]] = rs["pk"][:, 0]
            state["vc"][:, pg[0], off[0]] = rs["pv"][:, 0]
        else:
            # the padded tail lands in the slot's own rows past t0, which
            # step t rewrites before any query sees them
            state["kc"][:, j, :self.Ts] = rs["pk"][:, 0]
            state["vc"][:, j, :self.Ts] = rs["pv"][:, 0]
        state["base"][j] = rs["base"][0]
        state["first"][j] = rs["first"][0]
        return state

    def step(self, params, state, tok, t, pages=None):
        host = [np.asarray(tok, np.int32), np.asarray(t, np.int32)]
        if self.paged:
            host.append(np.asarray(pages, np.int32).reshape(-1))
        self._stage(state["inputs"], np.concatenate(host))
        g = self._live(params, state)
        nxt = g.step.replay() if g is not None \
            else self._step_device(params, state)
        return self._fetch(nxt), state


class CausalLMDecodeProgram(_CausalKVDecodeProgram):
    """Greedy KV-cached decode for models/long_context.py (the data-path
    pre-LN block math) over the paged B7 kernel with
    ``attn_impl='kernel'``. Serving uses the per-layer ``blocks``
    parameters: ``parallelism='pipeline'`` is refused, as in JAX."""

    def __init__(self, cfg, max_src_len: int, max_len: int, **kw):
        if cfg.parallelism == "pipeline":
            raise ValueError(
                "serving needs the per-layer 'blocks' param layout; "
                "parallelism='pipeline' stores blocks_stacked")
        self._mod = long_context
        super().__init__(cfg, max_src_len, max_len, **kw)


class MoeLMDecodeProgram(_CausalKVDecodeProgram):
    """Greedy KV-cached decode for models/moe_lm.py (post-LN switch-MoE
    blocks; ``parallax_tpu/serve/adapters.py:784-797``): each decode step
    routes its S tokens through ``ops.moe.switch_moe``, the router in
    fp32 as in training, and its attention through B7 with
    ``attn_impl='kernel'``. Without a mesh (one card) the dense
    per-token expert path runs: row-wise, no capacity drops, so served
    tokens equal each request decoded alone (exact under greedy). Under
    a live mesh the capacity-bounded all-to-all dispatch applies, and
    co-batched slots contend for expert capacity: one slot's token can
    displace another's."""

    _fp32_leaves = ("router",)

    def __init__(self, cfg, max_src_len: int, max_len: int, **kw):
        self._mod = moe_lm
        super().__init__(cfg, max_src_len, max_len, **kw)


# -- LM1B ---------------------------------------------------------------------


class LM1BDecodeProgram(_ServeProgram):
    """Greedy decode for models/lm1b.py (``parallax_tpu/serve/adapters.py:
    800-884``): the "cache" is the LSTM carry itself ([S, H] cell + [S,
    P] hidden per slot); there are no pages and no positions, and ``t``
    matters only for the step-0 first-token gate. Dense only; requests
    run to their cap (``eos_id = -1`` never fires). Greedy uses the full
    softmax projection. The cells are plain PyTorch, as the JAX program
    runs plain cells: no kernel lies on this path.

    The LSTM weights are cast to the compute dtype once per params
    object; the tables stay fp32. On the card ``capture`` makes the
    prefill and the step graphs, as for the other programs."""

    _feed_key = "ids"

    def __init__(self, cfg, max_src_len: int, max_len: int, device="cuda"):
        self._init_plumbing(device)
        self.cfg = cfg
        self.Ts = int(max_src_len)
        self.max_len = int(max_len)
        if self.Ts < 1 or self.max_len < 1:
            raise ValueError(
                f"max_src_len={max_src_len} / max_len={max_len} must "
                f"be >= 1")
        self.bos_id = 0
        self.pad_id = 0
        self.eos_id = -1
        self.paged = False
        self._in = None

    example_feed = _CausalKVDecodeProgram.example_feed

    def prepare_feed(self, feed: Dict[str, Any]) -> Dict[str, np.ndarray]:
        ids = np.asarray(feed["ids"], np.int32)
        if ids.ndim != 1:
            raise ValueError(
                f"decode feed 'ids' must be one request's [T] prompt "
                f"row, got shape {ids.shape}")
        if not 1 <= ids.shape[0] <= self.Ts:
            raise ValueError(
                f"prompt length {ids.shape[0]} outside [1, "
                f"max_src_len={self.Ts}]")
        if (ids < 1).any() or (ids >= self.cfg.vocab_size).any():
            raise ValueError(
                "prompt ids must lie in [1, vocab_size): 0 is the "
                "PAD sentinel")
        return {"ids": bucketing.pad_axis0(ids, self.Ts, self.pad_id)}

    def _cast(self, params):
        dt = self.cfg.compute_dtype
        return {**params,
                "lstm": {k: v.to(dt) for k, v in params["lstm"].items()}}

    def init_state(self, params, slots: int) -> Dict[str, torch.Tensor]:
        cdt, dev = self.cfg.compute_dtype, self.device
        return {"c": torch.zeros((slots, self.cfg.hidden_dim), dtype=cdt,
                                 device=dev),
                "h": torch.zeros((slots, self.cfg.proj_dim), dtype=cdt,
                                 device=dev),
                "first": torch.zeros((slots,), dtype=torch.int32,
                                     device=dev),
                # the step's inputs, one buffer: tok [S] | t [S]
                "inputs": torch.zeros((2 * slots,), dtype=torch.int32,
                                      device=dev)}

    def _prefill_device(self, params, ids):
        c, h, _, first = lm1b._lstm_prefill(
            self.cfg, self._compute_params(params), ids, self.pad_id)
        return {"c": c, "h": h, "first": first}

    def _step_device(self, params, state):
        S = state["first"].shape[0]
        tok, t = state["inputs"][:S], state["inputs"][S:]
        tok_eff = torch.where(t == 0, state["first"], tok)
        logits, c, h = lm1b._lstm_decode_step(
            self.cfg, self._compute_params(params), tok_eff, state["c"],
            state["h"])
        state["c"].copy_(c)
        state["h"].copy_(h)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def capture(self, params, state) -> None:
        """Warm prefill, insert and step on ``state`` and, on the card
        outside ``compile.disable_capture()``, capture prefill and step
        as graphs. The state is zeroed after."""
        self._graphs = None
        self._in = torch.zeros((1, self.Ts), dtype=torch.int32,
                               device=self.device)
        self._stage(self._in,
                    self.prepare_feed(self.example_feed())["ids"][None])
        state["inputs"].zero_()
        if graphs_lib.capture_enabled(self.device):
            g = _Graphs(params, state, self._compute_params(params))
            self.insert(state, 0, self._capture_prefill(g, params))
            g.step = self._capture(lambda: self._step_device(params, state))
            self._graphs = g
        else:
            self.insert(state, 0, self._prefill_device(params, self._in))
            self._step_device(params, state)
        for v in state.values():
            v.zero_()

    def insert(self, state, slot, request_state):
        j = int(slot)
        for k in ("c", "h", "first"):
            state[k][j] = request_state[k][0]
        return state

    def step(self, params, state, tok, t, pages=None):
        self._stage(state["inputs"], np.concatenate(
            [np.asarray(tok, np.int32), np.asarray(t, np.int32)]))
        g = self._live(params, state)
        nxt = g.step.replay() if g is not None \
            else self._step_device(params, state)
        return self._fetch(nxt), state


# -- the standalone greedy reference ------------------------------------------


def standalone_greedy(program, params, feed, max_new_tokens: int):
    """Greedy decode of one request through the program's own device math,
    outside any session or scheduler (``parallax_tpu/serve/adapters.py:
    886-935``): prefill (a chunked program's runs every chunk), a fresh
    one-slot state, insert
    (through pages 0.. of a fresh page row when paged), then one step at
    a time. Served tokens equal these (the exact-under-greedy contract
    in fp32). Not while a session serves on the same program: its
    prefill result would be shared. Returns the emitted tokens (EOS
    included when hit)."""
    prepared = program.prepare_feed(feed)
    rs = program.prefill(params, prepared)
    state = program.init_state(params, 1)
    cap = int(max_new_tokens)
    paged = bool(getattr(program, "paged", False))
    pages = row = None
    if paged:
        row = np.full((program.pages_per_seq,), program.pool_pages,
                      np.int32)
        need = min(program.pages_needed(cap), program.pages_per_seq)
        row[:need] = np.arange(need, dtype=np.int32)
        pages = row[None]
    if getattr(program, "insert_pages", False):
        state = program.insert(state, 0, rs, row)
    else:
        state = program.insert(state, 0, rs)
    toks = []
    tok = np.full((1,), program.bos_id, np.int32)
    t = np.zeros((1,), np.int32)
    for _ in range(cap):
        if paged:
            nxt, state = program.step(params, state, tok, t, pages)
        else:
            nxt, state = program.step(params, state, tok, t)
        nt = int(np.asarray(nxt)[0])
        toks.append(nt)
        if nt == program.eos_id:
            break
        tok = np.array([nt], np.int32)
        t = t + 1
    return toks


# -- the adapter registry ----------------------------------------------------
# One spec per served model family (``parallax_tpu/serve/adapters.py:
# 938-1037``). The conformance tests parametrise over this table, so
# another adapter is a subclass plus a register_adapter call. Fixtures
# build tiny fp32 configs from the port's own init_params on the device
# they are given.


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    """Registry row: how to build a tiny serving fixture of one adapter.

    ``build(paged, chunked, device)`` returns ``(program, params)``;
    ``make_feed(rng)`` returns one raw request feed; ``paged``/
    ``chunked`` say which layouts the adapter supports."""
    name: str
    build: Any
    make_feed: Any
    paged: bool = True
    chunked: bool = True


_ADAPTERS: Dict[str, AdapterSpec] = {}


def register_adapter(spec: AdapterSpec) -> AdapterSpec:
    _ADAPTERS[spec.name] = spec
    return spec


def registered_adapters() -> Dict[str, AdapterSpec]:
    return dict(_ADAPTERS)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def _paged_kw(paged: bool, chunked: bool) -> dict:
    return dict(page_size=4 if paged else None,
                pool_pages=96 if paged else None,
                prefill_chunk_layers=1 if chunked else None)


def _nmt_fixture(paged: bool = True, chunked: bool = False, device="cuda"):
    cfg = nmt.tiny_config(compute_dtype=torch.float32)
    params = nmt.init_params(cfg, _generator(device, 0), device=device)
    prog = NMTDecodeProgram(cfg, max_src_len=8, max_len=8,
                            device=device, **_paged_kw(paged, chunked))
    return prog, params


def _nmt_feed(rng: np.random.Generator):
    n = int(rng.integers(2, 8))
    return {"src": rng.integers(3, 512, (n,)).astype(np.int32)}


def _causal_lm_fixture(paged: bool = True, chunked: bool = False,
                       device="cuda"):
    cfg = long_context.tiny_config(parallelism="data",
                                   compute_dtype=torch.float32)
    params = long_context.init_params(cfg, _generator(device, 1), device)
    prog = CausalLMDecodeProgram(cfg, max_src_len=8, max_len=8,
                                 device=device, **_paged_kw(paged, chunked))
    return prog, params


def _moe_lm_fixture(paged: bool = True, chunked: bool = False,
                    device="cuda"):
    cfg = moe_lm.tiny_config(compute_dtype=torch.float32)
    params = moe_lm.init_params(cfg, _generator(device, 2), device)
    prog = MoeLMDecodeProgram(cfg, max_src_len=8, max_len=8,
                              device=device, **_paged_kw(paged, chunked))
    return prog, params


def _lm_feed(rng: np.random.Generator):
    n = int(rng.integers(2, 8))
    return {"ids": rng.integers(1, 512, (n,)).astype(np.int32)}


def _lm1b_fixture(paged: bool = False, chunked: bool = False,
                  device="cuda"):
    cfg = lm1b.tiny_config(compute_dtype=torch.float32)
    params = lm1b.init_params(cfg, _generator(device, 3), device)
    return LM1BDecodeProgram(cfg, max_src_len=8, max_len=8,
                             device=device), params


def _lm1b_feed(rng: np.random.Generator):
    n = int(rng.integers(2, 8))
    return {"ids": rng.integers(1, 1000, (n,)).astype(np.int32)}


register_adapter(AdapterSpec("nmt", _nmt_fixture, _nmt_feed))
register_adapter(AdapterSpec("causal_lm", _causal_lm_fixture, _lm_feed))
register_adapter(AdapterSpec("moe_lm", _moe_lm_fixture, _lm_feed))
register_adapter(AdapterSpec("lm1b", _lm1b_fixture, _lm1b_feed,
                             paged=False, chunked=False))


__all__ = ["NMTDecodeProgram", "CausalLMDecodeProgram", "MoeLMDecodeProgram",
           "LM1BDecodeProgram", "AdapterSpec", "register_adapter",
           "registered_adapters", "standalone_greedy", "layer_skip_draft"]
