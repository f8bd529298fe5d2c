"""Model adapters: DecodeProgram implementations over existing models.

The continuous scheduler (serve/continuous.py) is model-agnostic; an
adapter binds it to one model family's prefill/step math. The NMT
adapter reuses models/nmt.py's encoder, cross-attention K/V precompute
and the per-slot-position cached decoder step — the KV-cached math
``greedy_decode`` runs, restructured from "one loop per batch" into
"one step per scheduler iteration". ``CausalLMDecodeProgram`` does the
same for the decoder-only long-context LM (models/long_context.py), whose
prompt K/V lands in the same cache the decode steps write: its insert
scatters the prompt rows through the slot's page table
(``insert_pages``). ``MoeLMDecodeProgram`` serves the switch-MoE LM
(models/moe_lm.py) the same way. ``standalone_greedy`` decodes one
request through a program's own device math outside any scheduler: the
reference served tokens are held to.

On the card the scheduler's warmup calls ``capture``: the one-request
prefill and the decode step for its slot count become two CUDA graphs
(compile/graphs.py) over static buffers, and every later ``prefill`` and
``step`` copies its host inputs in and replays. The counterpart of the
JAX package compiling prefill and step ahead of serving.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from parallax_tpu_torch.common.lib import resolve_device
from parallax_tpu_torch.compile import bucketing, graphs as graphs_lib
from parallax_tpu_torch.models import long_context, moe_lm, nmt
from parallax_tpu_torch.ops import paged_attention as pa_ops
from parallax_tpu_torch.serve.continuous import DecodeProgram
from parallax_tpu_torch.serve.paging import pages_for


class NMTDecodeProgram(DecodeProgram):
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

    ``device`` is where the state lives and the steps run (default the
    card; ``"cpu"`` must be asked for). Chunked prefill and speculative
    decoding are not ported: ``prefill_chunk_layers`` / ``spec_tokens``
    are refused.

    Every weight but the fp32 output projection is cast to the compute
    dtype once per params object (the bits each use sees are the same
    as casting at the use). ``step`` takes its tokens, positions and
    page table through one static int32 buffer of the state, filled by
    one copy from pinned host memory, and writes the paged pool in
    place. After ``capture(params, state)`` (on the card, outside
    ``compile.disable_capture()``) ``prefill`` and ``step`` on that
    params object and state replay graphs; a prefill's result then
    lives in the prefill graph's pool until the next prefill.
    """

    def __init__(self, cfg: nmt.NMTConfig, max_src_len: int,
                 max_len: Optional[int] = None, *,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_layers: Optional[int] = None,
                 spec_tokens: int = 0,
                 attn_impl: Optional[str] = None,
                 device="cuda"):
        if prefill_chunk_layers is not None or spec_tokens:
            raise ValueError(
                "chunked prefill (prefill_chunk_layers) and speculative "
                "decoding (spec_tokens) are not ported to "
                "parallax_tpu_torch yet")
        self.device = resolve_device(device)
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
            if self.max_len % self.page_size != 0:
                raise ValueError(
                    f"page_size={page_size} must divide max_len="
                    f"{self.max_len}")
            self.pages_per_seq = self.max_len // self.page_size
            if self.pool_pages < self.pages_per_seq:
                raise ValueError(
                    f"pool_pages={pool_pages} cannot hold even one "
                    f"max-length sequence ({self.pages_per_seq} pages)")
        elif pool_pages is not None:
            raise ValueError("pool_pages given without page_size")

        if attn_impl is not None and attn_impl not in ("kernel", "einsum"):
            raise ValueError(
                f"attn_impl={attn_impl!r}: expected 'kernel' or 'einsum'")
        if attn_impl == "kernel" and not self.paged:
            raise ValueError(
                "attn_impl='kernel' requires the paged KV layout "
                "(page_size/pool_pages): the kernel's operand is the "
                "page-table-addressed pool")
        self.attn_impl = attn_impl
        self._cast_of = None        # (params object, its cast copy)
        self._graphs = None         # (params, state, prefill, step)
        self._src = None            # the prefill graph's static input
        self._out = None            # pinned host buffer of next tokens

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

    # -- device programs ---------------------------------------------------

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

    def _compute_params(self, params):
        """``params`` with every leaf but ``out_proj`` cast to the compute
        dtype, made once per params object."""
        if self._cast_of is None or self._cast_of[0] is not params:
            dt = self.cfg.compute_dtype

            def cast(tree):
                if isinstance(tree, dict):
                    return {k: cast(v) for k, v in tree.items()}
                if isinstance(tree, (list, tuple)):
                    return type(tree)(cast(v) for v in tree)
                return tree.to(dt)

            self._cast_of = (params, {k: (v if k == "out_proj" else cast(v))
                                      for k, v in params.items()})
        return self._cast_of[1]

    def init_state(self, params, slots: int) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        L, D, dt = cfg.num_layers, cfg.model_dim, cfg.compute_dtype
        shape = (L, slots, self.Ts, D)
        state = {"ck": torch.zeros(shape, dtype=dt, device=self.device),
                 "cv": torch.zeros(shape, dtype=dt, device=self.device),
                 "src_valid": torch.zeros((slots, self.Ts),
                                          dtype=torch.bool,
                                          device=self.device)}
        if self.paged:
            state["kc"], state["vc"] = nmt._init_paged_self_cache(
                cfg, self.pool_pages, self.page_size, self.device)
        else:
            state["kc"], state["vc"] = nmt._init_self_cache(
                cfg, slots, self.max_len, self.device)
        # the step's inputs, one buffer: tok [S] | t [S] | pages [S, P]
        P = self.pages_per_seq if self.paged else 0
        state["inputs"] = torch.zeros((slots * (2 + P),), dtype=torch.int32,
                                      device=self.device)
        return state

    def _step_inputs(self, state):
        """(tok, t, pages) views of the state's input buffer."""
        buf = state["inputs"]
        S = state["src_valid"].shape[0]
        pages = buf[2 * S:].view(S, -1) if self.paged else None
        return buf[:S], buf[S:2 * S], pages

    def _prefill_device(self, params, src):
        cp = self._compute_params(params)
        enc_out, src_valid = nmt._encode(self.cfg, cp, src.long())
        ck, cv = nmt._cross_kv(self.cfg, cp, enc_out)        # [L,1,Ts,D]
        return {"ck": ck, "cv": cv, "src_valid": src_valid}

    def _step_device(self, params, state):
        cp = self._compute_params(params)
        tok, t, pages = self._step_inputs(state)
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

    def _step_graph(self, params, state):
        g = self._graphs
        if g is not None and g[0] is params and g[1] is state:
            return g[3]
        return None

    def capture(self, params, state) -> None:
        """Warm the prefill, the insert and the step on ``state`` (the
        scheduler's own) and, on the card outside
        ``compile.disable_capture()``, capture prefill and step as graphs
        over static buffers. The warm calls write slot 0 and the spare
        page; the state is zeroed after, as fresh."""
        self._graphs = None
        self._src = torch.zeros((1, self.Ts), dtype=torch.int32,
                                device=self.device)
        self._stage(self._src,
                    self.prepare_feed(self.example_feed())["src"][None])
        tok, t, pages = self._step_inputs(state)
        tok.fill_(self.bos_id)
        t.zero_()
        if pages is not None:
            pages.fill_(self.pool_pages)
        if graphs_lib.capture_enabled(self.device):
            pre = graphs_lib.capture(
                lambda: self._prefill_device(params, self._src), self.device)
            stp = graphs_lib.capture(
                lambda: self._step_device(params, state), self.device)
            self._graphs = (params, state, pre, stp)
        else:
            self.insert(state, 0, self._prefill_device(params, self._src))
            self._step_device(params, state)
        for v in state.values():
            v.zero_()

    def prefill(self, params, feed):
        """The whole per-request one-time work: the encoder over the
        padded source, then every decoder layer's cross K/V."""
        g = self._graphs
        if g is not None and g[0] is params:
            self._stage(self._src, np.asarray(feed["src"])[None])
            return g[2].replay()
        return self._prefill_device(params,
                                    self._ints(feed["src"])[None])

    def insert(self, state, slot, request_state):
        """Write one prefilled request into slot ``slot`` (in place)."""
        j = int(slot)
        state["ck"][:, j] = request_state["ck"][:, 0]
        state["cv"][:, j] = request_state["cv"][:, 0]
        state["src_valid"][j] = request_state["src_valid"][0]
        return state

    def step(self, params, state, tok, t, pages=None):
        S = len(tok)
        host = [np.asarray(tok, np.int32), np.asarray(t, np.int32)]
        if self.paged:
            host.append(np.asarray(pages, np.int32).reshape(-1))
        self._stage(state["inputs"], np.concatenate(host))
        graph = self._step_graph(params, state)
        nxt = graph.replay() if graph is not None \
            else self._step_device(params, state)
        if self.device.type != "cuda":
            return nxt.numpy().copy(), state
        if self._out is None or self._out.shape[0] != S:
            self._out = torch.empty((S,), dtype=torch.int32,
                                    pin_memory=True)
        self._out.copy_(nxt, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self._out.numpy().copy(), state


# -- decoder-only causal LMs --------------------------------------------------


class _CausalKVDecodeProgram(DecodeProgram):
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
    spare page, so a slot never writes outside its own pages. A request
    needs the pages of its ``kv_prefix_positions`` plus its cap
    (``pages_needed(cap)`` is the worst case, the longest prompt).

    ``attn_impl`` ('kernel', 'einsum'; None and 'auto' = 'kernel')
    picks the paged attention as in ``NMTDecodeProgram``; the prompt's
    prefill runs the plain causal attention, as in JAX. Token ids: 0 is
    PAD, BOS and EOS at once; prompts use ids in [1, vocab), and a
    generated 0 retires the request. Chunked prefill and speculative
    decoding are not ported: ``prefill_chunk_layers`` / ``spec_tokens``
    are refused.

    As in ``NMTDecodeProgram``, every weight but the fp32 ``out_w`` (and
    the block leaves ``_fp32_leaves`` names, which the model reads in
    fp32) is cast to the compute dtype once per params object, ``step``
    takes its inputs through one static int32 buffer of the state, and
    after ``capture(params, state)`` on the card ``prefill`` and ``step``
    replay CUDA graphs (a prefill's result lives in the prefill graph's
    pool until the next prefill)."""

    _mod = None          # the model module with the serve decode section
    _fp32_leaves = ()    # block leaves kept in fp32 (the MoE router)

    def __init__(self, cfg, max_src_len: int, max_len: int, *,
                 page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefill_chunk_layers: Optional[int] = None,
                 spec_tokens: int = 0,
                 attn_impl: Optional[str] = None,
                 device="cuda"):
        if prefill_chunk_layers is not None or spec_tokens:
            raise ValueError(
                "chunked prefill (prefill_chunk_layers) and speculative "
                "decoding (spec_tokens) are not ported to "
                "parallax_tpu_torch yet")
        self.device = resolve_device(device)
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
            if self.Tbuf % self.page_size != 0:
                raise ValueError(
                    f"page_size={page_size} must divide max_src_len + "
                    f"max_len = {self.Tbuf}")
            self.pages_per_seq = self.Tbuf // self.page_size
            if self.pool_pages < self.pages_per_seq:
                raise ValueError(
                    f"pool_pages={pool_pages} cannot hold even one "
                    f"max-length sequence ({self.pages_per_seq} pages)")
        elif pool_pages is not None:
            raise ValueError("pool_pages given without page_size")
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
        self._cast_of = None        # (params object, its cast copy)
        self._graphs = None         # (params, state, prefill, step)
        self._ids = None            # the prefill graph's static input
        self._out = None            # pinned host buffer of next tokens

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
        prompt position): with the cap, the positions a request writes."""
        t0 = int((np.asarray(feed["ids"]) != self.pad_id).sum())
        return max(t0 - 1, 0)

    # -- device programs ---------------------------------------------------

    _ints = NMTDecodeProgram._ints
    _stage = NMTDecodeProgram._stage

    def _compute_params(self, params):
        """``params`` with every leaf but ``out_w`` cast to the compute
        dtype, made once per params object."""
        if self._cast_of is None or self._cast_of[0] is not params:
            dt = self.cfg.compute_dtype
            cast = {k: v.to(dt) for k, v in params.items()
                    if k not in ("out_w", "blocks")}
            cast["out_w"] = params["out_w"]
            cast["blocks"] = [
                {k: ({n: t.to(dt) for n, t in v.items()}
                     if isinstance(v, dict) else
                     v if k in self._fp32_leaves else v.to(dt))
                 for k, v in b.items()} for b in params["blocks"]]
            self._cast_of = (params, cast)
        return self._cast_of[1]

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

    def _step_device(self, params, state):
        cp = self._compute_params(params)
        tok, t, pages = self._step_inputs(state)
        logits, _, _ = self._mod._decode_step_cached(
            self.cfg, cp, tok, t, state["base"], state["first"],
            state["kc"], state["vc"], pages=pages,
            page_size=self.page_size if self.paged else None,
            attn_impl=self.attn_impl)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    _step_graph = NMTDecodeProgram._step_graph

    def capture(self, params, state) -> None:
        """Warm prefill, insert and step on ``state`` (the scheduler's)
        and, on the card outside ``compile.disable_capture()``, capture
        prefill and step as graphs over static buffers. The warm calls
        write slot 0 and the spare page; the state is zeroed after."""
        self._graphs = None
        self._ids = torch.zeros((1, self.Ts), dtype=torch.int32,
                                device=self.device)
        self._stage(self._ids,
                    self.prepare_feed(self.example_feed())["ids"][None])
        tok, t, pages = self._step_inputs(state)
        tok.fill_(self.bos_id)
        t.zero_()
        if pages is not None:
            pages.fill_(self.pool_pages)
        row = np.full((self.pages_per_seq,), self.pool_pages, np.int32) \
            if self.paged else None
        if graphs_lib.capture_enabled(self.device):
            pre = graphs_lib.capture(
                lambda: self._prefill_device(params, self._ids),
                self.device)
            self.insert(state, 0, pre.replay(), row)
            stp = graphs_lib.capture(
                lambda: self._step_device(params, state), self.device)
            self._graphs = (params, state, pre, stp)
        else:
            self.insert(state, 0, self._prefill_device(params, self._ids),
                        row)
            self._step_device(params, state)
        for v in state.values():
            v.zero_()

    def prefill(self, params, feed):
        """The prompt's forward: every layer's K/V over the padded prompt,
        ``base`` and ``first``."""
        g = self._graphs
        if g is not None and g[0] is params:
            self._stage(self._ids, np.asarray(feed["ids"])[None])
            return g[2].replay()
        return self._prefill_device(params, self._ints(feed["ids"])[None])

    def insert(self, state, slot, request_state, pages=None):
        """Write one prefilled request into slot ``slot`` (in place): the
        prompt's K/V through the slot's page row ``pages`` (paged; the
        padded rows to the spare page) or into the slot's rows (dense),
        then its ``base`` and ``first``."""
        j = int(slot)
        rs = request_state
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

    def copy_page(self, state, dst, src):
        """Device-side copy of page ``src`` onto page ``dst`` in both
        pools (the prefix cache's copy-on-write)."""
        for name in ("kc", "vc"):
            state[name][:, int(dst)] = state[name][:, int(src)]
        return state

    step = NMTDecodeProgram.step


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


# -- the standalone greedy reference ------------------------------------------


def standalone_greedy(program, params, feed, max_new_tokens: int):
    """Greedy decode of one request through the program's own device math,
    outside any session or scheduler (``parallax_tpu/serve/adapters.py:
    886-940``): prefill, a fresh one-slot state, insert (through pages
    0.. of a fresh page row when paged), then one step at a time.
    Served tokens equal these (the exact-under-greedy contract in fp32).
    Not while a session serves on the same program: its prefill graph's
    result would be shared. Returns the emitted tokens (EOS included
    when hit)."""
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


__all__ = ["NMTDecodeProgram", "CausalLMDecodeProgram", "MoeLMDecodeProgram",
           "standalone_greedy"]
