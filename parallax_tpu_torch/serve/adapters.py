"""Model adapters: DecodeProgram implementations over existing models.

The continuous scheduler (serve/continuous.py) is model-agnostic; an
adapter binds it to one model family's prefill/step math. The NMT
adapter reuses models/nmt.py's encoder, cross-attention K/V precompute
and the per-slot-position cached decoder step — the KV-cached math
``greedy_decode`` runs, restructured from "one loop per batch" into
"one step per scheduler iteration".

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
from parallax_tpu_torch.models import nmt
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


__all__ = ["NMTDecodeProgram"]
