"""Continuous-batching decode engine: a fixed slot batch over a paged KV
pool, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/serving/engine.py``.  The
engine owns ``num_slots`` decode lanes and per-layer paged KV pools
(:func:`..models.gpt.init_kv_pool`).  Admission and retirement happen per
step: a new request prefills into freshly allocated pages and joins the
slot batch while other lanes are mid-decode; a finished lane frees its
pages and its slot the step it emits eos or exhausts its budget.  Idle
lanes ride along with sentinel page tables (their writes go nowhere,
their outputs are ignored), so every step has the same shapes.

Weights: the engine carries a parameter mapping (the model's
``state_dict`` names) and runs the model through
:func:`torch.func.functional_call` with it, the counterpart of JAX's
``model.apply({"params": tree})``.  ``quantize="int8"`` stores that
mapping as per-channel int8 (:mod:`..ops.quant`, dequantized inside each
step) and ``kv_dtype="float8"`` keeps the pools in ``float8_e4m3fn``.
Hot swap (:meth:`DecodeEngine.swap_params`) stages a prepared mapping
and adopts it between steps; in-flight sequences keep their pages.

Sampling noise: row b's uniforms come from a ``torch.Generator`` seeded
by ``(seed, position + 1)`` (:func:`..models.gpt.row_uniforms`), so a
sampled stream is reproducible under any batch composition.  The bits
differ from the JAX engine's threefry keys; greedy streams are the same.

Chunked prefill (``prefill_chunk >= 1``): a new request's lane is seated
at once as a masked passenger (sentinel page table) and its prompt
advances ``prefill_chunk`` positions per engine step through
:meth:`..models.gpt.GptLM.prefill_chunk_paged`, one dispatch over the
slot batch, while the other lanes keep decoding; a long prompt no longer
stalls every live lane for its whole forward.  The speculative arm
(``spec_k >= 2``): whenever a live lane opted in
(``Request.speculative``), the step is one ``spec_k``-wide
:meth:`..models.gpt.GptLM.decode_chunk_paged` verify over the slot batch;
a speculative lane feeds its current token and ``spec_k - 1``
prompt-lookup drafts (:class:`..models.drafting.NGramIndex`) and emits
the accepted prefix plus the free correction, a plain lane emits its
sample from the chunk's first column.

Single-threaded by contract: one thread (the server's engine loop) calls
:meth:`admit` / :meth:`step`; :meth:`swap_params` may be called from any
thread.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch
from torch.func import functional_call

from ..models import gpt as gpt_lib
from ..models.drafting import NGramIndex
from ..ops.quant import (load_inference_tree, prepare_inference_tree,
                         resolve_kv_dtype, validate_quantize)
from ..utils import tracing
from ..utils.device import resolve_device
from .kv_pool import PageAllocator, reservation_tokens
from .scheduler import Request


def _unix_at(perf_t: float) -> float:
    """Map a ``perf_counter`` stamp onto the epoch clock (spans carry
    ``t_unix`` so the exporter can align them across hosts)."""
    return time.time() - (time.perf_counter() - perf_t)


def _ensure_request_trace(tracer, request: Request) -> None:
    """Give the request its trace identity on first tracer contact: a
    pre-allocated root span id (children parent under it live; the root
    ``serve.request`` span is emitted at retirement) and the
    ``"<run_id>/req<id>"`` trace id every span of this request carries."""
    if not request.span_root:
        request.span_root = tracer.allocate_id()
        request.trace = tracer.request_trace_id(request.id)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Decode-engine geometry and weight-path knobs."""

    num_slots: int = 4            # resident decode lanes (batch dim)
    page_size: int = 16           # token slots per KV page
    num_pages: int = 128          # pool pages per layer
    max_pages_per_seq: int = 8    # page-table width (caps seq length)
    quantize: str = ""            # "" | "int8" weight storage
    kv_dtype: str = ""            # "" | "bfloat16" | "float8" pool dtype
    # Speculative decode arm: 0 disables; >= 2 verifies spec_k tokens a
    # step (decode_chunk_paged) whenever a live lane opted in
    # (Request.speculative), with drafts from an n-gram index of order
    # spec_ngram over each lane's tokens (models/drafting.py).
    spec_k: int = 0
    spec_ngram: int = 3
    # Chunked prefill: 0 = whole-bucket prefill at admission; >= 1 = a
    # prefilling lane advances prefill_chunk prompt tokens per engine
    # step (prefill_chunk_paged) while the other lanes keep decoding.
    prefill_chunk: int = 0
    # Kept for config compatibility with the JAX engine, which bounds its
    # per-bucket compiled prefill programs; eager PyTorch compiles none.
    prefill_cache_cap: int = 8

    @property
    def max_seq_len(self) -> int:
        return self.page_size * self.max_pages_per_seq

    def __post_init__(self):
        if self.num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        validate_quantize(self.quantize)
        resolve_kv_dtype(self.kv_dtype)  # validates
        if self.spec_k == 1 or self.spec_k < 0:
            raise ValueError(f"spec_k must be 0 (off) or >= 2, "
                             f"got {self.spec_k}")
        if self.spec_k and self.spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, "
                             f"got {self.spec_ngram}")
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, "
                             f"got {self.prefill_chunk}")
        if self.prefill_cache_cap < 1:
            raise ValueError(f"prefill_cache_cap must be >= 1, "
                             f"got {self.prefill_cache_cap}")


class _Slot:
    """One live sequence's lane state (host side)."""

    __slots__ = ("request", "prompt_len", "budget", "generated", "spec",
                 "history", "hist_len", "index", "table", "prefill_pos",
                 "prefill_target", "prefill_chunks", "prefill_pages",
                 "t_prefill_start")

    def __init__(self, request: Request, spec_ngram: int = 0):
        self.request = request
        self.prompt_len = len(request.prompt)
        self.budget = request.num_tokens
        self.generated = 0
        self.table = None             # full page table, np [MP]
        # Chunked prefill: positions [prefill_pos, prefill_target) of the
        # prompt still owe their K/V to the pool (target stays 0 on the
        # whole-bucket path).
        self.prefill_pos = 0
        self.prefill_target = 0
        self.prefill_chunks = 0
        self.prefill_pages = 0
        self.t_prefill_start = 0.0
        # A speculative lane keeps its token history and an incremental
        # n-gram index on the host.
        self.spec = bool(spec_ngram)
        if self.spec:
            self.history = np.zeros(self.prompt_len + self.budget, np.int32)
            self.history[:self.prompt_len] = request.prompt
            self.hist_len = self.prompt_len
            self.index = NGramIndex(spec_ngram)
            self.index.update(self.history, self.hist_len - 1)
        else:
            self.history = None
            self.hist_len = 0
            self.index = None

    @property
    def prefilling(self) -> bool:
        """Seated, but the prompt's K/V not all in the pool yet: the lane
        rides the decode batch as a masked passenger (sentinel table)."""
        return self.prefill_pos < self.prefill_target

    def draft(self, k: int) -> np.ndarray:
        """[k] drafted continuation tokens for the lane's current tail."""
        return self.index.draft(self.history, self.hist_len, k)

    def commit(self, tokens: list[int]) -> None:
        """Fold the tokens emitted this step into the history and the
        index (the last token stays unindexed, so that the next tail
        cannot match itself)."""
        n = len(tokens)
        self.history[self.hist_len:self.hist_len + n] = tokens
        self.hist_len += n
        self.index.update(self.history, self.hist_len - 1)


class DecodeEngine:
    """Slot-batched continuous decoding over a paged KV pool.

    ``params`` is a parameter mapping with ``model.state_dict()``'s names
    (e.g. from :func:`..models.gpt.params_from_jax`); None takes the
    model's own.  ``device`` defaults to ``cuda``; without CUDA the
    engine raises unless ``device="cpu"`` is passed."""

    def __init__(self, model: gpt_lib.GptLM, params: dict | None = None,
                 config: EngineConfig | None = None, telemetry=None, *,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.config = cfg = config or EngineConfig()
        self.telemetry = telemetry
        mcfg = model.cfg
        if mcfg.attention_window:
            raise ValueError("the paged serving engine needs full-cache "
                             "addressing; sliding-window checkpoints are "
                             "not pageable")
        # Positions must stay addressable by the position table: the
        # logical capacity is the tighter of the page-table span and the
        # model's max_position.
        self.capacity = min(cfg.max_seq_len, mcfg.max_position)
        self._cache_dtype = resolve_kv_dtype(cfg.kv_dtype)
        self._reference = {k: (v.shape, v.dtype)
                           for k, v in model.state_dict().items()}
        self._decode = gpt_lib.MethodCall(model, "decode_paged")
        self._prefill = gpt_lib.MethodCall(model, "prefill")
        self._verify = gpt_lib.MethodCall(model, "decode_chunk_paged")
        self._chunk_prefill = gpt_lib.MethodCall(model,
                                                 "prefill_chunk_paged")
        self._tree = self._prepare_params(
            model.state_dict() if params is None else params)
        self._pending: tuple[Any, int] | None = None  # (tree, label step)
        self.model_step = 0            # checkpoint step the weights carry
        self.swaps = 0
        self.pools = gpt_lib.init_kv_pool(
            mcfg, cfg.num_pages, cfg.page_size, dtype=self._cache_dtype,
            device=self.device)
        self.allocator = PageAllocator(cfg.num_pages, cfg.page_size)

        B, MP = cfg.num_slots, cfg.max_pages_per_seq
        self._slots: list[_Slot | None] = [None] * B
        self._tokens = np.zeros((B,), np.int32)
        self._positions = np.zeros((B,), np.int32)
        self._tables = np.full((B, MP), cfg.num_pages, np.int32)
        self._temp = np.zeros((B,), np.float32)
        self._top_k = np.zeros((B,), np.int32)
        self._top_p = np.zeros((B,), np.float32)
        self._seeds = np.zeros((B,), np.int32)

        self.step_index = 0
        self._admitted_since_step = 0
        self._spec_rows_last_step = 0
        # Milliseconds spent producing prompt K/V (whole-bucket prefills
        # and chunk dispatches).
        self.prefill_ms_total = 0.0

    # ------------------------------------------------------------ params

    def _prepare_params(self, params: dict) -> dict:
        """Parameter mapping -> device-resident serving mapping (each
        tensor in its model parameter's dtype, int8 when asked)."""
        return prepare_inference_tree(
            gpt_lib.cast_params(params, self._reference, self.device),
            self.config.quantize)

    def _params(self, tree: dict) -> dict:
        """The mapping ``functional_call`` takes for a
        :class:`..models.gpt.MethodCall`."""
        params = load_inference_tree(tree, self.config.quantize,
                                     self.model.cfg.torch_dtype)
        return {f"model.{k}": v for k, v in params.items()}

    def swap_params(self, params: dict, step: int = 0) -> None:
        """Stage new weights for adoption between engine steps (safe from
        any thread: preparation runs here, on the caller)."""
        prepared = self._prepare_params(params)
        self._pending = (prepared, int(step))

    def apply_pending_swap(self) -> bool:
        """Adopt staged weights (engine thread, between steps)."""
        pending = self._pending
        if pending is None:
            return False
        t0 = time.perf_counter()
        self._pending = None
        tree, step = pending
        self._tree = tree
        prev = self.model_step
        self.model_step = step
        self.swaps += 1
        if self.telemetry is not None:
            self.telemetry.counter("serve_swaps").inc()
            self.telemetry.emit(
                "model_swap", step=self.step_index,
                from_model_step=prev, to_model_step=step,
                in_flight=self.active_slots)
        tracer = tracing.active()
        if tracer is not None:
            dur_ms = (time.perf_counter() - t0) * 1e3
            t_unix = _unix_at(t0)
            swap_id = tracer.emit_span(
                "serve.swap", t_unix, dur_ms, step=self.step_index,
                parent_id=0, from_model_step=prev, to_model_step=step,
                in_flight=self.active_slots)
            for state in self._slots:
                if state is None:
                    continue
                req = state.request
                _ensure_request_trace(tracer, req)
                tracer.emit_span(
                    "serve.swap_pause", t_unix, dur_ms,
                    step=self.step_index,
                    parent_id=req.span_root or swap_id, trace=req.trace,
                    request_id=req.id, tenant=req.tenant,
                    from_model_step=prev, to_model_step=step)
        return True

    # ------------------------------------------------------------ bodies

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Each lane's next token from its [B, vocab] logits, its noise
        drawn from ``(seed, position + 1)``."""
        sampled = np.flatnonzero(self._temp > 0.0)
        uniforms = gpt_lib.row_uniforms(
            self._seeds, self._positions + 1, logits.shape[-1],
            rows=sampled)
        return gpt_lib.sample_logits_dynamic(
            logits, uniforms.to(self.device), self._to_device(self._temp),
            self._to_device(self._top_k), self._to_device(self._top_p))

    def _run_decode(self) -> np.ndarray:
        """One decode step over the slot batch; the next token per lane."""
        tokens = self._to_device(self._tokens).long()
        positions = self._to_device(self._positions).long()
        tables = self._to_device(self._tables)
        logits, self.pools = functional_call(
            self._decode, self._params(self._tree),
            (tokens, self.pools, tables, positions))
        return self._sample(logits).cpu().numpy()

    def _run_verify(self, chunk: np.ndarray):
        """The speculative arm's step: one ``decode_chunk_paged`` over the
        slot batch.  Column 0 of ``chunk`` [B, spec_k] is each lane's
        current token, so ``logits[:, 0]`` is what the plain step computes
        and a plain lane samples from it exactly as the plain step would;
        columns 1.. are drafts.  Returns (greedy [B, spec_k], the column-0
        sample [B])."""
        positions = self._to_device(self._positions).long()
        logits, self.pools = functional_call(
            self._verify, self._params(self._tree),
            (self._to_device(chunk).long(), self.pools,
             self._to_device(self._tables), positions))
        greedy = torch.argmax(logits, dim=-1)
        sampled0 = self._sample(logits[:, 0])
        return greedy.cpu().numpy(), sampled0.cpu().numpy()

    def _run_prefill(self, toks: np.ndarray, phys: np.ndarray) -> None:
        """The prompt bucket's forward, then its K/V into pool pages."""
        mcfg, page = self.model.cfg, self.config.page_size
        n_pages, p_len = len(phys), toks.shape[1]
        caches = gpt_lib.init_kv_cache(mcfg, 1, p_len,
                                       dtype=self._cache_dtype,
                                       device=self.device)
        functional_call(self._prefill, self._params(self._tree),
                        (self._to_device(toks).long(), caches))
        idx = self._to_device(phys).long()
        for (kc, vc), (kp, vp) in zip(caches, self.pools):
            for cache, pool in ((kc, kp), (vc, vp)):
                pages = cache[0].reshape(n_pages, page, *cache.shape[2:])
                gpt_lib._bits(pool).index_copy_(0, idx,
                                                gpt_lib._bits(pages))

    # -------------------------------------------------------- admission

    @property
    def active_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def free_slots(self) -> int:
        return self.config.num_slots - self.active_slots

    def validate(self, request: Request) -> None:
        """Reject malformed requests up front (HTTP 400 territory)."""
        vocab = self.model.cfg.vocab_size
        if not request.prompt:
            raise ValueError("empty prompt")
        if any(not 0 <= t < vocab for t in request.prompt):
            raise ValueError(f"prompt token out of range [0, {vocab})")
        if request.num_tokens < 1:
            raise ValueError("num_tokens must be >= 1")
        if request.eos_id is not None and not (
                0 <= request.eos_id < vocab):
            raise ValueError(f"eos_id must be in [0, {vocab})")
        if not 0.0 <= request.top_p <= 1.0:
            raise ValueError("top_p must be in [0, 1]")
        # top_k / seed land in int32 slot arrays.
        if not 0 <= request.top_k < 2 ** 31:
            raise ValueError("top_k must be in [0, 2**31)")
        if not 0 <= request.seed < 2 ** 31:
            raise ValueError("seed must be in [0, 2**31)")
        if request.speculative and request.temperature > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only (acceptance compares "
                "against argmax); drop temperature or the speculative flag")
        total = len(request.prompt) + request.num_tokens
        if total > self.capacity:
            raise ValueError(
                f"prompt + num_tokens = {total} exceeds the engine "
                f"capacity {self.capacity} (pages x page_size, capped by "
                f"the model's max_position)")
        need = self.allocator.pages_for(
            reservation_tokens(len(request.prompt), request.num_tokens))
        if need > self.config.num_pages:
            raise ValueError(
                f"request reserves {need} KV page(s) worst-case but the "
                f"pool only has {self.config.num_pages}")

    def can_admit(self, request: Request) -> bool:
        """Slot and KV pages available right now (the scheduler's
        admissibility predicate; assumes :meth:`validate` passed)."""
        if self.free_slots < 1:
            return False
        return self.allocator.can_alloc(
            reservation_tokens(len(request.prompt), request.num_tokens))

    def admit(self, request: Request) -> int:
        """Reserve the request's pages and seat it.

        Whole-bucket path: the prompt prefills into its pages here, in one
        forward.  Chunked path (``prefill_chunk >= 1``): the lane is seated
        at once with a sentinel table and its prompt advances chunk by
        chunk in :meth:`step`.  Either way the first GENERATED token comes
        from a decode step: the lane is seeded with the last prompt token
        at position P-1, so the step produces token P like any other."""
        cfg = self.config
        slot = next(i for i, s in enumerate(self._slots) if s is None)
        P = len(request.prompt)
        tracer = tracing.active()
        if tracer is not None:
            _ensure_request_trace(tracer, request)
        t_res = time.perf_counter()
        pages = self.allocator.alloc(
            request.id, reservation_tokens(P, request.num_tokens))
        t_pre = time.perf_counter()
        if tracer is not None:
            tracer.emit_span(
                "serve.reserve", _unix_at(t_res), (t_pre - t_res) * 1e3,
                step=self.step_index, parent_id=request.span_root,
                trace=request.trace, request_id=request.id,
                tenant=request.tenant, pages=len(pages))
        n_prefill = self.allocator.pages_for(P)
        chunked = cfg.prefill_chunk > 0
        if not chunked:
            # Whole-bucket prefill: one forward over the padded prompt
            # bucket, blocking this engine step for its full duration.
            try:
                toks = np.zeros((1, n_prefill * cfg.page_size), np.int32)
                toks[0, :P] = request.prompt
                self._run_prefill(toks,
                                  np.asarray(pages[:n_prefill], np.int32))
                # Synchronise before timing: the span records device
                # time, not launch time.
                self._sync()
            except Exception:
                self.allocator.free(request.id)
                raise
            self.prefill_ms_total += (time.perf_counter() - t_pre) * 1e3
            if tracer is not None:
                tracer.emit_span(
                    "serve.prefill", _unix_at(t_pre),
                    (time.perf_counter() - t_pre) * 1e3,
                    step=self.step_index, parent_id=request.span_root,
                    trace=request.trace, request_id=request.id,
                    tenant=request.tenant, bucket=n_prefill,
                    pages=n_prefill, prompt_tokens=P, chunks=1)
        spec = bool(cfg.spec_k) and request.speculative
        state = _Slot(request, cfg.spec_ngram if spec else 0)
        state.table = self.allocator.page_table(request.id,
                                                cfg.max_pages_per_seq)
        state.prefill_pages = n_prefill
        self._slots[slot] = state
        if chunked and P > 1:
            # Seated prefilling: the row keeps the sentinel table (its
            # decode-batch writes drop, its outputs are ignored, as an idle
            # lane's) while step() advances positions [0, P-1); the decode
            # step writes P-1 itself, as after a whole-bucket prefill.
            state.prefill_target = P - 1
            state.t_prefill_start = t_pre
        else:
            # Whole-bucket path, or a one-token prompt, which owes no K/V:
            # the lane decodes from the next step.
            self._tables[slot] = state.table
        self._tokens[slot] = request.prompt[-1]
        self._positions[slot] = P - 1
        self._temp[slot] = request.temperature
        self._top_k[slot] = request.top_k
        self._top_p[slot] = request.top_p
        self._seeds[slot] = request.seed
        self._admitted_since_step += 1
        request.t_admit = time.perf_counter()
        return slot

    def _retire(self, slot: int, status: str) -> Request:
        state = self._slots[slot]
        assert state is not None
        req = state.request
        self._slots[slot] = None
        self._tables[slot] = self.config.num_pages
        self._tokens[slot] = 0
        self._positions[slot] = 0
        self._temp[slot] = 0.0
        self._top_k[slot] = 0
        self._top_p[slot] = 0.0
        self._seeds[slot] = 0
        self.allocator.free(req.id)
        req.t_done = time.perf_counter()
        if self.telemetry is not None:
            tel = self.telemetry
            tel.counter("serve_requests").inc()
            tel.counter("serve_tokens_out").inc(len(req.tokens))
            if status == "abandoned":
                tel.counter("serve_abandoned").inc()
                tel.counter(f"serve_abandoned[{req.tenant}]").inc()
            for name, value in (("serve_ttft_ms", req.ttft_ms),
                                ("serve_tpot_ms", req.tpot_ms),
                                ("serve_e2e_ms", req.e2e_ms)):
                if value is not None:
                    tel.histogram(name).record(value)
                    tel.histogram(f"{name}[{req.tenant}]").record(value)
            extra = {}
            if state.spec and req.spec_rounds:
                extra = {"speculative": True,
                         "spec_rounds": req.spec_rounds,
                         "spec_accepted_per_round": round(
                             len(req.tokens) / req.spec_rounds, 2)}
            tel.emit("serve_request", step=self.step_index,
                     tenant=req.tenant, status=status,
                     prompt_tokens=state.prompt_len,
                     tokens_out=len(req.tokens),
                     queue_ms=req.queue_ms, ttft_ms=req.ttft_ms,
                     tpot_ms=req.tpot_ms, e2e_ms=req.e2e_ms,
                     model_step=self.model_step, **extra)
        tracer = tracing.active()
        if tracer is not None:
            _ensure_request_trace(tracer, req)
            tracer.emit_span(
                "serve.retire", _unix_at(req.t_done), 0.0,
                step=self.step_index, parent_id=req.span_root,
                trace=req.trace, request_id=req.id, tenant=req.tenant,
                status=status, tokens_out=len(req.tokens))
            # The root span, submit..done; it nests under the calling
            # tier's span when the request arrived with wire context.
            tracer.emit_span(
                "serve.request", req.t_submit_unix,
                (req.t_done - req.t_submit) * 1e3, step=self.step_index,
                parent_id=req.wire_parent, span_id=req.span_root,
                trace=req.trace,
                request_id=req.id, tenant=req.tenant, status=status,
                tokens_out=len(req.tokens), queue_ms=req.queue_ms,
                ttft_ms=req.ttft_ms, tpot_ms=req.tpot_ms,
                model_step=self.model_step)
        return req

    # ------------------------------------------------------------- step

    def _spec_slots_active(self) -> bool:
        # A prefilling spec lane drafts nothing yet: it is a masked
        # passenger until its prompt K/V is in the pool.
        return any(s is not None and s.spec and not s.prefilling
                   for s in self._slots)

    def _advance_prefill(self) -> tuple[float, int]:
        """One chunk-prefill dispatch: every prefilling lane advances up to
        ``prefill_chunk`` prompt positions through ``prefill_chunk_paged``;
        a lane whose frontier reaches P-1 goes live (its real table
        installed) and its seed token rides the decode dispatch that
        follows.  The other rows ride along with sentinel tables.  Pad
        columns of a last partial chunk carry token 0 at positions >= the
        target: their junk K/V lands where the lane's decode steps write
        before its frontier reaches them.  Returns (ms, rows advanced)."""
        cfg = self.config
        C = cfg.prefill_chunk
        B, MP = cfg.num_slots, cfg.max_pages_per_seq
        t0 = time.perf_counter()
        tokens = np.zeros((B, C), np.int32)
        positions = np.zeros((B,), np.int32)
        tables = np.full((B, MP), cfg.num_pages, np.int32)
        rows: list[tuple[int, _Slot, int]] = []
        for slot, state in enumerate(self._slots):
            if (state is None or not state.prefilling
                    or state.request.abandoned):
                continue
            f = state.prefill_pos
            r = min(C, state.prefill_target - f)
            tokens[slot, :r] = state.request.prompt[f:f + r]
            positions[slot] = f
            tables[slot] = state.table
            rows.append((slot, state, r))
        if not rows:
            return 0.0, 0
        functional_call(self._chunk_prefill, self._params(self._tree),
                        (self._to_device(tokens).long(), self.pools,
                         self._to_device(tables),
                         self._to_device(positions).long()))
        # Device time, not launch time (the decode step would absorb it).
        self._sync()
        dur_ms = (time.perf_counter() - t0) * 1e3
        self.prefill_ms_total += dur_ms
        tracer = tracing.active()
        now = time.perf_counter()
        for slot, state, r in rows:
            state.prefill_pos += r
            state.prefill_chunks += 1
            if state.prefilling:
                continue
            self._tables[slot] = state.table       # live from now on
            req = state.request
            if tracer is not None:
                _ensure_request_trace(tracer, req)
                tracer.emit_span(
                    "serve.prefill", _unix_at(state.t_prefill_start),
                    (now - state.t_prefill_start) * 1e3,
                    step=self.step_index, parent_id=req.span_root,
                    trace=req.trace, request_id=req.id,
                    tenant=req.tenant, bucket=state.prefill_pages,
                    pages=state.prefill_pages,
                    prompt_tokens=state.prompt_len,
                    chunks=state.prefill_chunks, chunk_tokens=C)
        if self.telemetry is not None:
            self.telemetry.counter("serve_prefill_chunks").inc(len(rows))
            self.telemetry.histogram("serve_prefill_chunk_ms").record(
                dur_ms)
        return dur_ms, len(rows)

    def step(self, queue_depth: int = 0) -> list[Request]:
        """One decode step over the whole slot batch; returns the requests
        retired this step (completed/abandoned).  No-op (after adopting a
        staged swap) when every lane is idle.

        With chunked prefill the prompt chunks go first.  When a live lane
        opted into speculation the step is the verify dispatch: a
        speculative lane may emit several tokens (the accepted drafts and
        the free correction), a plain lane emits exactly what the plain
        step would."""
        self.apply_pending_swap()
        if self.active_slots == 0:
            return []
        prefill_ms, prefill_rows = 0.0, 0
        if self.config.prefill_chunk:
            prefill_ms, prefill_rows = self._advance_prefill()
        K = self.config.spec_k
        spec_mode = bool(K) and self._spec_slots_active()
        t0 = time.perf_counter()
        if spec_mode:
            chunk = np.zeros((self.config.num_slots, K), np.int32)
            chunk[:, 0] = self._tokens
            spec_rows = 0
            for slot, state in enumerate(self._slots):
                if state is not None and state.spec \
                        and not state.prefilling:
                    chunk[slot, 1:] = state.draft(K - 1)
                    spec_rows += 1
            greedy, nxt = self._run_verify(chunk)
            self._spec_rows_last_step = spec_rows
        else:
            nxt = self._run_decode()
            self._spec_rows_last_step = 0
        now = time.perf_counter()
        step_ms = (now - t0) * 1e3
        self.step_index += 1
        tracer = tracing.active()
        round_id = 0
        t_round_unix = 0.0
        if tracer is not None:
            t_round_unix = _unix_at(t0)
            round_id = tracer.emit_span(
                "serve.decode_round", t_round_unix, step_ms,
                step=self.step_index, parent_id=0,
                active_slots=self.active_slots,
                spec_rows=self._spec_rows_last_step,
                model_step=self.model_step)
        spec_accepted = 0
        retired: list[Request] = []
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            req = state.request
            if req.abandoned:
                retired.append(self._retire(slot, "abandoned"))
                continue
            if state.prefilling:
                continue              # a masked passenger: no token yet
            if spec_mode and state.spec:
                # The longest drafted prefix that matches the greedy
                # argmaxes, plus the free correction, clamped to the
                # lane's remaining budget; an accepted eos ends it.
                row, g = chunk[slot], greedy[slot]
                accept = 1
                while (accept < K and row[accept] == g[accept - 1]
                       and not (req.eos_id is not None
                                and row[accept - 1] == req.eos_id)):
                    accept += 1
                accept = min(accept, state.budget - state.generated)
                emitted = [int(t) for t in row[1:accept]]
                emitted.append(int(g[accept - 1]))
                req.spec_rounds += 1
            else:
                emitted = [int(nxt[slot])]
            if req.t_first_token is None:
                req.t_first_token = now
            done = False
            count = 0
            for token in emitted:
                req.tokens.append(token)
                state.generated += 1
                count += 1
                if ((req.eos_id is not None and token == req.eos_id)
                        or state.generated >= state.budget):
                    done = True
                    break
            if state.spec:
                state.commit(emitted[:count])
                # What landed: an eos cuts the emission mid-chunk.
                spec_accepted += count
            if tracer is not None:
                _ensure_request_trace(tracer, req)
                lane_attrs = {}
                if spec_mode and state.spec:
                    lane_attrs = {"accepted": count, "drafted": K - 1}
                tracer.emit_span(
                    "serve.decode_lane", t_round_unix, step_ms,
                    step=self.step_index, parent_id=round_id,
                    trace=req.trace, request_id=req.id,
                    tenant=req.tenant, tokens=count, **lane_attrs)
            if done:
                retired.append(self._retire(slot, "ok"))
            else:
                self._tokens[slot] = emitted[count - 1]
                self._positions[slot] += count
        if self.telemetry is not None:
            tel = self.telemetry
            tel.histogram("serve_step_ms").record(step_ms)
            tel.gauge("serve_active_slots").set(self.active_slots)
            tel.gauge("serve_kv_pages_in_use").set(
                self.allocator.pages_in_use)
            tel.gauge("serve_kv_pages_peak").set(self.allocator.peak_in_use)
            tel.gauge("serve_kv_fragmentation").set(
                self.allocator.internal_fragmentation())
            tel.gauge("serve_compile_cache").set(0)
            if spec_accepted:
                tel.counter("serve_spec_tokens").inc(spec_accepted)
            tel.emit("serve_step", step=self.step_index,
                     active_slots=self.active_slots + len(retired),
                     admitted=self._admitted_since_step,
                     retired=len(retired), queue_depth=queue_depth,
                     kv_pages_in_use=self.allocator.pages_in_use,
                     kv_pages_total=self.config.num_pages,
                     step_ms=round(step_ms, 3),
                     spec_rows=self._spec_rows_last_step,
                     spec_accepted=spec_accepted,
                     prefill_rows=prefill_rows,
                     prefill_ms=round(prefill_ms, 3),
                     model_step=self.model_step)
        self._admitted_since_step = 0
        return retired

    def fail_active(self, error: str) -> list[Request]:
        """Retire every live lane with an error (engine-fatal paths)."""
        out = []
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            state.request.error = error
            out.append(self._retire(slot, "error"))
        return out

    def stats(self) -> dict:
        """Occupancy/identity snapshot for /statz and the watch view (the
        JAX engine's keys; the compile-cache counts are 0 because eager
        PyTorch keeps no per-bucket compiled programs)."""
        return {
            "engine_step": self.step_index,
            "active_slots": self.active_slots,
            "num_slots": self.config.num_slots,
            "capacity_tokens": self.capacity,
            "model_step": self.model_step,
            "swaps": self.swaps,
            "quantize": self.config.quantize,
            "kv_dtype": self.config.kv_dtype,
            "spec_k": self.config.spec_k,
            "spec_rows": self._spec_rows_last_step,
            "prefill_chunk": self.config.prefill_chunk,
            "prefilling_slots": sum(
                1 for s in self._slots if s is not None and s.prefilling),
            "compile_cache": {
                "prefill_programs": 0,
                "chunk_programs": 0,
                "cap": self.config.prefill_cache_cap,
                "evictions": 0,
            },
            "kv_pool": self.allocator.snapshot(),
        }
