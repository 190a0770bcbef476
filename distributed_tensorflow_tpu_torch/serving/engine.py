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

Not ported yet (``EngineConfig`` raises): the speculative arm
(``spec_k >= 2``) and chunked prefill (``prefill_chunk >= 1``).

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
from torch import nn
from torch.func import functional_call

from ..models import gpt as gpt_lib
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
    # Speculative decode and chunked prefill: not ported yet, must stay 0.
    spec_k: int = 0
    spec_ngram: int = 3
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
        if self.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, "
                             f"got {self.prefill_chunk}")
        if self.prefill_cache_cap < 1:
            raise ValueError(f"prefill_cache_cap must be >= 1, "
                             f"got {self.prefill_cache_cap}")
        if self.spec_k:
            raise NotImplementedError(
                "spec_k >= 2 (speculative decode: decode_chunk_paged and "
                "models/drafting.py) is not ported yet; see ROADMAP.md, "
                "PyTorch port")
        if self.prefill_chunk:
            raise NotImplementedError(
                "prefill_chunk >= 1 (chunked prefill: prefill_chunk_paged) "
                "is not ported yet; see ROADMAP.md, PyTorch port")


class _Slot:
    """One live sequence's lane state (host side)."""

    __slots__ = ("request", "prompt_len", "budget", "generated", "table")

    def __init__(self, request: Request):
        self.request = request
        self.prompt_len = len(request.prompt)
        self.budget = request.num_tokens
        self.generated = 0
        self.table = None             # full page table, np [MP]


class _Method(nn.Module):
    """Calls one method of ``model``, so :func:`functional_call` can run
    it with a substituted parameter mapping."""

    def __init__(self, model: nn.Module, name: str):
        super().__init__()
        self.model = model
        self.name = name

    def forward(self, *args):
        return getattr(self.model, self.name)(*args)


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
        self._decode = _Method(model, "decode_paged")
        self._prefill = _Method(model, "prefill")
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

    # ------------------------------------------------------------ params

    def _prepare_params(self, params: dict) -> dict:
        """Parameter mapping -> device-resident serving mapping (each
        tensor in its model parameter's dtype, int8 when asked)."""
        missing = set(self._reference) ^ set(params)
        if missing:
            raise ValueError(f"params do not match the model's parameters: "
                             f"{sorted(missing)[:6]}")
        tree = {}
        for name, t in params.items():
            shape, dtype = self._reference[name]
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                 f"{tuple(shape)}")
            tree[name] = t.detach().to(device=self.device, dtype=dtype)
        return prepare_inference_tree(tree, self.config.quantize)

    def _params(self, tree: dict) -> dict:
        """The mapping ``functional_call`` takes for a :class:`_Method`."""
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

    def _run_decode(self) -> np.ndarray:
        """One decode step over the slot batch; the next token per lane."""
        tokens = self._to_device(self._tokens).long()
        positions = self._to_device(self._positions).long()
        tables = self._to_device(self._tables)
        logits, self.pools = functional_call(
            self._decode, self._params(self._tree),
            (tokens, self.pools, tables, positions))
        sampled = np.flatnonzero(self._temp > 0.0)
        uniforms = gpt_lib.row_uniforms(
            self._seeds, self._positions + 1, logits.shape[-1],
            rows=sampled)
        nxt = gpt_lib.sample_logits_dynamic(
            logits, uniforms.to(self.device), self._to_device(self._temp),
            self._to_device(self._top_k), self._to_device(self._top_p))
        return nxt.cpu().numpy()

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
        """Prefill the prompt into fresh pages and seat the request.

        The first GENERATED token comes from the next :meth:`step`: the
        lane is seeded with the last prompt token at position P-1, so the
        decode step produces token P like any other step."""
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
        # Whole-bucket prefill: one forward over the padded prompt bucket,
        # blocking this engine step for its full duration.
        try:
            toks = np.zeros((1, n_prefill * cfg.page_size), np.int32)
            toks[0, :P] = request.prompt
            self._run_prefill(toks, np.asarray(pages[:n_prefill], np.int32))
            # Synchronise before timing: the span records device time,
            # not launch time.
            self._sync()
        except Exception:
            self.allocator.free(request.id)
            raise
        if tracer is not None:
            tracer.emit_span(
                "serve.prefill", _unix_at(t_pre),
                (time.perf_counter() - t_pre) * 1e3,
                step=self.step_index, parent_id=request.span_root,
                trace=request.trace, request_id=request.id,
                tenant=request.tenant, bucket=n_prefill,
                pages=n_prefill, prompt_tokens=P, chunks=1)
        state = _Slot(request)
        state.table = self.allocator.page_table(request.id,
                                                cfg.max_pages_per_seq)
        self._slots[slot] = state
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
            tel.emit("serve_request", step=self.step_index,
                     tenant=req.tenant, status=status,
                     prompt_tokens=state.prompt_len,
                     tokens_out=len(req.tokens),
                     queue_ms=req.queue_ms, ttft_ms=req.ttft_ms,
                     tpot_ms=req.tpot_ms, e2e_ms=req.e2e_ms,
                     model_step=self.model_step)
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

    def step(self, queue_depth: int = 0) -> list[Request]:
        """One decode step over the whole slot batch; returns the requests
        retired this step (completed/abandoned).  No-op (after adopting a
        staged swap) when every lane is idle."""
        self.apply_pending_swap()
        if self.active_slots == 0:
            return []
        t0 = time.perf_counter()
        nxt = self._run_decode()
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
                active_slots=self.active_slots, spec_rows=0,
                model_step=self.model_step)
        retired: list[Request] = []
        for slot, state in enumerate(self._slots):
            if state is None:
                continue
            req = state.request
            if req.abandoned:
                retired.append(self._retire(slot, "abandoned"))
                continue
            token = int(nxt[slot])
            if req.t_first_token is None:
                req.t_first_token = now
            req.tokens.append(token)
            state.generated += 1
            done = ((req.eos_id is not None and token == req.eos_id)
                    or state.generated >= state.budget)
            if tracer is not None:
                _ensure_request_trace(tracer, req)
                tracer.emit_span(
                    "serve.decode_lane", t_round_unix, step_ms,
                    step=self.step_index, parent_id=round_id,
                    trace=req.trace, request_id=req.id,
                    tenant=req.tenant, tokens=1)
            if done:
                retired.append(self._retire(slot, "ok"))
            else:
                self._tokens[slot] = token
                self._positions[slot] += 1
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
            tel.emit("serve_step", step=self.step_index,
                     active_slots=self.active_slots + len(retired),
                     admitted=self._admitted_since_step,
                     retired=len(retired), queue_depth=queue_depth,
                     kv_pages_in_use=self.allocator.pages_in_use,
                     kv_pages_total=self.config.num_pages,
                     step_ms=round(step_ms, 3), spec_rows=0,
                     spec_accepted=0, prefill_rows=0, prefill_ms=0.0,
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
            "spec_rows": 0,
            "prefill_chunk": self.config.prefill_chunk,
            "prefilling_slots": 0,
            "compile_cache": {
                "prefill_programs": 0,
                "chunk_programs": 0,
                "cap": self.config.prefill_cache_cap,
                "evictions": 0,
            },
            "kv_pool": self.allocator.snapshot(),
        }
