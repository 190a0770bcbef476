"""Distributed tracing — cluster-correlated spans over the telemetry bus
(docs/observability.md, "Tracing").

The telemetry bus answers "how long did things take on this host"; this
module answers "what was every host doing at the same moment".  A *span*
is a named, timed region (``kind="span"`` record in the same JSONL stream
as the metric records) carrying:

- ``trace_id`` — ``"<run_id>/<step>"``, derived from the shared run id and
  the global step, so the SAME training step on every worker lands in the
  same trace (the cross-device timeline the TensorFlow paper leans on for
  diagnosing distributed stalls, Abadi et al. 2016 §5; TF-Replicator makes
  the same point for replica-skew debugging);
- ``span_id`` / ``parent_id`` — per-process nesting (``parent_id=0`` for
  roots), supplied explicitly by hot-path emitters (the loop parents its
  data_wait/compute spans under the step span) or implicitly by the
  thread-local stack :meth:`Tracer.span` maintains, under which
  host-side annotations nest;
- ``t_unix`` / ``dur_ms`` — start (epoch seconds, ``time.time``) and
  duration.  Epoch time is deliberate: per-stream ``wall_time`` is a
  process-relative monotonic clock that cannot be compared across hosts;
  ``tools/export_trace.py`` aligns the epoch stamps across workers with
  the clock offset each worker measured against the coordination server
  (the ``TIME`` protocol command) and renders one Perfetto-loadable
  Chrome trace, one row per worker;
- ``thread`` — the emitting thread's name (main loop vs prefetch producer
  vs coordination background threads become separate trace rows).

Everything is optional and cheap when off: call sites consult
:func:`active` (a module global, like :mod:`.faults`) and skip span
emission entirely when no tracer is installed — the training loop without
``--metrics_file`` pays a single ``is None`` check.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import random
import threading
import time
from typing import Any, Iterator

#: Wire headers carrying trace context between serving tiers on
#: ``POST /generate`` (docs/observability.md, "Cross-tier tracing").
TRACE_HEADER = "X-DTF-Trace"
PARENT_HEADER = "X-DTF-Parent"
SAMPLED_HEADER = "X-DTF-Sampled"


def wire_headers(trace: str, parent_id: int,
                 sampled: bool = False) -> dict[str, str]:
    """HTTP headers propagating ``trace`` to the next tier, with
    ``parent_id`` naming the span the callee's root should nest under.
    ``sampled`` forces the downstream tail sampler to KEEP the trace —
    set by a tier that already knows the trace is interesting (a
    failover retry), since the callee retires before the caller's own
    verdict exists."""
    headers = {TRACE_HEADER: str(trace), PARENT_HEADER: str(int(parent_id))}
    if sampled:
        headers[SAMPLED_HEADER] = "1"
    return headers


def parse_wire(headers) -> tuple[str | None, int, bool]:
    """``(trace, parent_id, sampled)`` from an inbound header mapping
    (anything with ``.get``); ``(None, 0, False)`` when the caller sent
    no trace context."""
    trace = headers.get(TRACE_HEADER)
    if not trace:
        return None, 0, False
    try:
        parent = int(headers.get(PARENT_HEADER) or 0)
    except (TypeError, ValueError):
        parent = 0
    return str(trace), parent, headers.get(SAMPLED_HEADER) == "1"


def mint_trace(tag: str = "cli") -> str:
    """Fresh client-side trace id (``"<tag>-<12 hex>"``).  ServeClient
    and loadgen mint one per request when no upstream context exists;
    everything downstream adopts it off the wire."""
    return f"{tag}-{random.getrandbits(48):012x}"


def head_sampled(trace_id: str, rate: float) -> bool:
    """Deterministic head-sampling decision: hash the trace id into
    [0, 1) and compare against ``rate``.  Every tier computes the SAME
    verdict for the same trace without coordination (Python's ``hash``
    is salted per process, so md5 it is)."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    digest = hashlib.md5(str(trace_id).encode()).hexdigest()
    return int(digest[:8], 16) / float(0xFFFFFFFF) < rate


class Tracer:
    """Span factory bound to a telemetry bus and a run id.

    ``set_step`` keys subsequent spans (and their ``trace_id``) on the
    current global step; the training loop advances it once per step.
    Span ids are unique within the process; nesting is tracked per thread
    (a prefetch producer's spans never adopt the main loop's parents).
    """

    def __init__(self, telemetry, run_id: str):
        self._telemetry = telemetry
        self.run_id = str(run_id)
        self._step = 0
        # Span ids start from a random per-process base: cross-tier traces
        # merge spans from SEVERAL processes (client, routers, engine) into
        # one tree, and two tracers both counting from 1 would collide on
        # span ids and corrupt the parent links.  48 random bits over the
        # handful of processes in a serving stack makes collisions
        # negligible; 0 stays reserved as the "root" parent sentinel.
        self._ids = itertools.count(random.getrandbits(48) + 1)
        self._ids_lock = threading.Lock()
        self._local = threading.local()
        #: Optional :class:`serving.trace_buffer.TraceBuffer` — when set,
        #: request-keyed spans (explicit ``trace=``) park there for the
        #: tail sampler instead of hitting the telemetry stream directly.
        self.buffer = None

    # ------------------------------------------------------------- state

    def set_step(self, step: int) -> None:
        """Current global step — tags spans emitted from here on."""
        self._step = int(step)

    @property
    def step(self) -> int:
        return self._step

    def trace_id(self, step: int | None = None) -> str:
        """``"<run_id>/<step>"`` — identical on every worker for the same
        step, the cross-worker correlation key."""
        return f"{self.run_id}/{self._step if step is None else int(step)}"

    def _next_id(self) -> int:
        with self._ids_lock:
            return next(self._ids)

    def allocate_id(self) -> int:
        """Reserve a span id without emitting anything.  The serving tier
        uses this for a request's ROOT span: children (queue wait,
        prefill, decode rounds) are emitted live and need the parent id
        up front, but the root itself — spanning submit..retire — can
        only be emitted once the request is done."""
        return self._next_id()

    def request_trace_id(self, request_id) -> str:
        """``"<run_id>/req<id>"`` — one trace per served request, the
        serving-side analogue of the per-step training trace."""
        return f"{self.run_id}/req{request_id}"

    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # ------------------------------------------------------------- spans

    def emit_span(self, name: str, t_unix: float, dur_ms: float,
                  step: int | None = None, parent_id: int | None = None,
                  span_id: int | None = None, trace: str | None = None,
                  **attrs: Any) -> int:
        """After-the-fact span: the caller already measured the region
        (the loop's data-wait/compute timings, a prefetch produce) — one
        record, no context-manager overhead on the hot path.  ``parent_id``
        links an explicit parent (the loop parents data_wait/compute under
        their step span this way); when omitted, the thread's
        :meth:`span` stack supplies one (0 = root).  ``span_id`` emits
        under a pre-reserved id (:meth:`allocate_id` — the serving root
        spans); ``trace`` overrides the step-derived trace id (the
        serving tier keys request spans on :meth:`request_trace_id`, not
        on a step).  Returns the span id so callers can parent further
        spans under it."""
        step = self._step if step is None else int(step)
        if parent_id is None:
            stack = self._stack()
            parent_id = stack[-1] if stack else 0
        if span_id is None:
            span_id = self._next_id()
        fields = dict(
            step=step, name=str(name),
            trace_id=trace if trace is not None else self.trace_id(step),
            span_id=span_id,
            parent_id=parent_id,
            t_unix=round(float(t_unix), 6),
            dur_ms=round(float(dur_ms), 3),
            thread=threading.current_thread().name,
            **attrs)
        # Request-keyed spans (explicit trace=) park in the tail-sampling
        # buffer when one is armed: the keep/drop decision happens at
        # retirement, not at emission.  Step-keyed training spans never
        # buffer — tail sampling is a serving concern.
        if trace is not None and self.buffer is not None:
            self.buffer.park(str(trace), fields)
        else:
            self._telemetry.emit("span", **fields)
        return span_id

    @contextlib.contextmanager
    def span(self, name: str, step: int | None = None,
             **attrs: Any) -> Iterator[int]:
        """Timed region: pushes onto this thread's span stack so nested
        spans record ``parent_id``; emits one ``kind="span"`` record on
        exit (exceptional exits included — a span that died is exactly
        the one the flight recorder wants)."""
        span_id = self._next_id()
        stack = self._stack()
        parent = stack[-1] if stack else 0
        stack.append(span_id)
        t0_unix, t0 = time.time(), time.perf_counter()
        try:
            yield span_id
        finally:
            dur_ms = (time.perf_counter() - t0) * 1000.0
            if stack and stack[-1] == span_id:
                stack.pop()
            s = self._step if step is None else int(step)
            self._telemetry.emit(
                "span", step=s, name=str(name), trace_id=self.trace_id(s),
                span_id=span_id, parent_id=parent,
                t_unix=round(t0_unix, 6), dur_ms=round(dur_ms, 3),
                thread=threading.current_thread().name, **attrs)


_installed: Tracer | None = None


def install(tracer: Tracer) -> Tracer:
    """Install a tracer process-wide (train.py does this when telemetry is
    on; tests pair it with :func:`clear`)."""
    global _installed
    _installed = tracer
    return tracer


def clear() -> None:
    global _installed
    _installed = None


def active() -> Tracer | None:
    return _installed


@contextlib.contextmanager
def span(name: str, **attrs: Any) -> Iterator[int | None]:
    """Module-level span over the installed tracer; a silent no-op when
    none is installed — safe to sprinkle anywhere."""
    tracer = _installed
    if tracer is None:
        yield None
        return
    with tracer.span(name, **attrs) as span_id:
        yield span_id


def emit_span(name: str, t_unix: float, dur_ms: float, **attrs: Any) -> None:
    """Module-level after-the-fact span; no-op without an installed tracer."""
    tracer = _installed
    if tracer is not None:
        tracer.emit_span(name, t_unix, dur_ms, **attrs)
