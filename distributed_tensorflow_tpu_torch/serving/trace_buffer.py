"""Tail-based trace sampling — keep the interesting traces, decide AFTER
retirement (docs/observability.md, "Cross-tier tracing & tail sampling").

Head sampling throws the dice when a request arrives, which is exactly
when nothing is known about it: the 1-in-10 000 request that failed over
across cells is dropped with probability 0.9999.  Tail sampling inverts
the order — every span a request produces parks in a bounded in-memory
ring keyed by trace id, and only at retirement, when the verdict (slow?
errored? failed over? throttled?) is in hand, does the whole trace get
flushed to the telemetry stream or dropped wholesale.

Two pieces:

- :class:`TailSampler` — the pure decision function.  Keep iff the
  request was slow (per-tenant latency threshold taken from the SLO
  objectives), errored, failed over, 429'd, force-kept by an upstream
  tier (``X-DTF-Sampled``), or head-sampled at ``--trace_sample_rate``
  (a deterministic trace-id hash, so every tier reaches the SAME verdict
  without coordination).  Injecting ``clock`` keeps tests deterministic.
- :class:`TraceBuffer` — the bounded per-tier ring.  ``park`` is what
  :meth:`utils.tracing.Tracer.emit_span` calls for request-keyed spans
  when a buffer is armed; ``retire`` applies the sampler and either
  flushes or drops.  Overflow degrades to head-sampling on the evicted
  (oldest) trace and never blocks the engine loop; kept/dropped/overflow
  counters surface on ``/statz`` and as per-decision ``trace_sample``
  records (the ``serve_trace_sampled`` gauge).

Zero-cost when off: without an installed tracer no span exists to park,
and without an armed buffer ``emit_span`` writes straight to telemetry
exactly as before this module existed.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Iterable

from ..utils import tracing

#: Retirement statuses the sampler treats as backpressure / error.
_BACKPRESSURE_STATUS = 429


def slow_thresholds(objectives: Iterable[Any]) -> dict[str, float]:
    """Per-tenant "slow" thresholds (ms) from parsed SLO objectives
    (:func:`serving.slo.parse_slos`).  A request is slow when its e2e
    latency exceeds the tenant's tightest ``e2e`` objective threshold;
    tenants without one inherit the ``"*"`` objective.  Non-latency and
    non-e2e objectives (ttft/tpot target different request phases) are
    ignored rather than misapplied to e2e."""
    out: dict[str, float] = {}
    for obj in objectives or ():
        if getattr(obj, "metric", None) != "e2e_ms":
            continue
        if obj.threshold_ms is None:
            continue
        prev = out.get(obj.tenant)
        if prev is None or obj.threshold_ms < prev:
            out[obj.tenant] = float(obj.threshold_ms)
    return out


class TailSampler:
    """Pure keep/drop decision for a retired trace.

    ``decide`` consults only its arguments (plus the construction-time
    thresholds and rate) — no I/O, no globals — so tests drive it with
    synthetic verdicts and an injected clock.  ``clock`` is only used to
    timestamp decisions on the record the buffer emits.
    """

    def __init__(self, sample_rate: float = 0.0,
                 slow_ms: dict[str, float] | None = None,
                 clock=time.time):
        self.sample_rate = float(sample_rate)
        self.slow_ms = dict(slow_ms or {})
        self.clock = clock

    def slow_threshold(self, tenant: str | None) -> float | None:
        if tenant is not None and tenant in self.slow_ms:
            return self.slow_ms[tenant]
        return self.slow_ms.get("*")

    def decide(self, trace_id: str, *, tenant: str | None = None,
               e2e_ms: float | None = None, ok: bool = True,
               status: int = 200, failovers: int = 0,
               forced: bool = False) -> tuple[bool, str]:
        """``(keep, reason)`` — reasons, in precedence order: ``forced``
        (upstream tier demanded it), ``error``, ``backpressure`` (429),
        ``failover``, ``slow``, ``head`` (the deterministic hash), else
        ``drop``."""
        if forced:
            return True, "forced"
        if not ok or int(status) >= 500:
            return True, "error"
        if int(status) == _BACKPRESSURE_STATUS:
            return True, "backpressure"
        if int(failovers) > 0:
            return True, "failover"
        threshold = self.slow_threshold(tenant)
        if (threshold is not None and e2e_ms is not None
                and float(e2e_ms) > threshold):
            return True, "slow"
        if tracing.head_sampled(trace_id, self.sample_rate):
            return True, "head"
        return False, "drop"


class TraceBuffer:
    """Bounded per-tier ring of in-flight request spans, keyed by trace.

    One buffer per process (tier); armed onto the tracer via
    ``tracer.buffer = buffer``.  All operations are short critical
    sections over a dict — ``park`` never blocks on I/O, so the engine
    loop's span emission stays hot-path safe.  ``capacity`` bounds the
    number of DISTINCT in-flight traces; when exceeded the oldest parked
    trace is evicted early with a head-sampling verdict (degraded mode:
    the tail verdict for that trace is lost, the stream records the
    overflow).
    """

    def __init__(self, telemetry, sampler: TailSampler, *,
                 tier: str = "engine", capacity: int = 256,
                 clock=time.time):
        self._telemetry = telemetry
        self.sampler = sampler
        self.tier = str(tier)
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._parked: "collections.OrderedDict[str, list[dict]]" = (
            collections.OrderedDict())
        self.kept = 0
        self.dropped = 0
        self.overflow = 0

    # ---------------------------------------------------------- parking

    def park(self, trace_id: str, fields: dict) -> None:
        """Hold one span record until its trace retires.  Called by
        ``Tracer.emit_span`` for request-keyed spans."""
        evicted: tuple[str, list[dict]] | None = None
        with self._lock:
            bucket = self._parked.get(trace_id)
            if bucket is None:
                if len(self._parked) >= self.capacity:
                    evicted = self._parked.popitem(last=False)
                    self.overflow += 1
                bucket = self._parked[trace_id] = []
            bucket.append(fields)
        if evicted is not None:
            # Degraded mode: the evicted trace can no longer wait for its
            # tail verdict — fall back to the deterministic head-sampling
            # coin so SOME overflow traces still surface.
            ev_trace, ev_spans = evicted
            keep = tracing.head_sampled(ev_trace, self.sampler.sample_rate)
            self._settle(ev_trace, ev_spans, keep,
                         "overflow_head" if keep else "overflow")

    def retire(self, trace_id: str, *, tenant: str | None = None,
               e2e_ms: float | None = None, ok: bool = True,
               status: int = 200, failovers: int = 0,
               forced: bool = False) -> bool:
        """Apply the tail verdict to a finished trace: flush every parked
        span (keep) or drop them wholesale.  Returns the keep decision so
        the caller can propagate it (e.g. onto a response header)."""
        with self._lock:
            spans = self._parked.pop(trace_id, [])
        keep, reason = self.sampler.decide(
            trace_id, tenant=tenant, e2e_ms=e2e_ms, ok=ok, status=status,
            failovers=failovers, forced=forced)
        self._settle(trace_id, spans, keep, reason, tenant=tenant)
        return keep

    def _settle(self, trace_id: str, spans: list[dict], keep: bool,
                reason: str, tenant: str | None = None) -> None:
        with self._lock:
            if keep:
                self.kept += 1
            else:
                self.dropped += 1
            kept, dropped = self.kept, self.dropped
        if keep:
            for fields in spans:
                self._telemetry.emit("span", **fields)
        # ONE trace_sample emit site — the serve_trace_sampled gauge.
        # Every decision is recorded (kept AND dropped) so the stream
        # proves what the sampler did; the running counters ride along.
        self._telemetry.emit(
            "trace_sample", step=0,
            trace_id=str(trace_id),
            tier=self.tier,
            sampled=int(bool(keep)),
            reason=str(reason),
            tenant=str(tenant) if tenant is not None else "",
            kept=kept,
            dropped=dropped,
            overflow=self.overflow,
            t_unix=round(float(self.clock()), 6))

    # ------------------------------------------------------------ statz

    def stats(self) -> dict:
        """Counters for ``/statz`` (the ``serve_trace_sampled`` gauge)."""
        with self._lock:
            return {
                "tier": self.tier,
                "kept": self.kept,
                "dropped": self.dropped,
                "overflow": self.overflow,
                "parked": len(self._parked),
            }
