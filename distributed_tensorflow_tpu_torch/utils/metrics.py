"""Metrics / observability (SURVEY §5) — beyond the reference's bare prints.

The reference's only observability is stdout: per-step loss/accuracy lines,
periodic validation, elapsed wall time (reference ``distributed.py:140-165``).
This module keeps that shape (the loop still prints) and adds the two things a
real framework needs on top:

- :class:`StepRateMeter` — steps/sec and examples/sec over a sliding window,
  the BASELINE.md headline metric, measured in-process;
- :class:`MetricsLogger` — structured JSONL metric records (step, wall time,
  loss, accuracy, rates) so runs are machine-comparable, the TensorBoard-
  summary role the reference's Supervisor supported but never used
  (SURVEY §5 "no summaries are defined").
"""

from __future__ import annotations

import collections
import json
import math
import os
import time
from typing import Any, IO


class StepRateMeter:
    """Sliding-window steps/sec (and optional examples/sec).

    ``update()`` once per completed step call — pass ``steps`` when one call
    advances several optimizer steps (scanned steps); ``rate()`` reads the
    window average.  Monotonic clock; the window bounds memory and makes the
    rate reflect *current* throughput, not the all-time mean (which compile
    time pollutes).
    """

    def __init__(self, window: int = 100):
        # (timestamp, cumulative step count) per update call.
        self._samples: collections.deque[tuple[float, int]] = (
            collections.deque(maxlen=window + 1))
        self.total_steps = 0

    def update(self, steps: int = 1, now: float | None = None) -> None:
        self.total_steps += steps
        self._samples.append(
            (time.perf_counter() if now is None else now, self.total_steps))

    def rate(self) -> float:
        """Steps/sec over the window; 0.0 until two updates have been seen."""
        if len(self._samples) < 2:
            return 0.0
        span = self._samples[-1][0] - self._samples[0][0]
        steps = self._samples[-1][1] - self._samples[0][1]
        return steps / span if span > 0 else 0.0

    def examples_per_sec(self, batch_size: int) -> float:
        return self.rate() * batch_size


class MetricFieldError(ValueError):
    """A metric record used a reserved/static field name — a caller bug.

    Distinct from ValueError so the telemetry bus can keep caller bugs loud
    while swallowing the unrelated ValueError a write racing
    :meth:`MetricsLogger.close` raises ("I/O operation on closed file")."""


class MetricsLogger:
    """Append-only JSONL metric stream, one record per call.

    Records carry ``wall_time`` (monotonic seconds since the logger was
    created, immune to system-clock steps) plus ``static_fields`` (e.g. the
    worker's task index — each process should write its *own* file; concurrent
    appends from separate processes can interleave mid-line) and whatever
    scalar fields the caller passes.  ``path=None`` makes it a no-op sink so
    call sites don't branch.  Values are coerced to plain Python scalars (a
    ``float()`` on a CUDA tensor device-syncs — callers on the hot path should
    pass already-fetched values, as the training loop does).
    """

    RESERVED = frozenset({"step", "wall_time"})

    def __init__(self, path: str | os.PathLike | None = None,
                 static_fields: dict[str, Any] | None = None):
        self._fh: IO[str] | None = None
        self._static = dict(static_fields or {})
        bad = self.RESERVED & self._static.keys()
        if bad:
            raise MetricFieldError(
                f"static_fields may not use reserved keys {sorted(bad)}")
        if path is not None:
            path = os.fspath(path)
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self._t0 = time.perf_counter()

    def log(self, step: int, **fields: Any) -> None:
        # Validate before the no-op early-out so MetricsLogger(None) rejects
        # exactly what a real logger would (tests catch bad call sites).
        clash = (self._static.keys() | self.RESERVED) & fields.keys()
        if clash:
            raise MetricFieldError(f"metric fields collide with static/"
                                   f"reserved keys {sorted(clash)}")
        if self._fh is None:
            return
        record = {"step": int(step),
                  "wall_time": round(time.perf_counter() - self._t0, 6)}
        record.update(self._static)
        for key, value in fields.items():
            record[key] = _scalar(value)
        self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _scalar(value: Any) -> Any:
    if isinstance(value, (str, bool)) or value is None:
        return value
    if isinstance(value, int):
        return value
    if isinstance(value, (list, tuple)):
        # Small sequences (per-peer health bits, heartbeat ages) serialize
        # element-wise so cluster records stay machine-readable.
        return [_scalar(v) for v in value]
    if isinstance(value, dict):
        # Nested aggregates (run_summary histograms) keep their structure.
        return {str(k): _scalar(v) for k, v in value.items()}
    try:
        value = float(value)
    except (TypeError, ValueError):
        return str(value)
    # json.dumps writes bare NaN/Infinity for non-finite floats — invalid
    # JSON that breaks strict JSONL consumers (summarize_run --check).
    # Null is the honest serialization of "no finite value this step".
    return value if math.isfinite(value) else None
