"""Merge per-worker telemetry streams into one Chrome trace-event JSON
(docs/observability.md, "Tracing").

Copied from ``distributed_tensorflow_tpu/tools/export_trace.py`` (standard
library only; the port's imports).

Every training process with ``--metrics_file`` writes ``kind="span"``
records (training-loop step/data-wait/compute, eval and checkpoint
pauses, prefetch produces, coordination requests — see
``utils/tracing.py``).  This tool merges one or more of those per-worker
streams into a single Chrome trace-event file that Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` loads directly:

- **one row per worker** — each worker becomes a trace *process* (pid),
  its emitting threads (main loop, prefetch producer, coordination
  background threads) become that process's trace threads;
- **clock-aligned** — spans carry epoch timestamps (``t_unix``), and each
  worker's stream carries the clock offset it measured against the
  coordination server at startup (``kind="clock_sync"``, the ``TIME``
  protocol command, NTP-style midpoint).  The exporter ADDS each worker's
  offset, so all rows share the coordination server's timeline to within
  the measured RTT;
- **correlated** — every span's ``trace_id`` (``"<run_id>/<step>"``) is
  in its args: the same training step on every worker carries the same
  id, so a straggler's long step N sits visibly beside its peers' short
  step N.

Recovery, fault-injection, and hot-swap records ride along as instant
events, so an eviction, an injected fault, or a model swap is a marker
on the timeline, not a line in a separate file.

Serving streams merge the same way (docs/observability.md, "Serving
tracing & SLOs"): a ``tools/serve.py --metrics_file`` stream carries
request-keyed spans (``trace_id="<run>/req<id>"`` — queue wait, page
reserve, prefill, per-round decode lanes, swap pauses, retire under one
``serve.request`` root), so a mixed train+serve cluster renders as ONE
clock-aligned Perfetto trace with serving rows beside training rows.

Usage::

    python -m distributed_tensorflow_tpu_torch.tools.export_trace \
        run.jsonl.task0 run.jsonl.task1 --output trace.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any

from .summarize_run import (clock_for, load_records, record_kind,
                            stream_clocks, worker_key)

#: Record kinds rendered as instant (marker) events on the worker's row.
#: The flat serving records (route/fleet/cell — streams predating the
#: cross-tier spans, or running with sampling dropping the spans) and
#: the tail sampler's keep/drop verdicts render as markers instead of
#: being silently skipped: a failover, a re-home, or a dropped trace is
#: visible on the timeline even without a span tree around it.  (The
#: PR-18 kv_replay window already rides the "recovery" kind as
#: ``action="kv_replay"``.)
INSTANT_KINDS = ("recovery", "fault_injected", "flight_header",
                 "model_swap", "route", "fleet", "cell", "trace_sample")

#: Span-record fields copied into the trace event's ``args`` (visible in
#: Perfetto's detail pane).  Serving spans (docs/observability.md,
#: "Serving tracing & SLOs") carry the request identity so one request's
#: queue/reserve/prefill/decode/retire decomposition is clickable.
SPAN_ARG_KEYS = (
    "step", "trace_id", "span_id", "parent_id", "source", "attempts",
    "barrier", "data_wait_ms", "compute_ms",
    # serving request spans
    "request_id", "tenant", "status", "queue_depth", "pages", "bucket",
    "prompt_tokens", "tokens", "tokens_out", "accepted", "drafted",
    "active_slots", "spec_rows", "queue_ms", "ttft_ms", "tpot_ms",
    "model_step", "from_model_step", "to_model_step", "in_flight",
    # routing-tier spans (route.global / route.cell / route.fleet /
    # route.attempt — docs/observability.md, "Cross-tier tracing")
    "tier", "cell", "replica", "failovers", "spilled", "rehomed",
    "load", "poll_age_ms", "ok", "error",
)


def build_trace(records: list[dict]) -> dict[str, Any]:
    """All loaded records -> the Chrome trace-event payload."""
    by_worker: dict[str, list[dict]] = {}
    for rec in records:
        by_worker.setdefault(worker_key(rec), []).append(rec)

    # One clock parse per stream (summarize_run.stream_clocks — the same
    # calibrations the report applies), reused for span alignment AND the
    # wall_time fallback of instant events below.  The newest calibration
    # supplies the worker's offset; instant events map wall_time through
    # the calibration of THEIR incarnation (clock_for) — a crash-restarted
    # stream holds one per incarnation, each with its own wall_time zero.
    clocks = {worker: stream_clocks(recs)
              for worker, recs in by_worker.items()}

    def worker_offset_ms(worker: str) -> float:
        return clocks[worker][-1]["offset_ms"] if clocks[worker] else 0.0

    events: list[dict] = []
    # Normalize to the earliest aligned span start so ts stays readable.
    t0: float | None = None
    for worker, recs in by_worker.items():
        offset_s = worker_offset_ms(worker) / 1000.0
        for rec in recs:
            if record_kind(rec) == "span" \
                    and isinstance(rec.get("t_unix"), (int, float)) \
                    and isinstance(rec.get("dur_ms"), (int, float)):
                t = rec["t_unix"] + offset_s
                t0 = t if t0 is None else min(t0, t)
    t0 = t0 or 0.0

    for pid, (worker, recs) in enumerate(sorted(by_worker.items())):
        offset_ms = worker_offset_ms(worker)
        offset_s = offset_ms / 1000.0
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"{worker} "
                                        f"(clock_offset_ms={offset_ms:+.3f})"}})
        events.append({"ph": "M", "name": "process_sort_index", "pid": pid,
                       "tid": 0, "args": {"sort_index": pid}})
        # Stable thread ids per worker: the main loop first, then the
        # background threads in name order.
        threads = sorted({str(r.get("thread", "MainThread")) for r in recs
                          if record_kind(r) == "span"},
                         key=lambda n: (n != "MainThread", n))
        tid_of = {name: tid for tid, name in enumerate(threads)}
        for name, tid in tid_of.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        for rec in recs:
            kind = record_kind(rec)
            if kind == "span":
                if not isinstance(rec.get("t_unix"), (int, float)) \
                        or not isinstance(rec.get("dur_ms"), (int, float)):
                    continue
                args = {k: v for k, v in rec.items()
                        if k in SPAN_ARG_KEYS and v is not None}
                events.append({
                    "name": str(rec.get("name", "span")),
                    "cat": "span", "ph": "X",
                    "ts": round((rec["t_unix"] + offset_s - t0) * 1e6, 1),
                    "dur": round(float(rec["dur_ms"]) * 1e3, 1),
                    "pid": pid,
                    "tid": tid_of.get(str(rec.get("thread", "MainThread")),
                                      0),
                    "args": args,
                })
            elif kind in INSTANT_KINDS:
                t_unix = rec.get("t_unix")
                if not isinstance(t_unix, (int, float)):
                    # Stream-resident recovery/fault records carry only the
                    # logger's process-relative wall_time; map it onto the
                    # epoch via THEIR incarnation's clock_sync anchor
                    # (flight-dump copies carry t_unix directly).
                    wall = rec.get("wall_time")
                    clock = clock_for(clocks[worker], rec)
                    if clock is None or not isinstance(wall, (int, float)):
                        continue
                    t_unix = clock["anchor_unix"] + wall
                label = rec.get("action") or rec.get("reason") or kind
                if kind == "model_swap":
                    label = f"swap->step{rec.get('to_model_step')}"
                elif kind == "route":
                    # Flat route records have no action/reason — show
                    # the routing outcome instead.
                    label = (f"{rec.get('tenant', '?')}->"
                             f"{rec.get('replica') or 'none'} "
                             f"({rec.get('status')})")
                elif kind == "trace_sample":
                    label = (f"{'keep' if rec.get('sampled') else 'drop'}"
                             f":{rec.get('reason')}")
                events.append({
                    "name": f"{kind}:{label}", "cat": kind,
                    "ph": "i", "s": "p",
                    "ts": round((t_unix + offset_s - t0) * 1e6, 1),
                    "pid": pid, "tid": 0,
                    "args": {k: v for k, v in rec.items()
                             if not k.startswith("_")},
                })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("files", nargs="+",
                        help="telemetry JSONL stream(s), one per worker")
    parser.add_argument("--output", "-o", required=True, metavar="PATH",
                        help="Chrome trace-event JSON destination")
    parser.add_argument("--allow-empty", action="store_true",
                        help="exit 0 even when the streams hold no spans "
                             "(default: that is an export failure)")
    args = parser.parse_args(argv)

    records: list[dict] = []
    for path in args.files:
        recs, errors = load_records(path)
        for err in errors:
            print(f"[export_trace] WARNING: {err}")
        records.extend(recs)

    trace = build_trace(records)
    span_events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    workers = {e["pid"] for e in span_events}
    with open(args.output, "w") as fh:
        json.dump(trace, fh)
    print(f"[export_trace] wrote {args.output}: {len(span_events)} spans "
          f"across {len(workers)} worker row(s) "
          f"({len(trace['traceEvents'])} events total) — load it at "
          "https://ui.perfetto.dev or chrome://tracing")
    if not span_events and not args.allow_empty:
        print("[export_trace] ERROR: no kind=\"span\" records in the "
              "input stream(s) — was the run started with --metrics_file "
              "(telemetry on)?")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
