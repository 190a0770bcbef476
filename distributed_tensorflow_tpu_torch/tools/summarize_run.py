"""Run report over per-host telemetry JSONL streams (docs/observability.md).

Copied from ``distributed_tensorflow_tpu/tools/summarize_run.py`` (standard
library only; the port's imports).

A training run with ``--metrics_file`` writes one kind-tagged JSONL stream
per process (``utils/telemetry.py``).  This tool replays one or more of
those streams and renders the run report the raw stream can't show at a
glance:

- **throughput curve** — steps/sec over the run's wall-clock, bucketed;
- **step-time breakdown** — where a step went (host data-wait vs device
  compute vs unaccounted host overhead), totals and percentiles;
- **straggler / gap detection** — wall-clock gaps between consecutive
  step records far above the median cadence (eval, checkpoint, stall?),
  cross-worker progress spread, and the ``cluster_health`` records' view
  (dead peers, heartbeat ages, straggler gap);
- **MFU / HBM summary** — live utilization against the chip peak and the
  memory high-watermark;
- **clock alignment** — cross-worker time comparisons apply each stream's
  recorded coordination-server clock offset (``kind="clock_sync"``, the
  ``TIME`` protocol command) and the per-worker offset is surfaced in the
  report;
- **flight recorder ingestion** — a ``<stream>.flight`` crash dump next
  to an input stream (or passed explicitly) is folded into that worker's
  recovery section: why it died and the last step it reached;
- **exchange traffic** — the async parameter-exchange records
  (``kind="param_exchange"``, docs/param_exchange.md) rolled into a
  per-worker section: periods, bytes-on-wire vs the full-state
  equivalent, compression ratio, quantization-residual health.

``--json`` additionally writes a machine-readable summary in the
``BENCH_*.json`` artifact shape (``{metric, value, unit, vs_baseline,
extra}``), so run reports and bench artifacts feed the same tooling.
``--check`` validates the stream instead (strict JSON, required fields on
every train_step record) and exits non-zero on violations — the CI smoke
gate (ci.sh).

Usage::

    python -m distributed_tensorflow_tpu_torch.tools.summarize_run run.jsonl \
        [more.jsonl ...] [--json summary.json] [--check] [--gap-factor 5]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any

#: Fields every ``train_step`` record must carry for the report to be
#: complete (``--check`` enforces presence; ``mfu`` may be null — unknown
#: chip peak — but the key must be there).
REQUIRED_STEP_FIELDS = (
    "step", "wall_time", "loss", "steps_per_sec",
    "data_wait_ms", "compute_ms", "mfu",
    "hbm_bytes_in_use", "hbm_peak_bytes",
)

#: Fields every serving-tier ``serve_step`` record must carry
#: (docs/serving.md); a serving stream satisfies ``--check`` through
#: these instead of the train_step contract.
REQUIRED_SERVE_STEP_FIELDS = (
    "step", "wall_time", "active_slots", "admitted", "retired",
    "queue_depth", "kv_pages_in_use", "kv_pages_total", "step_ms",
)

#: Fields every serving-SLO evaluation record (``kind="slo"``,
#: serving/slo.py) must carry — the ``--check`` contract of the SLO
#: section (docs/observability.md, "Serving tracing & SLOs").
REQUIRED_SLO_FIELDS = (
    "tenant", "objective", "burn_short", "burn_long", "burning",
    "good_short", "bad_short", "good_long", "bad_long",
    "window_short_s", "window_long_s",
)

#: Fields every fleet-router routing record (``kind="route"``,
#: serving/router.py — one per caller request) must carry; a router
#: stream satisfies ``--check`` through these (docs/serving.md, "Fleet").
REQUIRED_ROUTE_FIELDS = (
    "tenant", "replica", "failovers", "spilled", "route_ms", "ok",
    "status",
)

#: Fields every fleet membership/autoscale record (``kind="fleet"``,
#: serving/router.py) must carry.
REQUIRED_FLEET_FIELDS = (
    "replicas", "healthy", "queue_depth", "active_slots", "action",
)

#: Fields every HIERARCHICAL ``param_exchange`` record (``hierarchical``
#: truthy — cluster/param_sync.HierarchicalCompressedAverager) must carry
#: on top of the common exchange fields: the slice placement, the
#: inter-/intra-host byte split, and the per-stage latency decomposition
#: (docs/param_exchange.md, "Hierarchical exchange").  Flat exchange
#: records are exempt — they have no slice to report.
REQUIRED_HIER_EXCHANGE_FIELDS = (
    "slice", "n_slices", "exporter", "inter_bytes", "intra_bytes",
    "stages",
)

#: Fields every parallelism-tuner trial record (``kind="autotune_trial"``,
#: tools/autotune.py) must carry — the tuner's search is only auditable
#: when every trial names its layout, its compile-vs-steady-state split,
#: and its verdict (docs/autotune.md).  ``compile_ms``/``step_ms``/``mfu``
#: may be null on crashed/timed-out trials, but the keys must be there.
REQUIRED_AUTOTUNE_FIELDS = (
    "config", "compile_ms", "step_ms", "mfu", "verdict",
)

#: Fields every cell-tier record (``kind="cell"``, serving/cells.py —
#: global-router membership, tenant re-home, cell death, failover gap)
#: must carry; a global-router stream satisfies ``--check`` through
#: these (docs/serving.md, "Cells").
REQUIRED_CELL_FIELDS = (
    "action", "cell", "tenant", "gap_ms", "cells", "healthy_cells",
)

#: Fields every load-generator scenario report (``kind="loadgen"``,
#: tools/loadgen.py) must carry — the drill's verdict record.
REQUIRED_LOADGEN_FIELDS = (
    "scenario", "requests", "ok", "rejected", "failed", "duration_s",
)

#: Fields every per-request load-generator verdict
#: (``kind="loadgen_request"``, tools/loadgen.py) must carry — the
#: client-perceived half of a cross-tier trace, keyed by the SAME
#: ``trace_id`` the request carried on the wire
#: (docs/observability.md, "Cross-tier tracing & tail sampling").
REQUIRED_LOADGEN_REQUEST_FIELDS = (
    "scenario", "tenant", "trace_id", "verdict", "e2e_ms",
)

#: Fields every tail-sampling verdict record (``kind="trace_sample"``,
#: serving/trace_buffer.py — the ``serve_trace_sampled`` gauge stream)
#: must carry: which trace, which tier decided, keep or drop, why, and
#: the running kept/dropped counters that prove the sampler worked.
REQUIRED_TRACE_SAMPLE_FIELDS = (
    "trace_id", "tier", "sampled", "reason", "kept", "dropped",
)

#: Server-side ROOT span names a trace's client-vs-server comparison
#: keys on, in preference order (the engine's serve.request is the
#: deepest server view; the routing roots are fallbacks when the engine
#: stream is absent).  dtflint's span-name-unknown rule proves every
#: name here has an ``emit_span`` producer.
TRACE_ROOT_SPAN_NAMES = ("serve.request", "route.fleet", "route.global")

#: The cross-tier routing span taxonomy (docs/observability.md,
#: "Cross-tier tracing & tail sampling"): global-router root, per-cell
#: attempt, fleet-router root, per-replica attempt.  Same dtflint
#: producer guarantee as above.
ROUTING_SPAN_NAMES = ("route.global", "route.cell", "route.fleet",
                      "route.attempt")

#: Fields every ``kind="recovery"`` ``action="kv_shard_failover"`` record
#: (cluster/coordination.py) must carry — the KV-shard HA drill's
#: ``--check`` contract: which shard, how long the worker-visible stall
#: was, and which generation's promoted standby ended it
#: (docs/fault_tolerance.md, "KV-shard HA").
REQUIRED_KV_FAILOVER_FIELDS = (
    "shard", "gap_s", "generation", "endpoint",
)


# ------------------------------------------------------------- loading


def _reject_constant(name: str):
    # json.loads accepts bare NaN/Infinity by default; a *strict* JSONL
    # consumer (the whole point of --check) must flag them — they are not
    # JSON and break jq/pandas/anything else downstream.
    raise ValueError(f"non-standard JSON constant {name}")


def load_records(path: str) -> tuple[list[dict], list[str]]:
    """Parse one JSONL file -> (records, per-line error strings)."""
    records: list[dict] = []
    errors: list[str] = []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line, parse_constant=_reject_constant)
            except json.JSONDecodeError as e:
                errors.append(f"{path}:{lineno}: malformed JSON ({e.msg})")
                continue
            except ValueError as e:
                errors.append(f"{path}:{lineno}: malformed JSON ({e})")
                continue
            if not isinstance(rec, dict):
                errors.append(f"{path}:{lineno}: record is not an object")
                continue
            rec["_source"] = path
            # File position: clock calibrations are scoped to the records
            # that FOLLOW them (a restarted process appends a new
            # clock_sync with a reset wall_time clock — see clock_for).
            rec["_idx"] = lineno
            records.append(rec)
    return records, errors


def record_kind(rec: dict) -> str:
    """Kind of a record, inferring legacy (pre-telemetry) layouts."""
    kind = rec.get("kind")
    if kind:
        return kind
    if "validation_accuracy" in rec:
        return "eval"
    if "loss" in rec:
        return "train_step"
    return "other"


def worker_key(rec: dict) -> str:
    w = rec.get("worker")
    if w is not None:
        return f"worker{w}"
    base = os.path.basename(rec.get("_source", "?"))
    # A flight dump without a worker static field (serving streams) must
    # group under its PARENT stream, not as a phantom extra worker.
    if base.endswith(".flight"):
        base = base[:-len(".flight")]
    return base


def group_by_worker(records: list[dict]) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for rec in records:
        out.setdefault(worker_key(rec), []).append(rec)
    for recs in out.values():
        recs.sort(key=lambda r: (r.get("wall_time", 0.0)))
    return out


# ------------------------------------------------------------ analysis


def _quantile(values: list[float], q: float) -> float:
    """Nearest-rank quantile over a small in-memory list (the report reads
    back bounded record counts; the constant-memory estimator lives on the
    writer side in utils/telemetry.py)."""
    if not values:
        return math.nan
    s = sorted(values)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


def throughput_curve(steps: list[dict], buckets: int = 10
                     ) -> list[dict[str, float]]:
    """Bucket steps/sec over wall-time: [{t_s, steps_per_sec}]."""
    pts = [(r["wall_time"], r.get("steps_per_sec"))
           for r in steps
           if isinstance(r.get("steps_per_sec"), (int, float))
           and isinstance(r.get("wall_time"), (int, float))]
    if not pts:
        return []
    t0, t1 = min(p[0] for p in pts), max(p[0] for p in pts)
    span = max(t1 - t0, 1e-9)
    acc: list[list[float]] = [[] for _ in range(buckets)]
    for t, rate in pts:
        idx = min(int((t - t0) / span * buckets), buckets - 1)
        acc[idx].append(rate)
    return [{"t_s": round(t0 + (i + 0.5) * span / buckets, 3),
             "steps_per_sec": round(sum(a) / len(a), 3)}
            for i, a in enumerate(acc) if a]


def step_breakdown(steps: list[dict]) -> dict[str, Any] | None:
    """Aggregate the per-record timing fields into a breakdown summary."""
    waits = [r["data_wait_ms"] for r in steps
             if isinstance(r.get("data_wait_ms"), (int, float))]
    computes = [r["compute_ms"] for r in steps
                if isinstance(r.get("compute_ms"), (int, float))]
    if not waits and not computes:
        return None
    total_wait, total_compute = sum(waits), sum(computes)
    total = total_wait + total_compute
    out = {
        "records": len(steps),
        "data_wait_ms_total": round(total_wait, 1),
        "compute_ms_total": round(total_compute, 1),
        "data_wait_pct": round(100 * total_wait / total, 1) if total else None,
        "compute_pct": round(100 * total_compute / total, 1) if total else None,
    }
    for name, vals in (("data_wait_ms", waits), ("compute_ms", computes)):
        if vals:
            out[name] = {
                "mean": round(sum(vals) / len(vals), 3),
                "p50": round(_quantile(vals, 0.50), 3),
                "p95": round(_quantile(vals, 0.95), 3),
                "p99": round(_quantile(vals, 0.99), 3),
                "max": round(max(vals), 3),
            }
    return out


def detect_gaps(steps: list[dict], factor: float = 5.0,
                min_gap_s: float = 0.05) -> list[dict[str, float]]:
    """Wall-clock gaps between consecutive step records >> the median
    cadence: eval/checkpoint pauses, stalls, preemptions."""
    times = [(r.get("wall_time"), r.get("step")) for r in steps
             if isinstance(r.get("wall_time"), (int, float))]
    if len(times) < 3:
        return []
    deltas = [(times[i + 1][0] - times[i][0], times[i][1], times[i + 1][1])
              for i in range(len(times) - 1)]
    med = _quantile([d for d, *_ in deltas], 0.5)
    threshold = max(factor * med, min_gap_s)
    return [{"after_step": a, "before_step": b, "gap_s": round(d, 3),
             "vs_median": round(d / med, 1) if med > 0 else None}
            for d, a, b in deltas if d > threshold]


def mfu_summary(steps: list[dict]) -> dict[str, Any] | None:
    mfus = [r["mfu"] for r in steps
            if isinstance(r.get("mfu"), (int, float))]
    flops = [r["model_flops_per_sec"] for r in steps
             if isinstance(r.get("model_flops_per_sec"), (int, float))]
    if not mfus and not flops:
        return None
    out: dict[str, Any] = {}
    if mfus:
        out.update(mean_pct=round(100 * sum(mfus) / len(mfus), 2),
                   last_pct=round(100 * mfus[-1], 2),
                   max_pct=round(100 * max(mfus), 2))
    if flops:
        out["model_tflops_per_sec_last"] = round(flops[-1] / 1e12, 3)
    return out


def hbm_summary(steps: list[dict]) -> dict[str, Any] | None:
    peaks = [r["hbm_peak_bytes"] for r in steps
             if isinstance(r.get("hbm_peak_bytes"), (int, float))]
    limits = [r.get("hbm_bytes_limit") for r in steps
              if isinstance(r.get("hbm_bytes_limit"), (int, float))]
    if not peaks:
        return None
    peak, limit = max(peaks), max(limits, default=0)
    out = {"peak_bytes": int(peak), "peak_gib": round(peak / 2**30, 3)}
    if limit:
        out["limit_bytes"] = int(limit)
        out["peak_pct_of_limit"] = round(100 * peak / limit, 1)
    return out


def cluster_health_summary(health: list[dict]) -> dict[str, Any] | None:
    if not health:
        return None
    reachable = [r for r in health if r.get("coordinator_reachable")]
    out: dict[str, Any] = {
        "snapshots": len(health),
        "unreachable_snapshots": len(health) - len(reachable),
    }
    if reachable:
        out["min_alive"] = min(r.get("alive_count", 0) for r in reachable)
        out["max_dead"] = max(r.get("dead_count", 0) for r in reachable)
        ages = [r.get("max_heartbeat_age_s") for r in reachable
                if isinstance(r.get("max_heartbeat_age_s"), (int, float))]
        if ages:
            out["max_heartbeat_age_s"] = max(ages)
        gaps = [r.get("straggler_gap_steps") for r in reachable
                if isinstance(r.get("straggler_gap_steps"), (int, float))]
        if gaps:
            out["max_straggler_gap_steps"] = max(gaps)
    return out


def recovery_summary(records: list[dict]) -> dict[str, Any] | None:
    """Aggregate the fault-tolerance records (docs/fault_tolerance.md):
    ``kind="recovery"`` events (request retries, checkpoint fallbacks,
    rejoins, peer evictions) counted by action, plus any
    ``kind="fault_injected"`` records a chaos run tagged."""
    recoveries = [r for r in records if record_kind(r) == "recovery"]
    injected = [r for r in records if record_kind(r) == "fault_injected"]
    if not recoveries and not injected:
        return None
    by_action: dict[str, int] = {}
    for rec in recoveries:
        action = str(rec.get("action", "?"))
        by_action[action] = by_action.get(action, 0) + 1
    out: dict[str, Any] = {"events": len(recoveries),
                           "by_action": by_action}
    if injected:
        out["faults_injected"] = len(injected)
    # Coordinator failovers (docs/fault_tolerance.md, "Coordinator HA"):
    # each record carries the worker-visible stall across a control-shard
    # promotion (the acceptance budget: <= 2x the leadership lease), so
    # the report names both that a failover happened and what it cost.
    failovers = [r for r in recoveries
                 if str(r.get("action")) == "coord_failover"]
    if failovers:
        gaps = [float(r["gap_s"]) for r in failovers
                if isinstance(r.get("gap_s"), (int, float))]
        gens = [int(r["generation"]) for r in failovers
                if isinstance(r.get("generation"), (int, float))]
        out["coord_failover"] = {
            "count": len(failovers),
            "max_gap_s": max(gaps) if gaps else None,
            "last_generation": max(gens) if gens else None,
        }
    # KV-shard failovers (docs/fault_tolerance.md, "KV-shard HA"): the
    # per-data-shard counterpart — each record names the shard whose
    # promoted standby ended the stall, so the rollup carries WHICH
    # shards failed over as well as the worst worker-visible gap.
    kv_failovers = [r for r in recoveries
                    if str(r.get("action")) == "kv_shard_failover"]
    if kv_failovers:
        gaps = [float(r["gap_s"]) for r in kv_failovers
                if isinstance(r.get("gap_s"), (int, float))]
        gens = [int(r["generation"]) for r in kv_failovers
                if isinstance(r.get("generation"), (int, float))]
        shards = sorted({int(r["shard"]) for r in kv_failovers
                         if isinstance(r.get("shard"), (int, float))})
        out["kv_shard_failover"] = {
            "count": len(kv_failovers),
            "max_gap_s": max(gaps) if gaps else None,
            "last_generation": max(gens) if gens else None,
            "shards": shards,
        }
    # Elastic-membership resizes (docs/fault_tolerance.md, "Elastic
    # membership"): every epoch change the run observed, rolled up so the
    # report names how far the replica set shrank and where it ended.
    elastic = [r for r in recoveries
               if str(r.get("action", "")).startswith("elastic_")]
    if elastic:
        epochs = [int(r["epoch"]) for r in elastic
                  if isinstance(r.get("epoch"), (int, float))]
        counts = [int(r["active_count"]) for r in elastic
                  if isinstance(r.get("active_count"), (int, float))]
        # A resize is a watcher-observed epoch transition; the controller's
        # own elastic_leave/evicted/rejoin/reshard records narrate the same
        # cycle and must not inflate the count.
        resizes = sum(by_action.get(a, 0) for a in
                      ("elastic_shrink", "elastic_grow", "elastic_reshape"))
        out["elastic"] = {
            "resizes": resizes,
            "shrinks": by_action.get("elastic_shrink", 0),
            "grows": by_action.get("elastic_grow", 0),
            "last_epoch": max(epochs) if epochs else None,
            "min_active": min(counts) if counts else None,
            "final_active": counts[-1] if counts else None,
        }
    return out


def exchange_summary(records: list[dict]) -> dict[str, Any] | None:
    """Aggregate the async parameter-exchange records
    (``kind="param_exchange"``, docs/param_exchange.md): bytes-on-wire,
    compression ratio, consensus rounds, residual-norm health — the
    per-worker view that makes a misconfigured (uncompressed) worker
    stand out in the report."""
    exchanges = [r for r in records if record_kind(r) == "param_exchange"]
    if not exchanges:
        return None
    wire = [r.get("bytes_on_wire") for r in exchanges
            if isinstance(r.get("bytes_on_wire"), (int, float))]
    full = [r.get("full_state_bytes") for r in exchanges
            if isinstance(r.get("full_state_bytes"), (int, float))]
    ratios = [r.get("ratio") for r in exchanges
              if isinstance(r.get("ratio"), (int, float))]
    residuals = [r.get("residual_rms") for r in exchanges
                 if isinstance(r.get("residual_rms"), (int, float))]
    rounds = [r.get("round") for r in exchanges
              if isinstance(r.get("round"), (int, float))]
    compressed = [r for r in exchanges if r.get("compressed")]
    out: dict[str, Any] = {
        "exchanges": len(exchanges),
        "compressed": len(compressed),
        "fallback": len(exchanges) - len(compressed),
        "bytes_on_wire_total": int(sum(wire)) if wire else 0,
    }
    if full:
        out["full_state_bytes_total"] = int(sum(full))
        if sum(wire):
            out["wire_vs_full_state_pct"] = round(
                100.0 * sum(wire) / sum(full), 1)
    if ratios:
        out["ratio_mean"] = round(sum(ratios) / len(ratios), 2)
        out["ratio_last"] = round(ratios[-1], 2)
    if rounds:
        out["last_round"] = int(max(rounds))
    if residuals:
        out["residual_rms_last"] = residuals[-1]
    # Hierarchical exchange (docs/param_exchange.md, "Hierarchical
    # exchange"): slice placement, the inter-/intra-host byte split, and
    # the last per-stage latency decomposition.  A worker whose
    # compressed records stopped carrying ``hierarchical`` while its
    # peers' still do has silently fallen back to the flat exchange —
    # the ``flat_fallbacks`` count makes that visible in the report.
    hier = [r for r in compressed if r.get("hierarchical")]
    if hier:
        out["hierarchical"] = len(hier)
        out["flat_fallbacks"] = len(compressed) - len(hier)
        last = hier[-1]
        if last.get("slice") is not None:
            out["slice"] = last["slice"]
        if last.get("n_slices") is not None:
            out["n_slices"] = last["n_slices"]
        out["exporter"] = bool(last.get("exporter"))
        inter = [r.get("inter_bytes") for r in hier
                 if isinstance(r.get("inter_bytes"), (int, float))]
        intra = [r.get("intra_bytes") for r in hier
                 if isinstance(r.get("intra_bytes"), (int, float))]
        if inter:
            out["inter_bytes_total"] = int(sum(inter))
        if intra:
            out["intra_bytes_total"] = int(sum(intra))
        if isinstance(last.get("stages"), dict):
            out["stages_last"] = last["stages"]
    return out


def meta_summary(records: list[dict]) -> dict[str, Any] | None:
    """The stream's identity, from its ``kind="run_meta"`` record(s):
    role, model, schema version, and the launch-time knobs the producer
    stamped.  The LAST record wins (a restarted process appends a fresh
    one) — without this the report can't say what produced the stream."""
    metas = [r for r in records if record_kind(r) == "run_meta"]
    if not metas:
        return None
    latest = max(metas, key=lambda r: r.get("_idx", 0))
    out = {k: v for k, v in latest.items()
           if not k.startswith("_") and k not in ("kind", "wall_time")
           and v not in (None, "")}
    out.pop("step", None)
    return out or None


def fatal_summary(records: list[dict]) -> dict[str, Any] | None:
    """Fatal-loop records (``kind="serve_fatal"``, serving/server.py):
    the serving engine loop died and dumped its flight ring.  Surfacing
    it here means a crashed server's post-mortem does not depend on
    anyone noticing the ``.flight`` file."""
    fatals = [r for r in records if record_kind(r) == "serve_fatal"]
    if not fatals:
        return None
    last = max(fatals, key=lambda r: r.get("_idx", 0))
    return {"count": len(fatals),
            "step": last.get("step"),
            "error": last.get("error")}


def serving_summary(records: list[dict]) -> dict[str, Any] | None:
    """Roll the serving tier's records (docs/serving.md) into a report
    section: engine occupancy, continuous-batching evidence, per-tenant
    QPS + TTFT/TPOT percentiles, hot swaps.

    ``overlap_admissions`` counts admissions that joined WHILE another
    sequence was already mid-decode (``admitted > 0`` on a step whose
    active set exceeds the fresh admissions) — the continuous-batching
    acceptance signal, measurable straight from step-level telemetry."""
    steps = [r for r in records if record_kind(r) == "serve_step"]
    reqs = [r for r in records if record_kind(r) == "serve_request"]
    swaps = [r for r in records if record_kind(r) == "model_swap"]
    slos = [r for r in records if record_kind(r) == "slo"]
    tenant_recs = [r for r in records if record_kind(r) == "serve_tenant"]
    if not steps and not reqs:
        return None
    out: dict[str, Any] = {"engine_steps": len(steps),
                           "requests": len(reqs)}
    if steps:
        def vals(key):
            return [r[key] for r in steps
                    if isinstance(r.get(key), (int, float))]
        active = vals("active_slots")
        if active:
            out["peak_active_slots"] = int(max(active))
        pages = vals("kv_pages_in_use")
        if pages:
            out["kv_pages_peak"] = int(max(pages))
            totals = vals("kv_pages_total")
            if totals:
                out["kv_pages_total"] = int(max(totals))
        out["admitted_total"] = int(sum(vals("admitted")))
        out["retired_total"] = int(sum(vals("retired")))
        out["overlap_admissions"] = int(sum(
            r["admitted"] for r in steps
            if isinstance(r.get("admitted"), (int, float))
            and isinstance(r.get("active_slots"), (int, float))
            and r["admitted"] > 0
            and r["active_slots"] > r["admitted"]))
        step_ms = vals("step_ms")
        if step_ms:
            out["step_ms"] = {
                "p50": round(_quantile(step_ms, 0.50), 3),
                "p95": round(_quantile(step_ms, 0.95), 3),
                "max": round(max(step_ms), 3),
            }
        # Speculative arm rollup (docs/speculative.md): spec_rows counts
        # lane-rounds served through the chunk verify, spec_accepted the
        # tokens they banked — accepted/round > 1 is the speedup proof.
        row_rounds = int(sum(vals("spec_rows")))
        if row_rounds:
            accepted = int(sum(vals("spec_accepted")))
            out["speculation"] = {
                "row_rounds": row_rounds,
                "accepted_tokens": accepted,
                "accepted_per_round": round(accepted / row_rounds, 2),
            }
    tenants: dict[str, Any] = {}
    if reqs:
        times = [r["wall_time"] for r in reqs
                 if isinstance(r.get("wall_time"), (int, float))]
        span = (max(times) - min(times)) if len(times) > 1 else 0.0
        if span > 0:
            out["qps"] = round(len(reqs) / span, 3)
        for tenant in sorted({str(r.get("tenant", "?")) for r in reqs}):
            mine = [r for r in reqs if str(r.get("tenant", "?")) == tenant]
            entry: dict[str, Any] = {
                "requests": len(mine),
                "tokens_out": int(sum(
                    r.get("tokens_out", 0) or 0 for r in mine)),
            }
            for key, label in (("ttft_ms", "ttft_ms"),
                               ("tpot_ms", "tpot_ms"),
                               ("e2e_ms", "e2e_ms")):
                latencies = [r[key] for r in mine
                             if isinstance(r.get(key), (int, float))]
                if latencies:
                    entry[label] = {
                        "p50": round(_quantile(latencies, 0.50), 3),
                        "p95": round(_quantile(latencies, 0.95), 3),
                        "p99": round(_quantile(latencies, 0.99), 3),
                        "max": round(max(latencies), 3),
                    }
            bad = [r for r in mine if r.get("status") not in ("ok", None)]
            if bad:
                entry["not_ok"] = len(bad)
            tenants[tenant] = entry
    # Per-tenant counter gauges (kind="serve_tenant", emitted on the SLO
    # cadence): the LAST record per tenant carries the final
    # rejected-429 / abandoned-caller / queue-HWM tallies.  Deliberately
    # OUTSIDE the reqs branch — a server that died before any request
    # retired leaves serve_tenant records and no serve_request records,
    # and the crash post-mortem is exactly when these counters matter.
    for rec in sorted(tenant_recs, key=lambda r: r.get("_idx", 0)):
        name = str(rec.get("tenant", "?"))
        entry = tenants.setdefault(name, {"requests": 0, "tokens_out": 0})
        for key in ("rejected", "abandoned", "queued_hwm"):
            if isinstance(rec.get(key), (int, float)):
                entry[key] = int(rec[key])
    if tenants:
        out["tenants"] = tenants
    if swaps:
        out["model_swaps"] = len(swaps)
        in_flight = [r.get("in_flight") for r in swaps
                     if isinstance(r.get("in_flight"), (int, float))]
        if in_flight:
            out["max_in_flight_at_swap"] = int(max(in_flight))
        last = swaps[-1].get("to_model_step")
        if isinstance(last, (int, float)):
            out["final_model_step"] = int(last)
    if slos:
        # SLO evaluations (kind="slo", serving/slo.py): the LAST record
        # per (tenant, objective) is the end-of-run state; an objective
        # that burned at ANY evaluation is named — a breach mid-run must
        # not vanish because the run ended quiet.
        last_by_obj: dict[tuple, dict] = {}
        ever_burning: set[str] = set()
        for rec in sorted(slos, key=lambda r: r.get("_idx", 0)):
            key = (str(rec.get("tenant")), str(rec.get("objective")))
            last_by_obj[key] = rec
            if rec.get("burning"):
                ever_burning.add(f"{key[0]}:{key[1]}")
        out["slo"] = {
            "evaluations": len(slos),
            "objectives": [
                {"tenant": t, "objective": o,
                 "burn_short": rec.get("burn_short"),
                 "burn_long": rec.get("burn_long"),
                 "burning": bool(rec.get("burning")),
                 "bad_long": rec.get("bad_long"),
                 "good_long": rec.get("good_long")}
                for (t, o), rec in sorted(last_by_obj.items())],
            "burning": sorted(f"{t}:{o}"
                              for (t, o), rec in last_by_obj.items()
                              if rec.get("burning")),
            "ever_burning": sorted(ever_burning),
        }
    return out


def fleet_summary(records: list[dict]) -> dict[str, Any] | None:
    """Roll a fleet router's records (docs/serving.md, "Fleet") into a
    report section: per-replica serving credit, failover evidence
    (count + worst rescued-request latency), spills, membership events,
    and the autoscale trajectory.

    The drain invariant is visible here: ``served_by`` credits only the
    replica that actually answered, so a replica SIGKILLed mid-run
    shows its books frozen while the survivors' counts absorb the
    re-routed load."""
    routes = [r for r in records if record_kind(r) == "route"]
    fleets = [r for r in records if record_kind(r) == "fleet"]
    if not routes and not fleets:
        return None
    out: dict[str, Any] = {"routed": len(routes),
                           "fleet_records": len(fleets)}
    if routes:
        ok = [r for r in routes if r.get("ok")]
        out["ok"] = len(ok)
        out["failed"] = len(routes) - len(ok)
        out["failovers_total"] = int(sum(
            r.get("failovers", 0) or 0 for r in routes))
        out["spills"] = sum(1 for r in routes if r.get("spilled"))
        rescued = [r["route_ms"] for r in routes
                   if (r.get("failovers") or 0) > 0
                   and isinstance(r.get("route_ms"), (int, float))]
        if rescued:
            out["failover_route_ms_max"] = round(max(rescued), 3)
        lat = [r["route_ms"] for r in ok
               if isinstance(r.get("route_ms"), (int, float))]
        if lat:
            out["route_ms"] = {
                "p50": round(_quantile(lat, 0.50), 3),
                "p99": round(_quantile(lat, 0.99), 3),
                "max": round(max(lat), 3),
            }
        served_by: dict[str, int] = {}
        for r in ok:
            rid = str(r.get("replica") or "?")
            served_by[rid] = served_by.get(rid, 0) + 1
        out["served_by"] = dict(sorted(served_by.items()))
        tenants: dict[str, int] = {}
        for r in routes:
            t = str(r.get("tenant") or "?")
            tenants[t] = tenants.get(t, 0) + 1
        out["routed_by_tenant"] = dict(sorted(tenants.items()))
    if fleets:
        counts = [r.get("replicas") for r in fleets
                  if isinstance(r.get("replicas"), (int, float))]
        healthy = [r.get("healthy") for r in fleets
                   if isinstance(r.get("healthy"), (int, float))]
        if counts:
            out["replicas_peak"] = int(max(counts))
            out["replicas_final"] = int(counts[-1])
        if healthy:
            out["healthy_min"] = int(min(healthy))
        actions: dict[str, int] = {}
        for r in fleets:
            action = str(r.get("action") or "")
            if action and action != "poll":
                actions[action] = actions.get(action, 0) + 1
        if actions:
            out["actions"] = dict(sorted(actions.items()))
    return out


def cell_summary(records: list[dict]) -> dict[str, Any] | None:
    """Roll the cell tier's records (docs/serving.md, "Cells") into a
    report section: membership/failover events by action, tenant
    re-homes, the recorded failover gaps (the drill's headline number),
    and any loadgen scenario verdicts riding the same stream."""
    cells = [r for r in records if record_kind(r) == "cell"]
    loadgens = [r for r in records if record_kind(r) == "loadgen"]
    if not cells and not loadgens:
        return None
    out: dict[str, Any] = {"cell_records": len(cells)}
    if cells:
        actions: dict[str, int] = {}
        for r in cells:
            action = str(r.get("action") or "")
            if action and action != "poll":
                actions[action] = actions.get(action, 0) + 1
        if actions:
            out["actions"] = dict(sorted(actions.items()))
        out["cell_deaths"] = actions.get("cell_dead", 0)
        out["rehomes"] = actions.get("tenant_rehome", 0)
        out["returns"] = actions.get("tenant_return", 0)
        out["throttle_rejects"] = actions.get("throttle_reject", 0)
        rehomed = sorted({
            str(r.get("tenant")) for r in cells
            if r.get("action") == "tenant_rehome" and r.get("tenant")})
        if rehomed:
            out["rehomed_tenants"] = rehomed
        gaps = [r["gap_ms"] for r in cells
                if r.get("action") == "failover_gap"
                and isinstance(r.get("gap_ms"), (int, float))]
        if gaps:
            out["failover_gaps"] = len(gaps)
            out["failover_gap_ms_max"] = round(max(gaps), 3)
        counts = [r.get("cells") for r in cells
                  if isinstance(r.get("cells"), (int, float))]
        healthy = [r.get("healthy_cells") for r in cells
                   if isinstance(r.get("healthy_cells"), (int, float))]
        if counts:
            out["cells_final"] = int(counts[-1])
        if healthy:
            out["healthy_min"] = int(min(healthy))
    if loadgens:
        out["loadgen"] = [
            {"scenario": r.get("scenario"),
             "requests": r.get("requests"), "ok": r.get("ok"),
             "rejected": r.get("rejected"), "failed": r.get("failed"),
             "duration_s": r.get("duration_s"),
             "ever_burning": r.get("ever_burning")}
            for r in loadgens]
    return out


def trace_summary(records: list[dict]) -> dict[str, Any] | None:
    """Cross-tier tracing roll-up (docs/observability.md, "Cross-tier
    tracing & tail sampling"): lay the CLIENT-perceived latency of each
    request (``kind="loadgen_request"``, keyed by the wire trace id)
    beside the SERVER-side root span of the same trace, and count the
    tail sampler's keep/drop verdicts (``kind="trace_sample"``) per
    tier.  The overhead column — client e2e minus server-side duration
    — is the network + routing + queueing the server never sees."""
    reqs = [r for r in records if record_kind(r) == "loadgen_request"]
    samples = [r for r in records if record_kind(r) == "trace_sample"]
    if not reqs and not samples:
        return None
    out: dict[str, Any] = {}
    if reqs:
        verdicts: dict[str, int] = {}
        for r in reqs:
            v = str(r.get("verdict") or "?")
            verdicts[v] = verdicts.get(v, 0) + 1
        out["loadgen_requests"] = len(reqs)
        out["verdicts"] = dict(sorted(verdicts.items()))
        # Server-side duration per trace: prefer the engine's
        # serve.request root (the deepest server-side view), fall back
        # to the outermost routing root when the engine stream is not
        # among the inputs or the sampler dropped its spans.
        server: dict[str, float] = {}
        for name in TRACE_ROOT_SPAN_NAMES:
            for r in records:
                if record_kind(r) != "span" or r.get("name") != name:
                    continue
                tid, dur = r.get("trace_id"), r.get("dur_ms")
                if isinstance(tid, str) and tid not in server \
                        and isinstance(dur, (int, float)):
                    server[tid] = float(dur)
        pairs = [(str(r["trace_id"]), float(r["e2e_ms"]),
                  server[str(r["trace_id"])])
                 for r in reqs
                 if isinstance(r.get("e2e_ms"), (int, float))
                 and str(r.get("trace_id")) in server]
        if pairs:
            client_ms = sorted(c for _, c, _ in pairs)
            server_ms = sorted(s for _, _, s in pairs)
            overhead = sorted(c - s for _, c, s in pairs)
            worst = max(pairs, key=lambda p: p[1] - p[2])
            out["matched_traces"] = len(pairs)
            out["client_e2e_p50_ms"] = round(
                client_ms[len(client_ms) // 2], 3)
            out["server_e2e_p50_ms"] = round(
                server_ms[len(server_ms) // 2], 3)
            out["overhead_p50_ms"] = round(
                overhead[len(overhead) // 2], 3)
            out["overhead_max_ms"] = round(overhead[-1], 3)
            out["overhead_worst_trace"] = worst[0]
    counts: dict[str, int] = {}
    for r in records:
        if record_kind(r) == "span" and r.get("name") in ROUTING_SPAN_NAMES:
            counts[str(r.get("name"))] = counts.get(str(r.get("name")), 0) + 1
    if counts:
        out["routing_spans"] = {n: counts[n] for n in ROUTING_SPAN_NAMES
                                if n in counts}
    if samples:
        by_tier: dict[str, dict[str, int]] = {}
        reasons: dict[str, int] = {}
        for r in samples:
            tier = by_tier.setdefault(str(r.get("tier") or "?"),
                                      {"kept": 0, "dropped": 0})
            tier["kept" if r.get("sampled") else "dropped"] += 1
            reason = str(r.get("reason") or "?")
            reasons[reason] = reasons.get(reason, 0) + 1
        out["sampling_by_tier"] = dict(sorted(by_tier.items()))
        out["sampling_reasons"] = dict(sorted(reasons.items()))
    return out


def autotune_summary(records: list[dict]) -> dict[str, Any] | None:
    """Roll the parallelism tuner's trial stream (``kind="autotune_trial"``,
    tools/autotune.py) into the report: verdict counts, the measured
    winner, and — when the naive default layout was among the trials —
    the speedup the search bought."""
    trials = [r for r in records if record_kind(r) == "autotune_trial"]
    if not trials:
        return None
    ok = [r for r in trials
          if r.get("verdict") == "ok"
          and isinstance(r.get("step_ms"), (int, float))]
    out: dict[str, Any] = {
        "trials": len(trials),
        "ok": len(ok),
        "crashed": sum(1 for r in trials if r.get("verdict") == "crash"),
        "timed_out": sum(1 for r in trials
                         if r.get("verdict") == "timeout"),
        "phases": sorted({r.get("phase", "train") for r in trials}),
    }
    # Train and serving trials measure incomparable step_ms (optimizer
    # step vs mean engine step): best/default figures compare within the
    # train phase when present, never across phases (a reused metrics
    # file can legitimately carry both tuners' streams).
    train_ok = [r for r in ok if r.get("phase", "train") == "train"]
    pool = train_ok or ok
    if pool:
        best = min(pool, key=lambda r: r["step_ms"])
        out["best"] = {
            "layout": best.get("layout"),
            "step_ms": best["step_ms"],
            "compile_ms": best.get("compile_ms"),
            "mfu": best.get("mfu"),
        }
        default = next((r for r in train_ok if r.get("default")), None)
        if default is not None:
            out["default_step_ms"] = default["step_ms"]
            if best["step_ms"]:
                out["best_vs_default"] = round(
                    default["step_ms"] / best["step_ms"], 3)
    if ok:
        worst_slo = [r for r in ok if r.get("slo_violations")]
        if worst_slo:
            out["slo_violating_trials"] = len(worst_slo)
    return out


def stream_clocks(records: list[dict]) -> list[dict]:
    """All clock calibrations in a record set, in file order.

    Each ``clock_sync`` record yields ``{offset_ms, rtt_ms, anchor_unix,
    _source, _idx}`` where ``anchor_unix`` is the epoch time at that
    incarnation's ``wall_time`` zero.  A stream appended to by a
    RESTARTED process (same ``--metrics_file`` across a crash-rejoin
    cycle) carries one calibration per incarnation, each governing only
    the records after it — the wall_time clock resets with the process.
    """
    out = []
    for rec in records:
        if record_kind(rec) != "clock_sync":
            continue
        offset, t_unix, wall = (rec.get("offset_ms"), rec.get("t_unix"),
                                rec.get("wall_time"))
        if not all(isinstance(v, (int, float))
                   for v in (offset, t_unix, wall)):
            continue
        out.append({"offset_ms": float(offset),
                    "rtt_ms": float(rec.get("rtt_ms", 0.0) or 0.0),
                    "anchor_unix": float(t_unix) - float(wall),
                    "_source": rec.get("_source"),
                    "_idx": rec.get("_idx", 0)})
    return out


def stream_clock(records: list[dict]) -> dict | None:
    """The newest calibration (the live incarnation's), or None when the
    run never synced (standalone)."""
    clocks = stream_clocks(records)
    return clocks[-1] if clocks else None


def clock_for(clocks: list[dict], rec: dict) -> dict | None:
    """The calibration governing ``rec``: the last ``clock_sync`` from the
    same file at or before the record's position (None before the first —
    such records have no trustworthy epoch mapping)."""
    governing = None
    for clock in clocks:
        if clock["_source"] != rec.get("_source"):
            continue
        if clock["_idx"] <= rec.get("_idx", 0):
            governing = clock
    return governing


def aligned_time(clock: dict, wall_time: float) -> float:
    """Map an incarnation-relative ``wall_time`` onto the coordination
    server's epoch timeline using its governing calibration."""
    return clock["anchor_unix"] + wall_time + clock["offset_ms"] / 1000.0


def cross_worker_spread(by_worker: dict[str, list[dict]]) -> dict | None:
    """Final-step spread across workers — the between-host straggler view
    (each host writes its own stream; a lagging host's last step lags).

    When every stream carries a ``clock_sync`` calibration, the spread is
    also measured in TIME: the moment each worker logged the latest step
    they all reached, aligned onto the server clock — per-stream
    ``wall_time`` alone is process-relative and not comparable across
    hosts, which is exactly the assumption this correction removes."""
    finals = {}
    for worker, recs in by_worker.items():
        steps = [r.get("step") for r in recs
                 if record_kind(r) == "train_step"
                 and isinstance(r.get("step"), (int, float))]
        if steps:
            finals[worker] = max(steps)
    if len(finals) < 2:
        return None
    out = {"final_step_per_worker": finals,
           "spread_steps": max(finals.values()) - min(finals.values())}
    clocks = {w: stream_clocks(recs) for w, recs in by_worker.items()
              if w in finals}
    if all(clocks.values()):
        out["clock_offset_ms"] = {
            w: round(c[-1]["offset_ms"], 3) for w, c in clocks.items()}
        common_step = min(finals.values())
        arrivals = {}
        for worker, recs in by_worker.items():
            if worker not in finals:
                continue
            # Per-record governing calibration: a crash-restarted worker's
            # stream holds multiple incarnations, each with its own
            # wall_time zero — a record only maps onto the shared timeline
            # through ITS incarnation's clock_sync.
            hits = []
            for r in recs:
                if (record_kind(r) != "train_step"
                        or not isinstance(r.get("step"), (int, float))
                        or not isinstance(r.get("wall_time"), (int, float))
                        or r["step"] < common_step):
                    continue
                clock = clock_for(clocks[worker], r)
                if clock is not None:
                    hits.append(aligned_time(clock, r["wall_time"]))
            if hits:
                arrivals[worker] = min(hits)
        if len(arrivals) >= 2:
            out["skew_at_step"] = common_step
            out["aligned_step_skew_s"] = round(
                max(arrivals.values()) - min(arrivals.values()), 3)
    return out


# ------------------------------------------------------------ checking


def check_records(records: list[dict], errors: list[str]) -> list[str]:
    """The --check contract: strict JSON plus required train_step fields.

    Flight-recorder records (crash dumps ingested alongside a stream) are
    exempt: a dying worker's ring is allowed to hold partial records —
    that is the artifact's whole point."""
    problems = list(errors)
    records = [r for r in records if not r.get("_flight")]
    step_records = [r for r in records if record_kind(r) == "train_step"]
    serve_records = [r for r in records if record_kind(r) == "serve_step"]
    route_records = [r for r in records if record_kind(r) == "route"]
    fleet_records = [r for r in records if record_kind(r) == "fleet"]
    autotune_records = [r for r in records
                        if record_kind(r) == "autotune_trial"]
    cell_records = [r for r in records if record_kind(r) == "cell"]
    loadgen_records = [r for r in records
                       if record_kind(r) == "loadgen"]
    loadgen_request_records = [r for r in records
                               if record_kind(r) == "loadgen_request"]
    trace_sample_records = [r for r in records
                            if record_kind(r) == "trace_sample"]
    if not records:
        problems.append("no records found in the stream(s)")
    elif not (step_records or serve_records or route_records
              or fleet_records or autotune_records or cell_records
              or loadgen_records or loadgen_request_records):
        # Serving streams carry serve_step records, router streams
        # route/fleet records, global-router streams cell records,
        # loadgen streams a loadgen verdict, tuner streams
        # autotune_trial records — any satisfies the contract in place
        # of train_step.
        problems.append("no train_step, serve_step, route/fleet, "
                        "cell/loadgen, or autotune_trial records found "
                        "in the stream(s)")
    for rec in step_records:
        missing = [f for f in REQUIRED_STEP_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: train_step record at step "
                f"{rec.get('step')} missing required fields {missing}")
    for rec in serve_records:
        missing = [f for f in REQUIRED_SERVE_STEP_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: serve_step record at step "
                f"{rec.get('step')} missing required fields {missing}")
    for rec in (r for r in records if record_kind(r) == "slo"):
        missing = [f for f in REQUIRED_SLO_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: slo record at step "
                f"{rec.get('step')} missing required fields {missing}")
    for rec in route_records:
        missing = [f for f in REQUIRED_ROUTE_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: route record at step "
                f"{rec.get('step')} missing required fields {missing}")
    for rec in fleet_records:
        missing = [f for f in REQUIRED_FLEET_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: fleet record at step "
                f"{rec.get('step')} missing required fields {missing}")
    for rec in (r for r in records if record_kind(r) == "param_exchange"
                and r.get("hierarchical")):
        missing = [f for f in REQUIRED_HIER_EXCHANGE_FIELDS
                   if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: hierarchical param_exchange "
                f"record missing required fields {missing}")
    for rec in autotune_records:
        missing = [f for f in REQUIRED_AUTOTUNE_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: autotune_trial record at "
                f"trial {rec.get('trial')} missing required fields "
                f"{missing}")
    for rec in cell_records:
        missing = [f for f in REQUIRED_CELL_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: cell record at step "
                f"{rec.get('step')} missing required fields {missing}")
    for rec in loadgen_records:
        missing = [f for f in REQUIRED_LOADGEN_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: loadgen record "
                f"({rec.get('scenario')}) missing required fields "
                f"{missing}")
    for rec in loadgen_request_records:
        missing = [f for f in REQUIRED_LOADGEN_REQUEST_FIELDS
                   if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: loadgen_request record "
                f"(trace {rec.get('trace_id')}) missing required fields "
                f"{missing}")
    for rec in trace_sample_records:
        missing = [f for f in REQUIRED_TRACE_SAMPLE_FIELDS
                   if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: trace_sample record "
                f"(trace {rec.get('trace_id')}) missing required fields "
                f"{missing}")
    for rec in (r for r in records if record_kind(r) == "recovery"
                and r.get("action") == "kv_shard_failover"):
        missing = [f for f in REQUIRED_KV_FAILOVER_FIELDS if f not in rec]
        if missing:
            problems.append(
                f"{rec.get('_source', '?')}: kv_shard_failover recovery "
                f"record missing required fields {missing}")
    return problems


# ----------------------------------------------------------- rendering


def _bar(value: float, peak: float, width: int = 40) -> str:
    n = 0 if peak <= 0 else round(width * value / peak)
    return "#" * max(0, min(width, n))


def build_summary(records: list[dict], gap_factor: float = 5.0,
                  buckets: int = 10) -> dict[str, Any]:
    """Analyze a full record set into the report dict (also the --json
    payload's ``extra``)."""
    by_worker = group_by_worker(records)
    workers: dict[str, Any] = {}
    all_rates: list[float] = []
    for worker, all_recs in sorted(by_worker.items()):
        # Flight-dump records are COPIES of the last ring-resident records
        # already in the stream: they feed only the flight section below —
        # counting them into the aggregates would double the crash run's
        # last 256 records.
        recs = [r for r in all_recs if not r.get("_flight")]
        flights = [r for r in all_recs if r.get("_flight")]
        steps = [r for r in recs if record_kind(r) == "train_step"]
        evals = [r for r in recs if record_kind(r) == "eval"]
        ckpts = [r for r in recs if record_kind(r) == "checkpoint"]
        health = [r for r in recs if record_kind(r) == "cluster_health"]
        summaries = [r for r in recs if record_kind(r) == "run_summary"]
        rates = [r["steps_per_sec"] for r in steps
                 if isinstance(r.get("steps_per_sec"), (int, float))]
        all_rates.extend(rates[-1:])
        entry: dict[str, Any] = {
            "step_records": len(steps),
            "final_step": max((r.get("step", 0) for r in steps), default=0),
            "steps_per_sec_last": rates[-1] if rates else None,
            "throughput_curve": throughput_curve(steps, buckets=buckets),
            "breakdown": step_breakdown(steps),
            "gaps": detect_gaps(steps, factor=gap_factor),
            "mfu": mfu_summary(steps),
            "hbm": hbm_summary(steps),
            "eval_pauses": len(evals),
            "eval_ms_total": round(sum(
                r.get("eval_ms", 0) or 0 for r in evals), 1),
            "checkpoints": len(ckpts),
            "checkpoint_ms_total": round(sum(
                r.get("save_ms", 0) or 0 for r in ckpts), 1),
            "meta": meta_summary(recs),
            "cluster_health": cluster_health_summary(health),
            "exchange": exchange_summary(recs),
            "serving": serving_summary(recs),
            "fleet": fleet_summary(recs),
            "cells": cell_summary(recs),
            "autotune": autotune_summary(recs),
            "fatal": fatal_summary(recs),
            "recovery": recovery_summary(recs),
            "clock_offset_ms": (stream_clock(recs) or {}).get("offset_ms"),
        }
        if flights:
            # Crash flight recorder dump (docs/observability.md): the
            # worker's last-seconds ring, folded into its report entry.
            header = next((r for r in flights
                           if record_kind(r) == "flight_header"), None)
            body = sorted((r for r in flights
                           if record_kind(r) != "flight_header"),
                          key=lambda r: r.get("t_unix", 0.0))
            body_steps = [r.get("step") for r in body
                          if isinstance(r.get("step"), (int, float))]
            entry["flight"] = {
                "records": len(body),
                "reason": (header or {}).get("reason"),
                "last_step": max(body_steps) if body_steps else None,
                "last_kind": record_kind(body[-1]) if body else None,
            }
        if summaries:
            # The writer-side constant-memory summary (histogram quantiles
            # over EVERY step, not just the logged ones) — carry it whole.
            final = dict(summaries[-1])
            final.pop("_source", None)
            final.pop("_idx", None)
            entry["run_summary"] = final
        workers[worker] = entry
    return {
        "workers": workers,
        "cross_worker": cross_worker_spread(by_worker),
        # Cross-STREAM by construction: the client half (loadgen_request)
        # and the server half (root spans) of the same trace live in
        # different workers' files — match over the whole record set.
        "traces": trace_summary(
            [r for r in records if not r.get("_flight")]),
        "steps_per_sec_total": (round(sum(all_rates), 3)
                                if all_rates else None),
    }


def render_report(summary: dict[str, Any], print_fn=print) -> None:
    for worker, w in summary["workers"].items():
        print_fn(f"=== {worker}: {w['step_records']} step records, final "
                 f"step {w['final_step']} ===")
        meta = w.get("meta")
        if meta:
            ident = ", ".join(f"{k}={meta[k]}" for k in
                              ("role", "model", "model_step",
                               "schema_version") if k in meta)
            if ident:
                print_fn(f"meta: {ident}")
        fatal = w.get("fatal")
        if fatal:
            print_fn(f"ENGINE FATAL at step {fatal['step']}: "
                     f"{fatal['error']} ({fatal['count']} record(s))")
        curve = w["throughput_curve"]
        if curve:
            peak = max(p["steps_per_sec"] for p in curve)
            print_fn("throughput (steps/sec over wall time):")
            for p in curve:
                print_fn(f"  t={p['t_s']:>9.2f}s {p['steps_per_sec']:>10.2f} "
                         f"|{_bar(p['steps_per_sec'], peak)}")
        b = w["breakdown"]
        if b:
            print_fn("step-time breakdown (logged records):")
            print_fn(f"  {'phase':<12} {'total_ms':>10} {'share':>7} "
                     f"{'p50':>8} {'p95':>8} {'p99':>8} {'max':>8}")
            for phase, key, tot, pct in (
                    ("data_wait", "data_wait_ms",
                     b["data_wait_ms_total"], b["data_wait_pct"]),
                    ("compute", "compute_ms",
                     b["compute_ms_total"], b["compute_pct"])):
                q = b.get(key) or {}
                print_fn(f"  {phase:<12} {tot:>10.1f} "
                         f"{(str(pct) + '%') if pct is not None else '-':>7} "
                         f"{q.get('p50', '-'):>8} {q.get('p95', '-'):>8} "
                         f"{q.get('p99', '-'):>8} {q.get('max', '-'):>8}")
        if w["mfu"]:
            print_fn(f"mfu: {w['mfu']}")
        if w["hbm"]:
            print_fn(f"hbm: {w['hbm']}")
        if w["gaps"]:
            print_fn(f"gaps: {len(w['gaps'])} suspicious wall-clock "
                     "hole(s) between step records:")
            for g in w["gaps"][:10]:
                print_fn(f"  step {g['after_step']} -> {g['before_step']}: "
                         f"{g['gap_s']}s ({g['vs_median']}x median cadence)")
        if w["eval_pauses"] or w["checkpoints"]:
            print_fn(f"pauses: {w['eval_pauses']} evals "
                     f"({w['eval_ms_total']} ms), {w['checkpoints']} "
                     f"checkpoints ({w['checkpoint_ms_total']} ms)")
        ch = w["cluster_health"]
        if ch:
            print_fn(f"cluster health: {ch}")
        ex = w.get("exchange")
        if ex:
            line = (f"param exchange: {ex['exchanges']} period(s) "
                    f"({ex['compressed']} compressed, {ex['fallback']} "
                    f"full-state), {ex['bytes_on_wire_total'] / 1e6:.2f} MB "
                    "on wire")
            if ex.get("wire_vs_full_state_pct") is not None:
                line += (f" = {ex['wire_vs_full_state_pct']}% of the "
                         "full-state equivalent")
            if ex.get("ratio_last") is not None:
                line += f", ratio {ex['ratio_last']}x"
            if ex.get("residual_rms_last") is not None:
                line += f", residual rms {ex['residual_rms_last']}"
            print_fn(line)
            if ex.get("hierarchical"):
                line = (f"  hierarchical: slice {ex.get('slice')}"
                        f"/{ex.get('n_slices')} "
                        f"({'exporter' if ex.get('exporter') else 'member'}"
                        f"), inter "
                        f"{ex.get('inter_bytes_total', 0) / 1e6:.2f} MB / "
                        f"intra "
                        f"{ex.get('intra_bytes_total', 0) / 1e6:.2f} MB")
                if ex.get("flat_fallbacks"):
                    line += (f", {ex['flat_fallbacks']} FLAT-fallback "
                             "period(s)")
                stages = ex.get("stages_last")
                if stages:
                    line += ", stages " + " ".join(
                        f"{k.replace('_ms', '')}={v}ms"
                        for k, v in stages.items())
                print_fn(line)
        sv = w.get("serving")
        if sv:
            line = (f"serving: {sv['engine_steps']} engine step(s), "
                    f"{sv['requests']} request(s)")
            if sv.get("qps") is not None:
                line += f" ({sv['qps']} qps)"
            if sv.get("peak_active_slots") is not None:
                line += f", peak {sv['peak_active_slots']} slot(s)"
            if sv.get("kv_pages_peak") is not None:
                line += (f", kv pages peak {sv['kv_pages_peak']}"
                         f"/{sv.get('kv_pages_total', '?')}")
            if sv.get("overlap_admissions"):
                line += (f", {sv['overlap_admissions']} admission(s) "
                         "joined mid-decode")
            if sv.get("model_swaps"):
                line += (f", {sv['model_swaps']} hot swap(s) "
                         f"(max {sv.get('max_in_flight_at_swap', 0)} "
                         "in flight)")
            sp = sv.get("speculation")
            if sp:
                line += (f", spec {sp['accepted_tokens']} token(s) over "
                         f"{sp['row_rounds']} lane-round(s) "
                         f"({sp['accepted_per_round']}/round)")
            print_fn(line)
            for tenant, t in (sv.get("tenants") or {}).items():
                tline = (f"  tenant {tenant}: {t['requests']} request(s), "
                         f"{t['tokens_out']} token(s)")
                if t.get("ttft_ms"):
                    tline += (f", ttft p50={t['ttft_ms']['p50']}ms "
                              f"p95={t['ttft_ms']['p95']}ms "
                              f"p99={t['ttft_ms']['p99']}ms")
                if t.get("tpot_ms"):
                    tline += (f", tpot p50={t['tpot_ms']['p50']}ms "
                              f"p95={t['tpot_ms']['p95']}ms "
                              f"p99={t['tpot_ms']['p99']}ms")
                if t.get("rejected"):
                    tline += f", {t['rejected']} rejected(429)"
                if t.get("abandoned"):
                    tline += f", {t['abandoned']} abandoned"
                if t.get("queued_hwm") is not None:
                    tline += f", queue hwm {t['queued_hwm']}"
                if t.get("not_ok"):
                    tline += f", {t['not_ok']} not-ok"
                print_fn(tline)
            slo = sv.get("slo")
            if slo:
                print_fn(f"  slo: {len(slo['objectives'])} objective(s) "
                         f"over {slo['evaluations']} evaluation(s)"
                         + (f"; BURNING now: {slo['burning']}"
                            if slo["burning"] else "")
                         + (f"; burned during run: {slo['ever_burning']}"
                            if slo["ever_burning"] else "; none burned"))
                for o in slo["objectives"]:
                    print_fn(f"    {'BURN' if o['burning'] else ' ok '} "
                             f"{o['tenant']}:{o['objective']} "
                             f"burn short={o['burn_short']} "
                             f"long={o['burn_long']} "
                             f"bad {o['bad_long']}/"
                             f"{(o['bad_long'] or 0) + (o['good_long'] or 0)}")
        ft = w.get("fleet")
        if ft:
            line = (f"fleet: {ft.get('routed', 0)} request(s) routed "
                    f"({ft.get('ok', 0)} ok, {ft.get('failed', 0)} "
                    f"failed), {ft.get('failovers_total', 0)} "
                    f"failover(s), {ft.get('spills', 0)} spill(s)")
            if ft.get("failover_route_ms_max") is not None:
                line += (f", worst rescued request "
                         f"{ft['failover_route_ms_max']}ms")
            if ft.get("replicas_peak") is not None:
                line += (f"; replicas peak {ft['replicas_peak']} -> "
                         f"final {ft.get('replicas_final')}")
            print_fn(line)
            if ft.get("served_by"):
                print_fn(f"  served by: {ft['served_by']}")
            if ft.get("routed_by_tenant"):
                print_fn(f"  routed by tenant: {ft['routed_by_tenant']}")
            if ft.get("actions"):
                print_fn(f"  fleet actions: {ft['actions']}")
        cl = w.get("cells")
        if cl:
            line = (f"cells: {cl.get('cell_records', 0)} record(s), "
                    f"{cl.get('cell_deaths', 0)} death(s), "
                    f"{cl.get('rehomes', 0)} re-home(s)")
            if cl.get("returns"):
                line += f", {cl['returns']} return(s)"
            if cl.get("throttle_rejects"):
                line += (f", {cl['throttle_rejects']} throttle "
                         f"reject(s)")
            if cl.get("failover_gap_ms_max") is not None:
                line += (f"; failover gap max "
                         f"{cl['failover_gap_ms_max']}ms "
                         f"({cl.get('failover_gaps', 0)} recorded)")
            if cl.get("healthy_min") is not None:
                line += (f"; healthy cells min {cl['healthy_min']}"
                         f"/{cl.get('cells_final', '?')}")
            print_fn(line)
            if cl.get("actions"):
                print_fn(f"  cell actions: {cl['actions']}")
            if cl.get("rehomed_tenants"):
                print_fn(f"  re-homed tenants: "
                         f"{cl['rehomed_tenants']}")
            for lg in cl.get("loadgen") or ():
                print_fn(f"  loadgen {lg['scenario']}: "
                         f"{lg['ok']}/{lg['requests']} ok, "
                         f"{lg['rejected']} rejected, "
                         f"{lg['failed']} failed in "
                         f"{lg['duration_s']}s"
                         + (f"; ever burned {lg['ever_burning']}"
                            if lg.get("ever_burning") else ""))
        at = w.get("autotune")
        if at:
            line = (f"autotune: {at['trials']} trial(s) ({at['ok']} ok, "
                    f"{at['crashed']} crash, {at['timed_out']} timeout; "
                    f"phases {at['phases']})")
            best = at.get("best")
            if best:
                line += (f", best {best['layout']} "
                         f"step {best['step_ms']}ms "
                         f"(compile {best['compile_ms']}ms)")
                if best.get("mfu") is not None:
                    line += f" mfu {best['mfu']}%"
            if at.get("best_vs_default") is not None:
                line += (f", {at['best_vs_default']}x vs the default "
                         f"layout ({at['default_step_ms']}ms)")
            if at.get("slo_violating_trials"):
                line += (f"; {at['slo_violating_trials']} trial(s) "
                         "violating SLO objectives")
            print_fn(line)
        if w.get("clock_offset_ms") is not None:
            print_fn(f"clock offset vs coordination server: "
                     f"{w['clock_offset_ms']:+.3f} ms")
        fl = w.get("flight")
        if fl:
            print_fn(f"flight recorder: {fl['records']} record(s) dumped "
                     f"(reason={fl['reason']}), last step {fl['last_step']} "
                     f"({fl['last_kind']})")
        rv = w.get("recovery")
        if rv:
            line = (f"recovery events: {rv['events']} {rv['by_action']}")
            if rv.get("faults_injected"):
                line += f", faults injected: {rv['faults_injected']}"
            print_fn(line)
            kv = rv.get("kv_shard_failover")
            if kv:
                print_fn(f"kv shard failovers: {kv['count']} "
                         f"(shards {kv['shards']}, max gap "
                         f"{kv['max_gap_s']}s, last generation "
                         f"{kv['last_generation']})")
            el = rv.get("elastic")
            if el:
                print_fn(f"elastic membership: {el['resizes']} resize(s) "
                         f"({el['shrinks']} shrink, {el['grows']} grow), "
                         f"last epoch {el['last_epoch']}, active "
                         f"{el['min_active']} at the trough -> "
                         f"{el['final_active']} at the end")
        rs = w.get("run_summary")
        if rs and isinstance(rs.get("histograms"), dict):
            hists = rs["histograms"]
            interesting = [k for k in ("step_ms", "data_wait_ms",
                                       "compute_ms", "barrier_wait_ms")
                           if hists.get(k, {}).get("count")]
            if interesting:
                print_fn("whole-run histograms (every step, writer-side):")
                for k in interesting:
                    h = hists[k]
                    print_fn(f"  {k:<16} n={h['count']:<7} p50={h['p50']} "
                             f"p95={h['p95']} p99={h['p99']} max={h['max']}")
    tr = summary.get("traces")
    if tr:
        if tr.get("loadgen_requests"):
            line = (f"traces: {tr['loadgen_requests']} client-side "
                    f"request verdict(s) {tr.get('verdicts')}")
            if tr.get("matched_traces"):
                line += (f"; {tr['matched_traces']} matched to server "
                         f"spans — client p50 {tr['client_e2e_p50_ms']}ms "
                         f"vs server p50 {tr['server_e2e_p50_ms']}ms, "
                         f"overhead p50 {tr['overhead_p50_ms']}ms "
                         f"max {tr['overhead_max_ms']}ms "
                         f"({tr['overhead_worst_trace']})")
            print_fn(line)
        if tr.get("routing_spans"):
            print_fn(f"routing spans: {tr['routing_spans']}")
        if tr.get("sampling_by_tier"):
            print_fn(f"trace sampling: {tr['sampling_by_tier']} "
                     f"reasons {tr.get('sampling_reasons')}")
    cw = summary["cross_worker"]
    if cw:
        print_fn(f"cross-worker progress spread: {cw['spread_steps']} steps "
                 f"{cw['final_step_per_worker']}")
        if cw.get("aligned_step_skew_s") is not None:
            print_fn(f"cross-worker step skew (clock-aligned): "
                     f"{cw['aligned_step_skew_s']}s at step "
                     f"{cw['skew_at_step']} "
                     f"(offsets {cw['clock_offset_ms']} ms)")


def bench_shape(summary: dict[str, Any]) -> dict[str, Any]:
    """The machine-readable artifact: BENCH_*.json shape — one headline
    metric plus everything else under ``extra``."""
    return {
        "metric": "steps_per_sec_total",
        "value": summary.get("steps_per_sec_total"),
        "unit": "steps/sec",
        "vs_baseline": None,
        "extra": summary,
    }


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("files", nargs="+",
                        help="telemetry JSONL stream(s), one per host")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="also write the BENCH-shaped summary JSON here")
    parser.add_argument("--check", action="store_true",
                        help="validate the stream (strict JSON, required "
                             "train_step fields); exit 1 on problems")
    parser.add_argument("--gap-factor", type=float, default=5.0,
                        help="flag wall-clock gaps above this multiple of "
                             "the median step cadence (default 5)")
    parser.add_argument("--buckets", type=int, default=10,
                        help="throughput-curve buckets (default 10)")
    args = parser.parse_args(argv)

    records: list[dict] = []
    errors: list[str] = []
    flight_warnings: list[str] = []
    seen_flights: set[str] = set()

    def _load_flight(path: str) -> None:
        # Dedupe: a dump both passed explicitly AND auto-discovered next
        # to its stream must ingest once, not twice.
        key = os.path.abspath(path)
        if key in seen_flights:
            return
        seen_flights.add(key)
        recs, errs = load_records(path)
        for rec in recs:
            rec["_flight"] = True
        records.extend(recs)
        # Flight dumps are best-effort writes from dying processes: parse
        # problems are warnings, never --check failures.
        flight_warnings.extend(errs)

    for path in args.files:
        if path.endswith(".flight"):
            _load_flight(path)
            continue
        recs, errs = load_records(path)
        records.extend(recs)
        errors.extend(errs)
        if os.path.exists(path + ".flight"):
            # A crash dump sitting next to the stream is part of the run's
            # story — ingest it automatically.
            _load_flight(path + ".flight")

    # Flight-dump parse problems are warnings (never --check failures),
    # but they must SURFACE even on the --check early-return path: a
    # damaged crash dump is exactly the kind of thing an operator needs
    # to hear about.
    for e in flight_warnings:
        print(f"[summarize_run] WARNING: {e}")

    if args.check:
        problems = check_records(records, errors)
        if problems:
            for p in problems:
                print(f"[summarize_run] CHECK FAIL: {p}")
            print(f"[summarize_run] {len(problems)} problem(s)")
            return 1
        print(f"[summarize_run] CHECK OK: {len(records)} records, all "
              "train_step/serve_step/route/fleet/autotune_trial/cell/"
              "loadgen/loadgen_request/trace_sample records carry the "
              "required fields")
        if not args.json:
            return 0

    for e in errors:
        print(f"[summarize_run] WARNING: {e}")

    summary = build_summary(records, gap_factor=args.gap_factor,
                            buckets=args.buckets)
    if not args.check:
        render_report(summary)
    if args.json:
        payload = bench_shape(summary)
        with open(args.json, "w") as fh:
            json.dump(payload, fh, indent=2)
        print(f"[summarize_run] wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
