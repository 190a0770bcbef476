"""Trace-driven load generator — replayed reality and a chaos scenario
library, scored by the SLO engine (docs/serving.md, "Cells").

Copied from ``distributed_tensorflow_tpu/tools/loadgen.py`` (standard
library only; the port's imports).

Every serving PR so far drove its acceptance with ad-hoc curl loops;
the cell drills need *repeatable* load with a verdict.  This tool
turns a workload into threads against any ``ServeClient``-compatible
endpoint (single server, fleet router, or global cell router — same
wire format) and scores the outcome with its OWN
:class:`..serving.slo.SloEngine` instance: the client-side view of the
SLO, measured from real responses (the server-reported ``ttft_ms`` /
``tpot_ms`` plus wall-clock e2e), not the server's self-report.

Workloads come from two sources:

- ``--trace FILE`` replays a recorded telemetry stream: every
  ``kind="serve_request"`` record becomes one request with the SAME
  tenant, prompt length, generation length, and inter-arrival spacing
  (``--speed 2`` compresses time 2x) — yesterday's production traffic
  as today's regression load.
- ``--scenario NAME`` generates a parameterized schedule
  (deterministic per ``--seed``):

  * ``flash_crowd`` — steady fair-share traffic, then one tenant
    bursts at ``--burst_x`` its rate for the middle third (the
    failover-cascade shape the blast-radius throttle exists for);
  * ``abusive_tenant`` — one tenant at ``--burst_x`` rate with 4x
    generation length for the whole run vs well-behaved tenants (the
    fair-share story under sustained abuse);
  * ``slow_drip`` — a trickle of long-generation requests (slow
    clients holding decode slots);
  * ``diurnal`` — a rate ramp up and back down (does autoscale/burn
    recover without flapping);
  * ``cell_kill`` — steady multi-tenant load while
    ``faults.kill_cell`` SIGKILLs a whole named cell at
    ``--kill_at_s`` (what runs the two-cell drill).

  Every scenario can draw per-request prompt lengths from a long-tail
  mixture instead of a constant (``--prompt_dist lognormal|zipf``,
  ROADMAP item 5b): mixed prefill load is what makes admission/paging
  drills honest — constant-size requests never fragment the KV pool.

One ``kind="loadgen"`` record lands on ``--metrics_file``
(``summarize_run --check`` gates its fields) and ``--json`` prints the
same report to stdout — the CI hook: exit 0 iff nothing failed
outright (429 backpressure is a *scored* outcome, not a failure; the
throttle answering 429 is the design working).

With ``--metrics_file`` every individual request ALSO lands as one
``kind="loadgen_request"`` record carrying the client-side verdict and
wall-clock latency, keyed by the SAME trace id the request carried on
the wire (``X-DTF-Trace`` — docs/observability.md, "Cross-tier tracing
& tail sampling"), so ``summarize_run`` can lay the client-perceived
latency beside the server-side spans of the identical request.
"""

from __future__ import annotations

import argparse
import json
import math
import random
import sys
import threading
import time

SCENARIOS = ("flash_crowd", "abusive_tenant", "slow_drip", "diurnal",
             "cell_kill")


# ----------------------------------------------------------- schedules


def load_trace(path: str, *, speed: float = 1.0,
               max_requests: int = 0) -> list[dict]:
    """A recorded telemetry stream -> schedule.  Each
    ``kind="serve_request"`` record replays with its original tenant,
    sizes, and wall-clock spacing (compressed by ``speed``)."""
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    items: list[dict] = []
    base: float | None = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") != "serve_request":
                continue
            wall = float(rec.get("wall_time") or 0.0)
            if base is None:
                base = wall
            items.append({
                "t": max(0.0, wall - base) / speed,
                "tenant": str(rec.get("tenant") or "default"),
                "prompt_len": max(1, int(rec.get("prompt_tokens") or 1)),
                "gen_len": max(1, int(rec.get("tokens_out") or 1)),
            })
            if max_requests and len(items) >= max_requests:
                break
    items.sort(key=lambda i: i["t"])
    return items


PROMPT_DISTS = ("constant", "lognormal", "zipf")


def sample_prompt_len(rng: random.Random, dist: str, base: int,
                      sigma: float = 1.0, alpha: float = 1.5,
                      cap: int = 512) -> int:
    """One prompt length from the named long-tail mixture (ROADMAP item
    5b): ``constant`` returns ``base``; ``lognormal`` multiplies it by a
    median-1 lognormal factor (sigma controls the tail); ``zipf`` by a
    Pareto factor (alpha < ~2 gives the heavy prefill tail real traces
    show).  Capped at ``cap`` so one sample cannot exceed any plausible
    context budget, floored at 1."""
    if dist == "constant":
        return base
    if dist == "lognormal":
        factor = rng.lognormvariate(0.0, sigma)
    elif dist == "zipf":
        factor = rng.paretovariate(alpha)
    else:
        raise ValueError(f"unknown prompt dist {dist!r} "
                         f"(one of {PROMPT_DISTS})")
    return max(1, min(int(cap), round(base * factor)))


def build_schedule(scenario: str, *, duration_s: float = 20.0,
                   qps: float = 4.0, tenants: tuple[str, ...] | None =
                   None, seed: int = 0, burst_x: float = 8.0,
                   prompt_len: int = 8, gen_len: int = 8,
                   prompt_dist: str = "constant",
                   prompt_sigma: float = 1.0, zipf_alpha: float = 1.5,
                   prompt_cap: int = 512) -> list[dict]:
    """One scenario -> schedule, deterministic per seed (Poisson
    arrivals from a seeded RNG).  ``prompt_dist`` draws each request's
    prompt length from a long-tail mixture around ``prompt_len``
    (:func:`sample_prompt_len`) instead of a constant — mixed prefill
    load, the shape real serving traffic has."""
    if scenario not in SCENARIOS:
        raise ValueError(f"unknown scenario {scenario!r} "
                         f"(one of {SCENARIOS})")
    if prompt_dist not in PROMPT_DISTS:
        raise ValueError(f"unknown prompt dist {prompt_dist!r} "
                         f"(one of {PROMPT_DISTS})")
    tenants = tuple(tenants or ("search", "ads"))
    rng = random.Random(seed)
    items: list[dict] = []

    def arrivals(tenant: str, rate: float, t0: float, t1: float,
                 plen: int, glen: int) -> None:
        if rate <= 0:
            return
        t = t0 + rng.expovariate(rate)
        while t < t1:
            items.append({"t": t, "tenant": tenant,
                          "prompt_len": sample_prompt_len(
                              rng, prompt_dist, plen, sigma=prompt_sigma,
                              alpha=zipf_alpha, cap=prompt_cap),
                          "gen_len": glen})
            t += rng.expovariate(rate)

    fair = qps / max(1, len(tenants))
    if scenario in ("flash_crowd", "cell_kill"):
        for tenant in tenants:
            arrivals(tenant, fair, 0.0, duration_s, prompt_len, gen_len)
        if scenario == "flash_crowd":
            arrivals(tenants[0], burst_x * qps, duration_s / 3,
                     2 * duration_s / 3, prompt_len, gen_len)
    elif scenario == "abusive_tenant":
        arrivals(tenants[0], burst_x * qps, 0.0, duration_s,
                 prompt_len, gen_len * 4)
        for tenant in tenants[1:]:
            arrivals(tenant, fair, 0.0, duration_s, prompt_len, gen_len)
    elif scenario == "slow_drip":
        for tenant in tenants:
            arrivals(tenant, fair / 4, 0.0, duration_s, prompt_len,
                     gen_len * 4)
    elif scenario == "diurnal":
        slices = 16
        for i in range(slices):
            t0 = duration_s * i / slices
            t1 = duration_s * (i + 1) / slices
            rate = qps * (0.25 + 0.75 * math.sin(
                math.pi * (i + 0.5) / slices))
            for tenant in tenants:
                arrivals(tenant, rate / len(tenants), t0, t1,
                         prompt_len, gen_len)
    items.sort(key=lambda i: i["t"])
    return items


# ------------------------------------------------------------ execution


def run_schedule(url: str, schedule: list[dict], *, slo: str = "",
                 timeout_s: float = 60.0, kill_at_s: float = 0.0,
                 kill_fn=None, scenario: str = "trace",
                 telemetry=None,
                 clock=time.monotonic, sleep=time.sleep) -> dict:
    """Fire the schedule at ``url`` (one thread per in-flight request)
    and return the scored report.  ``kill_fn`` (the chaos hook) fires
    once, just before the first request scheduled at or after
    ``kill_at_s`` is dispatched.  With ``telemetry``, every request
    mints a trace id, carries it on the wire, and lands one
    ``kind="loadgen_request"`` verdict record keyed by it."""
    from ..serving.client import (Backpressure, Overloaded,
                                  ReplicaUnavailable, ServeClient)
    from ..serving.slo import SloEngine, parse_slos
    from ..utils import tracing

    client = ServeClient(url, timeout_s=timeout_s, retries=1)
    engine = SloEngine(parse_slos(slo)) if slo else None
    lock = threading.Lock()
    counts = {"ok": 0, "rejected": 0, "failed": 0}
    e2e: list[float] = []
    errors: list[str] = []

    def worker(item: dict) -> None:
        tenant = item["tenant"]
        # Minted even with telemetry off: the server adopts it as its
        # root either way, so a request is findable in SERVER streams
        # by the id the client logged (or printed on failure).
        trace = tracing.mint_trace("lg")
        t0 = clock()
        try:
            resp = client.generate(
                list(range(1, item["prompt_len"] + 1)), item["gen_len"],
                tenant=tenant, trace=trace)
        except Backpressure:
            wall_ms = (clock() - t0) * 1e3
            with lock:
                counts["rejected"] += 1
            if engine is not None:
                engine.observe_admission(tenant, rejected=True)
            _emit_loadgen_request(
                telemetry, scenario=scenario, tenant=tenant,
                trace_id=trace, verdict="rejected",
                e2e_ms=round(wall_ms, 3))
        except (Overloaded, ReplicaUnavailable, ValueError,
                RuntimeError, TimeoutError, OSError) as e:
            wall_ms = (clock() - t0) * 1e3
            with lock:
                counts["failed"] += 1
                if len(errors) < 8:
                    errors.append(f"{tenant}: {e!r}")
            if engine is not None:
                engine.observe_request(tenant, ttft_ms=None,
                                       tpot_ms=None, e2e_ms=None,
                                       ok=False)
            _emit_loadgen_request(
                telemetry, scenario=scenario, tenant=tenant,
                trace_id=trace, verdict="failed",
                e2e_ms=round(wall_ms, 3))
        else:
            wall_ms = (clock() - t0) * 1e3
            with lock:
                counts["ok"] += 1
                e2e.append(wall_ms)
            if engine is not None:
                engine.observe_request(
                    tenant, ttft_ms=resp.get("ttft_ms"),
                    tpot_ms=resp.get("tpot_ms"), e2e_ms=wall_ms,
                    ok=True)
            _emit_loadgen_request(
                telemetry, scenario=scenario, tenant=tenant,
                trace_id=trace, verdict="ok",
                e2e_ms=round(wall_ms, 3),
                ttft_ms=resp.get("ttft_ms"),
                tpot_ms=resp.get("tpot_ms"))

    start = clock()
    threads: list[threading.Thread] = []
    killed = False
    for item in schedule:
        if kill_fn is not None and not killed \
                and item["t"] >= kill_at_s:
            killed = True
            threading.Thread(target=kill_fn, daemon=True).start()
        delay = item["t"] - (clock() - start)
        if delay > 0:
            sleep(delay)
        t = threading.Thread(target=worker, args=(item,), daemon=True)
        t.start()
        threads.append(t)
    if kill_fn is not None and not killed:
        kill_fn()
    for t in threads:
        t.join(timeout=timeout_s + 30.0)
    duration = clock() - start
    snap = engine.snapshot() if engine is not None else {}
    report = {
        "scenario": scenario,
        "requests": len(schedule),
        "ok": counts["ok"],
        "rejected": counts["rejected"],
        "failed": counts["failed"],
        "duration_s": round(duration, 3),
        "e2e_p50_ms": round(sorted(e2e)[len(e2e) // 2], 3) if e2e
        else None,
        "burning": snap.get("burning", []),
        "ever_burning": snap.get("ever_burning", []),
        "errors": errors,
    }
    return report


# ------------------------------------------------------------------ CLI


def _emit_loadgen_request(telemetry, *, scenario: str, tenant: str,
                          trace_id: str, verdict: str, e2e_ms: float,
                          ttft_ms=None, tpot_ms=None) -> None:
    """The ONE ``kind="loadgen_request"`` emit site — the client-side
    verdict of one request, keyed by the trace id it carried on the
    wire, so ``summarize_run`` can show client-perceived vs server-side
    latency for the SAME request.  Every field of
    ``REQUIRED_LOADGEN_REQUEST_FIELDS`` is an explicit keyword here
    (the dtflint telemetry-contract analyzer proves it statically)."""
    if telemetry is None:
        return
    telemetry.emit(
        "loadgen_request", step=0, scenario=scenario, tenant=tenant,
        trace_id=trace_id, verdict=verdict, e2e_ms=e2e_ms,
        ttft_ms=ttft_ms, tpot_ms=tpot_ms,
        t_unix=round(time.time(), 6))


def _emit_loadgen(telemetry, report: dict) -> None:
    """The ONE ``kind="loadgen"`` emit site — every field of
    ``REQUIRED_LOADGEN_FIELDS`` is an explicit keyword here, so the
    dtflint telemetry-contract analyzer can prove the contract
    statically."""
    telemetry.emit(
        "loadgen", step=0, scenario=report["scenario"],
        requests=report["requests"], ok=report["ok"],
        rejected=report["rejected"], failed=report["failed"],
        duration_s=report["duration_s"],
        burning=report["burning"], ever_burning=report["ever_burning"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--url", required=True,
                        help="target base URL (server, fleet router, "
                             "or global cell router)")
    parser.add_argument("--trace", default="",
                        help="replay this telemetry stream's "
                             "serve_request records")
    parser.add_argument("--speed", type=float, default=1.0,
                        help="trace time compression (2 = replay 2x "
                             "as fast)")
    parser.add_argument("--max_requests", type=int, default=0,
                        help="cap the trace replay (0 = all)")
    parser.add_argument("--scenario", default="",
                        choices=("",) + SCENARIOS,
                        help="generate this scenario instead of (or "
                             "after) a trace")
    parser.add_argument("--duration_s", type=float, default=20.0)
    parser.add_argument("--qps", type=float, default=4.0,
                        help="aggregate request rate across tenants")
    parser.add_argument("--tenants", default="search,ads",
                        help="comma list of tenant names to drive")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--burst_x", type=float, default=8.0,
                        help="flash-crowd/abusive rate multiplier")
    parser.add_argument("--prompt_len", type=int, default=8)
    parser.add_argument("--gen_len", type=int, default=8)
    parser.add_argument("--prompt_dist", default="constant",
                        choices=PROMPT_DISTS,
                        help="per-request prompt-length mixture around "
                             "--prompt_len: constant, lognormal (median "
                             "--prompt_len, tail per --prompt_sigma), or "
                             "zipf (Pareto tail per --zipf_alpha) — "
                             "mixed prefill load (ROADMAP item 5b)")
    parser.add_argument("--prompt_sigma", type=float, default=1.0,
                        help="lognormal sigma of the prompt-length "
                             "mixture (default 1.0)")
    parser.add_argument("--zipf_alpha", type=float, default=1.5,
                        help="Pareto alpha of the zipf prompt-length "
                             "mixture (lower = heavier tail, default 1.5)")
    parser.add_argument("--prompt_cap", type=int, default=512,
                        help="hard cap on any sampled prompt length")
    parser.add_argument("--slo", default="",
                        help="objectives to score client-side "
                             "(serving/slo.py parse_slos syntax)")
    parser.add_argument("--timeout_s", type=float, default=60.0)
    parser.add_argument("--kill_state", default="",
                        help="cell_kill: state file naming the victim "
                             "cell's pids (serve_cell --state_file)")
    parser.add_argument("--kill_cell", default="",
                        help="cell_kill: victim cell name (safety "
                             "check against the state file)")
    parser.add_argument("--kill_at_s", type=float, default=5.0,
                        help="cell_kill: schedule offset of the kill")
    parser.add_argument("--metrics_file", default=None,
                        help="emit the kind=loadgen report here")
    parser.add_argument("--json", action="store_true",
                        help="print the report as one JSON document "
                             "on stdout (the CI hook)")
    args = parser.parse_args(argv)

    if not args.trace and not args.scenario:
        parser.error("give --trace and/or --scenario")
    if args.scenario == "cell_kill" and not args.kill_state:
        parser.error("--scenario cell_kill needs --kill_state")

    schedule: list[dict] = []
    if args.trace:
        schedule += load_trace(args.trace, speed=args.speed,
                               max_requests=args.max_requests)
    if args.scenario:
        schedule += build_schedule(
            args.scenario, duration_s=args.duration_s, qps=args.qps,
            tenants=tuple(t for t in args.tenants.split(",") if t),
            seed=args.seed, burst_x=args.burst_x,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            prompt_dist=args.prompt_dist, prompt_sigma=args.prompt_sigma,
            zipf_alpha=args.zipf_alpha, prompt_cap=args.prompt_cap)
    schedule.sort(key=lambda i: i["t"])
    if not schedule:
        print("loadgen: empty schedule", file=sys.stderr)
        return 1

    kill_fn = None
    if args.scenario == "cell_kill":
        from ..utils import faults

        def kill_fn() -> None:
            killed = faults.kill_cell(args.kill_state,
                                      args.kill_cell or None)
            print(f"loadgen: killed cell "
                  f"{args.kill_cell or '?'} pids {killed}",
                  file=sys.stderr, flush=True)

    # The stream must exist BEFORE the run: per-request
    # kind=loadgen_request verdicts are emitted live from the worker
    # threads, not just the one summary record at the end.
    logger = telemetry = None
    if args.metrics_file:
        from ..utils.metrics import MetricsLogger
        from ..utils.telemetry import Telemetry

        logger = MetricsLogger(args.metrics_file)
        telemetry = Telemetry(logger)

    report = run_schedule(
        args.url, schedule, slo=args.slo, timeout_s=args.timeout_s,
        kill_at_s=args.kill_at_s, kill_fn=kill_fn,
        scenario=args.scenario or "trace", telemetry=telemetry)

    if telemetry is not None:
        _emit_loadgen(telemetry, report)
        logger.close()
    if args.json:
        print(json.dumps(report))
    else:
        print(f"loadgen: {report['scenario']} — "
              f"{report['ok']}/{report['requests']} ok, "
              f"{report['rejected']} rejected (backpressure), "
              f"{report['failed']} failed in "
              f"{report['duration_s']:.1f}s"
              + (f"; burning {report['burning']}"
                 if report["burning"] else "")
              + (f"; ever burned {report['ever_burning']}"
                 if report["ever_burning"] else ""), flush=True)
        for err in report["errors"]:
            print(f"loadgen:   error: {err}", flush=True)
    return 0 if report["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
