"""Serving-fleet CLI — N engine replicas behind one statz-routed,
SLO-autoscaled frontend (docs/serving.md, "Fleet").

Copied from ``distributed_tensorflow_tpu/tools/serve_fleet.py`` (standard
library only; the port's imports).  Its replicas are the port's serving
CLI (``distributed_tensorflow_tpu_torch.tools.serve``), and ``--device``
(default ``cuda``, passed to every replica) takes the place of the JAX
CLI's ``--platform``.

Spawn two replicas of a trained checkpoint and route them::

    python -m distributed_tensorflow_tpu_torch.tools.serve_fleet \
        --logdir <run>/gpt_mini --replicas 2 --port 8700 \
        --device cpu --slots 4 --page_size 8 --num_pages 64 \
        --tenants "search:2,ads:1" --metrics_file fleet.jsonl \
        --state_file fleet.json

Each replica is a real ``tools/serve.py`` subprocess (the
single-program-multi-role pattern: the same serving binary plays replica
here and standalone server elsewhere) on an ephemeral port with a fleet
identity (``--replica_id r0, r1, ...``); the router frontend speaks the
unchanged ``ServeClient`` wire format on ``--port``, so callers cannot
tell a fleet from a single server.  ``--adopt URL[,URL...]`` skips
spawning and fronts already-running servers instead (mix with
``--replicas`` freely).

Autoscaling (``--autoscale_max`` > initial size arms it): the router
watches every member's ``/statz`` SLO burn state; a tenant burning for
``--burn_sustain_s`` spawns a new replica from the SAME checkpoint plane
(it boots, restores, and joins mid-traffic — hot-swap-aware: a
``--hot_swap`` fleet's newcomers restore the newest verified
checkpoint, landing on the generation the fleet is converging to), and
a fleet idle for ``--idle_sustain_s`` drains and reaps one, never below
``--autoscale_min``.  ``--respawn`` replaces crashed members 1:1.

``--metrics_file`` writes the ROUTER's telemetry stream
(``kind="route"`` per caller request, ``kind="fleet"`` membership /
autoscale events) — ``summarize_run --check`` gates it; per-replica
streams land next to it as ``<metrics_file>.<replica_id>`` when
``--replica_metrics`` is set.  ``--state_file`` maintains a JSON map of
members (id, url, state, pid) for watchers and kill-a-replica chaos
drills (the CI fleet gate SIGKILLs a pid from this file).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--logdir",
                        help="run directory containing checkpoints/ "
                             "(each replica restores from it)")
    parser.add_argument("--replicas", type=int, default=2,
                        help="replicas to spawn at startup")
    parser.add_argument("--adopt", default="",
                        help="comma list of running server URLs to "
                             "front instead of (or besides) spawning")
    parser.add_argument("--port", type=int, default=8700,
                        help="router frontend port (0 = ephemeral)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of every spawned replica "
                             "(cuda raises without a card; cpu for a "
                             "CPU run)")
    # Engine/tenant knobs forwarded verbatim to every spawned replica.
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--page_size", type=int, default=16)
    parser.add_argument("--num_pages", type=int, default=256)
    parser.add_argument("--max_pages_per_seq", type=int, default=8)
    parser.add_argument("--quantize", default="")
    parser.add_argument("--kv_dtype", default="")
    parser.add_argument("--spec_k", type=int, default=0)
    parser.add_argument("--prefill_chunk", type=int, default=0)
    parser.add_argument("--tenants", default="")
    parser.add_argument("--max_queue", type=int, default=64)
    parser.add_argument("--request_timeout_s", type=float, default=120.0)
    parser.add_argument("--slo", default="",
                        help="per-tenant objectives each replica "
                             "evaluates (the autoscaler's burn signal)")
    parser.add_argument("--slo_short_window_s", type=float, default=60.0)
    parser.add_argument("--slo_long_window_s", type=float, default=600.0)
    parser.add_argument("--slo_emit_every_s", type=float, default=2.0)
    parser.add_argument("--hot_swap", action="store_true",
                        help="replicas watch the checkpoint plane and "
                             "hot-swap newer verified checkpoints")
    # Router knobs.
    parser.add_argument("--poll_s", type=float, default=1.0,
                        help="member health/statz poll cadence")
    parser.add_argument("--spill_margin", type=float, default=2.0,
                        help="tenant-affinity spill threshold (load "
                             "units; see serving/router.py)")
    parser.add_argument("--fail_after", type=int, default=2,
                        help="consecutive probe failures before a "
                             "member is declared dead")
    parser.add_argument("--respawn", action="store_true",
                        help="replace dead members 1:1")
    parser.add_argument("--autoscale_min", type=int, default=0,
                        help="autoscale floor (default: initial size)")
    parser.add_argument("--autoscale_max", type=int, default=0,
                        help="autoscale ceiling; > initial size arms "
                             "the SLO-burn autoscaler")
    parser.add_argument("--burn_sustain_s", type=float, default=6.0,
                        help="SLO burn must sustain this long to scale "
                             "up (flapping never scales)")
    parser.add_argument("--idle_sustain_s", type=float, default=60.0,
                        help="fleet-wide idle must sustain this long "
                             "to scale down")
    parser.add_argument("--cooldown_s", type=float, default=30.0,
                        help="quiet window after any scale action")
    # Artifacts.
    parser.add_argument("--metrics_file", default=None,
                        help="router telemetry stream (route/fleet "
                             "records; summarize_run --check input); "
                             "also arms route.fleet span tracing")
    parser.add_argument("--replica_metrics", action="store_true",
                        help="give each replica its own stream at "
                             "<metrics_file>.<replica_id>")
    parser.add_argument("--trace_sample_rate", type=float, default=None,
                        metavar="RATE",
                        help="arm tail-based trace sampling on this "
                             "router AND every spawned replica "
                             "(serving/trace_buffer.py; 0 = tail-only)")
    parser.add_argument("--trace_buffer_cap", type=int, default=256,
                        help="tail-sampling ring bound (distinct "
                             "in-flight traces)")
    parser.add_argument("--coord", default="", metavar="HOST:PORT",
                        help="coordination service to stamp a "
                             "clock_sync record against (observer) — "
                             "aligns router spans with worker/replica "
                             "rows in export_trace")
    parser.add_argument("--state_file", default=None,
                        help="maintained JSON fleet map (members, "
                             "urls, pids) for watchers/chaos drills")
    parser.add_argument("--cell", default="",
                        help="cell this fleet belongs to (stamped on "
                             "the state file and every member entry — "
                             "faults.kill_cell's targeting key)")
    parser.add_argument("--fleet_dir", default=None,
                        help="replica log directory (default: a "
                             "tempdir, or the metrics file's dir)")
    args = parser.parse_args(argv)

    if not args.logdir and not args.adopt:
        parser.error("--logdir is required (or --adopt URLs)")
    if args.replicas and not args.logdir:
        parser.error("spawning replicas needs --logdir")

    from ..serving.router import AutoscalePolicy, Router
    from ..serving.slo import parse_slos
    from ..serving.trace_buffer import (TailSampler, TraceBuffer,
                                        slow_thresholds)
    from ..utils import tracing
    from ..utils.metrics import MetricsLogger
    from ..utils.telemetry import SCHEMA_VERSION, Telemetry

    fleet_dir = args.fleet_dir or (
        os.path.dirname(os.path.abspath(args.metrics_file))
        if args.metrics_file else tempfile.mkdtemp(prefix="dtf_fleet_"))
    os.makedirs(fleet_dir, exist_ok=True)

    logger = MetricsLogger(args.metrics_file)
    telemetry = Telemetry(logger)
    if args.metrics_file:
        # Cross-tier tracing (docs/observability.md): the fleet router
        # emits route.fleet/route.attempt spans on its own stream; with
        # --trace_sample_rate they park in a tail-sampling buffer until
        # each request's verdict is known.
        tracer = tracing.install(tracing.Tracer(
            telemetry,
            run_id=f"fleet-{args.cell}" if args.cell else "fleet"))
        if args.trace_sample_rate is not None:
            tracer.buffer = TraceBuffer(
                telemetry,
                TailSampler(args.trace_sample_rate,
                            slow_ms=slow_thresholds(
                                parse_slos(args.slo))),
                tier="fleet", capacity=args.trace_buffer_cap)
    if args.coord and args.metrics_file:
        # Clock alignment (same record workers and replicas stamp): the
        # router's spans join the one coordination-server timeline in
        # export_trace instead of floating on an uncalibrated clock.
        from ..cluster.coordination import (CoordinationClient,
                                            CoordinationError)
        host, _, port = args.coord.partition(",")[0].rpartition(":")
        if host and port.isdigit():
            try:
                cc = CoordinationClient.observer(host, int(port))
                try:
                    offset_s, rtt_s = cc.clock_offset()
                    telemetry.emit(
                        "clock_sync", step=0,
                        offset_ms=round(offset_s * 1000.0, 3),
                        rtt_ms=round(rtt_s * 1000.0, 3),
                        t_unix=round(time.time(), 6),
                        source="coord_time")
                finally:
                    cc.close()
            except CoordinationError:
                pass    # unaligned beats unrouted; export falls back

    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    spawn_lock = threading.Lock()
    spawn_seq = [0]

    def spawn_replica() -> tuple[str, str, subprocess.Popen]:
        """One replica subprocess on a fresh port; the router adopts it
        as ``starting`` and routes to it once /healthz turns ok."""
        with spawn_lock:
            rid = f"r{spawn_seq[0]}"
            spawn_seq[0] += 1
        port = _free_port()
        cmd = [sys.executable, "-m",
               "distributed_tensorflow_tpu_torch.tools.serve",
               "--logdir", args.logdir, "--port", str(port),
               "--replica_id", rid, "--device", args.device,
               "--slots", str(args.slots),
               "--page_size", str(args.page_size),
               "--num_pages", str(args.num_pages),
               "--max_pages_per_seq", str(args.max_pages_per_seq),
               "--max_queue", str(args.max_queue),
               "--request_timeout_s", str(args.request_timeout_s),
               "--slo_short_window_s", str(args.slo_short_window_s),
               "--slo_long_window_s", str(args.slo_long_window_s),
               "--slo_emit_every_s", str(args.slo_emit_every_s)]
        if args.quantize:
            cmd += ["--quantize", args.quantize]
        if args.kv_dtype:
            cmd += ["--kv_dtype", args.kv_dtype]
        if args.spec_k:
            cmd += ["--spec_k", str(args.spec_k)]
        if args.prefill_chunk:
            cmd += ["--prefill_chunk", str(args.prefill_chunk)]
        if args.tenants:
            cmd += ["--tenants", args.tenants]
        if args.slo:
            cmd += ["--slo", args.slo]
        if args.hot_swap:
            cmd += ["--hot_swap"]
        if args.metrics_file and args.replica_metrics:
            cmd += ["--metrics_file", f"{args.metrics_file}.{rid}"]
            if args.trace_sample_rate is not None:
                cmd += ["--trace_sample_rate",
                        str(args.trace_sample_rate),
                        "--trace_buffer_cap", str(args.trace_buffer_cap)]
            if args.coord:
                # First endpoint of a possibly comma-separated spec —
                # serve.py takes a single HOST:PORT observer target.
                cmd += ["--coord", args.coord.partition(",")[0]]
        log_path = os.path.join(fleet_dir, f"replica-{rid}.log")
        log = open(log_path, "w")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        with spawn_lock:
            procs[rid] = proc
            logs[rid] = log_path
        return rid, f"http://127.0.0.1:{port}", proc

    def reap_replica(member) -> None:
        proc = member.handle
        if proc is None:
            return
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15.0)
        except subprocess.TimeoutExpired:
            proc.kill()

    initial = args.replicas + len([u for u in args.adopt.split(",") if u])
    autoscale = None
    if args.autoscale_max:
        autoscale = AutoscalePolicy(
            min_replicas=args.autoscale_min or max(1, initial),
            max_replicas=args.autoscale_max,
            burn_sustain_s=args.burn_sustain_s,
            idle_sustain_s=args.idle_sustain_s,
            cooldown_s=args.cooldown_s)

    router = Router(
        port=args.port, telemetry=telemetry, poll_s=args.poll_s,
        spill_margin=args.spill_margin, fail_after=args.fail_after,
        request_timeout_s=args.request_timeout_s, autoscale=autoscale,
        spawn_fn=spawn_replica if args.logdir else None,
        reap_fn=reap_replica, respawn=args.respawn)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    def write_state() -> None:
        if not args.state_file or router._http is None:
            return      # not started (or crashed pre-start): no URL yet
        snap = router.fleet_snapshot()
        with spawn_lock:
            pids = {rid: p.pid for rid, p in procs.items()}
        state = {
            "router_url": f"http://127.0.0.1:{router.port}",
            "cell": args.cell or None,
            "members": [
                {"id": m["id"], "url": m["url"], "state": m["state"],
                 "cell": args.cell or None,
                 "pid": pids.get(m["id"]),
                 "log": logs.get(m["id"])}
                for m in snap["members"]],
        }
        tmp = args.state_file + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(state, fh, indent=2)
        os.replace(tmp, args.state_file)

    # Everything past here runs under the reap-all finally: a crash
    # between the first spawn and steady state must not orphan replica
    # subprocesses.
    try:
        for url in filter(None,
                          (u.strip() for u in args.adopt.split(","))):
            router.add_replica(url)
        for _ in range(args.replicas):
            rid, url, proc = spawn_replica()
            router.add_replica(url, handle=proc, replica_id=rid)

        telemetry.emit(
            "run_meta", schema_version=SCHEMA_VERSION, role="router",
            cell=args.cell, logdir=args.logdir or "", replicas=initial,
            autoscale_min=autoscale.min_replicas if autoscale else 0,
            autoscale_max=autoscale.max_replicas if autoscale else 0,
            respawn=args.respawn, slo=args.slo, tenants=args.tenants)

        router.start()
        print(f"routing fleet on :{router.port} — {initial} replica(s)"
              + (f" from {args.logdir}" if args.logdir else "")
              + (f", autoscale {autoscale.min_replicas}.."
                 f"{autoscale.max_replicas}" if autoscale else "")
              + (", respawn armed" if args.respawn else ""), flush=True)
        while not stop.is_set():
            write_state()
            stop.wait(1.0)
    finally:
        router.shutdown()
        with spawn_lock:
            live = list(procs.values())
        for proc in live:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in live:
            try:
                proc.wait(timeout=15.0)
            except subprocess.TimeoutExpired:
                proc.kill()
        write_state()
        telemetry.emit_summary(step=0, role="router")
        logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
