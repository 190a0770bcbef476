"""Serving CLI — a continuous-batching multi-tenant decode server over a
trained checkpoint: the counterpart of ``distributed_tensorflow_tpu/
tools/serve.py`` (docs/serving.md), on the port's engine and kernels.

Serve the newest checkpoint of a GPT run::

    python -m distributed_tensorflow_tpu_torch.tools.serve \
        --logdir <run>/gpt_mini --port 8700 [--device cpu] \
        --slots 8 --page_size 16 --num_pages 256 \
        --quantize int8 --kv_dtype float8 --spec_k 8 \
        --tenants "search:2,ads:1" --metrics_file serve.jsonl \
        --hot_swap

    curl -d '{"prompt": [10, 11, 12], "num_tokens": 16,
              "tenant": "search"}' localhost:8700/generate

The server runs the LIVE model with one decode step over a slot batch
and a paged KV pool: sequences are admitted and retired per step
(continuous batching), tenants get weighted-fair slots with bounded queues
(429 backpressure), and ``--hot_swap`` watches the run's checkpoint plane
— verifying integrity manifests first — to swap new weights in between
steps without dropping in-flight streams.  The checkpoint is one the JAX
trainer or :func:`.checkpoint_io.save_raw` wrote; its widths and
architecture come from the tree (:func:`load_gpt_serving_model`), and the
model runs the hand-written kernels: flash attention (K1) in every
prefill, the LayerNorm kernel (K3) in every LayerNorm.  ``--device``
(default ``cuda``, which raises without a card) takes the place of the
JAX CLI's ``--platform``.  ``--coord host:port`` additionally consults
the coordination KV's init-done key as a cheap newest-step hint (the
chief republishes it at every durable save) and stamps one
``clock_sync`` record against that service.  On a clean exit (SIGTERM
or SIGINT) the CLI prints one line, ``kernel launches {json}``: every
hand-written kernel's launches in this process (zeros on the CPU, where
the kernels' plain versions run).

``--watch http://host:port`` turns the CLI into a live observer of a
RUNNING server (``watch_run``-style table over ``/statz``): per-tenant
queue/admission/service, slot + KV-pool occupancy, TTFT/TPOT percentiles,
the model step being served.

With ``--metrics_file`` the server writes the standard telemetry stream
(``kind="serve_step"`` / ``"serve_request"`` / ``"model_swap"`` /
``"slo"`` / ``"serve_tenant"`` plus per-request ``kind="span"`` traces —
``tools/export_trace.py`` renders them in the same Perfetto timeline as
training workers) that ``tools/summarize_run.py`` rolls into a serving
report and CI gates on with ``--check``; the crash flight recorder is
armed at ``<metrics_file>.flight``.  ``--slo`` declares per-tenant
objectives (``serving/slo.py``) surfaced via ``GET /metricz``
(Prometheus text) and ``tools/watch_serve.py`` (live burn-rate table).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


def load_gpt_serving_model(logdir: str, step: int | None = None,
                           gpt_positions: str = "auto"):
    """``(cfg, plain_params_tree, global_step)`` from a run directory.

    Layout-agnostic like the export path (raw restore; EMA preferred;
    pipelined trees merged; widths, vocab, GQA, swiglu and rmsnorm
    inferred from the tree itself) — ONE restore recipe shared by startup
    and every hot swap.  ``logdir`` is the directory containing
    ``checkpoints/``.  The tree keeps the JAX package's names (CPU
    tensors; :func:`..models.gpt.params_from_jax` maps it to the model's),
    and ``cfg`` runs the kernels (:func:`.export_model.kernel_config`)."""
    from .export_model import _gpt_tree_and_cfg, _restore_raw, kernel_config

    params, _, global_step = _restore_raw(os.path.abspath(logdir), step)
    cfg, tree = _gpt_tree_and_cfg(params, gpt_positions=gpt_positions)
    return kernel_config(cfg), tree, global_step


# ------------------------------------------------------------------ watch


def render_statz(stats: dict, print_fn=print) -> None:
    """One ``/statz`` snapshot as a watch_run-style table."""
    eng = stats.get("engine", {})
    pool = eng.get("kv_pool", {})
    stamp = time.strftime("%H:%M:%S")
    print_fn(f"--- serving @ {stamp}: engine step {eng.get('engine_step')}, "
             f"model step {eng.get('model_step')} "
             f"({eng.get('swaps', 0)} swap(s)) ---")
    print_fn(f"slots {eng.get('active_slots')}/{eng.get('num_slots')} "
             f"active; kv pages {pool.get('pages_in_use')}/"
             f"{pool.get('num_pages')} "
             f"(util {pool.get('utilization')}, frag "
             f"{pool.get('internal_fragmentation')}); "
             f"queue depth {stats.get('queue_depth')}")
    tenants = stats.get("tenants", {})
    if tenants:
        print_fn(f"{'tenant':<12} {'weight':>6} {'queued':>7} "
                 f"{'admitted':>9} {'done':>6} {'rejected':>9} "
                 f"{'tokens':>8}")
        for name, t in tenants.items():
            print_fn(f"{name:<12} {t['weight']:>6} {t['queued']:>7} "
                     f"{t['admitted']:>9} {t['completed']:>6} "
                     f"{t['rejected']:>9} {t['served_tokens']:>8}")
    lat = stats.get("latency", {})
    parts = []
    for key, label in (("serve_ttft_ms", "ttft"),
                       ("serve_tpot_ms", "tpot"),
                       ("serve_step_ms", "step")):
        h = lat.get(key) or {}
        if h.get("count"):
            parts.append(f"{label} p50={h['p50']}ms p95={h['p95']}ms")
    if parts:
        print_fn("latency: " + "; ".join(parts))


def watch_loop(url: str, interval: float, once: bool,
               as_json: bool) -> int:
    from ..serving.client import ServeClient
    from .watch_common import watch_loop as shared_watch_loop

    # retries=0: the watch loop owns retry cadence — a down server must
    # report unreachable on THIS tick, not after a backoff window.
    client = ServeClient(url, timeout_s=10.0, retries=0)
    return shared_watch_loop(
        client.stats, render_statz, interval=interval, once=once,
        as_json=as_json, describe=f"server at {url}",
        tool="serve --watch")


# ------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--logdir",
                        help="run directory containing checkpoints/")
    parser.add_argument("--step", type=int, default=None,
                        help="serve this checkpoint step (default newest)")
    parser.add_argument("--port", type=int, default=8700)
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (cuda raises "
                             "without a card; cpu for a CPU run)")
    parser.add_argument("--slots", type=int, default=8,
                        help="resident decode lanes (batch dim)")
    parser.add_argument("--page_size", type=int, default=16,
                        help="token slots per KV page")
    parser.add_argument("--num_pages", type=int, default=256,
                        help="KV pool pages per layer")
    parser.add_argument("--max_pages_per_seq", type=int, default=8,
                        help="page-table width (caps sequence length)")
    parser.add_argument("--quantize", default="",
                        help="weight storage: '' | int8")
    parser.add_argument("--kv_dtype", default="",
                        help="KV pool dtype: '' | bfloat16 | float8")
    parser.add_argument("--spec_k", type=int, default=0,
                        help="speculative decode arm: chunk width of the "
                             "paged verify step (0 = off, >= 2 enables; "
                             "requests opt in with 'speculative': true)")
    parser.add_argument("--spec_ngram", type=int, default=3,
                        help="prompt-lookup draft n-gram order (--spec_k)")
    parser.add_argument("--prefill_chunk", type=int, default=0,
                        help="chunked prefill: a prefilling lane advances "
                             "this many prompt tokens per engine step "
                             "while other lanes keep decoding (0 = "
                             "whole-bucket prefill at admission; see "
                             "docs/serving.md#chunked-prefill)")
    parser.add_argument("--prefill_cache_cap", type=int, default=8,
                        help="LRU bound on resident per-bucket prefill "
                             "programs (the serve_compile_cache gauge)")
    parser.add_argument("--tenants", default="",
                        help="tenant config 'name[:weight[:max_queue]],...'"
                             " (unknown tenants self-register at defaults)")
    parser.add_argument("--max_queue", type=int, default=64,
                        help="per-tenant queue bound for self-registered "
                             "tenants (backpressure -> HTTP 429)")
    parser.add_argument("--request_timeout_s", type=float, default=120.0,
                        help="503 a request that waits longer than this")
    parser.add_argument("--replica_id", default="",
                        help="fleet identity stamped on /statz//healthz "
                             "(tools/serve_fleet.py sets r0, r1, ...; "
                             "standalone servers may leave it empty)")
    parser.add_argument("--metrics_file", default=None,
                        help="telemetry JSONL stream (summarize_run "
                             "input); also arms request tracing and the "
                             "<file>.flight crash recorder")
    parser.add_argument("--trace_sample_rate", type=float, default=None,
                        metavar="RATE",
                        help="arm tail-based trace sampling "
                             "(serving/trace_buffer.py): request spans "
                             "buffer until retirement, kept only for "
                             "slow/errored/failed-over/429'd requests "
                             "or the head-sampled RATE (0..1; 0 = "
                             "tail-only).  Default: off — every span "
                             "emits directly")
    parser.add_argument("--trace_buffer_cap", type=int, default=256,
                        help="tail-sampling ring bound (distinct "
                             "in-flight traces; overflow degrades to "
                             "head sampling)")
    parser.add_argument("--slo", default="",
                        help="per-tenant objectives "
                             "'tenant:ttft_p95_ms<=50,...' "
                             "(serving/slo.py grammar; tenant * = all)")
    parser.add_argument("--slo_short_window_s", type=float, default=60.0,
                        help="SLO short burn window (seconds)")
    parser.add_argument("--slo_long_window_s", type=float, default=600.0,
                        help="SLO long burn window (seconds)")
    parser.add_argument("--slo_burn_threshold", type=float, default=14.4,
                        help="alert when BOTH windows burn the error "
                             "budget at >= this rate")
    parser.add_argument("--slo_emit_every_s", type=float, default=2.0,
                        help="cadence of kind=\"slo\"/serve_tenant "
                             "telemetry records")
    parser.add_argument("--hot_swap", action="store_true",
                        help="watch the checkpoint plane and swap newer "
                             "verified checkpoints in without restarting")
    parser.add_argument("--swap_poll_s", type=float, default=2.0,
                        help="checkpoint-plane poll cadence (--hot_swap)")
    parser.add_argument("--coord", default="", metavar="HOST:PORT",
                        help="coordination service for the newest-step "
                             "hint (observer; never joins membership)")
    parser.add_argument("--watch", default="", metavar="URL",
                        help="observe a RUNNING server instead of serving")
    parser.add_argument("--interval", type=float, default=2.0,
                        help="--watch poll seconds")
    parser.add_argument("--once", action="store_true",
                        help="--watch: one snapshot and exit")
    parser.add_argument("--json", action="store_true",
                        help="--watch: emit JSON instead of the table")
    args = parser.parse_args(argv)

    if args.watch:
        return watch_loop(args.watch, args.interval, args.once, args.json)
    if not args.logdir:
        parser.error("--logdir is required (or use --watch URL)")

    from ..utils.device import cli_device
    device = cli_device(args.device)

    from ..models import gpt as gpt_lib
    from ..ops.kernels import launch_counts
    from ..serving.engine import DecodeEngine, EngineConfig
    from ..serving.hot_swap import ModelWatcher
    from ..serving.scheduler import FairScheduler, parse_tenants
    from ..serving.server import ServingServer
    from ..serving.slo import SloEngine, parse_slos
    from ..utils import tracing
    from ..utils.metrics import MetricsLogger
    from ..utils.telemetry import SCHEMA_VERSION, Telemetry

    def load_params(step):
        return gpt_lib.params_from_jax(
            load_gpt_serving_model(args.logdir, step)[1])

    cfg, tree, global_step = load_gpt_serving_model(args.logdir, args.step)
    model = gpt_lib.GptLM(cfg, device=device)
    # The restore is layout-agnostic (vocab/GQA/swiglu inferred from the
    # tree), so the served model's name is the checkpoint namespace the
    # trainer wrote (<logdir>/<model>/checkpoints), not a constant.
    model_name = os.path.basename(os.path.normpath(args.logdir)) or "gpt"
    logger = MetricsLogger(args.metrics_file)
    telemetry = Telemetry(logger)
    if args.metrics_file:
        # Request-level tracing (docs/observability.md, "Serving tracing
        # & SLOs"): every request becomes one "<run>/req<id>" trace in
        # the stream, and the crash flight recorder is armed so a dead
        # server leaves its last records next to the stream.
        tracing.install(tracing.Tracer(telemetry,
                                       run_id=f"serve-{model_name}"))
        telemetry.enable_flight_recorder(args.metrics_file + ".flight")
    engine = DecodeEngine(
        model, gpt_lib.params_from_jax(tree),
        EngineConfig(num_slots=args.slots, page_size=args.page_size,
                     num_pages=args.num_pages,
                     max_pages_per_seq=args.max_pages_per_seq,
                     quantize=args.quantize, kv_dtype=args.kv_dtype,
                     spec_k=args.spec_k, spec_ngram=args.spec_ngram,
                     prefill_chunk=args.prefill_chunk,
                     prefill_cache_cap=args.prefill_cache_cap),
        telemetry=telemetry, device=device)
    engine.model_step = global_step
    scheduler = FairScheduler(parse_tenants(args.tenants),
                              default_max_queue=args.max_queue)
    # The SLO engine always runs (it also feeds per-tenant QPS to
    # watch_serve); objectives come from --slo, possibly none.
    slo = SloEngine(parse_slos(args.slo),
                    short_window_s=args.slo_short_window_s,
                    long_window_s=args.slo_long_window_s,
                    burn_threshold=args.slo_burn_threshold)
    buffer = None
    if args.trace_sample_rate is not None and args.metrics_file:
        from ..serving.trace_buffer import (TailSampler, TraceBuffer,
                                            slow_thresholds)
        buffer = TraceBuffer(
            telemetry,
            TailSampler(args.trace_sample_rate,
                        slow_ms=slow_thresholds(slo.objectives)),
            tier="engine", capacity=args.trace_buffer_cap)
        tracing.active().buffer = buffer
    server = ServingServer(
        engine, scheduler, port=args.port,
        request_timeout_s=args.request_timeout_s, telemetry=telemetry,
        slo=slo, slo_emit_every_s=args.slo_emit_every_s,
        replica_id=args.replica_id, trace_buffer=buffer,
        meta={"model": model_name, "vocab_size": cfg.vocab_size,
              "num_layers": cfg.num_layers})
    telemetry.emit("run_meta", schema_version=SCHEMA_VERSION,
                   role="serve", replica_id=args.replica_id,
                   model=model_name,
                   model_step=global_step, vocab_size=cfg.vocab_size,
                   num_slots=args.slots, page_size=args.page_size,
                   num_pages=args.num_pages, quantize=args.quantize,
                   kv_dtype=args.kv_dtype, spec_k=args.spec_k,
                   prefill_chunk=args.prefill_chunk, slo=args.slo)

    coord_client = None
    watcher = None
    if args.coord:
        from ..cluster.coordination import (CoordinationClient,
                                            CoordinationError)
        host, _, port = args.coord.rpartition(":")
        if not host or not port.isdigit():
            parser.error(f"--coord must be HOST:PORT, got "
                         f"{args.coord!r}")
        coord_client = CoordinationClient.observer(host, int(port))
        # Clock alignment for mixed train+serve traces: the serving
        # stream stamps the same clock_sync record training workers do,
        # so export_trace aligns serve spans onto the coordination
        # server's timeline alongside the training rows.
        try:
            offset_s, rtt_s = coord_client.clock_offset()
            telemetry.emit(
                "clock_sync", step=0,
                offset_ms=round(offset_s * 1000.0, 3),
                rtt_ms=round(rtt_s * 1000.0, 3),
                t_unix=round(time.time(), 6), source="coord_time")
        except CoordinationError:
            pass  # no alignment beats no serving; export falls back to 0
    if args.hot_swap:
        watcher = ModelWatcher(
            args.logdir, load_params, server.request_swap,
            initial_step=global_step, poll_s=args.swap_poll_s,
            coord_client=coord_client, telemetry=telemetry)
        watcher.start()

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    server.start()
    print(f"serving {model_name} (vocab {cfg.vocab_size}, "
          f"{cfg.num_layers} layers) step {global_step} from "
          f"{args.logdir} on :{server.port} — {args.slots} slots, "
          f"{args.num_pages} pages x {args.page_size}"
          + (f", quantize={args.quantize}" if args.quantize else "")
          + (f", kv_dtype={args.kv_dtype}" if args.kv_dtype else "")
          + (", hot-swap armed" if args.hot_swap else ""), flush=True)
    try:
        stop.wait()
    finally:
        if watcher is not None:
            watcher.close()
        if coord_client is not None:
            coord_client.close()
        server.shutdown()
        telemetry.emit_summary(step=engine.step_index, role="serve")
        logger.close()
        print(f"kernel launches {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
