"""Live serving watcher — the ``watch_run`` of the serving tier
(docs/observability.md, "Serving tracing & SLOs").

Copied from ``distributed_tensorflow_tpu/tools/watch_serve.py`` (standard
library only; the port's imports).

Polls a RUNNING serving process's ``/statz`` (no file access, no load on
the engine loop — handler threads snapshot under their own locks) and
renders a per-tenant table plus the SLO burn state:

- per-tenant **QPS** (completions over the SLO short window),
  **TTFT/TPOT p50/p95/p99**, queue depth + high-water mark, 429
  rejections, abandoned-caller retirements, tokens served;
- engine occupancy: slots, KV-pool pages in use / peak / fragmentation,
  speculative acceptance, the model step being served (hot-swap aware);
- **SLO burn-rate flags** — every objective's short/long-window burn
  rate, ``BURNING`` when both windows exceed the alert threshold (the
  multi-window rule of ``serving/slo.py``).

Usage::

    python -m distributed_tensorflow_tpu_torch.tools.watch_serve \
        --url http://127.0.0.1:8700 [--interval 2] [--once] [--json]

``--once --json`` emits one machine-readable snapshot (the ``/statz``
payload verbatim) — the CI smoke gate asserts the injected-breach burn
flag through it.

``--fleet`` points ``--url`` at a ROUTER (``serving/router.py`` /
``tools/serve_fleet.py``) and renders the aggregated fleet table from
its ``/fleetz`` member list instead: one row per replica (state, load,
engine/model step, slots, queue, served, failovers absorbed) plus the
router's routing/failover/autoscale counters — the whole tier in one
poll of one process.  ``--once --json`` emits the ``/fleetz`` payload
verbatim (the fleet CI gate's hook).

``--cells`` points ``--url`` at a GLOBAL router (``serving/cells.py``
/ ``tools/serve_cell.py``) and renders the cell table from its
``/cellz`` payload: one row per cell (state, load, replicas, queue,
served, fleet-wide burn flags) plus the global routing / failover /
re-home / blast-radius-throttle counters and the tenant-home map —
the whole fleet-of-fleets in one poll.  ``--once --json`` emits the
``/cellz`` payload verbatim (the cell drill gate's hook).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any

from .watch_common import add_watch_args, watch_loop


def _pcts(hist: dict | None) -> str:
    """``p50/p95/p99`` column from a histogram snapshot dict."""
    if not hist or not hist.get("count"):
        return "-"
    return (f"{hist['p50']:.0f}/{hist['p95']:.0f}/{hist['p99']:.0f}")


def render(stats: dict[str, Any], print_fn=print) -> None:
    """One ``/statz`` snapshot as the live table (pure; the test hook)."""
    eng = stats.get("engine", {})
    pool = eng.get("kv_pool", {})
    stamp = time.strftime("%H:%M:%S")
    print_fn(f"--- serving @ {stamp}: engine step "
             f"{eng.get('engine_step')}, model step "
             f"{eng.get('model_step')} ({eng.get('swaps', 0)} swap(s)) "
             f"---")
    print_fn(f"slots {eng.get('active_slots')}/{eng.get('num_slots')}; "
             f"kv pages {pool.get('pages_in_use')}/"
             f"{pool.get('num_pages')} (peak {pool.get('peak_in_use')}, "
             f"frag {pool.get('internal_fragmentation')}); "
             f"queue depth {stats.get('queue_depth')} "
             f"(hwm {stats.get('queue_depth_hwm')})")
    slo = stats.get("slo") or {}
    qps = slo.get("tenant_qps", {})
    lat = stats.get("tenant_latency", {})
    tenants = stats.get("tenants", {})
    if tenants:
        print_fn(f"{'tenant':<12} {'qps':>6} {'ttft p50/95/99':>15} "
                 f"{'tpot p50/95/99':>15} {'queued':>7} {'hwm':>4} "
                 f"{'429':>5} {'aband':>6} {'tokens':>8}")
        for name, t in tenants.items():
            tl = lat.get(name, {})
            print_fn(
                f"{name:<12} "
                f"{qps.get(name, 0.0):>6.2f} "
                f"{_pcts(tl.get('serve_ttft_ms')):>15} "
                f"{_pcts(tl.get('serve_tpot_ms')):>15} "
                f"{t['queued']:>7} {t.get('queued_hwm', 0):>4} "
                f"{t.get('rejected', 0):>5} {t.get('abandoned', 0):>6} "
                f"{t['served_tokens']:>8}")
    counters = stats.get("counters", {})
    if counters.get("serve_spec_tokens"):
        print_fn(f"speculation: {counters['serve_spec_tokens']} accepted "
                 f"token(s), spec_rows last step {eng.get('spec_rows')}")
    objectives = slo.get("objectives", [])
    if objectives:
        print_fn(f"slo (burn alert at >= {slo.get('burn_threshold')}x "
                 f"budget over {slo.get('window_short_s')}s AND "
                 f"{slo.get('window_long_s')}s):")
        for o in objectives:
            flag = "BURNING" if o["burning"] else "ok"
            print_fn(f"  [{flag:>7}] {o['tenant']:<12} "
                     f"{o['objective']:<22} burn {o['burn_short']:>7.2f} "
                     f"(short) {o['burn_long']:>7.2f} (long)  "
                     f"bad {o['bad_long']}/{o['bad_long'] + o['good_long']}"
                     )
        ever = slo.get("ever_burning")
        if ever:
            print_fn(f"  ever burned: {ever}")


def render_fleet(snapshot: dict[str, Any], print_fn=print) -> None:
    """One ``/fleetz`` snapshot as the aggregated fleet table (pure)."""
    router = snapshot.get("router", {})
    members = snapshot.get("members", [])
    stamp = time.strftime("%H:%M:%S")
    print_fn(f"--- fleet @ {stamp}: {router.get('replicas', 0)} "
             f"replica(s), {router.get('healthy', 0)} healthy, "
             f"{router.get('dead', 0)} dead ---")
    print_fn(f"routed {router.get('routed', 0)} "
             f"(served {router.get('served', 0)}, failed "
             f"{router.get('failed', 0)}); failovers "
             f"{router.get('failovers', 0)} (max gap "
             f"{router.get('max_failover_ms', 0)}ms), spills "
             f"{router.get('spills', 0)}, respawns "
             f"{router.get('respawns', 0)}; fleet queue "
             f"{router.get('queue_depth', 0)}, active slots "
             f"{router.get('active_slots', 0)}")
    if members:
        print_fn(f"{'replica':<8} {'state':<9} {'load':>6} "
                 f"{'slots':>7} {'queue':>6} {'estep':>7} {'mstep':>6} "
                 f"{'gen':>4} {'served':>7} {'failov':>7} {'uptime':>8}")
        for m in members:
            rep = m.get("replica") or {}
            slots = (f"{m.get('active_slots')}/{m.get('num_slots')}"
                     if m.get("num_slots") is not None else "-")
            up = rep.get("uptime_s")
            print_fn(
                f"{m['id']:<8} {m['state']:<9} {m.get('load', 0):>6} "
                f"{slots:>7} "
                f"{m.get('queue_depth') if m.get('queue_depth') is not None else '-':>6} "
                f"{m.get('engine_step') if m.get('engine_step') is not None else '-':>7} "
                f"{m.get('model_step') if m.get('model_step') is not None else '-':>6} "
                f"{rep.get('engine_generation', '-'):>4} "
                f"{m.get('served', 0):>7} "
                f"{m.get('failovers_absorbed', 0):>7} "
                f"{(str(up) + 's') if up is not None else '-':>8}")
    affinity = router.get("tenant_affinity") or {}
    if affinity:
        print_fn("tenant affinity: " + ", ".join(
            f"{t}->{r}" for t, r in sorted(affinity.items())))
    burning = sorted({
        flag for m in members
        for flag in ((m.get("statz") or {}).get("slo") or {})
        .get("burning", ())})
    if burning:
        print_fn(f"BURNING (fleet-wide): {burning}")
    auto = router.get("autoscale")
    if auto:
        print_fn(f"autoscale: {auto['min_replicas']}.."
                 f"{auto['max_replicas']} replicas, last action "
                 f"{auto.get('last_action')}")


def render_cells(snapshot: dict[str, Any], print_fn=print) -> None:
    """One ``/cellz`` snapshot as the global cell table (pure)."""
    glob = snapshot.get("global", {})
    cells = snapshot.get("cells", [])
    stamp = time.strftime("%H:%M:%S")
    print_fn(f"--- cells @ {stamp}: {glob.get('cells', 0)} cell(s), "
             f"{glob.get('healthy_cells', 0)} healthy, "
             f"{glob.get('dead_cells', 0)} dead ---")
    print_fn(f"routed {glob.get('routed', 0)} "
             f"(served {glob.get('served', 0)}, failed "
             f"{glob.get('failed', 0)}); failovers "
             f"{glob.get('failovers', 0)}, re-homes "
             f"{glob.get('rehomes', 0)} (returns "
             f"{glob.get('returns', 0)}), throttle 429s "
             f"{glob.get('throttle_rejected', 0)}, max failover gap "
             f"{glob.get('max_failover_gap_ms', 0)}ms; policy "
             f"{glob.get('rehome_policy', '?')}")
    if cells:
        print_fn(f"{'cell':<10} {'state':<9} {'load':>6} {'repl':>5} "
                 f"{'healthy':>8} {'queue':>6} {'slots':>6} "
                 f"{'inflt':>6} {'served':>7} {'burning':<20}")
        for c in cells:
            burning = ",".join(c.get("burning") or ()) or "-"
            print_fn(
                f"{c['cell']:<10} {c['state']:<9} "
                f"{c.get('load', 0):>6} "
                f"{c.get('replicas') if c.get('replicas') is not None else '-':>5} "
                f"{c.get('healthy') if c.get('healthy') is not None else '-':>8} "
                f"{c.get('queue_depth') if c.get('queue_depth') is not None else '-':>6} "
                f"{c.get('active_slots') if c.get('active_slots') is not None else '-':>6} "
                f"{c.get('in_flight', 0):>6} {c.get('served', 0):>7} "
                f"{burning:<20}")
    homes = glob.get("tenant_homes") or {}
    if homes:
        print_fn("tenant homes: " + ", ".join(
            f"{t}->{c}" for t, c in sorted(homes.items())))
    displaced = glob.get("displaced") or {}
    if displaced:
        print_fn("displaced (origin): " + ", ".join(
            f"{t}<-{c}" for t, c in sorted(displaced.items())))
    throttle = glob.get("throttle")
    if throttle:
        print_fn(f"throttle: bound {throttle['bound']} / "
                 f"{throttle['window_s']:g}s window, "
                 f"{throttle['admitted']} admitted, "
                 f"{throttle['rejected']} rejected"
                 + (f", active {throttle['throttled_tenants']}"
                    if throttle.get("throttled_tenants") else ""))


def watch(url: str, interval: float, once: bool, as_json: bool,
          fleet: bool = False, cells: bool = False) -> int:
    from ..serving.client import ServeClient

    client = ServeClient(url, timeout_s=10.0, retries=0)
    if cells:
        return watch_loop(client.cellz, render_cells, interval=interval,
                          once=once, as_json=as_json,
                          describe=f"global router at {url}",
                          tool="watch_serve --cells")
    if fleet:
        return watch_loop(client.fleetz, render_fleet, interval=interval,
                          once=once, as_json=as_json,
                          describe=f"router at {url}",
                          tool="watch_serve --fleet")
    return watch_loop(client.stats, render, interval=interval, once=once,
                      as_json=as_json, describe=f"server at {url}",
                      tool="watch_serve")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--url", required=True, metavar="URL",
                        help="serving server base URL "
                             "(e.g. http://127.0.0.1:8700)")
    parser.add_argument("--fleet", action="store_true",
                        help="--url is a router: render the aggregated "
                             "fleet table from its /fleetz member list")
    parser.add_argument("--cells", action="store_true",
                        help="--url is a GLOBAL router: render the "
                             "cell table from its /cellz payload")
    add_watch_args(parser)
    args = parser.parse_args(argv)
    try:
        return watch(args.url, args.interval, args.once, args.json,
                     fleet=args.fleet, cells=args.cells)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
