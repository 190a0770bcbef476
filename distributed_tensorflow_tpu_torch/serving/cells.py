"""Cells — fleet-of-fleets behind one global router
(docs/serving.md, "Cells").

Copied from ``distributed_tensorflow_tpu/serving/cells.py`` (standard
library only; the port's imports).

PR 12's :class:`..serving.router.Router` made N replicas one endpoint;
PR 13/15 made the coordinator plane shardable and highly available.
But the composition was still ONE failure domain: a coordinator-plane
meltdown, an autoscale flap, or an abusive tenant hits every user at
once.  A **cell** is the isolation unit above the fleet: one
coordinator plane (with its warm standby) + one fleet router + N
replicas, launched as a unit (``tools/serve_cell.py``).  The
:class:`GlobalRouter` here fronts M cells and speaks the SAME wire
format a single server or a fleet router does (``POST /generate`` /
``GET /healthz`` / ``/statz``), so every existing
:class:`..serving.client.ServeClient` caller works unchanged — the
PR-12 router composing with itself, one level up.

Three policies, deliberately reusing the fleet router's pure pieces:

- **Tenant homes** — every tenant is *homed* on exactly one cell
  (sticky: decode-state locality, fairness books, and SLO windows all
  live in one cell).  Selection reuses :func:`..serving.router
  .choose_replica` with the home map as the affinity map and a HIGH
  spill margin: unlike replica affinity, a tenant leaving its home
  cell is an isolation event, not a load-balancing nicety.  The home
  map is persisted to EVERY reachable cell's coordination KV plane
  (seq-versioned, newest wins at recovery) so it survives both a
  global-router restart and the loss of any cell.
- **Cell failover** — a cell's router ``/healthz`` + ``/fleetz`` is
  the unit of aliveness.  ``fail_after`` consecutive probe failures
  (or a ``503 no_healthy_replica``) marks the cell dead: its tenants
  are re-homed onto surviving cells immediately, its in-flight
  forwards fail over with the PR-12 one-response guarantee (transport
  error → retry elsewhere; timeout → 503, NEVER re-sent), and the
  first re-homed request that completes records the **failover gap**
  (wall time from death to first served request) as ``kind="cell"``
  telemetry.  A cell that sustains SLO burn for ``burn_fail_s`` gets
  the same tenant re-home without being declared dead.  On recovery,
  ``rehome_policy`` decides: ``"sticky"`` leaves tenants where they
  landed; ``"return"`` sends displaced tenants back to their origin.
- **Blast radius** — failover load must not cascade: a dead cell's
  tenants arriving on the survivor could push IT into burn, and the
  next failover takes the whole tier down.  :class:`AdmissionThrottle`
  bounds each re-homed tenant to a small in-flight budget (the
  ``FairScheduler`` bound vocabulary: per-tenant cap, ``QueueFull`` →
  429) for a decaying window after the re-home.  Excess arrives as
  429 backpressure AT THE GLOBAL ROUTER — the surviving cell never
  sees it.

Telemetry: ``kind="cell"`` records (membership, ``cell_dead``,
``tenant_rehome``/``tenant_return``, ``failover_gap``,
``throttle_reject``, periodic ``poll``) — ``tools/summarize_run.py``
rolls them into a cells section and ``--check`` enforces the field
contract (``REQUIRED_CELL_FIELDS``); ``tools/watch_serve.py --cells``
renders the live global table from ``/cellz``.

The policy pieces (:func:`cell_load`, :class:`AdmissionThrottle`) are
pure and clock-injectable — unit-tested without sockets in
tests/test_cells.py.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any
import urllib.error
import urllib.request

from .router import choose_replica
from .scheduler import QueueFull, TenantConfig
from ..utils import tracing

#: Cell lifecycle: added -(healthz+fleetz ok)-> healthy
#: -(fail_after probes / no_healthy_replica)-> dead -(probe ok)-> healthy.
CELL_STATES = ("starting", "healthy", "dead")

#: States a new request may be routed to.
ROUTABLE_CELL_STATES = ("healthy",)

#: KV key the tenant-home map persists under, on every cell's plane.
HOME_KEY = "cells/tenant_homes"


# ---------------------------------------------------------- cell policy


def cell_load(statz: dict | None) -> float:
    """One cell's load figure from its fleet router's ``/statz``.

    Same shape as :func:`..serving.router.replica_load`, one level up:
    fleet-wide queue depth dominates (queued work is waiting NOW);
    active decode slots per healthy replica break ties among
    empty-queue cells.  A cell with no snapshot yet scores 0 (a
    freshly adopted cell should attract load)."""
    if not statz:
        return 0.0
    queue = statz.get("queue_depth") or 0
    healthy = statz.get("healthy") or 1
    active = (statz.get("active_slots") or 0) / max(1, healthy)
    return 2.0 * float(queue) + float(active)


class AdmissionThrottle:
    """Blast-radius bound for re-homed traffic.

    When a cell dies, its tenants' full arrival rate lands on the
    survivors at once — exactly the flash crowd that could cascade a
    second cell into SLO burn.  This throttle caps each *recently
    re-homed* tenant to ``bound`` concurrently in-flight requests
    through the global router for ``window_s`` seconds after its
    re-home; excess raises :class:`..serving.scheduler.QueueFull`
    (surfaced as HTTP 429, the scheduler's own backpressure verb)
    WITHOUT ever reaching the surviving cell.  Tenants outside the
    window pass untouched — steady-state traffic is never throttled.

    Per-tenant overrides reuse :class:`..serving.scheduler
    .TenantConfig`: ``max_queue`` is read as the in-flight cap
    (``tools/serve_cell.py --rehome_tenants`` feeds ``parse_tenants``
    output straight in).  Pure and clock-injectable."""

    def __init__(self, *, bound: int = 4, window_s: float = 30.0,
                 tenants: list[TenantConfig] | None = None,
                 clock=time.monotonic):
        if bound < 1:
            raise ValueError(f"bound must be >= 1, got {bound}")
        self.bound = int(bound)
        self.window_s = float(window_s)
        self._bounds = {t.name: t.max_queue for t in (tenants or [])}
        self._clock = clock
        self._lock = threading.Lock()
        self._rehomed_at: dict[str, float] = {}
        self._in_flight: dict[str, int] = {}
        self._admitted = 0
        self._rejected = 0

    def bound_for(self, tenant: str) -> int:
        return self._bounds.get(tenant, self.bound)

    def mark_rehomed(self, tenant: str) -> None:
        """Open (or refresh) the throttle window for ``tenant``."""
        with self._lock:
            self._rehomed_at[tenant] = self._clock()

    def throttled(self, tenant: str) -> bool:
        """Is ``tenant`` inside its re-home window?  (Expires lazily.)"""
        with self._lock:
            return self._throttled_locked(tenant)

    def _throttled_locked(self, tenant: str) -> bool:
        at = self._rehomed_at.get(tenant)
        if at is None:
            return False
        if self._clock() - at >= self.window_s:
            del self._rehomed_at[tenant]
            return False
        return True

    def acquire(self, tenant: str) -> bool:
        """Take an in-flight token for a throttled tenant.

        Returns ``False`` when the tenant is not under throttle (no
        token taken, no release owed), ``True`` on a taken token, and
        raises :class:`QueueFull` at the bound — the caller answers
        429 without forwarding anything."""
        with self._lock:
            if not self._throttled_locked(tenant):
                return False
            bound = self.bound_for(tenant)
            if self._in_flight.get(tenant, 0) >= bound:
                self._rejected += 1
                raise QueueFull(
                    f"tenant {tenant!r} re-home throttle full "
                    f"({bound} in flight); retry with backoff")
            self._in_flight[tenant] = self._in_flight.get(tenant, 0) + 1
            self._admitted += 1
            return True

    def release(self, tenant: str) -> None:
        with self._lock:
            n = self._in_flight.get(tenant, 0)
            if n <= 1:
                self._in_flight.pop(tenant, None)
            else:
                self._in_flight[tenant] = n - 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "bound": self.bound,
                "window_s": self.window_s,
                "throttled_tenants": sorted(
                    t for t in self._rehomed_at
                    if self._clock() - self._rehomed_at[t]
                    < self.window_s),
                "in_flight": dict(self._in_flight),
                "admitted": self._admitted,
                "rejected": self._rejected,
            }


# ----------------------------------------------------------- membership


class CellHandle:
    """One cell as the global router sees it: the fleet router URL (the
    wire surface), the coordination-plane spec (the persistence
    surface), and the latest probe snapshot."""

    def __init__(self, name: str, url: str, *, coord: str | None = None,
                 state: str = "starting"):
        assert state in CELL_STATES, state
        self.name = name
        self.url = url.rstrip("/")
        self.coord = coord          # "host:port[,host:port]" KV spec
        self.state = state
        self.statz: dict | None = None   # fleet router /statz snapshot
        self.members: list[dict] = []    # trimmed /fleetz member views
        self.burning: list[str] = []     # fleet-wide burning objectives
        self.burn_since: float | None = None
        self.burn_rehomed = False
        self.fails = 0
        self.in_flight = 0
        self.routed = 0
        self.served = 0
        self.t_added = time.time()
        self.t_dead: float | None = None
        self.dead_reason = ""
        self.t_statz: float | None = None   # monotonic, last statz refresh

    def view(self) -> dict:
        statz = self.statz or {}
        return {
            "cell": self.name,
            "url": self.url,
            "coord": self.coord,
            "state": self.state,
            "load": round(cell_load(self.statz) + self.in_flight, 3),
            "replicas": statz.get("replicas"),
            "healthy": statz.get("healthy"),
            "queue_depth": statz.get("queue_depth"),
            "active_slots": statz.get("active_slots"),
            "in_flight": self.in_flight,
            "routed": self.routed,
            "served": self.served,
            "burning": list(self.burning),
            "fails": self.fails,
            "dead_reason": self.dead_reason,
            "statz": statz,
        }


# -------------------------------------------------------- global router


class GlobalRouter:
    """The cell frontend.  ``add_cell()`` members, ``recover_homes()``
    (optional), ``start()``, ``shutdown()``.  See the module docstring
    for the three policies."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 telemetry=None, poll_s: float = 1.0,
                 fail_after: int = 2, spill_margin: float = 50.0,
                 request_timeout_s: float = 120.0,
                 rehome_policy: str = "sticky",
                 throttle: AdmissionThrottle | None = None,
                 burn_fail_s: float = 0.0,
                 boot_timeout_s: float = 600.0,
                 cell_emit_every_s: float = 2.0,
                 home_key: str = HOME_KEY):
        if rehome_policy not in ("sticky", "return"):
            raise ValueError(
                f"rehome_policy must be 'sticky' or 'return', "
                f"got {rehome_policy!r}")
        self.telemetry = telemetry
        self.poll_s = float(poll_s)
        self.fail_after = int(fail_after)
        self.spill_margin = float(spill_margin)
        self.request_timeout_s = float(request_timeout_s)
        self.rehome_policy = rehome_policy
        self.throttle = throttle
        self.burn_fail_s = float(burn_fail_s)
        self.boot_timeout_s = float(boot_timeout_s)
        self.cell_emit_every_s = float(cell_emit_every_s)
        self.home_key = home_key
        self._lock = threading.Lock()
        self._cells: dict[str, CellHandle] = {}
        self._homes: dict[str, str] = {}     # tenant -> cell name
        self._origin: dict[str, str] = {}    # displaced tenant -> origin
        self._home_seq = 0
        self._homes_dirty = False
        self._gap_pending: dict[str, float] = {}   # dead cell -> t_dead
        self._kv_clients: dict[str, Any] = {}
        self._routed_total = 0
        self._served_total = 0
        self._failed_total = 0
        self._failover_total = 0
        self._spill_total = 0
        self._rehome_total = 0
        self._return_total = 0
        self._throttle_rejected = 0
        self._max_gap_ms = 0.0
        self._ticks = 0
        self._last_cell_emit = 0.0
        self._stop = threading.Event()
        self._control: threading.Thread | None = None
        self._http: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._host, self._port = host, int(port)

    # ------------------------------------------------------- membership

    def add_cell(self, name: str, url: str, *, coord: str | None = None,
                 state: str = "starting") -> str:
        """Adopt a cell by its fleet-router URL.  ``coord`` is the
        cell's coordination-plane spec (``host:port[,standby...]``, or
        ``;``-separated per-instance groups for a sharded plane — see
        :meth:`_kv_client`) — cells without one still serve, but cannot
        mirror the tenant home map.  New cells start in ``starting``
        and attract traffic once a health probe promotes them."""
        with self._lock:
            if name in self._cells:
                raise ValueError(f"duplicate cell {name!r}")
            self._cells[name] = CellHandle(name, url, coord=coord,
                                           state=state)
        return name

    def _mark_cell_dead_locked(self, c: CellHandle, reason: str) -> None:
        """Lock held.  End the cell's routing eligibility and queue its
        tenants for re-home; in-flight forwards fail over on their
        own.  The failover-gap clock starts HERE."""
        c.state = "dead"
        c.dead_reason = reason[:300]
        c.t_dead = time.time()
        c.burn_since = None
        c.burn_rehomed = False
        self._gap_pending[c.name] = c.t_dead

    # ---------------------------------------------- tenant-home persist

    def _kv_client(self, name: str, coord: str):
        """A (cached) observer client onto one cell's KV plane — never
        registers as a task, small retry budget so a dead plane costs
        the control loop little.

        Two spec forms (docs/fault_tolerance.md, "KV-shard HA"):
        ``"h:p[,h:p]"`` — one instance's ordered endpoint list (primary
        first, then its warm standbys; the observer walks it on
        failure); ``"h0:p0[,standby];h1:p1[,standby]"`` — a SHARDED
        plane, one ``;``-segment per instance, each with its own
        standby tail.  Either way a home-mirror read/write rides a
        shard failover instead of dropping the mirror."""
        client = self._kv_clients.get(name)
        if client is not None:
            return client
        if ";" in coord:
            from ..cluster.coordination import CoordinationRouter
            primaries, standbys = [], {}
            for i, seg in enumerate(s for s in coord.split(";") if s):
                head, _, tail = seg.partition(",")
                primaries.append(head)
                if tail:
                    standbys[i] = tail
            client = CoordinationRouter.observer(
                ",".join(primaries), retry_budget=2.0,
                standbys=standbys or None)
        else:
            from ..cluster.coordination import CoordinationClient
            client = CoordinationClient.observer(coord, retry_budget=2.0)
        self._kv_clients[name] = client
        return client

    def _home_payload_locked(self) -> str:
        return json.dumps(
            {"seq": self._home_seq, "homes": self._homes,
             "origin": self._origin},
            separators=(",", ":"), sort_keys=True)

    def flush_homes(self) -> int:
        """Mirror the home map to every cell that has a KV plane.
        Best-effort per cell (a dead plane is exactly the event the
        mirroring exists to survive); returns the number of planes
        written.  Runs on the control thread — never the route path."""
        with self._lock:
            if not self._homes_dirty:
                return 0
            payload = self._home_payload_locked()
            targets = [(c.name, c.coord) for c in self._cells.values()
                       if c.coord and c.state != "dead"]
            self._homes_dirty = False
        written = 0
        for name, coord in targets:
            try:
                self._kv_client(name, coord).kv_set(self.home_key,
                                                    payload)
                written += 1
            except Exception:  # noqa: BLE001 — mirrored, best-effort
                self._kv_clients.pop(name, None)
        return written

    def recover_homes(self) -> int:
        """Read the home map back from every reachable cell's KV plane;
        the highest ``seq`` wins (a stale mirror on a cell that was
        dead during recent re-homes must not roll them back).  Returns
        the adopted seq (0 when nothing was found)."""
        with self._lock:
            targets = [(c.name, c.coord) for c in self._cells.values()
                       if c.coord]
        best: dict | None = None
        for name, coord in targets:
            try:
                raw = self._kv_client(name, coord).kv_get(self.home_key)
            except Exception:  # noqa: BLE001 — unreachable plane: skip
                self._kv_clients.pop(name, None)
                continue
            if not raw:
                continue
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            if best is None or doc.get("seq", 0) > best.get("seq", 0):
                best = doc
        if best is None:
            return 0
        with self._lock:
            self._home_seq = int(best.get("seq", 0))
            self._homes = {str(t): str(c)
                           for t, c in (best.get("homes") or {}).items()}
            self._origin = {str(t): str(c)
                            for t, c
                            in (best.get("origin") or {}).items()}
        return self._home_seq

    def _set_home_locked(self, tenant: str, cell: str) -> None:
        self._homes[tenant] = cell
        self._home_seq += 1
        self._homes_dirty = True

    # ---------------------------------------------------------- routing

    def _forward(self, url: str, body: bytes,
                 headers: dict[str, str] | None = None
                 ) -> tuple[int, bytes]:
        """POST the raw request body to one cell's fleet router; same
        transport semantics as :meth:`..serving.router.Router._forward`
        — ``TimeoutError`` is never re-sendable, other ``OSError`` is
        failover-safe.  ``headers`` carries the X-DTF-* trace context
        down to the cell."""
        req = urllib.request.Request(
            url + "/generate", data=body,
            headers={"Content-Type": "application/json",
                     **(headers or {})})
        try:
            with urllib.request.urlopen(
                    req, timeout=self.request_timeout_s + 10.0) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()
        except urllib.error.URLError as e:
            reason = getattr(e, "reason", e)
            if isinstance(reason, TimeoutError) and not isinstance(
                    reason, ConnectionError):
                raise TimeoutError(str(reason)) from None
            if isinstance(reason, OSError):
                raise reason from None
            raise OSError(str(reason)) from None

    def route(self, body: bytes, tenant: str,
              wire: tuple[str | None, int, bool] | None = None
              ) -> tuple[int, bytes]:
        """Serve one caller request: throttle, choose a cell, forward,
        fail over.  One-response guarantee: transport failures and
        500s rotate to the next cell; 429s spill; 400 passes through;
        a forward timeout answers 503 and is NEVER re-sent; exhausting
        the cell set returns the last status seen or 503.

        ``wire`` is the inbound ``(trace, parent, forced)`` context —
        see :meth:`..serving.router.Router.route`; here the root span
        is ``route.global`` and each per-cell forward attempt a
        ``route.cell`` child."""
        token = False
        if self.throttle is not None:
            try:
                token = self.throttle.acquire(tenant)
            except QueueFull as e:
                with self._lock:
                    self._throttle_rejected += 1
                self._emit_cell("throttle_reject", tenant=tenant,
                                reason=str(e))
                self._trace_throttled(tenant, wire, str(e))
                return 429, json.dumps({"error": str(e)}).encode()
        try:
            return self._route_inner(body, tenant, wire)
        finally:
            if token:
                self.throttle.release(tenant)

    def _trace_throttled(self, tenant: str,
                         wire: tuple[str | None, int, bool] | None,
                         reason: str) -> None:
        """A throttle 429 never reaches ``_route_inner``, but it IS the
        interesting tail (blast-radius admission control fired) — record
        a zero-duration ``route.global`` span and the tier's keep
        verdict so the trace survives the sampler."""
        tracer = tracing.active()
        if tracer is None:
            return
        in_trace, in_parent, forced = wire or (None, 0, False)
        trace = in_trace or tracing.mint_trace("global")
        tracer.emit_span(
            "route.global", time.time(), 0.0, step=self._routed_total,
            parent_id=in_parent if in_trace else 0, trace=trace,
            tenant=tenant, cell="", failovers=0, rehomed="",
            status=429, error=reason[:200])
        if tracer.buffer is not None:
            tracer.buffer.retire(trace, tenant=tenant, status=429,
                                 forced=forced)

    def _route_inner(self, body: bytes, tenant: str,
                     wire: tuple[str | None, int, bool] | None = None
                     ) -> tuple[int, bytes]:
        t0 = time.perf_counter()
        t0_unix = time.time()
        tried: set[str] = set()
        failovers = 0
        last: tuple[int, bytes] | None = None
        served_by = ""
        rehomed_any = ""
        tracer = tracing.active()
        in_trace, in_parent, forced = wire or (None, 0, False)
        trace: str | None = None
        span_global = 0
        if tracer is not None:
            trace = in_trace or tracing.mint_trace("global")
            span_global = tracer.allocate_id()

        def finish(status: int) -> None:
            # The route.global root span + this tier's tail verdict.
            if tracer is None:
                return
            dur_ms = (time.perf_counter() - t0) * 1e3
            tracer.emit_span(
                "route.global", t0_unix, dur_ms,
                step=self._routed_total,
                parent_id=in_parent if in_trace else 0,
                span_id=span_global, trace=trace, tenant=tenant,
                cell=served_by, failovers=failovers,
                rehomed=rehomed_any, status=status, error="")
            if tracer.buffer is not None:
                tracer.buffer.retire(
                    trace, tenant=tenant, e2e_ms=dur_ms,
                    ok=status == 200, status=status,
                    failovers=failovers, forced=forced)

        while True:
            with self._lock:
                loads = {
                    name: cell_load(c.statz) + c.in_flight
                    for name, c in self._cells.items()
                    if c.state in ROUTABLE_CELL_STATES
                    and name not in tried}
                name, _spilled = choose_replica(
                    loads, tenant, self._homes, self.spill_margin)
                if name is None:
                    break
                if _spilled:
                    self._spill_total += 1
                home = self._homes.get(tenant)
                home_cell = self._cells.get(home) \
                    if home is not None else None
                home_routable = (home_cell is not None
                                 and home_cell.state
                                 in ROUTABLE_CELL_STATES)
                rehomed = ""
                if home is None:
                    self._set_home_locked(tenant, name)
                elif home != name and not home_routable \
                        and not _spilled:
                    # The home cell is dead/absent: this IS the
                    # failover re-home (a spill is a one-off and does
                    # not move the home).
                    self._origin.setdefault(tenant, home)
                    self._set_home_locked(tenant, name)
                    self._rehome_total += 1
                    rehomed = home
                c = self._cells[name]
                c.in_flight += 1
                c.routed += 1
                self._routed_total += 1
                poll_age_ms = (round((time.monotonic() - c.t_statz)
                                     * 1e3, 1)
                               if c.t_statz is not None else -1.0)
            if rehomed:
                rehomed_any = rehomed
                if self.throttle is not None:
                    self.throttle.mark_rehomed(tenant)
                self._emit_cell("tenant_rehome", cell=name,
                                tenant=tenant,
                                reason=f"home {rehomed} not routable")
            tried.add(name)
            ta_unix, ta = time.time(), time.perf_counter()
            headers = None
            span_attempt = 0
            if tracer is not None:
                span_attempt = tracer.allocate_id()
                # A retry proves the trace interesting — force every
                # downstream tier's tail sampler to keep its half.
                headers = tracing.wire_headers(
                    trace, span_attempt, sampled=forced or failovers > 0)

            def attempt_span(status: int, error: str = "") -> None:
                if tracer is None:
                    return
                tracer.emit_span(
                    "route.cell", ta_unix,
                    (time.perf_counter() - ta) * 1e3,
                    step=self._routed_total, parent_id=span_global,
                    span_id=span_attempt, trace=trace, tier="global",
                    cell=name, load=round(loads[name], 3),
                    spilled=_spilled, rehomed=rehomed,
                    poll_age_ms=poll_age_ms, status=status,
                    ok=status == 200, error=error[:200])

            try:
                status, payload = self._forward(c.url, body, headers)
            except TimeoutError:
                with self._lock:
                    c.in_flight -= 1
                    self._failed_total += 1
                attempt_span(504, "forward timeout")
                finish(504)
                return 503, json.dumps(
                    {"error": f"cell {name} timed out; "
                              "request may still be executing"}).encode()
            except OSError as e:
                with self._lock:
                    c.in_flight -= 1
                    c.fails += 1
                    dead = c.fails >= self.fail_after \
                        and c.state not in ("dead",)
                    if dead:
                        self._mark_cell_dead_locked(c, f"route: {e!r}")
                        rehome = self._rehome_tenants_locked(
                            c.name, reason=f"route {e!r}")
                    else:
                        rehome = []
                if dead:
                    self._emit_cell("cell_dead", cell=c.name,
                                    reason=f"route {e!r}")
                    self._emit_rehomes(rehome)
                attempt_span(0, repr(e))
                failovers += 1
                continue
            attempt_span(status)
            with self._lock:
                c.in_flight -= 1
                if status == 200:
                    c.fails = 0
                    c.served += 1
                    self._served_total += 1
                    if failovers:
                        self._failover_total += failovers
                    served_by = name
                    gap = self._gap_done_locked(tenant)
                else:
                    gap = None
            if gap is not None:
                self._emit_cell("failover_gap", cell=gap[0],
                                tenant=tenant, gap_ms=gap[1])
            if status in (500, 429):
                # 500: the fleet router already exhausted ITS members;
                # re-running the generate on another cell is safe.
                # 429: every member of that cell backpressured — spill
                # to the next cell, surface only when all cells are
                # full.
                last = (status, payload)
                failovers += status == 500
                continue
            finish(status)
            return status, payload
        if last is None:
            last = (503, json.dumps(
                {"error": "no cell available"}).encode())
        with self._lock:
            if last[0] != 429:
                self._failed_total += 1
        finish(last[0])
        return last

    def _gap_done_locked(self, tenant: str) -> tuple[str, float] | None:
        """Lock held.  First served request of a tenant displaced from
        a pending dead cell closes that cell's failover gap."""
        origin = self._origin.get(tenant)
        t_dead = self._gap_pending.pop(origin, None) \
            if origin is not None else None
        if t_dead is None:
            return None
        gap_ms = (time.time() - t_dead) * 1e3
        self._max_gap_ms = max(self._max_gap_ms, gap_ms)
        return origin, gap_ms

    def _rehome_tenants_locked(self, dead: str,
                               reason: str) -> list[tuple[str, str]]:
        """Lock held.  Move every tenant homed on ``dead`` to the
        least-loaded surviving cell NOW (waiting for each tenant's
        next request would stretch every failover gap by one arrival
        interval).  Returns ``(tenant, new_home)`` pairs for emission
        outside the lock."""
        loads = {name: cell_load(c.statz) + c.in_flight
                 for name, c in self._cells.items()
                 if c.state in ROUTABLE_CELL_STATES}
        moved: list[tuple[str, str]] = []
        for tenant in sorted(t for t, cell in self._homes.items()
                             if cell == dead):
            if not loads:
                # No survivor yet: drop the home; the next request
                # re-assigns (and still closes the gap).
                del self._homes[tenant]
                self._origin.setdefault(tenant, dead)
                self._home_seq += 1
                self._homes_dirty = True
                continue
            target, _ = choose_replica(loads, tenant, {}, 0.0)
            self._origin.setdefault(tenant, dead)
            self._set_home_locked(tenant, target)
            self._rehome_total += 1
            loads[target] = loads.get(target, 0.0) + 1.0
            moved.append((tenant, target))
        return moved

    def _emit_rehomes(self, moved: list[tuple[str, str]],
                      reason: str = "cell failover") -> None:
        for tenant, target in moved:
            if self.throttle is not None:
                self.throttle.mark_rehomed(tenant)
            self._emit_cell("tenant_rehome", cell=target, tenant=tenant,
                            reason=reason)

    # ------------------------------------------------------ health loop

    def _get_json(self, url: str, path: str,
                  timeout: float = 5.0) -> tuple[int, dict]:
        req = urllib.request.Request(url + path)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                return e.code, json.loads(e.read())
            except Exception:
                return e.code, {}
        except urllib.error.URLError as e:
            reason = getattr(e, "reason", e)
            if isinstance(reason, OSError):
                raise reason from None
            raise OSError(str(reason)) from None

    @staticmethod
    def _fleet_burning(members: list[dict]) -> list[str]:
        return sorted({
            flag for m in members
            for flag in ((m.get("statz") or {}).get("slo") or {})
            .get("burning", ())})

    def poll_cells_once(self) -> None:
        """One health sweep (control thread; callable from tests).
        Probes every cell's ``/healthz`` + ``/fleetz`` CONCURRENTLY
        (a blackholed cell must not stall death detection for the
        rest), promotes/demotes, refreshes the statz snapshots routing
        reads, and drives burn-based re-home and the recovery policy."""
        with self._lock:
            targets = [(c.name, c.url) for c in self._cells.values()]
        probes: dict[str, tuple[int, dict, dict | None] | OSError] = {}

        def probe(name: str, url: str) -> None:
            try:
                code, health = self._get_json(url, "/healthz")
                fleetz = None
                if code == 200:
                    _, fleetz = self._get_json(url, "/fleetz")
                probes[name] = (code, health, fleetz)
            except OSError as e:
                probes[name] = e

        threads = [threading.Thread(target=probe, args=t, daemon=True)
                   for t in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        events: list[tuple[str, dict]] = []
        rehomes: list[tuple[str, str]] = []
        for name, _url in targets:
            outcome = probes.get(name)
            with self._lock:
                c = self._cells.get(name)
                if c is None:
                    continue
                failing = isinstance(outcome, OSError) or (
                    outcome is not None and outcome[0] != 200)
                if outcome is None:
                    continue
                if failing:
                    reason = (repr(outcome)
                              if isinstance(outcome, OSError)
                              else f"healthz {outcome[0]}: "
                                   f"{outcome[1].get('status', '')}")
                    if c.state == "dead":
                        continue
                    c.fails += 1
                    if c.state == "starting":
                        if time.time() - c.t_added > self.boot_timeout_s:
                            self._mark_cell_dead_locked(
                                c, "boot timeout")
                            rehomes += self._rehome_tenants_locked(
                                name, reason="boot timeout")
                            events.append(("cell_dead", {
                                "cell": name,
                                "reason": "boot timeout"}))
                    elif c.fails >= self.fail_after:
                        self._mark_cell_dead_locked(c, reason)
                        rehomes += self._rehome_tenants_locked(
                            name, reason=reason)
                        events.append(("cell_dead", {
                            "cell": name, "reason": reason}))
                    continue
                _code, _health, fleetz = outcome
                c.fails = 0
                c.statz = (fleetz or {}).get("router") or {}
                c.t_statz = time.monotonic()
                c.members = (fleetz or {}).get("members") or []
                c.burning = self._fleet_burning(c.members)
                if c.burning:
                    if c.burn_since is None:
                        c.burn_since = time.monotonic()
                else:
                    c.burn_since = None
                    c.burn_rehomed = False
                if c.state == "starting":
                    c.state = "healthy"
                    events.append(("cell_up", {"cell": name,
                                               "reason": "adopted"}))
                elif c.state == "dead":
                    c.state = "healthy"
                    c.dead_reason = ""
                    self._gap_pending.pop(name, None)
                    events.append(("cell_up", {"cell": name,
                                               "reason": "recovered"}))
                    if self.rehome_policy == "return":
                        for tenant in sorted(
                                t for t, origin in self._origin.items()
                                if origin == name):
                            self._set_home_locked(tenant, name)
                            del self._origin[tenant]
                            self._return_total += 1
                            events.append(("tenant_return", {
                                "cell": name, "tenant": tenant,
                                "reason": "home cell recovered"}))
                # Sustained SLO burn: re-home the cell's tenants onto a
                # non-burning survivor without declaring it dead.
                if (self.burn_fail_s > 0 and c.state == "healthy"
                        and not c.burn_rehomed
                        and c.burn_since is not None
                        and time.monotonic() - c.burn_since
                        >= self.burn_fail_s):
                    others = [o for o in self._cells.values()
                              if o.name != name and o.state == "healthy"
                              and not o.burning]
                    if others:
                        c.burn_rehomed = True
                        loads = {o.name: cell_load(o.statz) + o.in_flight
                                 for o in others}
                        for tenant in sorted(
                                t for t, cell in self._homes.items()
                                if cell == name):
                            target, _ = choose_replica(loads, tenant,
                                                       {}, 0.0)
                            self._origin.setdefault(tenant, name)
                            self._set_home_locked(tenant, target)
                            self._rehome_total += 1
                            loads[target] += 1.0
                            rehomes.append((tenant, target))
                        events.append(("cell_burning", {
                            "cell": name,
                            "reason": f"slo burn {c.burning}"}))
        for action, fields in events:
            self._emit_cell(action, **fields)
        self._emit_rehomes(rehomes)

    def _control_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_cells_once()
                self.flush_homes()
                with self._lock:
                    self._ticks += 1
                now = time.monotonic()
                if now - self._last_cell_emit >= self.cell_emit_every_s:
                    self._last_cell_emit = now
                    self._emit_cell("poll")
            except Exception:  # noqa: BLE001 — the tier outlives a tick
                pass

    # -------------------------------------------------------- telemetry

    def _emit_cell(self, action: str, *, cell: str = "",
                   tenant: str = "", gap_ms: float = 0.0,
                   reason: str = "") -> None:
        """The ONE ``kind="cell"`` emit site — every field of
        ``REQUIRED_CELL_FIELDS`` is an explicit keyword here, so the
        dtflint telemetry-contract analyzer can prove the contract
        statically."""
        if self.telemetry is None:
            return
        with self._lock:
            cells = len(self._cells)
            healthy = sum(c.state == "healthy"
                          for c in self._cells.values())
            step = self._ticks
        self.telemetry.emit(
            "cell", step=step, action=action, cell=cell, tenant=tenant,
            gap_ms=round(float(gap_ms), 3), cells=cells,
            healthy_cells=healthy, reason=reason[:300])

    # ------------------------------------------------------------ views

    def stats(self) -> dict:
        """The global router's own ``/statz`` (role-tagged so a watcher
        knows it is neither a server's nor a fleet router's)."""
        with self._lock:
            cells = list(self._cells.values())
            out = {
                "role": "global_router",
                "cells": len(cells),
                "healthy_cells": sum(c.state == "healthy"
                                     for c in cells),
                "dead_cells": sum(c.state == "dead" for c in cells),
                "routed": self._routed_total,
                "served": self._served_total,
                "failed": self._failed_total,
                "failovers": self._failover_total,
                "spills": self._spill_total,
                "rehomes": self._rehome_total,
                "returns": self._return_total,
                "throttle_rejected": self._throttle_rejected,
                "max_failover_gap_ms": round(self._max_gap_ms, 3),
                "tenant_homes": dict(self._homes),
                "displaced": dict(self._origin),
                "home_seq": self._home_seq,
                "rehome_policy": self.rehome_policy,
                "queue_depth": sum(
                    (c.statz or {}).get("queue_depth") or 0
                    for c in cells if c.state == "healthy"),
                "active_slots": sum(
                    (c.statz or {}).get("active_slots") or 0
                    for c in cells if c.state == "healthy"),
            }
        if self.throttle is not None:
            out["throttle"] = self.throttle.snapshot()
        tracer = tracing.active()
        if tracer is not None and tracer.buffer is not None:
            out["serve_trace_sampled"] = tracer.buffer.stats()
        return out

    def cells_snapshot(self) -> dict:
        """The ``/cellz`` payload: global stats + per-cell views —
        ``tools/watch_serve.py --cells``'s one-poll feed."""
        with self._lock:
            cells = [c.view() for c in sorted(
                self._cells.values(), key=lambda c: c.name)]
        return {"global": self.stats(), "cells": cells}

    # -------------------------------------------------------- lifecycle

    @property
    def port(self) -> int:
        assert self._http is not None, "start() first"
        return self._http.server_address[1]

    def start(self) -> None:
        self._http = ThreadingHTTPServer((self._host, self._port),
                                         self._make_handler())
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, daemon=True,
            name="global-router-http")
        self._http_thread.start()
        self._control = threading.Thread(
            target=self._control_loop, daemon=True,
            name="global-router-control")
        self._control.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        if self._control is not None:
            self._control.join(timeout=10.0)
        for client in self._kv_clients.values():
            try:
                client.close()
            except Exception:  # noqa: BLE001 — shutdown best-effort
                pass
        self._kv_clients.clear()

    # ------------------------------------------------------------- HTTP

    def _make_handler(self):
        router = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet server
                pass

            def _reply_json(self, code: int, payload: dict) -> None:
                self._reply_raw(code, json.dumps(payload).encode())

            def _reply_raw(self, code: int, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    stats = router.stats()
                    if stats["healthy_cells"] == 0:
                        return self._reply_json(503, {
                            "status": "no_healthy_cell", **stats})
                    return self._reply_json(200, {"status": "ok",
                                                  **stats})
                if self.path == "/statz":
                    return self._reply_json(200, router.stats())
                if self.path == "/cellz":
                    return self._reply_json(200,
                                            router.cells_snapshot())
                return self._reply_json(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path != "/generate":
                    return self._reply_json(404,
                                            {"error": "unknown path"})
                n = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(n) or b"{}"
                try:
                    tenant = str(json.loads(body).get(
                        "tenant", "default"))
                except (ValueError, AttributeError):
                    tenant = "default"
                status, payload = router.route(
                    body, tenant, wire=tracing.parse_wire(self.headers))
                return self._reply_raw(status, payload)

        return Handler
