"""Fleet frontend — N serving replicas behind one statz-routed,
SLO-autoscaled HTTP endpoint (docs/serving.md, "Fleet").

Copied from ``distributed_tensorflow_tpu/serving/router.py`` (standard
library only; the port's imports).

A single :class:`..serving.server.ServingServer` is both the capacity
ceiling and the availability ceiling of the serving tier.  The router
turns N of them into one endpoint that speaks the SAME wire format a
single server does (``POST /generate`` / ``GET /healthz`` / ``/statz``),
so every existing :class:`..serving.client.ServeClient` caller works
unchanged — TF-Replicator's single-program-multi-role pattern: the same
engine binary plays replica or (through ``tools/serve_fleet.py``)
frontend, by role.

Three loops, three jobs:

- **Routing** (handler threads) — each admission goes to the replica
  with the lowest live load: queue depth + slot occupancy + KV-pool
  occupancy from the member's last ``/statz`` snapshot, plus the
  router's own in-flight count toward that member (the snapshot is a
  poll old; in-flight is the router's real-time correction).  Tenants
  are **affine**: a tenant sticks to the replica that has been serving
  it (decode-state locality, and the fairness books stay in one place)
  until that replica's load exceeds the best alternative by
  ``spill_margin`` — then the request *spills* to the least-loaded
  member.  Failures fail over: a connection refused/reset or HTTP 500
  marks the attempt failed and the SAME request is re-routed to the
  next-best member — the caller sees one response, never a socket
  error.  429 (tenant queue full / draining) spills the same way and
  only surfaces when EVERY member backpressures.
- **Health** (control thread) — each member's ``/healthz`` + ``/statz``
  are polled every ``poll_s``.  A member reporting ``engine_dead``
  (the PR-8 engine-fatal → 503 path) or failing ``fail_after``
  consecutive probes is marked dead and drained: its tenants re-home on
  the next route, its in-flight forwards fail over, and — with
  ``respawn`` — a replacement is spawned from the checkpoint plane via
  ``spawn_fn`` and adopted once its own ``/healthz`` turns ok.
- **Autoscaling** (control thread) — the replicas' SLO engines already
  compute per-tenant burn rate (``serving/slo.py``); the router closes
  the loop.  :class:`AutoscalePolicy` scales UP when any tenant has
  been burning for ``burn_sustain_s`` (a blip shorter than that — or a
  flapping objective — never scales), DOWN when the whole fleet has
  been idle for ``idle_sustain_s``, with a shared ``cooldown_s`` so
  consecutive actions cannot oscillate.  Scale-down is graceful: the
  victim is ``POST /drain``-ed (new work 429s to siblings), removed
  from routing, and reaped only once empty.

Telemetry: one ``kind="route"`` record per caller request (which
replica served it, how many failovers it survived, wall latency) and
``kind="fleet"`` snapshots/events (membership, health, autoscale
actions) — ``tools/summarize_run.py`` rolls both into a fleet section
and ``--check`` enforces their field contracts
(``REQUIRED_ROUTE_FIELDS`` / ``REQUIRED_FLEET_FIELDS``).

The policy pieces (:func:`replica_load`, :func:`choose_replica`,
:class:`AutoscalePolicy`) are pure and clock-injectable — unit-tested
without sockets in tests/test_router.py.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable
import urllib.error
import urllib.request

from ..utils import tracing

#: Member lifecycle: spawned/adopted -> starting -(healthz ok)-> healthy
#: -(drain begun)-> draining -(empty, reaped)-> stopped;
#: healthy/starting/draining -(engine_dead or fail_after probes)-> dead.
REPLICA_STATES = ("starting", "healthy", "draining", "dead", "stopped")

#: States a new request may be routed to.
ROUTABLE_STATES = ("healthy",)


# ------------------------------------------------------- routing policy


def replica_load(statz: dict | None) -> float:
    """One replica's load figure from its ``/statz`` snapshot.

    Queue depth dominates — each queued request weighs as much as a
    replica's ENTIRE possible occupancy pressure (slot + KV fractions
    sum to at most 2), because queued work is waiting *now*; slot
    occupancy and KV-pool occupancy break ties among empty-queue
    replicas toward the one with free decode lanes and free pages.  A
    member with no snapshot yet scores 0 (a freshly adopted replica
    should attract load)."""
    if not statz:
        return 0.0
    eng = statz.get("engine") or {}
    pool = eng.get("kv_pool") or {}
    slots = eng.get("num_slots") or 1
    active = (eng.get("active_slots") or 0) / max(1, slots)
    kv = pool.get("utilization") or 0.0
    queue = statz.get("queue_depth") or 0
    return 2.0 * float(queue) + float(active) + float(kv)


def choose_replica(loads: dict[str, float], tenant: str,
                   affinity: dict[str, str],
                   spill_margin: float = 2.0) -> tuple[str | None, bool]:
    """Pick a member for ``tenant`` given each candidate's live load.

    Returns ``(replica_id, spilled)``.  The tenant's affine replica wins
    while its load stays within ``spill_margin`` of the best candidate;
    beyond that the request spills to the least-loaded member
    (``spilled=True``).  A dead/absent affine replica is simply
    re-homed, not a spill.  Ties break on replica id so the choice is
    deterministic for tests."""
    if not loads:
        return None, False
    best = min(loads, key=lambda rid: (loads[rid], rid))
    home = affinity.get(tenant)
    if home is not None and home in loads:
        if loads[home] <= loads[best] + spill_margin:
            return home, False
        return best, True
    return best, False


# ----------------------------------------------------------- autoscale


class AutoscalePolicy:
    """Hysteresis for the scale decision — pure, clock-injectable.

    ``observe()`` is fed the current fleet view each control tick and
    returns ``"up"``, ``"down"``, or ``None``.  Burn must SUSTAIN for
    ``burn_sustain_s`` before an up (one burning evaluation — or an
    objective flapping in and out of burn — never scales), idle must
    sustain ``idle_sustain_s`` before a down, and any action starts a
    shared ``cooldown_s`` window during which the policy stays quiet.
    Not thread-safe by itself: the router calls it from the single
    control thread."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 burn_sustain_s: float = 6.0,
                 idle_sustain_s: float = 60.0,
                 cooldown_s: float = 30.0,
                 clock=time.monotonic):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.burn_sustain_s = float(burn_sustain_s)
        self.idle_sustain_s = float(idle_sustain_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._burn_since: float | None = None
        self._idle_since: float | None = None
        self._last_action_t: float | None = None
        self.last_action: str | None = None

    def _cooled(self, now: float) -> bool:
        return (self._last_action_t is None
                or now - self._last_action_t >= self.cooldown_s)

    def observe(self, *, replicas: int, burning: bool, idle: bool,
                now: float | None = None) -> str | None:
        """One control tick: ``replicas`` counts live members (starting
        included — a booting replica is capacity already paid for),
        ``burning`` is "any tenant's SLO is burning fleet-wide",
        ``idle`` is "no queued, active, or in-flight work anywhere"."""
        now = self._clock() if now is None else float(now)
        if burning:
            self._idle_since = None
            if self._burn_since is None:
                self._burn_since = now
            if (now - self._burn_since >= self.burn_sustain_s
                    and replicas < self.max_replicas
                    and self._cooled(now)):
                # Re-arm: a burn that persists must re-sustain past the
                # cooldown before the NEXT step up.
                self._burn_since = None
                self._last_action_t = now
                self.last_action = "up"
                return "up"
            return None
        self._burn_since = None
        if idle:
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= self.idle_sustain_s
                    and replicas > self.min_replicas
                    and self._cooled(now)):
                self._idle_since = None
                self._last_action_t = now
                self.last_action = "down"
                return "down"
        else:
            self._idle_since = None
        return None

    def snapshot(self) -> dict:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "burn_sustain_s": self.burn_sustain_s,
            "idle_sustain_s": self.idle_sustain_s,
            "cooldown_s": self.cooldown_s,
            "last_action": self.last_action,
        }


# ------------------------------------------------------------- members


class ReplicaHandle:
    """One fleet member's book: identity, health, and serving credit.

    All mutation happens under the router's lock.  ``served`` counts
    only requests this replica actually answered — a request re-routed
    off a dying member is credited to the member that completed it, so
    a dead replica's books freeze at what it truly served."""

    def __init__(self, replica_id: str, url: str, handle: Any = None,
                 state: str = "starting"):
        assert state in REPLICA_STATES, state
        self.id = replica_id
        self.url = url.rstrip("/")
        self.handle = handle          # opaque (e.g. subprocess.Popen)
        self.state = state
        self.statz: dict | None = None
        self.fails = 0                # consecutive probe/route failures
        self.in_flight = 0            # router-side outstanding forwards
        self.routed = 0               # forwards attempted
        self.served = 0               # 200s actually answered
        self.failovers_absorbed = 0   # requests rescued FROM siblings
        self.dead_reason: str | None = None
        self.replaced = False         # a respawn already covers this death
        self.reaped = False           # reap_fn already ran on the handle
        self.t_added = time.time()
        self.t_statz: float | None = None   # monotonic, last statz refresh

    def view(self) -> dict:
        """The /fleetz member entry (snapshot under the router lock)."""
        eng = (self.statz or {}).get("engine") or {}
        return {
            "id": self.id,
            "url": self.url,
            "state": self.state,
            "load": round(replica_load(self.statz), 3),
            "in_flight": self.in_flight,
            "routed": self.routed,
            "served": self.served,
            "failovers_absorbed": self.failovers_absorbed,
            "dead_reason": self.dead_reason,
            "engine_step": eng.get("engine_step"),
            "model_step": eng.get("model_step"),
            "active_slots": eng.get("active_slots"),
            "num_slots": eng.get("num_slots"),
            "queue_depth": (self.statz or {}).get("queue_depth"),
            "replica": (self.statz or {}).get("replica"),
            "statz": self.statz,
        }


# --------------------------------------------------------------- router


class Router:
    """The fleet frontend.  ``add_replica()`` members, ``start()``,
    ``shutdown()``.  See the module docstring for the three loops."""

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 telemetry=None, poll_s: float = 1.0,
                 spill_margin: float = 2.0, fail_after: int = 2,
                 request_timeout_s: float = 120.0,
                 autoscale: AutoscalePolicy | None = None,
                 spawn_fn: Callable[[], tuple[str, str, Any]]
                 | None = None,
                 reap_fn: Callable[[ReplicaHandle], None] | None = None,
                 respawn: bool = False,
                 fleet_emit_every_s: float = 2.0,
                 boot_timeout_s: float = 600.0):
        self.telemetry = telemetry
        self.poll_s = float(poll_s)
        self.spill_margin = float(spill_margin)
        self.fail_after = int(fail_after)
        self.request_timeout_s = float(request_timeout_s)
        self.autoscale = autoscale
        self.spawn_fn = spawn_fn
        self.reap_fn = reap_fn
        self.respawn = bool(respawn)
        self.fleet_emit_every_s = float(fleet_emit_every_s)
        self.boot_timeout_s = float(boot_timeout_s)
        self._lock = threading.Lock()
        self._members: dict[str, ReplicaHandle] = {}
        self._affinity: dict[str, str] = {}     # tenant -> replica id
        self._next_auto_id = 0
        self._respawns = 0
        self._routed_total = 0
        self._served_total = 0
        self._failed_total = 0
        self._failover_total = 0
        self._spill_total = 0
        self._max_failover_ms = 0.0
        self._ticks = 0
        self._last_fleet_emit = 0.0
        self._stop = threading.Event()
        self._control: threading.Thread | None = None
        self._http: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._host, self._port = host, int(port)

    # ------------------------------------------------------- membership

    def add_replica(self, url: str, *, handle: Any = None,
                    replica_id: str | None = None,
                    state: str = "starting") -> str:
        """Adopt a member by URL (spawned here or anywhere else).  New
        members start in ``starting`` and attract traffic once a health
        probe promotes them; tests may pass ``state="healthy"``.

        Auto-assigned ids use the ``a<N>`` namespace (``a0, a1, ...``)
        and skip taken names, so adopted-by-URL members can never
        collide with a spawner's own ``r<N>`` numbering."""
        with self._lock:
            if replica_id is None:
                while f"a{self._next_auto_id}" in self._members:
                    self._next_auto_id += 1
                replica_id = f"a{self._next_auto_id}"
                self._next_auto_id += 1
            if replica_id in self._members:
                raise ValueError(f"duplicate replica id {replica_id!r}")
            self._members[replica_id] = ReplicaHandle(
                replica_id, url, handle=handle, state=state)
        return replica_id

    def _mark_dead_locked(self, m: ReplicaHandle, reason: str) -> None:
        """Lock held.  Kill the member's routing eligibility and re-home
        its tenants; its in-flight forwards fail over on their own."""
        m.state = "dead"
        m.dead_reason = reason[:300]
        for tenant in [t for t, rid in self._affinity.items()
                       if rid == m.id]:
            del self._affinity[tenant]

    # ---------------------------------------------------------- routing

    def _forward(self, url: str, body: bytes,
                 headers: dict[str, str] | None = None
                 ) -> tuple[int, bytes]:
        """POST the raw request body to one replica; returns
        ``(status, body)`` for pass-through statuses, raises
        ``TimeoutError`` on a forward timeout (the replica may STILL be
        executing the request — never re-sendable) and other
        ``OSError``/``ConnectionError`` on transport death (nothing was
        served — safe to fail over).  ``headers`` carries the X-DTF-*
        trace context to the replica."""
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
        """Serve one caller request: choose, forward, fail over.

        Returns the final ``(status, body)``.  Transport failures and
        500s rotate to the next member; 429s spill; 400 passes through
        untried elsewhere (it is the request's fault, deterministically).
        Exhausting the member set returns the last replica status seen,
        or 503 when nothing was reachable at all.

        ``wire`` is the inbound ``(trace, parent, forced)`` context from
        :func:`utils.tracing.parse_wire`.  With a tracer installed the
        whole route becomes one ``route.fleet`` span (adopting the
        caller's trace, or minting one when this router IS the top
        tier), each forward attempt a ``route.attempt`` child carrying
        the member, its load score, the spill/affinity decision, the
        statz-poll staleness, and — on failure — the dead replica's id
        and the retry latency.  The chosen attempt's span id rides the
        X-DTF-Parent header so the replica's ``serve.request`` tree
        nests under it."""
        t0 = time.perf_counter()
        t0_unix = time.time()
        tried: set[str] = set()
        failovers = 0
        spilled_any = False
        last: tuple[int, bytes] | None = None
        served_by = ""
        tracer = tracing.active()
        in_trace, in_parent, forced = wire or (None, 0, False)
        trace: str | None = None
        span_fleet = 0
        if tracer is not None:
            trace = in_trace or tracing.mint_trace("fleet")
            span_fleet = tracer.allocate_id()

        def finish(status: int) -> None:
            # The route.fleet root span + this tier's tail verdict, at
            # the single point the outcome is known.
            if tracer is None:
                return
            dur_ms = (time.perf_counter() - t0) * 1e3
            tracer.emit_span(
                "route.fleet", t0_unix, dur_ms, step=self._routed_total,
                parent_id=in_parent if in_trace else 0,
                span_id=span_fleet, trace=trace, tenant=tenant,
                replica=served_by, failovers=failovers,
                spilled=spilled_any, status=status)
            if tracer.buffer is not None:
                tracer.buffer.retire(
                    trace, tenant=tenant, e2e_ms=dur_ms,
                    ok=status == 200, status=status,
                    failovers=failovers, forced=forced)

        while True:
            with self._lock:
                loads = {
                    rid: replica_load(m.statz) + m.in_flight
                    for rid, m in self._members.items()
                    if m.state in ROUTABLE_STATES and rid not in tried}
                rid, spilled = choose_replica(
                    loads, tenant, self._affinity, self.spill_margin)
                if rid is None:
                    break
                m = self._members[rid]
                m.in_flight += 1
                m.routed += 1
                self._routed_total += 1
                if spilled:
                    self._spill_total += 1
                    spilled_any = True
                elif tenant not in self._affinity:
                    self._affinity[tenant] = rid
                poll_age_ms = (round((time.monotonic() - m.t_statz) * 1e3,
                                     1)
                               if m.t_statz is not None else -1.0)
            tried.add(rid)
            ta_unix, ta = time.time(), time.perf_counter()
            headers = None
            span_attempt = 0
            if tracer is not None:
                span_attempt = tracer.allocate_id()
                # A retry already proves the trace interesting — force
                # the downstream tier's tail sampler to keep its half
                # (it retires before this tier's own verdict exists).
                headers = tracing.wire_headers(
                    trace, span_attempt, sampled=forced or failovers > 0)

            def attempt_span(status: int, error: str = "") -> None:
                if tracer is None:
                    return
                tracer.emit_span(
                    "route.attempt", ta_unix,
                    (time.perf_counter() - ta) * 1e3,
                    step=self._routed_total, parent_id=span_fleet,
                    span_id=span_attempt, trace=trace, tier="fleet",
                    replica=rid, load=round(loads[rid], 3),
                    spilled=spilled, poll_age_ms=poll_age_ms,
                    status=status, ok=status == 200, error=error[:200])

            try:
                status, payload = self._forward(m.url, body, headers)
            except TimeoutError:
                # The replica may still be executing this request —
                # re-sending it elsewhere would double-execute, and a
                # slow-but-alive member must not be counted toward
                # fail_after (the health poll owns that verdict) — the
                # same carve-out ServeClient makes for its own retries.
                with self._lock:
                    m.in_flight -= 1
                    self._failed_total += 1
                attempt_span(504, "forward timeout")
                self._emit_route(tenant, "", failovers, spilled_any, t0,
                                 504)
                finish(504)
                return 503, json.dumps(
                    {"error": f"replica {rid} timed out; "
                              "request may still be executing"}).encode()
            except OSError as e:
                with self._lock:
                    m.in_flight -= 1
                    m.fails += 1
                    dead = m.fails >= self.fail_after \
                        and m.state not in ("dead", "stopped")
                    if dead:
                        self._mark_dead_locked(m, f"route: {e!r}")
                if dead:
                    self._emit_fleet("replica_dead",
                                     reason=f"{m.id}: route {e!r}")
                attempt_span(0, repr(e))
                failovers += 1
                continue
            attempt_span(status)
            with self._lock:
                m.in_flight -= 1
                if status == 200:
                    m.fails = 0
                    m.served += 1
                    self._served_total += 1
                    if failovers:
                        m.failovers_absorbed += 1
                        self._failover_total += failovers
                        self._max_failover_ms = max(
                            self._max_failover_ms,
                            (time.perf_counter() - t0) * 1e3)
                    served_by = rid
            if status == 500:
                # Engine-loop death answers 500 ("engine loop died") —
                # and a generate is safely re-runnable — so a 500 rotates
                # like a transport failure; the health poll decides
                # whether the member is actually dead.
                last = (status, payload)
                failovers += 1
                continue
            if status == 429:
                # Backpressure/draining: spill to the next member; only
                # an all-members-full fleet surfaces the 429.  Counted
                # only when selection didn't already count this attempt
                # as an affinity spill (no double-booking one hop).
                last = (status, payload)
                spilled_any = True
                if not spilled:
                    with self._lock:
                        self._spill_total += 1
                continue
            self._emit_route(tenant, served_by, failovers, spilled_any,
                             t0, status)
            finish(status)
            return status, payload
        if last is None:
            last = (503, json.dumps(
                {"error": "no replica available"}).encode())
        with self._lock:
            if last[0] != 429:
                self._failed_total += 1
        self._emit_route(tenant, "", failovers, spilled_any, t0, last[0])
        finish(last[0])
        return last

    def _emit_route(self, tenant: str, replica: str, failovers: int,
                    spilled: bool, t0: float, status: int) -> None:
        if self.telemetry is None:
            return
        self.telemetry.emit(
            "route", step=self._routed_total, tenant=tenant,
            replica=replica, failovers=failovers, spilled=spilled,
            route_ms=round((time.perf_counter() - t0) * 1e3, 3),
            ok=status == 200, status=status)

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

    def poll_members_once(self) -> None:
        """One health/statz sweep (control thread; callable from tests).
        Promotes starting members whose /healthz turned ok, demotes
        members that report engine_dead or stop answering, refreshes the
        /statz snapshots routing reads, and reaps drained + dead
        members' handles.

        Probes run CONCURRENTLY (one short-lived thread per member): a
        blackholed host that hangs its probe until timeout must not
        stall death detection — or the autoscale/respawn reaction — for
        the rest of the tier."""
        with self._lock:
            targets = [(m.id, m.url, m.state)
                       for m in self._members.values()
                       if m.state in ("starting", "healthy", "draining")]
        events: list[tuple[str, str]] = []
        reap: list[ReplicaHandle] = []
        probes: dict[str, tuple[int, dict, dict | None] | OSError] = {}

        def probe(rid: str, url: str) -> None:
            try:
                code, health = self._get_json(url, "/healthz")
                statz = None
                if code == 200:
                    _, statz = self._get_json(url, "/statz")
                probes[rid] = (code, health, statz)
            except OSError as e:
                probes[rid] = e

        probe_threads = [
            threading.Thread(target=probe, args=(rid, url), daemon=True)
            for rid, url, _ in targets]
        for t in probe_threads:
            t.start()
        for t in probe_threads:
            t.join()
        for rid, url, state in targets:
            outcome = probes.get(rid)
            if isinstance(outcome, OSError):
                e = outcome
                with self._lock:
                    m = self._members.get(rid)
                    if m is None or m.state not in ("starting", "healthy",
                                                    "draining"):
                        continue
                    m.fails += 1
                    # A booting replica is expected to refuse connections
                    # while it restores + compiles — probe failures only
                    # kill members that were once reachable, or whose
                    # boot overran boot_timeout_s (crashed at startup).
                    if m.state == "starting":
                        if time.time() - m.t_added > self.boot_timeout_s:
                            self._mark_dead_locked(m, "boot timeout")
                            events.append(("replica_dead",
                                           f"{rid}: boot timeout"))
                    elif m.fails >= self.fail_after:
                        self._mark_dead_locked(m, f"health: {e!r}")
                        events.append(("replica_dead",
                                       f"{rid}: health {e!r}"))
                continue
            if outcome is None:
                continue
            code, health, statz = outcome
            with self._lock:
                m = self._members.get(rid)
                if m is None or m.state in ("dead", "stopped"):
                    continue
                if code == 503 and health.get("status") == "engine_dead":
                    self._mark_dead_locked(
                        m, health.get("error") or "engine_dead")
                    events.append(("replica_dead",
                                   f"{rid}: engine_dead"))
                    continue
                if code != 200:
                    continue
                m.fails = 0
                m.statz = statz
                m.t_statz = time.monotonic()
                if m.state == "starting":
                    m.state = "healthy"
                    events.append(("replica_up", rid))
                elif m.state == "draining":
                    empty = (m.in_flight == 0
                             and not (statz or {}).get("queue_depth")
                             and not ((statz or {}).get("engine") or {})
                             .get("active_slots"))
                    if empty:
                        m.state = "stopped"
                        reap.append(m)
                        events.append(("scale_down", f"{rid}: drained"))
        with self._lock:
            # Dead members' PROCESSES must die too: a replica declared
            # dead (engine-fatal, or fail_after missed probes) may still
            # have a live subprocess holding a full copy of the model —
            # without this, every death incident leaks one engine's
            # RAM/CPU until fleet shutdown.
            for m in self._members.values():
                if m.state == "dead" and m.handle is not None \
                        and not m.reaped:
                    m.reaped = True
                    reap.append(m)
        for m in reap:
            if self.reap_fn is not None:
                try:
                    self.reap_fn(m)
                except Exception as e:  # noqa: BLE001 — reap best-effort
                    events.append(("reap_error", f"{m.id}: {e!r}"))
        for action, reason in events:
            self._emit_fleet(action, reason=reason)

    def _respawn_once(self) -> None:
        """Replace dead members 1:1 (``respawn=True`` + ``spawn_fn``) —
        one replacement per control tick, each death replaced once."""
        if not self.respawn or self.spawn_fn is None:
            return
        with self._lock:
            victim = next((m for m in self._members.values()
                           if m.state == "dead" and not m.replaced),
                          None)
            if victim is not None:
                victim.replaced = True
        if victim is None:
            return
        try:
            rid, url, handle = self.spawn_fn()
            self.add_replica(url, handle=handle, replica_id=rid)
        except Exception as e:  # noqa: BLE001 — retried next tick
            with self._lock:
                victim.replaced = False
            self._emit_fleet("spawn_error", reason=repr(e))
            return
        with self._lock:
            self._respawns += 1
        self._emit_fleet("respawn", reason=f"{rid} replaces {victim.id}")

    def _autoscale_once(self) -> None:
        if self.autoscale is None:
            return
        with self._lock:
            live = [m for m in self._members.values()
                    if m.state in ("starting", "healthy")]
            replicas = len(live)
            burning = sorted({
                flag
                for m in live if m.statz
                for flag in (m.statz.get("slo") or {}).get("burning", ())})
            idle = all(
                m.state == "healthy" and m.in_flight == 0
                and not (m.statz or {}).get("queue_depth")
                and not ((m.statz or {}).get("engine") or {})
                .get("active_slots")
                for m in live) and bool(live)
        decision = self.autoscale.observe(
            replicas=replicas, burning=bool(burning), idle=idle)
        if decision == "up" and self.spawn_fn is not None:
            try:
                rid, url, handle = self.spawn_fn()
                self.add_replica(url, handle=handle, replica_id=rid)
            except Exception as e:  # noqa: BLE001 — retried next burn
                self._emit_fleet("spawn_error", reason=repr(e))
                return
            self._emit_fleet("scale_up",
                             reason=f"{rid}: burning {burning}")
        elif decision == "down":
            with self._lock:
                victims = sorted(
                    (m for m in self._members.values()
                     if m.state == "healthy"),
                    key=lambda m: (replica_load(m.statz) + m.in_flight,
                                   # youngest first: keep the seasoned
                                   # members' affinity maps warm
                                   -m.t_added))
                victim = victims[0] if victims else None
                if victim is not None:
                    victim.state = "draining"
                    for tenant in [t for t, rid in self._affinity.items()
                                   if rid == victim.id]:
                        del self._affinity[tenant]
            if victim is not None:
                try:
                    self._get_json(victim.url, "/healthz")  # reachability
                    req = urllib.request.Request(
                        victim.url + "/drain", data=b"{}",
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=5.0):
                        pass
                except Exception:  # noqa: BLE001 — router-side drain holds
                    pass
                self._emit_fleet("drain_begin", reason=victim.id)

    def _control_loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.poll_members_once()
                self._respawn_once()
                self._autoscale_once()
                with self._lock:
                    self._ticks += 1
                now = time.monotonic()
                if now - self._last_fleet_emit >= self.fleet_emit_every_s:
                    self._last_fleet_emit = now
                    self._emit_fleet("poll")
            except Exception:  # noqa: BLE001 — the fleet outlives a tick
                pass

    def _emit_fleet(self, action: str, reason: str = "") -> None:
        if self.telemetry is None:
            return
        with self._lock:
            members = list(self._members.values())
            replicas = sum(m.state in ("starting", "healthy", "draining")
                           for m in members)
            healthy = sum(m.state == "healthy" for m in members)
            queue_depth = sum((m.statz or {}).get("queue_depth") or 0
                              for m in members if m.state == "healthy")
            active = sum(((m.statz or {}).get("engine") or {})
                         .get("active_slots") or 0
                         for m in members if m.state == "healthy")
            step = self._ticks
        self.telemetry.emit(
            "fleet", step=step, replicas=replicas, healthy=healthy,
            queue_depth=queue_depth, active_slots=active, action=action,
            reason=reason[:300])

    # ------------------------------------------------------------ views

    def stats(self) -> dict:
        """The router's own ``/statz`` (role-tagged so a watcher knows it
        is NOT a single server's snapshot)."""
        with self._lock:
            members = list(self._members.values())
            out = {
                "role": "router",
                "replicas": len(members),
                "healthy": sum(m.state == "healthy" for m in members),
                "starting": sum(m.state == "starting" for m in members),
                "dead": sum(m.state == "dead" for m in members),
                "routed": self._routed_total,
                "served": self._served_total,
                "failed": self._failed_total,
                "failovers": self._failover_total,
                "spills": self._spill_total,
                "respawns": self._respawns,
                "max_failover_ms": round(self._max_failover_ms, 3),
                "queue_depth": sum(
                    (m.statz or {}).get("queue_depth") or 0
                    for m in members if m.state == "healthy"),
                "active_slots": sum(
                    ((m.statz or {}).get("engine") or {})
                    .get("active_slots") or 0
                    for m in members if m.state == "healthy"),
                "tenant_affinity": dict(self._affinity),
            }
        if self.autoscale is not None:
            out["autoscale"] = self.autoscale.snapshot()
        tracer = tracing.active()
        if tracer is not None and tracer.buffer is not None:
            out["serve_trace_sampled"] = tracer.buffer.stats()
        return out

    def fleet_snapshot(self) -> dict:
        """The ``/fleetz`` payload: router stats + per-member views —
        ``tools/watch_serve.py --fleet``'s one-poll feed."""
        with self._lock:
            members = [m.view() for m in sorted(
                self._members.values(), key=lambda m: m.id)]
        return {"router": self.stats(), "members": members}

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
            name="router-http")
        self._http_thread.start()
        self._control = threading.Thread(
            target=self._control_loop, daemon=True, name="router-control")
        self._control.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
        if self._control is not None:
            self._control.join(timeout=10.0)

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
                    if stats["healthy"] == 0:
                        return self._reply_json(503, {
                            "status": "no_healthy_replica", **stats})
                    return self._reply_json(200, {"status": "ok",
                                                  **stats})
                if self.path == "/statz":
                    return self._reply_json(200, router.stats())
                if self.path == "/fleetz":
                    return self._reply_json(200, router.fleet_snapshot())
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
                    # Forward anyway under the default tenant — the
                    # replica owns request validation (400s it).
                    tenant = "default"
                status, payload = router.route(
                    body, tenant, wire=tracing.parse_wire(self.headers))
                return self._reply_raw(status, payload)

        return Handler
