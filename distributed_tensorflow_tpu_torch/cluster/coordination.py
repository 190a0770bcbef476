"""Python bindings for the C++ coordination service (N1 control plane).

Copied from ``distributed_tensorflow_tpu/cluster/coordination.py``; the
port builds and loads its OWN copy of the native source
(``distributed_tensorflow_tpu_torch/csrc/coordination/coord.cc``, the
same protocol, so either package's client talks to either package's
server), never the JAX package's source or library.  It provides task registration
with incarnation numbers, named barriers, heartbeat health tracking, and a KV
store — the control-plane residue of the reference's gRPC runtime
(``tf.train.Server``, reference ``distributed.py:54``) once the data plane has
moved onto ICI collectives.

Bindings use ctypes against a C ABI (no pybind11 in the image).  The shared
library is built on first use with ``g++`` from the in-tree source into the
package's ``_build/`` directory.
"""

from __future__ import annotations

import ctypes
import json
import os
import random
import threading
import time
import zlib

from ..utils import faults, tracing

_LIB_NAME = "libdtfcoord.so"
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.normpath(
    os.path.join(_HERE, "..", "csrc", "coordination", "coord.cc"))
# The built library goes beside the kernels' builds, in the package's
# ignored ``_build/`` (not in ``cluster/``, where it would be listed as a
# module of the package).
_BUILD = os.path.normpath(os.path.join(_HERE, "..", "_build"))

_lib = None
_lib_lock = threading.Lock()


def _load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        override = os.environ.get("DTF_COORD_BIN")
        if override:
            # Alternate prebuilt library (docs/static_analysis.md,
            # "Sanitizer builds"): `make -C csrc/coordination tsan` then
            # DTF_COORD_BIN=<...>/libdtfcoord.tsan.so runs every
            # coordination test against the instrumented binary
            # (sanitized builds additionally need the matching
            # LD_PRELOAD, e.g. $(g++ -print-file-name=libtsan.so)).
            lib = ctypes.CDLL(override)
        else:
            from ..utils.native import build_and_load
            os.makedirs(_BUILD, exist_ok=True)
            lib = build_and_load(os.path.join(_BUILD, _LIB_NAME), _SRC,
                                 extra_flags=("-pthread",))
        lib.dtf_coord_server_start.restype = ctypes.c_void_p
        lib.dtf_coord_server_start.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_char_p]
        lib.dtf_coord_server_port.restype = ctypes.c_int
        lib.dtf_coord_server_port.argtypes = [ctypes.c_void_p]
        lib.dtf_coord_server_stop.argtypes = [ctypes.c_void_p]
        lib.dtf_coord_server_join.argtypes = [ctypes.c_void_p]
        try:
            lib.dtf_coord_server_start2.restype = ctypes.c_void_p
            lib.dtf_coord_server_start2.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            lib.dtf_coord_server_set_shard.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        except AttributeError:
            # A prebuilt DTF_COORD_BIN older than the sharded plane: the
            # single-instance path still works; shard identity is
            # best-effort.
            pass
        try:
            lib.dtf_coord_server_start3.restype = ctypes.c_void_p
            lib.dtf_coord_server_start3.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_char_p, ctypes.c_double, ctypes.c_char_p]
        except AttributeError:
            # Prebuilt DTF_COORD_BIN older than coordinator HA: primaries
            # still work; standby_of raises at construction.
            pass
        lib.dtf_coord_client_create.restype = ctypes.c_void_p
        lib.dtf_coord_client_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.dtf_coord_client_destroy.argtypes = [ctypes.c_void_p]
        lib.dtf_coord_client_request.restype = ctypes.c_int
        lib.dtf_coord_client_request.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_double]
        _lib = lib
        return _lib


class CoordinationError(RuntimeError):
    """Base class for control-plane failures (protocol ERRs, timeouts)."""


class CoordinationTransportError(CoordinationError):
    """A transport-level failure (connect/send/recv) that survived the
    client's whole retry budget — the socket stayed dead through the
    jittered-backoff reconnect attempts.  Callers that can degrade
    gracefully (health polling, async exchange) catch the base class;
    callers that must distinguish a dead coordinator from a protocol
    error can catch this one."""


class CoordinationBackgroundError(CoordinationError):
    """A client background thread (heartbeats, health polling) died on an
    unexpected exception.  The thread latches the error instead of dying
    silently — a worker whose heartbeats stopped would otherwise only
    learn of it when the cluster evicts it — and the next protocol call
    on the owning client re-raises it here."""


class CoordinationServer:
    """Hosts the control-plane service — the PS role's surviving duty.

    ``persist_path`` (optional) journals the KV store to that file and
    restores it on construction, so a restarted coordination service keeps
    async-published parameters and signalling state (the durability the
    reference's PS provided by surviving its workers, SURVEY §5).

    ``standby_of`` (optional, ``"host:port"``) starts this instance as a
    warm STANDBY of that control shard (docs/fault_tolerance.md,
    "Coordinator HA"): it snapshot-bootstraps via ``REPLJOIN``, applies
    the primary's journal stream (``REPLSTREAM``), refuses mutating
    commands with ``NOTPRIMARY``, and promotes itself — coordinator
    generation bump, persisted when a persist path is set — after
    ``lease_timeout`` seconds without primary contact.
    """

    def __init__(self, port: int, num_tasks: int,
                 heartbeat_timeout: float = 10.0,
                 persist_path: str | None = None,
                 shard: int = 0, nshards: int = 1,
                 standby_of: str | None = None,
                 lease_timeout: float = 2.0,
                 advertise_addr: str | None = None):
        self._lib = _load_library()
        if persist_path:
            os.makedirs(os.path.dirname(os.path.abspath(persist_path)),
                        exist_ok=True)
        encoded = persist_path.encode() if persist_path else None
        if standby_of and not hasattr(self._lib,
                                      "dtf_coord_server_start3"):
            raise CoordinationError(
                "this libdtfcoord build predates coordinator HA — rebuild "
                "it (or drop the DTF_COORD_BIN override) to run a standby")
        if hasattr(self._lib, "dtf_coord_server_start3"):
            # Role travels through construction exactly like shard
            # identity below: a standby must never answer its first
            # request as a primary.
            # advertise_addr is how PEER standbys reach this one at
            # promotion time (probed so a survivor adopts an already-
            # promoted peer instead of promoting a second primary);
            # None -> the C++ default, loopback + the bound port.
            self._handle = self._lib.dtf_coord_server_start3(
                port, num_tasks, heartbeat_timeout, encoded, shard,
                nshards, standby_of.encode() if standby_of else None,
                lease_timeout,
                advertise_addr.encode() if advertise_addr else None)
        elif hasattr(self._lib, "dtf_coord_server_start2"):
            # Shard identity of a sharded coordination plane (SHARDINFO;
            # docs/param_exchange.md "Hierarchical exchange") travels
            # through construction, so it is fixed BEFORE the accept
            # thread takes its first connection — a bring-up probe racing
            # a fixed-port launch can never read the default identity.
            self._handle = self._lib.dtf_coord_server_start2(
                port, num_tasks, heartbeat_timeout, encoded, shard,
                nshards)
        else:
            # Prebuilt DTF_COORD_BIN older than the sharded plane.
            self._handle = self._lib.dtf_coord_server_start(
                port, num_tasks, heartbeat_timeout, encoded)
        self.shard = shard
        self.nshards = nshards
        self.standby_of = standby_of
        self.lease_timeout = lease_timeout
        self._started = False

    def start(self) -> None:
        if not self._handle:
            raise CoordinationError("coordination server failed to bind")
        self._started = True

    @property
    def port(self) -> int:
        return self._lib.dtf_coord_server_port(self._handle)

    def join(self) -> None:
        """Block serving forever (``server.join()`` parity, ``distributed.py:55-56``)."""
        self._lib.dtf_coord_server_join(self._handle)

    def stop(self) -> None:
        if self._handle:
            self._lib.dtf_coord_server_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


def _parse_endpoints(spec) -> list[tuple[str, int]]:
    """``"h1:p1,h2:p2"`` (or an iterable of the same / of tuples) ->
    ordered ``(host, port)`` list."""
    if spec is None:
        return []
    if isinstance(spec, str):
        spec = [a for a in spec.split(",") if a]
    out: list[tuple[str, int]] = []
    for addr in spec:
        if isinstance(addr, str):
            host, _, port = addr.rpartition(":")
            out.append((host, int(port)))
        else:
            out.append((addr[0], int(addr[1])))
    return out


def parse_standby_map(spec) -> dict[int, str]:
    """``--coord_standbys`` spec -> ``{instance_index: "host:port[,...]"}``.

    Two forms (docs/fault_tolerance.md, "KV-shard HA"):

    * ``"h:p[,h:p...]"`` — a plain endpoint list: standbys of the CONTROL
      shard only (instance 0), the PR-15 flat form.
    * ``"0:h:p[,h:p];1:h:p[,...]"`` — a per-instance map: each
      ``;``-separated segment is ``<instance>:<comma endpoint list>`` and
      wires that instance's ordered warm-standby list, so every KV shard
      of a sharded plane can carry its own replica set.

    A dict (``{0: "h:p", 1: "h:p"}``) passes through normalized.  A
    segment is map-form iff its first ``:``-field is all digits and the
    remainder still contains a ``:`` — ``"0:host:2222"`` is instance 0,
    ``"host:2222"`` is the flat form.
    """
    if not spec:
        return {}
    if isinstance(spec, dict):
        return {int(k): v for k, v in spec.items() if v}
    segments = [s for s in str(spec).split(";") if s]
    out: dict[int, str] = {}
    for seg in segments:
        idx, _, rest = seg.partition(":")
        if idx.isdigit() and ":" in rest:
            if int(idx) in out:
                raise ValueError(
                    f"duplicate instance {idx} in standby map {spec!r}")
            out[int(idx)] = rest
        elif len(segments) == 1:
            out[0] = seg  # flat form: control-shard standbys
        else:
            raise ValueError(
                f"malformed standby map segment {seg!r} in {spec!r} "
                "(want '<instance>:host:port[,host:port...]')")
    return out


def _fnv1a(data: str) -> str:
    """FNV-1a 32-bit hex — the replication wire checksum (mirror of
    ``Fnv1a`` in coord.cc)."""
    h = 0x811C9DC5
    for b in data.encode():
        h = ((h ^ b) * 0x01000193) & 0xFFFFFFFF
    return f"{h:08x}"


class CoordinationClient:
    """Per-task client: register, barrier, heartbeat, KV, health.

    Transport failures retry transparently: every protocol request is an
    idempotent one-shot line over a fresh connection, so a dropped/reset
    socket is retried with jittered exponential backoff (base
    ``retry_base``, doubling to ``retry_max_interval``) until
    ``retry_budget`` seconds have elapsed, then raises
    :class:`CoordinationTransportError`.  A transient coordinator outage
    (restart, network blip, injected chaos) thus becomes a stall, not a
    crash — the reference's ``recovery_wait_secs`` poll made survivable
    (``distributed.py:111,125``).  Liveness-cadence requests (register
    polls, heartbeats) opt out with ``retry_budget=0``: their own cadence
    IS the retry.

    **Coordinator HA** (docs/fault_tolerance.md, "Coordinator HA"): the
    client holds an ORDERED endpoint list — ``host`` may be a
    comma-separated ``"h1:p1,h2:p2"`` spec, and/or ``standbys`` appends
    warm-standby endpoints.  The same retry loop walks the list on a
    transport error or a ``NOTPRIMARY <leader>`` redirect (redirects cost
    no backoff), re-resolving leadership without losing a call's nonce
    semantics.  Every reply carries a generation/role trailer; once a
    coordinator generation G has been seen, replies stamped < G are
    fenced — a promoted-then-restarted old primary can never win a write
    back (the split-brain fence).  The first success after an outage
    whose generation moved forward emits one ``kind="recovery"``
    ``action="coord_failover"`` record carrying the worker-visible gap —
    or ``action="kv_shard_failover"`` (plus the shard id) when
    ``failover_shard`` names this client as a KV data shard of a sharded
    plane (docs/fault_tolerance.md, "KV-shard HA").
    """

    def __init__(self, host: str, port: int, task_id: int,
                 incarnation: int | None = None,
                 retry_budget: float = 6.0,
                 retry_base: float = 0.05,
                 retry_max_interval: float = 1.0,
                 standbys=None,
                 failover_shard: int | None = None):
        self._lib = _load_library()
        if "," in host or ":" in host:
            # "h1:p1[,h2:p2...]" spec (the observer/endpoint-list form);
            # port is ignored — each entry carries its own.
            self._endpoints = _parse_endpoints(host)
        else:
            self._endpoints = [(host, int(port))]
        self._endpoints += _parse_endpoints(standbys)
        # Eager handle creation (no I/O happens until a request), so the
        # heartbeat/health threads never race a lazy construction.
        self._handles = [
            self._lib.dtf_coord_client_create(h.encode(), p, task_id)
            for h, p in self._endpoints]
        self._active = 0
        self.task_id = task_id
        self.incarnation = incarnation if incarnation is not None else time.time_ns()
        self.restarts = 0
        self._registered = False  # set by register(); gates leave()
        self._retry_budget = float(retry_budget)
        self._retry_base = float(retry_base)
        self._retry_max_interval = float(retry_max_interval)
        # Deterministic per-task jitter: reproducible chaos runs, and peers
        # still desynchronize their retry storms against each other.
        self._retry_rng = random.Random(0x9E3779B1 * (task_id + 1))
        self._heartbeat_thread: threading.Thread | None = None
        self._heartbeat_stop = threading.Event()
        self._health_thread: threading.Thread | None = None
        self._cached_health: list[bool] = []
        self._health_lock = threading.Lock()
        self._progress_step = -1  # latest step to carry in heartbeats
        self._telemetry = None    # optional Telemetry bus (attach_telemetry)
        # Latched background-thread failure: (thread name, exception).  Set
        # by the heartbeat/health loops on a non-CoordinationError crash,
        # re-raised as CoordinationBackgroundError on the next client call.
        self._background_error: tuple[str, BaseException] | None = None
        # Coordinator-generation tracking (guarded by _gen_lock: the
        # heartbeat/health threads issue requests concurrently with the
        # caller).  last_generation/last_role mirror the newest reply
        # trailer; _max_generation is the fence; _outage_started stamps
        # the first failure of the current outage so the eventual success
        # can report the worker-visible gap.
        self._gen_lock = threading.Lock()
        self.last_generation = 0
        self.last_role: str | None = None
        self._max_generation = 0
        self._gen_seeded = len(self._endpoints) < 2
        self._outage_started: float | None = None
        self._outage_gen = 0
        # KV-shard identity for failover telemetry: None -> this client
        # talks to the control shard (action="coord_failover"); an int ->
        # a KV data shard of a sharded plane (action="kv_shard_failover"
        # stamped with the shard id).  Set by CoordinationRouter.
        self._failover_shard = failover_shard
        #: failovers this client has ridden (generation moved forward
        #: across an outage) — counted whether or not telemetry is
        #: attached.  ``param_sync`` polls this (via
        #: :meth:`plane_failovers`) to trigger its post-failover replay of
        #: write-once records a dead primary may have acknowledged but
        #: never replicated.
        self.failover_count = 0

    @classmethod
    def observer(cls, host: str, port: int = 0,
                 retry_budget: float = 2.0) -> "CoordinationClient":
        """A pure-observer client (task_id -1): it never registers, so it
        can never shrink a live cluster's elastic membership — the
        constructor ``tools/watch_run.py`` and the serving tier's
        checkpoint watcher share.  ``host`` may be a comma-separated
        endpoint list (primary first, then standbys)."""
        return cls(host, port, task_id=-1, retry_budget=retry_budget)

    def _latch_background_error(self, thread_name: str,
                                exc: BaseException) -> None:
        if self._background_error is None:
            self._background_error = (thread_name, exc)

    def check_background(self) -> None:
        """Raise :class:`CoordinationBackgroundError` if a background
        thread (heartbeats, health polling) has died on an unexpected
        exception.  Every protocol request calls this implicitly; loops
        whose hot path makes no protocol calls (the masked-sync mask reads
        only cached snapshots) must call it explicitly — a worker whose
        heartbeats silently stopped is a zombie awaiting eviction."""
        if self._background_error is not None:
            name, exc = self._background_error
            raise CoordinationBackgroundError(
                f"coordination client {name} thread died: "
                f"{type(exc).__name__}: {exc}") from exc

    def _seed_generation_fence(self) -> None:
        """One-shot, before this client's FIRST request on a multi-endpoint
        list: best-effort probe of every endpoint's generation (INFO, short
        timeout, failures ignored) so ``_max_generation`` starts at the
        cluster's real maximum.  Without this, a FRESH client — a restarted
        worker — whose list leads with a resurrected pre-promotion primary
        would accept the ghost wholesale (its replies carry the highest
        generation the client has ever seen) and split the brain the fence
        exists to prevent; the ghost answers happily, so only comparing it
        against the other endpoints can unmask it."""
        best_gen, best_idx = 0, None
        for i in range(len(self._endpoints)):
            once = self._request_once("INFO", 0.5, 1 << 14, index=i)
            if once is None:
                continue
            _, gen, role = once
            if gen > best_gen:
                best_gen, best_idx = gen, i
        with self._gen_lock:
            if best_gen > self._max_generation:
                self._max_generation = best_gen
        if best_idx is not None and best_idx != self._active:
            self._active = best_idx

    def _request_once(self, line: str, timeout: float, bufsize: int,
                      index: int | None = None
                      ) -> tuple[str, int, str | None] | None:
        """One wire attempt against the ACTIVE endpoint (or an explicit
        ``index``); None on transport failure, else ``(response,
        generation, role)`` with the server's 0x1f generation/role trailer
        split off the response body."""
        handle = self._handles[self._active if index is None else index]
        raw = None
        while True:
            buf = ctypes.create_string_buffer(bufsize)
            n = self._lib.dtf_coord_client_request(
                handle, line.encode(), buf, bufsize, timeout)
            if n < 0:
                return None
            if n < bufsize - 1:
                raw = buf.value.decode()
                break
            # Truncated: re-issue with a buffer sized to the full response
            # (requests are idempotent one-shot lines).
            bufsize = n + 2
        gen, role = 0, None
        cut = raw.rfind("\x1f")
        if cut >= 0 and raw.startswith("gen=", cut + 1):
            meta, raw = raw[cut + 1:], raw[:cut]
            for part in meta.split():
                key, _, value = part.partition("=")
                if key == "gen":
                    try:
                        gen = int(value)
                    except ValueError:
                        gen = 0
                elif key == "role":
                    role = value
        return raw, gen, role

    def _endpoint_index(self, addr: str) -> int | None:
        """Index of a ``host:port`` leader hint in the endpoint list (None
        when the hint is absent/unknown — round-robin takes over)."""
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            return None
        port_num = int(port)
        local = {"localhost", "127.0.0.1"}
        for i, (h, p) in enumerate(self._endpoints):
            if p != port_num:
                continue
            if h == host or (h in local and host in local):
                return i
        return None

    def _note_failure(self) -> None:
        """Stamp the start of an outage (first failure wins) so the
        eventual success can report the worker-visible gap."""
        with self._gen_lock:
            if self._outage_started is None:
                self._outage_started = time.monotonic()
                self._outage_gen = self._max_generation

    def _note_success(self, gen: int, role: str | None) -> None:
        """Record the reply trailer; when this success ends an outage AND
        the coordinator generation moved forward, the stall was a
        failover — emit the ``coord_failover`` (control shard) or
        ``kv_shard_failover`` (KV data shard, with the shard id) recovery
        record carrying the worker-visible gap (the acceptance budget:
        <= 2x the leadership lease timeout)."""
        failover = None
        with self._gen_lock:
            self.last_generation = gen
            self.last_role = role
            if gen > self._max_generation:
                self._max_generation = gen
            if self._outage_started is not None:
                gap = time.monotonic() - self._outage_started
                if gen > self._outage_gen:
                    failover = (gap, gen)
                    self.failover_count += 1
                self._outage_started = None
        if failover is not None and self._telemetry is not None:
            gap, gen = failover
            host, port = self._endpoints[self._active]
            if self._failover_shard is None:
                self._telemetry.counter("coord_failovers").inc()
                self._telemetry.emit(
                    "recovery", step=max(self._progress_step, 0),
                    action="coord_failover", gap_s=round(gap, 3),
                    generation=gen, endpoint=f"{host}:{port}")
            else:
                self._telemetry.counter("kv_shard_failovers").inc()
                self._telemetry.emit(
                    "recovery", step=max(self._progress_step, 0),
                    action="kv_shard_failover", gap_s=round(gap, 3),
                    generation=gen, endpoint=f"{host}:{port}",
                    shard=self._failover_shard)

    def _request(self, line: str, timeout: float = 5.0,
                 bufsize: int = 1 << 20,
                 retry_budget: float | None = None) -> str:
        self.check_background()
        seed = False
        with self._gen_lock:
            if not self._gen_seeded:
                self._gen_seeded = True
                seed = True
        if seed:
            self._seed_generation_fence()
        budget = self._retry_budget if retry_budget is None else retry_budget
        command = line.split(None, 1)[0] if line else ""
        deadline = time.monotonic() + budget
        delay = self._retry_base
        attempts = 0
        redirects = 0
        refusal = ""
        t0_unix, t0_perf = time.time(), time.perf_counter()
        while True:
            injector = faults.active()
            fault = (injector.coordination_fault(command)
                     if injector is not None else None)
            if fault is not None and fault[0] == "delay":
                time.sleep(fault[1])
                fault = None
            if fault is not None and fault[0] == "drop":
                once = None  # injected transport failure
            else:
                # Generation guard: stamp the request with the highest
                # coordinator generation this client has seen, so a stale
                # ghost (a restarted pre-promotion primary) refuses the
                # command WITHOUT executing it — the server-side half of
                # the split-brain fence.  Recomputed per attempt: the
                # fence tightens mid-walk as newer generations appear.
                seen = self._max_generation
                wire = f"gen={seen} {line}" if seen > 0 else line
                once = self._request_once(wire, timeout, bufsize)
            resp = None
            leader_idx = None
            walk = once is None  # plain transport failure: round-robin
            if once is not None:
                body, gen, role = once
                if body.startswith("NOTPRIMARY"):
                    # A standby (or demoted primary) refused and named its
                    # leader: walk the endpoint list toward it.  Not an
                    # answer — the call keeps its line (and nonce) intact.
                    parts = body.split()
                    if len(parts) > 1:
                        leader_idx = self._endpoint_index(parts[1])
                    refusal = ", last refusal NOTPRIMARY"
                    walk = True
                elif 0 < gen < self._max_generation:
                    # Stale primary: an older generation's ghost came back
                    # (a restarted pre-promotion primary).  Fence it —
                    # accepting its answer (worse: landing a write on it)
                    # would split the brain the promotion just healed.
                    refusal = ", last refusal stale generation"
                    walk = True
                else:
                    resp = body
            if resp is not None:
                self._note_success(gen, role)
                if attempts and self._telemetry is not None:
                    # The recovery itself is telemetry: one record naming
                    # the action, not one per retry (counters carry those).
                    self._telemetry.emit(
                        "recovery", step=max(self._progress_step, 0),
                        action="request_retry", command=command,
                        attempts=attempts)
                tracer = tracing.active()
                if tracer is not None:
                    # Control-plane spans: every request (retries included)
                    # becomes one span in the exported cross-worker trace,
                    # so a slow/stormy coordinator shows up as trace rows,
                    # not just as mystery step-time (docs/observability.md).
                    tracer.emit_span(
                        f"coord.{command.lower()}", t0_unix,
                        (time.perf_counter() - t0_perf) * 1000.0,
                        attempts=attempts)
                return resp
            # Failure: stamp the outage and advance the endpoint BEFORE
            # the deadline check, so even budget-0 callers (heartbeats)
            # leave the pointer on the next candidate for whoever calls
            # next.
            self._note_failure()
            if walk and len(self._endpoints) > 1:
                if leader_idx is not None and leader_idx != self._active:
                    self._active = leader_idx
                else:
                    self._active = (self._active + 1) % len(self._endpoints)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CoordinationTransportError(
                    f"coordination request failed: {command} "
                    f"({attempts + 1} attempt(s), retry budget {budget}s"
                    f"{refusal})")
            attempts += 1
            if self._telemetry is not None:
                self._telemetry.counter("coordination_retries").inc()
            if once is not None and redirects < len(self._endpoints):
                # A NOTPRIMARY/stale refusal came from a LIVE server: the
                # next endpoint is a different process, so walking on
                # costs no backoff — one free pass around the list, then
                # the normal jittered backoff paces the search for a
                # promotion still in flight.
                redirects += 1
                continue
            # Jittered exponential backoff (0.5-1.5x the nominal delay),
            # capped by the budget remainder.  Sleeping on the stop event
            # makes close() abort an in-flight retry loop promptly.
            sleep_for = min(delay * (0.5 + self._retry_rng.random()),
                            remaining)
            if self._heartbeat_stop.wait(max(sleep_for, 0.0)):
                raise CoordinationTransportError(
                    f"coordination request aborted by close(): {command}")
            delay = min(delay * 2.0, self._retry_max_interval)

    def register(self, timeout: float = 60.0, poll_interval: float = 1.0) -> int:
        """Register with poll-until-ready semantics (``recovery_wait_secs``-style,
        reference ``distributed.py:111,125``).  Returns the restart count the
        server has seen for this task id (>0 ⇒ we are a rejoining incarnation).
        """
        deadline = time.monotonic() + timeout
        while True:
            try:
                # retry_budget=0: this poll loop IS the retry policy.
                resp = self._request(
                    f"REGISTER {self.task_id} {self.incarnation}",
                    retry_budget=0.0)
                if resp.startswith("OK"):
                    for part in resp.split():
                        if part.startswith("restarts="):
                            self.restarts = int(part.split("=", 1)[1])
                    self._registered = True
                    return self.restarts
            except CoordinationError:
                pass
            if time.monotonic() >= deadline:
                raise CoordinationError("register timed out waiting for coordinator")
            time.sleep(poll_interval)

    def attach_telemetry(self, telemetry) -> None:
        """Route this client's control-plane timings (barrier waits, barrier
        failures) into a :class:`..utils.telemetry.Telemetry` bus — the
        cluster-health half of the unified stream."""
        self._telemetry = telemetry

    def plane_failovers(self) -> int:
        """Failovers this client has ridden (the single-instance view of
        :meth:`CoordinationRouter.plane_failovers`) — the monotonic count
        ``param_sync`` polls to trigger its post-failover record replay."""
        return self.failover_count

    def barrier(self, name: str, timeout: float = 60.0) -> None:
        # Per-call nonce (time_ns: unique across restarts) makes the arrival
        # retry-safe: if the barrier released but the OK was lost on the
        # wire, the transport retry re-presents the same nonce and the
        # server re-answers OK instead of entering the next generation.
        nonce = time.time_ns()
        t0 = time.perf_counter()
        try:
            resp = self._request(
                f"BARRIER {name} {self.task_id} {timeout} {nonce}",
                timeout=timeout + 5.0)
        except CoordinationError:
            if self._telemetry is not None:
                self._telemetry.counter("barrier_failures").inc()
            raise
        wait_ms = (time.perf_counter() - t0) * 1000.0
        if self._telemetry is not None:
            # Barrier wait is where stragglers first hurt everyone else:
            # the fastest worker pays the slowest worker's lateness here.
            self._telemetry.counter("barriers").inc()
            self._telemetry.histogram("barrier_wait_ms").record(wait_ms)
        tracer = tracing.active()
        if tracer is not None:
            # Named barrier span on top of the transport-level
            # coord.barrier span: the exported trace shows WHICH barrier
            # the cluster converged on, and the wait is the straggler's
            # cost to this worker.
            tracer.emit_span("barrier_wait", time.time() - wait_ms / 1000.0,
                             wait_ms, barrier=name)
        if resp != "OK":
            if self._telemetry is not None:
                self._telemetry.counter("barrier_failures").inc()
            raise CoordinationError(f"barrier {name!r} failed: {resp}")

    def heartbeat(self, step: int | None = None) -> None:
        """Liveness ping; ``step`` (optional) reports training progress for
        the coordinator's straggler detection.  No internal retry (budget
        0): a stale beat is worthless — the next one supersedes it."""
        injector = faults.active()
        if injector is not None and injector.heartbeats_frozen():
            return  # injected frozen-process window: beats silently dropped
        if step is None:
            step = self._progress_step
        self._request(f"HEARTBEAT {self.task_id} {step}", retry_budget=0.0)

    def set_progress(self, step: int) -> None:
        """Record this task's latest step; the heartbeat thread carries it to
        the coordinator (no extra round trip on the training hot path)."""
        self._progress_step = int(step)

    def start_heartbeats(self, interval: float = 1.0) -> None:
        if self._heartbeat_thread is not None:
            return
        def loop():
            while not self._heartbeat_stop.wait(interval):
                try:
                    self.heartbeat()
                except CoordinationError:
                    pass  # a stale beat is worthless; the next one retries
                except Exception as e:  # noqa: BLE001 — latch, don't die mute
                    # Dying silently here turns into a mystery eviction
                    # minutes later; latch and surface on the next call.
                    self._latch_background_error("heartbeat", e)
                    return
        self._heartbeat_thread = threading.Thread(target=loop, daemon=True)
        self._heartbeat_thread.start()

    def kv_set(self, key: str, value: str) -> None:
        resp = self._request(f"KVSET {key} {value}")
        if resp != "OK":
            raise CoordinationError(f"kv_set failed: {resp}")

    def kv_get(self, key: str) -> str | None:
        resp = self._request(f"KVGET {key}")
        if resp.startswith("OK"):
            return resp[3:]
        return None

    def kv_wait(self, key: str, timeout: float = 60.0,
                poll_interval: float = 1.0) -> str:
        """Poll for a key — the chief-initializes/others-wait pattern
        (``prepare_or_wait_for_session``, reference ``distributed.py:121-125``).

        Polls with capped exponential backoff: the interval starts at
        ``min(0.05, poll_interval)`` and doubles up to ``poll_interval``
        (the cap).  A fast chief is noticed within ~50 ms while a long
        chief init (minutes of restore/compile) costs one syscall per
        ``poll_interval`` instead of a fixed-cadence idle spin.
        """
        deadline = time.monotonic() + timeout
        interval = min(0.05, poll_interval)
        while True:
            value = self.kv_get(key)
            if value is not None:
                return value
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CoordinationError(f"timed out waiting for key {key!r}")
            time.sleep(min(interval, remaining))
            interval = min(interval * 2.0, poll_interval)

    def health(self, straggler_lag: int = 0) -> list[bool]:
        """Live set per task — feeds the R<N replica mask.

        Heartbeat-based liveness; with ``straggler_lag > 0`` a
        slow-but-heartbeating task more than that many steps behind the
        front-runner is also excluded (it rejoins once it catches up) — the
        reference SyncReplicasOptimizer's drop-the-slow semantics
        (``distributed.py:97-100``)."""
        resp = self._request(f"HEALTH {int(straggler_lag)}")
        if not resp.startswith("OK"):
            raise CoordinationError(f"health query failed: {resp}")
        return [bit == "1" for bit in resp.split()[1:]]

    def progress(self) -> list[int]:
        """Latest heartbeat-reported step per task (-1 = none reported)."""
        resp = self._request("PROGRESS")
        if not resp.startswith("OK"):
            raise CoordinationError(f"progress query failed: {resp}")
        return [int(s) for s in resp.split()[1:]]

    def heartbeat_ages(self) -> list[float]:
        """Seconds since each task's last heartbeat (-1.0 = never seen) —
        the raw straggler signal behind :meth:`health`, for telemetry."""
        resp = self._request("AGES")
        if not resp.startswith("OK"):
            raise CoordinationError(f"ages query failed: {resp}")
        return [float(s) for s in resp.split()[1:]]

    def info(self) -> dict:
        """Server INFO line as a dict (``num_tasks``, ``registered``,
        ``evictions``, ``epoch``, ``active``, plus the coordinator-HA
        fields ``role``, ``generation``, ``standbys``, ``repl_lag``,
        ``last_promotion_age_s``) — how standalone tools
        (``tools/watch_run.py``, ``tools/coord_shard.py --status``) learn
        the cluster and control-plane state without flags."""
        return self._parse_int_fields(self._request("INFO"), "info")

    @staticmethod
    def _parse_int_fields(resp: str, what: str) -> dict:
        """``OK key=value ...`` reply -> dict (INFO/SHARDINFO shape):
        values parse as int, then float, else stay strings (``role``)."""
        if not resp.startswith("OK"):
            raise CoordinationError(f"{what} query failed: {resp}")
        out: dict = {}
        for part in resp.split()[1:]:
            key, _, value = part.partition("=")
            try:
                out[key] = int(value)
            except ValueError:
                try:
                    out[key] = float(value)
                except ValueError:
                    out[key] = value
        return out

    def shard_info(self) -> dict[str, int]:
        """The server instance's shard identity (``shard``, ``nshards``)
        — how a :class:`CoordinationRouter` (or an operator probe) verifies
        it reached the instance a key hashed to.  A pre-sharding server
        answers ``shard=0 nshards=1``."""
        return self._parse_int_fields(self._request("SHARDINFO"),
                                      "shard info")

    def repl_join(self, addr: str = "-") -> dict:
        """Attach to the control shard's replication plane (the
        ``REPLJOIN`` snapshot bootstrap a warm standby performs; docs/
        fault_tolerance.md, "Coordinator HA").  Returns the snapshot —
        ``snap_seq``, ``generation``, ``lease_timeout``, the assigned
        ``standby_id``, and the checksum-verified state ``records`` — and
        registers this caller as a standby in the primary's ack table.
        ``addr`` is the advertised endpoint peers see in REPLSTREAM acks
        (``"-"`` = unadvertised: a tap, not a promotable standby).  Test
        and debug tooling drives this directly; production standbys run
        the C++ pull loop (``CoordinationServer(standby_of=...)``)."""
        resp = self._request(f"REPLJOIN {addr}")
        if not resp.startswith("OK"):
            raise CoordinationError(f"repl join failed: {resp}")
        chunks = resp.split("\x1e")
        head = chunks[0].split()
        out = {"snap_seq": int(head[1]), "generation": int(head[2]),
               "lease_timeout": float(head[3]),
               "standby_id": int(head[4]), "records": []}
        for chunk in chunks[1:]:
            checksum, _, body = chunk.partition(" ")
            if _fnv1a(body) != checksum:
                raise CoordinationError(
                    f"repl snapshot checksum mismatch on {body[:60]!r}")
            out["records"].append(body)
        return out

    def repl_stream(self, standby_id: int, from_seq: int) -> dict:
        """Pull one batch of the control shard's journal stream
        (``REPLSTREAM``): records ``[from_seq, latest_seq]`` as
        ``{"seq", "body"}`` dicts, sequence-checked and
        checksum-verified, behind ``latest_seq``/``generation`` and the
        per-standby ``acks`` table (``{id: {"acked_seq", "addr"}}``).
        Raises on ``ERR rejoin`` (the primary restarted and forgot this
        standby id — :meth:`repl_join` again) and ``ERR resync`` (fell
        off the bounded log — re-bootstrap)."""
        resp = self._request(f"REPLSTREAM {int(standby_id)} {int(from_seq)}")
        if not resp.startswith("OK"):
            raise CoordinationError(f"repl stream failed: {resp}")
        chunks = resp.split("\x1e")
        head = chunks[0].split()
        out = {"latest_seq": int(head[1]), "generation": int(head[2]),
               "acks": {}, "records": []}
        for token in head[3:]:
            if not token.startswith("acks=") or len(token) == 5:
                continue
            for entry in token[5:].split(","):
                sid, acked, addr = entry.split(":", 2)
                out["acks"][int(sid)] = {"acked_seq": int(acked),
                                         "addr": addr}
        expect = int(from_seq)
        for chunk in chunks[1:]:
            seq, checksum, body = chunk.split(" ", 2)
            if _fnv1a(body) != checksum:
                raise CoordinationError(
                    f"repl stream checksum mismatch at seq {seq}")
            if int(seq) != expect:
                raise CoordinationError(
                    f"repl stream sequence gap: got {seq}, want {expect}")
            expect += 1
            out["records"].append({"seq": int(seq), "body": body})
        return out

    def server_time(self) -> float:
        """The coordination server's epoch clock (seconds) — one sample of
        the ``TIME`` protocol command."""
        resp = self._request("TIME")
        if not resp.startswith("OK"):
            raise CoordinationError(f"time query failed: {resp}")
        return float(resp.split()[1])

    def clock_offset(self, samples: int = 5) -> tuple[float, float]:
        """NTP-style offset estimate against the coordination server.

        Each sample brackets a ``TIME`` request between two local
        ``time.time()`` reads and takes the midpoint; the sample with the
        smallest round trip wins (its midpoint error is bounded by rtt/2).
        Returns ``(offset_seconds, rtt_seconds)`` where *offset* is
        ``server_clock - local_clock`` — ADD it to local epoch stamps to
        land on the server's timeline.  Workers measure this once at
        startup and stamp it into their telemetry stream as a
        ``kind="clock_sync"`` record; ``tools/export_trace.py`` applies it
        when merging per-worker spans into one cross-worker trace, so the
        alignment error is bounded by the measured RTT."""
        best: tuple[float, float] | None = None
        for _ in range(max(int(samples), 1)):
            t0 = time.time()
            server = self.server_time()
            t1 = time.time()
            rtt = t1 - t0
            offset = server - (t0 + t1) / 2.0
            if best is None or rtt < best[1]:
                best = (offset, rtt)
        return best

    def stat_put(self, payload) -> None:
        """Publish one live-stats entry (a dict, JSON-encoded compactly, or
        a pre-encoded single-line string) into this task's bounded ring on
        the coordination server.  No retry (budget 0): stale stats are
        worthless — the next logged step supersedes them.  The training
        loop publishes per-step summaries here so ``tools/watch_run.py``
        can watch a live run without touching its files."""
        if not isinstance(payload, str):
            payload = json.dumps(payload, separators=(",", ":"))
        if "\n" in payload or "\x1e" in payload:
            raise ValueError(
                "stat payload must be a single line without the 0x1e "
                "record separator")
        # Sub-second timeout, no retry: this is called from the training
        # loop's log boundary — a black-holed coordinator must cost the
        # step milliseconds, not the default request timeout.
        resp = self._request(f"STATPUT {self.task_id} {payload}",
                             timeout=0.5, retry_budget=0.0)
        if resp != "OK":
            raise CoordinationError(f"stat_put failed: {resp}")

    def stat_dump(self, last: int = 1) -> list[dict]:
        """Newest ``last`` ring entries per task:
        ``[{task, age_s, seq, stat}]`` where ``age_s`` is the server-side
        seconds since receipt (staleness without trusting worker clocks)
        and ``stat`` is the decoded JSON payload (``{"raw": ...}`` when a
        publisher sent something that isn't JSON)."""
        resp = self._request(f"STATDUMP {int(last)}")
        if not resp.startswith("OK"):
            raise CoordinationError(f"stat_dump failed: {resp}")
        entries: list[dict] = []
        for chunk in resp.split("\x1e")[1:]:
            head = chunk.split(" ", 3)
            if len(head) < 3:
                continue
            raw = head[3] if len(head) > 3 else ""
            try:
                stat = json.loads(raw)
                if not isinstance(stat, dict):
                    stat = {"raw": stat}
            except ValueError:
                stat = {"raw": raw}
            entries.append({"task": int(head[0]), "age_s": float(head[1]),
                            "seq": int(head[2]), "stat": stat})
        return entries

    @staticmethod
    def _parse_members(resp: str, what: str) -> tuple[int, list[int]]:
        if not resp.startswith("OK"):
            raise CoordinationError(f"{what} query failed: {resp}")
        parts = resp.split()[1:]
        if not parts:
            raise CoordinationError(f"{what} reply missing epoch: {resp!r}")
        return int(parts[0]), [int(t) for t in parts[1:]]

    def members(self) -> tuple[int, list[int]]:
        """``(membership_epoch, active_task_ids)`` — the elastic replica
        set.  The epoch increments on every shrink (lease expiry, LEAVE,
        explicit evict) and grow (re-register, explicit admit), so callers
        can detect resizes without diffing the id list
        (docs/fault_tolerance.md, "Elastic membership")."""
        return self._parse_members(self._request("MEMBERS"), "members")

    def reconfigure(self, task: int | None = None,
                    active: bool = True) -> tuple[int, list[int]]:
        """Force a lease scan and return the authoritative
        ``(epoch, active_task_ids)``; with ``task`` set, additionally evict
        (``active=False``) or admit (``active=True``) that task explicitly —
        the chief-driven resize path."""
        line = ("RECONFIGURE" if task is None
                else f"RECONFIGURE {int(task)} {1 if active else 0}")
        return self._parse_members(self._request(line), "reconfigure")

    def start_health_polling(self, interval: float = 1.0,
                             num_tasks: int | None = None,
                             straggler_lag: int = 0) -> None:
        """Background health refresh so hot-path readers (the per-step replica
        mask) never pay a TCP round trip — they read the cached snapshot."""
        with self._health_lock:
            if not self._cached_health:
                self._cached_health = [True] * (num_tasks or 1)
        if self._health_thread is not None:
            return

        def loop():
            while not self._heartbeat_stop.wait(interval):
                try:
                    h = self.health(straggler_lag)
                except CoordinationError:
                    continue
                except Exception as e:  # noqa: BLE001 — latch, don't die mute
                    self._latch_background_error("health-poll", e)
                    return
                with self._health_lock:
                    self._cached_health = h
        self._health_thread = threading.Thread(target=loop, daemon=True)
        self._health_thread.start()

    def cached_health(self) -> list[bool]:
        """Latest background-polled health snapshot (optimistic before first poll)."""
        with self._health_lock:
            return list(self._cached_health)

    def chaos(self, *directive: object) -> None:
        """Drive the server-side fault injector (the ``CHAOS`` protocol
        command, csrc/coordination/coord.cc) — test/ops tooling only:
        ``chaos("drop", 3)`` drops the next 3 requests (connection closed
        with no response), ``chaos("dropfor", 2.5)`` drops everything for
        2.5 s, ``chaos("delay", 0.2, 5)`` delays the next 5 responses by
        0.2 s, ``chaos("off")`` clears.  The CHAOS command itself is never
        dropped/delayed, so the harness can always disarm."""
        line = " ".join(["CHAOS", *(str(d) for d in directive)])
        resp = self._request(line)
        if resp != "OK":
            raise CoordinationError(f"chaos directive failed: {resp}")

    def leave(self) -> None:
        """Voluntary departure: deregisters AND shrinks the elastic
        membership set immediately (epoch bump — survivors resize without
        waiting out our lease).  A client that never registered is not a
        member and must not shrink a live cluster (eval-mode/standalone
        clients share the coordinator address); a closed client no-ops."""
        if not self._handles or not self._registered:
            return
        try:
            self._request(f"LEAVE {self.task_id}", retry_budget=0.0)
            self._registered = False
        except CoordinationError:
            pass

    def close(self) -> None:
        self._heartbeat_stop.set()
        if self._heartbeat_thread is not None:
            self._heartbeat_thread.join(timeout=5.0)
            self._heartbeat_thread = None
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)
            self._health_thread = None
        for handle in self._handles:
            self._lib.dtf_coord_client_destroy(handle)
        self._handles = []

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


#: Record-family suffixes that must co-locate with their base key on ONE
#: instance of a sharded coordination plane: the chunked-KV transport's
#: commit-point ordering (chunks, then ``.fp``, then the meta entry) and
#: the version hints (``.v``/``.hint``/``.tfp``) are only meaningful
#: against the same instance's view of the base entry.
_FAMILY_SUFFIXES = (".fp", ".v", ".hint", ".tfp")


def router_base_key(key: str) -> str:
    """The routing key of a KV entry: its record family's base key.

    ``<base>.c<i>`` chunk entries and the ``.fp``/``.v``/``.hint``/``.tfp``
    side entries all hash as ``<base>``, so one publication's whole key
    family lands on one instance — write ordering (chunks before the meta
    commit point) and torn-read detection keep their single-instance
    semantics under the sharded plane."""
    for suffix in _FAMILY_SUFFIXES:
        if key.endswith(suffix):
            return key[:-len(suffix)]
    dot = key.rfind(".c")
    if dot > 0 and key[dot + 2:].isdigit():
        return key[:dot]
    return key


class CoordinationRouter:
    """Client facade over a sharded coordination plane (docs/
    param_exchange.md, "Hierarchical exchange").

    The KV/blob plane spreads across ``M`` coordinator instances by stable
    key hash (``crc32(router_base_key(key)) % M``); membership, barriers,
    leases, heartbeats, stats, and every other control command stay pinned
    to instance 0 — the **control shard** — so there is exactly one
    authoritative membership epoch.  Each instance's requests retry/fail
    over independently with the owning client's existing jittered-backoff
    budget: one dead KV shard makes *its* keys unavailable (callers see
    the usual :class:`CoordinationTransportError` and degrade as they
    already do for a flat coordinator) without touching the control plane
    or the other shards.

    The facade duck-types :class:`CoordinationClient` (same method
    surface), so averagers, supervisors, and watchers take either.

    ``standbys`` (optional) wires per-instance ordered warm-standby lists
    — any :func:`parse_standby_map` form (docs/fault_tolerance.md,
    "KV-shard HA").  Each instance's client walks ITS list on a dead or
    demoted primary exactly like the control-shard client (PR 15's
    endpoint walk generalized to every shard); KV shards stamp the
    recovery record ``action="kv_shard_failover"`` with their shard id.
    ``control_standbys`` (``"host:port,..."``) is the pre-sharded-HA
    alias: standbys of the CONTROL shard (instance 0) only."""

    def __init__(self, addresses, task_id: int,
                 incarnation: int | None = None,
                 control_standbys=None, standbys=None, **client_kwargs):
        parsed = _parse_endpoints(addresses)
        if not parsed:
            raise ValueError("coordination router needs >= 1 instance")
        standby_map = parse_standby_map(standbys)
        if control_standbys:
            standby_map.setdefault(0, control_standbys)
        for idx in standby_map:
            if not 0 <= idx < len(parsed):
                raise ValueError(
                    f"standby map names instance {idx} but the plane has "
                    f"{len(parsed)} instance(s)")
        self._clients = []
        for i, (host, port) in enumerate(parsed):
            kwargs = dict(client_kwargs)
            if standby_map.get(i):
                kwargs["standbys"] = standby_map[i]
            if i > 0:
                # KV data shard: failovers are per-shard recovery events.
                kwargs["failover_shard"] = i
            self._clients.append(
                CoordinationClient(host, port, task_id,
                                   incarnation=incarnation, **kwargs))
        self.addresses = parsed

    @classmethod
    def observer(cls, addresses, retry_budget: float = 2.0,
                 standbys=None) -> "CoordinationRouter":
        """Observer router (task_id -1, never registers) — the sharded
        counterpart of :meth:`CoordinationClient.observer`."""
        return cls(addresses, task_id=-1, retry_budget=retry_budget,
                   standbys=standbys)

    @property
    def control(self) -> CoordinationClient:
        """Instance 0 — the control shard every non-KV command goes to."""
        return self._clients[0]

    @property
    def num_instances(self) -> int:
        return len(self._clients)

    def instance_for(self, key: str) -> int:
        return zlib.crc32(router_base_key(key).encode()) \
            % len(self._clients)

    def instance_client(self, index: int) -> CoordinationClient:
        return self._clients[index]

    def _kv_client(self, key: str) -> CoordinationClient:
        return self._clients[self.instance_for(key)]

    # -- routed KV/blob traffic ------------------------------------------

    def kv_set(self, key: str, value: str) -> None:
        self._kv_client(key).kv_set(key, value)

    def kv_get(self, key: str) -> str | None:
        return self._kv_client(key).kv_get(key)

    def kv_wait(self, key: str, timeout: float = 60.0,
                poll_interval: float = 1.0) -> str:
        return self._kv_client(key).kv_wait(key, timeout=timeout,
                                            poll_interval=poll_interval)

    # -- whole-plane plumbing --------------------------------------------

    def attach_telemetry(self, telemetry) -> None:
        for client in self._clients:
            client.attach_telemetry(telemetry)

    def check_background(self) -> None:
        for client in self._clients:
            client.check_background()

    def shard_map(self) -> list[dict[str, int]]:
        """Every instance's SHARDINFO identity, in route order — the
        bring-up/debug probe that catches a mis-wired instance list."""
        return [c.shard_info() for c in self._clients]

    def plane_failovers(self) -> int:
        """Total failovers ridden across every instance's client — a
        monotonic counter.  A bump means some primary died and a standby
        was promoted, so writes the dead primary acknowledged inside its
        replication-lag window may be gone; ``param_sync`` polls this
        each period and replays its write-once records when it moves."""
        return sum(c.failover_count for c in self._clients)

    def leave(self) -> None:
        self.control.leave()

    def close(self) -> None:
        for client in self._clients:
            client.close()

    def __getattr__(self, name):
        # Everything else (register, barrier, heartbeat, members, stats,
        # time, health polling, task_id/_progress_step, ...) is
        # control-shard state: delegate to instance 0, the one place
        # membership lives.  The router's own attributes are exempt so a
        # half-built self can never recurse here.
        if name in ("_clients", "addresses"):
            raise AttributeError(name)
        return getattr(self._clients[0], name)

    def __enter__(self) -> "CoordinationRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MembershipWatcher:
    """Background view of the coordination service's elastic membership.

    Polls ``MEMBERS`` every ``interval`` seconds and caches the latest
    ``(epoch, active_task_ids)`` snapshot for hot-path readers (the R<N
    replica mask reads it exactly like the cached health bits — no TCP on
    the step path).  Every epoch change is recorded as a transition event
    and, with telemetry attached, emitted as a ``kind="recovery"`` record:
    ``action="elastic_shrink"`` when the active set got smaller,
    ``action="elastic_grow"`` when it got larger (``elastic_reshape`` for
    an equal-size swap), carrying the epoch and the active count — the
    resize trail ``tools/summarize_run.py`` rolls into the run report.

    Poll failures keep the last snapshot (an unreachable coordinator is a
    health problem, not a membership decision); the watcher itself must
    never take training down.
    """

    def __init__(self, client: CoordinationClient, num_tasks: int,
                 interval: float = 1.0, telemetry=None,
                 print_fn=print):
        if num_tasks < 1:
            raise ValueError(f"num_tasks must be >= 1, got {num_tasks}")
        self._client = client
        self._num_tasks = num_tasks
        self._interval = interval
        self._telemetry = telemetry
        self._print = print_fn
        self._step_fn = lambda: 0
        self._lock = threading.Lock()
        # Optimistic before the first successful poll (epoch 0 = no server
        # data yet): everyone is presumed active, matching the server's own
        # bring-up semantics.
        self._epoch = 0
        self._active: tuple[int, ...] = tuple(range(num_tasks))
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: transition log: dicts with action/epoch/active (test surface)
        self.events: list[dict] = []

    def attach_telemetry(self, telemetry) -> None:
        self._telemetry = telemetry

    def set_step_fn(self, fn) -> None:
        """Current-step callable used to key the recovery records."""
        self._step_fn = fn

    # -- reads (lock-guarded snapshot; safe from the step hot path) -------

    def snapshot(self) -> tuple[int, tuple[int, ...]]:
        with self._lock:
            return self._epoch, self._active

    @property
    def epoch(self) -> int:
        return self.snapshot()[0]

    def active_tasks(self) -> tuple[int, ...]:
        return self.snapshot()[1]

    def is_active(self, task: int) -> bool:
        return task in self.snapshot()[1]

    def active_mask(self, num_tasks: int | None = None) -> list[bool]:
        """Per-task membership bits, same shape as
        :meth:`CoordinationClient.health` — AND the two for the replica
        mask (membership says who belongs, health says who is answering)."""
        n = self._num_tasks if num_tasks is None else num_tasks
        active = set(self.snapshot()[1])
        return [t in active for t in range(n)]

    # -- refresh ----------------------------------------------------------

    def poll(self) -> tuple[int, tuple[int, ...]]:
        """One synchronous refresh (also the test hook); returns the
        snapshot, last-known on coordinator failure.  A latched
        background-thread crash (CoordinationBackgroundError) propagates —
        swallowing it here would hide a dead heartbeat thread behind a
        forever-stale snapshot."""
        try:
            epoch, active = self._client.members()
        except CoordinationBackgroundError:
            raise
        except CoordinationError:
            if self._telemetry is not None:
                self._telemetry.counter("membership_poll_failures").inc()
            return self.snapshot()
        self._apply(epoch, tuple(active))
        return self.snapshot()

    def wait_for_epoch(self, min_epoch: int, timeout: float = 30.0,
                       poll_interval: float = 0.1) -> tuple[int, tuple[int, ...]]:
        """Poll until the epoch reaches ``min_epoch`` (resize rendezvous
        for tests and the rejoin path); raises CoordinationError on
        timeout."""
        deadline = time.monotonic() + timeout
        while True:
            epoch, active = self.poll()
            if epoch >= min_epoch:
                return epoch, active
            if time.monotonic() >= deadline:
                raise CoordinationError(
                    f"membership epoch never reached {min_epoch} "
                    f"(last seen {epoch})")
            time.sleep(poll_interval)

    def _apply(self, epoch: int, active: tuple[int, ...]) -> None:
        with self._lock:
            prev_epoch, prev_active = self._epoch, self._active
            if epoch == prev_epoch:
                return
            self._epoch, self._active = epoch, active
        if prev_epoch == 0:
            # First server contact: adopting the authoritative view is not
            # a resize unless the set actually differs from presumed-full.
            if len(active) == self._num_tasks:
                return
        if len(active) < len(prev_active):
            action = "elastic_shrink"
        elif len(active) > len(prev_active):
            action = "elastic_grow"
        else:
            action = "elastic_reshape"
        event = dict(action=action, epoch=epoch,
                     active_count=len(active), active=list(active))
        self.events.append(event)
        self._print(f"MembershipWatcher: {action} to epoch {epoch} "
                    f"(active {list(active)})")
        if self._telemetry is not None:
            try:
                step = int(self._step_fn())
            except Exception:
                step = 0
            self._telemetry.counter(action).inc()
            self._telemetry.emit("recovery", step=max(step, 0), **event)

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self._interval):
                try:
                    self.poll()
                except CoordinationBackgroundError:
                    # The owning client's heartbeat/health thread died; the
                    # latch will surface on the next main-thread protocol
                    # call (the elastic controller checks every step) —
                    # stop polling rather than spin on the same error.
                    return
        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="membership-watcher")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "MembershipWatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ClusterHealthReporter:
    """Periodic cluster-health snapshots into the telemetry stream.

    Every ``interval`` seconds a background thread queries the coordination
    service for the per-task liveness bits, heartbeat ages, and progress
    steps, derives the straggler gap (front-runner step minus slowest live
    task's step), and emits one ``kind="cluster_health"`` record through
    the :class:`..utils.telemetry.Telemetry` bus.  Stragglers and dead
    workers thus show up in the same per-host JSONL stream as the step
    timings — visible in ``tools/summarize_run.py`` — instead of only as
    eventual barrier timeouts.

    A query failure emits a ``coordinator_reachable: false`` record rather
    than raising: the reporter must never be able to take training down,
    and an unreachable coordinator is itself a health signal worth a line
    in the stream.
    """

    def __init__(self, client: CoordinationClient, telemetry,
                 num_tasks: int, interval: float = 10.0,
                 straggler_lag: int = 0):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        self._client = client
        self._telemetry = telemetry
        self._num_tasks = num_tasks
        self._interval = interval
        self._straggler_lag = straggler_lag
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step_fn = lambda: 0  # current global step for record keying
        self._prev_alive: list[bool] | None = None
        self._evicted: set[int] = set()  # tasks seen alive, then dead
        self.snapshots = 0

    def set_step_fn(self, fn) -> None:
        """Provide the 'current step' callable used to key records (e.g.
        the rate meter's total); defaults to 0."""
        self._step_fn = fn

    def tick(self) -> dict | None:
        """One snapshot: query, derive, emit.  Returns the emitted fields
        (None when the coordinator was unreachable) — also the test hook."""
        try:
            alive = self._client.health(self._straggler_lag)
            ages = self._client.heartbeat_ages()
            progress = self._client.progress()
        except CoordinationError:
            self._telemetry.counter("health_poll_failures").inc()
            self._telemetry.emit("cluster_health", step=self._safe_step(),
                                 coordinator_reachable=False)
            return None
        n = self._num_tasks
        alive, ages, progress = alive[:n], ages[:n], progress[:n]
        # Liveness *transitions* are recovery events in their own right:
        # a peer leaving the live set (heartbeat death or straggler
        # exclusion — an eviction) and an EVICTED peer coming back (a
        # rejoin) each get one kind-tagged record, so summarize_run can
        # name what happened instead of leaving it implicit in adjacent
        # snapshots.  Rejoin is gated on a prior eviction: a worker merely
        # registering late during normal bring-up (dead->alive with no
        # alive history) is not a recovery and must not pollute the
        # recovery stream chaos assertions key on.
        if self._prev_alive is not None and len(self._prev_alive) == len(alive):
            for task, (was, now) in enumerate(zip(self._prev_alive, alive)):
                if was and not now:
                    self._evicted.add(task)
                    self._telemetry.counter("peer_evictions").inc()
                    self._telemetry.emit(
                        "recovery", step=self._safe_step(),
                        action="peer_eviction", task=task)
                elif now and not was and task in self._evicted:
                    self._evicted.discard(task)
                    self._telemetry.counter("peer_rejoins").inc()
                    self._telemetry.emit(
                        "recovery", step=self._safe_step(),
                        action="peer_rejoin", task=task)
        self._prev_alive = list(alive)
        live_steps = [s for ok, s in zip(alive, progress) if ok and s >= 0]
        straggler_gap = (max(live_steps) - min(live_steps)
                         if len(live_steps) >= 2 else 0)
        max_age = max((a for a in ages if a >= 0), default=-1.0)
        fields = dict(
            coordinator_reachable=True,
            alive=[int(b) for b in alive],
            alive_count=sum(alive),
            dead_count=n - sum(alive),
            # Structured eviction state (tasks seen alive, then dead, and
            # not yet back): consumers get the evicted peer LIST, not just
            # the free-text INFO line the transitions used to leave behind.
            evicted=sorted(self._evicted),
            heartbeat_age_s=[round(a, 3) for a in ages],
            max_heartbeat_age_s=round(max_age, 3),
            progress=progress,
            straggler_gap_steps=straggler_gap,
        )
        self._telemetry.gauge("cluster_alive").set(sum(alive))
        self._telemetry.gauge("cluster_straggler_gap").set(straggler_gap)
        self._telemetry.histogram("heartbeat_age_s").record(max(max_age, 0.0))
        self._telemetry.emit("cluster_health", step=self._safe_step(),
                             **fields)
        self.snapshots += 1
        return fields

    def _safe_step(self) -> int:
        try:
            return int(self._step_fn())
        except Exception:
            return 0

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self._interval):
                self.tick()
        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ClusterHealthReporter":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
