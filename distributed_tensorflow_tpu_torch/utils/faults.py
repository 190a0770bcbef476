"""Deterministic fault injection — the chaos harness behind the recovery
machinery (docs/fault_tolerance.md).

Copied from ``distributed_tensorflow_tpu/utils/faults.py`` (numpy and the standard library
only; the port's imports).

The reference's entire fault story was tf.train.Supervisor
restart-and-recover (reference ``distributed.py:108-131``); nothing ever
*exercised* it.  This module makes faults first-class and reproducible so
the recovery paths (coordination retry/backoff, checkpoint-integrity
fallback, worker rejoin) are tested machinery, not hope:

- **kill_at_step=K** — SIGKILL this process the moment the training loop
  completes global step K (the hook is :func:`on_step`, called once per
  step by ``training/loop.py``); a hard preemption at a deterministic
  point instead of a racy external ``kill``.
- **kill_coord_at_step=K** (paired with **coord_pid=PID**) — SIGKILL the
  COORDINATOR process when this worker completes global step K:
  coordinator death injected exactly like worker death, at a
  deterministic training step.  The harness passes the primary control
  shard's pid via the ``coord_pid`` directive (or registers a callback
  with :meth:`FaultInjector.set_kill_coord_fn`); with a standby
  configured (docs/fault_tolerance.md, "Coordinator HA") the workers'
  endpoint-list failover rides through the promotion and the stall lands
  in telemetry as a ``kind="recovery"`` ``action="coord_failover"``
  record.  :func:`sigkill_coordinator` is the test-harness helper for
  killing a real coordinator subprocess outside the step loop.
- **kill_kv_shard=I** (optionally **at_round=K**, default 1) — KV-shard
  HA chaos (docs/fault_tolerance.md, "KV-shard HA"): SIGKILL coordinator
  instance I's PRIMARY the moment this worker enters exchange round K
  (the hook is :func:`on_round`, called once per compressed-exchange
  period by ``cluster/param_sync.py``).  The victim pid comes from
  **coord_state=PATH** (a ``coord_shard --state_file`` JSON state map),
  from **kv_shard_pid=PID** directly, or from a
  :meth:`FaultInjector.set_kill_kv_shard_fn` callback.  With a per-shard
  standby wired (``--coord_standbys='I:host:port'``) the router's
  endpoint walk rides through the promotion and the stall lands in
  telemetry as ``kind="recovery"`` ``action="kv_shard_failover"``.
- **drop_coord=N** — treat the next N coordination requests as transport
  failures client-side (``CoordinationClient._request`` consults
  :meth:`FaultInjector.coordination_fault` before touching the wire), so
  the retry/backoff machinery is exercised without a server in the loop.
- **drop_coord_for=SECS** — same, for every request in the first SECS
  after installation (a dead-network window).
- **delay_coord=SECS:N** — delay the next N coordination requests by
  SECS each (slow-network injection; exercises timeout headroom).
- **freeze_heartbeats=SECS** — the heartbeat path drops beats for the
  first SECS after installation (a frozen-but-alive process, the
  straggler/eviction trigger).
- **evict_at_step=K** — elastic-membership chaos: when the training loop
  completes global step K this worker LEAVEs the replica set (immediate
  epoch shrink — no lease wait), stays partitioned from the coordinator
  for ``partition_for`` seconds, then rejoins (re-register -> epoch grow,
  restore from the chief's latest published checkpoint).  The
  :class:`..training.elastic.ElasticController` drives the sequence off
  :meth:`FaultInjector.take_leave_request` / :meth:`begin_partition` /
  :meth:`partitioned`.
- **partition_for=SECS** — drop every coordination request for a SECS
  window: paired with ``evict_at_step`` the window starts at the
  eviction; alone it starts at installation (a network partition from
  bring-up).

Server-side counterparts live in the coordination service itself (the
``CHAOS`` protocol command in ``csrc/coordination/coord.cc`` — drop or
delay responses for *every* client, which a test drives via
``CoordinationClient.chaos``).  Checkpoint corruption is a plain helper
(:func:`truncate_newest_checkpoint`) because the injection point is the
filesystem, not a code path.

Activation: programmatic (``install(FaultInjector(...))`` in tests) or
environment-driven for subprocess scenarios — ``DTF_CHAOS`` holds
comma-separated directives, e.g. ``DTF_CHAOS="kill_at_step=12"`` or
``DTF_CHAOS="drop_coord=3,delay_coord=0.2:5"`` — parsed once by
``install_from_env()`` (train.py calls it at startup).  No injector
installed (the default) keeps every hook a single ``is None`` check.
"""

from __future__ import annotations

import os
import signal
import threading
import time

ENV_VAR = "DTF_CHAOS"


class FaultInjector:
    """Holds the armed faults and their remaining budgets (thread-safe:
    coordination requests arrive from heartbeat/health threads too).

    ``injected`` counts the faults actually fired, per kind — the test
    assertion surface; with telemetry attached each fired fault also
    emits a ``kind="fault_injected"`` record so chaos runs are
    self-documenting in the stream.
    """

    def __init__(self, kill_at_step: int = 0,
                 drop_coord: int = 0,
                 drop_coord_for: float = 0.0,
                 delay_coord: tuple[float, int] = (0.0, 0),
                 freeze_heartbeats: float = 0.0,
                 evict_at_step: int = 0,
                 partition_for: float = 0.0,
                 kill_coord_at_step: int = 0,
                 coord_pid: int = 0,
                 kill_kv_shard: int = -1,
                 at_round: int = 1,
                 coord_state: str = "",
                 kv_shard_pid: int = 0):
        self.kill_at_step = int(kill_at_step)
        self.evict_at_step = int(evict_at_step)
        self.kill_coord_at_step = int(kill_coord_at_step)
        self.coord_pid = int(coord_pid)
        self._kill_coord_fn = None   # optional callable override
        self._kill_coord_fired = False
        # KV-shard kill: instance index (-1 = disarmed), fired once when
        # the exchange-round counter reaches at_round.
        self.kill_kv_shard = int(kill_kv_shard)
        self.at_round = int(at_round)
        self.coord_state = str(coord_state)
        self.kv_shard_pid = int(kv_shard_pid)
        self._kill_kv_shard_fn = None
        self._kill_kv_shard_fired = False
        self._drop_coord = int(drop_coord)
        self._drop_coord_for = float(drop_coord_for)
        self._delay_secs = float(delay_coord[0])
        self._delay_budget = int(delay_coord[1])
        self._freeze_heartbeats = float(freeze_heartbeats)
        self._partition_for = float(partition_for)
        self._t0 = time.monotonic()
        # Standalone partition_for opens the window at installation; paired
        # with evict_at_step it opens when the controller's LEAVE is on the
        # wire (begin_partition) so the sequence is step-deterministic and
        # the LEAVE itself is never dropped by its own partition.
        self._partition_until = (self._t0 + self._partition_for
                                 if partition_for and not evict_at_step
                                 else 0.0)
        self._leave_pending = False
        self._evict_fired = False
        self._lock = threading.Lock()
        self._telemetry = None
        self.injected = {"kill": 0, "drop": 0, "delay": 0,
                         "heartbeat_freeze": 0, "evict": 0,
                         "kill_coord": 0, "kill_kv_shard": 0}

    def attach_telemetry(self, telemetry) -> None:
        self._telemetry = telemetry

    def _emit(self, action: str, **fields) -> None:
        if self._telemetry is not None:
            self._telemetry.emit("fault_injected", action=action, **fields)

    # ------------------------------------------------------------- hooks

    def on_step(self, global_step: int) -> None:
        """Training-loop hook: hard-kill this process at the armed step."""
        if self.kill_at_step and global_step >= self.kill_at_step:
            self.injected["kill"] += 1
            # Crash flight recorder: SIGKILL is untrappable, but THIS hook
            # runs before the kill — the one place the dying worker can
            # still write its last seconds (docs/observability.md,
            # "Flight recorder").  Dump must never block the kill.
            if self._telemetry is not None:
                try:
                    self._telemetry.dump_flight(
                        reason=f"kill_at_step={self.kill_at_step}")
                except Exception:
                    pass
            # flush=True: this line is the last thing the process says.
            print(f"FAULT INJECTION: SIGKILL self at global step "
                  f"{global_step}", flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        if self.kill_coord_at_step and global_step >= self.kill_coord_at_step:
            fired = False
            with self._lock:
                if not self._kill_coord_fired:
                    self._kill_coord_fired = True
                    self.injected["kill_coord"] += 1
                    fired = True
            if fired:
                # The coordinator dies, THIS worker keeps training: with a
                # standby configured the endpoint-list failover turns the
                # kill into a lease-bounded stall (the chaos assertion).
                self._emit("kill_coord_at_step", step=global_step,
                           pid=self.coord_pid)
                print(f"FAULT INJECTION: SIGKILL coordinator pid "
                      f"{self.coord_pid or '<fn>'} at global step "
                      f"{global_step}", flush=True)
                if self._kill_coord_fn is not None:
                    self._kill_coord_fn()
                elif self.coord_pid:
                    try:
                        os.kill(self.coord_pid, signal.SIGKILL)
                    except ProcessLookupError:
                        pass  # already dead — the injection still counts
        if self.evict_at_step and global_step >= self.evict_at_step:
            fired = False
            with self._lock:
                if not self._evict_fired:
                    self._evict_fired = True
                    self._leave_pending = True
                    self.injected["evict"] += 1
                    fired = True
            if fired:  # emit outside the lock
                self._emit("evict_at_step", step=global_step)

    def set_kill_coord_fn(self, fn) -> None:
        """In-process alternative to ``coord_pid``: the callable to run
        when ``kill_coord_at_step`` fires (tests kill an in-process
        CoordinationServer or a Popen they hold)."""
        self._kill_coord_fn = fn

    def on_round(self, round_index: int) -> None:
        """Exchange-round hook (the consensus-round counterpart of
        :meth:`on_step`): called once per compressed-exchange period by
        ``cluster/param_sync.py`` with a 1-based period index; hard-kills
        the armed KV shard's primary exactly once when the index reaches
        ``at_round``."""
        if self.kill_kv_shard < 0 or round_index < self.at_round:
            return
        with self._lock:
            if self._kill_kv_shard_fired:
                return
            self._kill_kv_shard_fired = True
            self.injected["kill_kv_shard"] += 1
        pid = self.kv_shard_pid
        if not pid and self._kill_kv_shard_fn is None and self.coord_state:
            try:
                pid = _state_map_pid(self.coord_state, self.kill_kv_shard)
            except (OSError, ValueError) as e:
                # The injection still counts (one-shot), but a chaos run
                # whose victim lookup failed must say so on the stream.
                print(f"FAULT INJECTION: kill_kv_shard "
                      f"{self.kill_kv_shard} victim lookup failed: {e}",
                      flush=True)
                return
        self._emit("kill_kv_shard", round=round_index,
                   shard=self.kill_kv_shard, pid=pid)
        print(f"FAULT INJECTION: SIGKILL kv shard {self.kill_kv_shard} "
              f"primary pid {pid or '<fn>'} at exchange round "
              f"{round_index}", flush=True)
        if self._kill_kv_shard_fn is not None:
            self._kill_kv_shard_fn()
        elif pid:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass  # already dead — the injection still counts

    def set_kill_kv_shard_fn(self, fn) -> None:
        """In-process alternative to ``coord_state``/``kv_shard_pid``: the
        callable to run when ``kill_kv_shard`` fires at ``at_round``."""
        self._kill_kv_shard_fn = fn

    def take_leave_request(self) -> bool:
        """One-shot: True exactly once after ``evict_at_step`` fires — the
        elastic controller then sends LEAVE and only AFTERWARDS calls
        :meth:`begin_partition` (a LEAVE dropped by its own partition
        window would inject nothing)."""
        with self._lock:
            if not self._leave_pending:
                return False
            self._leave_pending = False
            return True

    def begin_partition(self) -> None:
        """Open the post-eviction partition window (called by the elastic
        controller right after its LEAVE went out on the wire); the
        controller then waits out :meth:`partitioned` before rejoining."""
        with self._lock:
            if self._partition_for:
                self._partition_until = (time.monotonic()
                                         + self._partition_for)

    def partitioned(self) -> bool:
        """True while the injected partition window is open (all
        coordination requests are treated as transport failures)."""
        return time.monotonic() < self._partition_until

    def coordination_fault(self, command: str):
        """Consulted by ``CoordinationClient._request`` before the wire call.

        Returns ``("drop", None)`` (simulate a transport failure),
        ``("delay", secs)`` (sleep before the real request), or None.
        """
        if self.partitioned():
            with self._lock:
                self.injected["drop"] += 1
            self._emit("partition", command=command)
            return ("drop", None)
        with self._lock:
            if self._drop_coord > 0:
                self._drop_coord -= 1
                self.injected["drop"] += 1
                self._emit("drop_coord", command=command)
                return ("drop", None)
            if (self._drop_coord_for
                    and (time.monotonic() - self._t0) < self._drop_coord_for):
                self.injected["drop"] += 1
                self._emit("drop_coord", command=command)
                return ("drop", None)
            if self._delay_budget > 0 and self._delay_secs > 0:
                self._delay_budget -= 1
                self.injected["delay"] += 1
                self._emit("delay_coord", command=command,
                           delay_s=self._delay_secs)
                return ("delay", self._delay_secs)
        return None

    def heartbeats_frozen(self) -> bool:
        """Consulted by ``CoordinationClient.heartbeat``: True while the
        freeze window is active (the beat is silently dropped)."""
        if not self._freeze_heartbeats:
            return False
        frozen = (time.monotonic() - self._t0) < self._freeze_heartbeats
        if frozen:
            with self._lock:
                self.injected["heartbeat_freeze"] += 1
        return frozen


_installed: FaultInjector | None = None


def install(injector: FaultInjector) -> FaultInjector:
    """Arm an injector process-wide (tests pair this with ``clear()``)."""
    global _installed
    _installed = injector
    return injector


def clear() -> None:
    global _installed
    _installed = None


def active() -> FaultInjector | None:
    return _installed


def install_from_env(env=None) -> FaultInjector | None:
    """Parse ``DTF_CHAOS`` and install the injector it describes (None and
    no-op when unset).  Unknown/malformed directives raise — a chaos run
    with a typo'd fault spec must fail loudly, not run clean."""
    spec = (os.environ if env is None else env).get(ENV_VAR, "").strip()
    if not spec:
        return None
    kwargs: dict = {}
    for directive in spec.split(","):
        directive = directive.strip()
        if not directive:
            continue
        if "=" not in directive:
            raise ValueError(
                f"{ENV_VAR} directive {directive!r} is not key=value")
        key, value = directive.split("=", 1)
        key = key.strip()
        try:
            if key == "kill_at_step":
                kwargs[key] = int(value)
            elif key == "kill_coord_at_step":
                kwargs[key] = int(value)
            elif key == "coord_pid":
                kwargs[key] = int(value)
            elif key == "evict_at_step":
                kwargs[key] = int(value)
            elif key == "drop_coord":
                kwargs[key] = int(value)
            elif key == "drop_coord_for":
                kwargs[key] = float(value)
            elif key == "freeze_heartbeats":
                kwargs[key] = float(value)
            elif key == "partition_for":
                kwargs[key] = float(value)
            elif key == "kill_kv_shard":
                kwargs[key] = int(value)
            elif key == "at_round":
                kwargs[key] = int(value)
            elif key == "kv_shard_pid":
                kwargs[key] = int(value)
            elif key == "coord_state":
                kwargs[key] = value.strip()
            elif key == "delay_coord":
                secs, _, count = value.partition(":")
                kwargs[key] = (float(secs), int(count or 1))
            else:
                raise ValueError(f"unknown {ENV_VAR} directive {key!r}")
        except ValueError as e:
            raise ValueError(
                f"{ENV_VAR} directive {directive!r}: {e}") from None
    return install(FaultInjector(**kwargs))


def on_step(global_step: int) -> None:
    """Training-loop hook; a single None check when chaos is off."""
    if _installed is not None:
        _installed.on_step(global_step)


def on_round(round_index: int) -> None:
    """Exchange-round hook; a single None check when chaos is off."""
    if _installed is not None:
        _installed.on_round(round_index)


def _state_map_pid(state_file: str, instance: int,
                   role: str = "primary") -> int:
    """Pid of coordinator ``instance``'s ``role`` member from a
    ``coord_shard --state_file`` JSON state map; raises ValueError when
    the map carries no such member (a chaos typo must fail loudly)."""
    import json

    with open(state_file) as fh:
        state = json.load(fh)
    for member in state.get("members") or ():
        if (member.get("instance") == instance
                and member.get("role") == role and member.get("pid")):
            return int(member["pid"])
    raise ValueError(f"state map {state_file!r} has no {role} member for "
                     f"instance {instance}")


def kill_coord_instance(state_file: str, instance: int,
                        role: str = "primary") -> int:
    """SIGKILL coordinator ``instance``'s ``role`` member by pid from a
    ``coord_shard --state_file`` state map — the harness-side counterpart
    of the ``kill_kv_shard`` directive.  Returns the pid signalled (an
    already-dead pid is not an error: the drill may race a crash)."""
    pid = _state_map_pid(state_file, instance, role)
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    return pid


def sigkill_coordinator(proc=None, *, state_file: str | None = None,
                        instance: int = 0, role: str = "primary") -> int:
    """Test-harness helper: SIGKILL a real coordinator process —
    coordinator death injected exactly like worker death, for harnesses
    outside the step loop.  Two forms:

    * ``sigkill_coordinator(proc)`` — kill and reap a
      ``subprocess.Popen`` this harness holds; returns the reaped
      returncode (``-SIGKILL`` on Linux).
    * ``sigkill_coordinator(state_file=..., instance=I[, role=...])`` —
      target ANY instance of a sharded plane by pid from its
      ``coord_shard --state_file`` state map; returns the pid signalled.
    """
    if proc is not None:
        proc.send_signal(signal.SIGKILL)
        return proc.wait(timeout=30)
    if state_file is None:
        raise ValueError("sigkill_coordinator needs a Popen or a "
                         "state_file= target")
    return kill_coord_instance(state_file, instance, role)


def kill_cell(state_file: str, cell: str | None = None) -> list[int]:
    """Chaos hook for the cell drills: SIGKILL every pid of a named
    cell, wholesale — coordinator primary, standby, fleet router, and
    all replicas die in the same instant, the worst correlated failure
    a cell can suffer.

    ``state_file`` is a cell state file (``tools/serve_cell.py
    --state_file``: ``{"cell", "pids": {...}, "members": [...]}``) or a
    fleet state file (``tools/serve_fleet.py --state_file``, replicas
    only).  ``cell`` (when given) must match the file's cell name —
    refusing a mismatched kill is what makes the helper safe to aim.
    Returns the pids signalled (dead pids are skipped, not errors —
    the drill may race a crash-loop)."""
    import json

    with open(state_file) as fh:
        state = json.load(fh)
    named = state.get("cell")
    if cell is not None and named is not None and named != cell:
        raise ValueError(
            f"state file {state_file!r} is cell {named!r}, not {cell!r}")
    pids: list[int] = []
    for key in ("coordinator", "standby", "fleet"):
        pid = (state.get("pids") or {}).get(key)
        if pid:
            pids.append(int(pid))
    for member in state.get("members") or ():
        if member.get("pid"):
            pids.append(int(member["pid"]))
    killed: list[int] = []
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
            killed.append(pid)
        except (ProcessLookupError, PermissionError):
            continue
    return killed


# -------------------------------------------------- filesystem injection


def truncate_newest_checkpoint(logdir: str, keep_bytes: int = 16
                               ) -> tuple[int, str]:
    """Corrupt the newest checkpoint under ``<logdir>/checkpoints`` by
    truncating its largest data file to ``keep_bytes`` bytes (the manifest
    is left intact, so integrity verification — not luck — must catch it).
    Returns ``(step, truncated_file_path)``.
    """
    from ..tools import checkpoint_io

    ckpt_dir = os.path.join(logdir, "checkpoints")
    steps = checkpoint_io.list_step_dirs(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step, step_dir = steps[-1]
    victim, victim_size = None, -1
    # Same file set the manifest covers (tmp files excluded): truncating a
    # file the manifest does not track would inject nothing.
    for _, path in checkpoint_io._iter_checkpoint_files(step_dir):
        size = os.path.getsize(path)
        if size > victim_size:
            victim, victim_size = path, size
    if victim is None:
        raise FileNotFoundError(f"no data files under {step_dir}")
    with open(victim, "r+b") as fh:
        fh.truncate(min(keep_bytes, victim_size))
    return step, victim
