"""Elastic membership — shrink/grow the replica set on failure instead of
stalling (docs/fault_tolerance.md, "Elastic membership").

Counterpart of ``distributed_tensorflow_tpu/training/elastic.py``, a copy
over the port's coordination client, supervisor and chaos harness.  In
the port, ``reshard`` mode serves the sync workers of a
``torch.distributed`` process group (a fixed world size, as JAX's
multi-controller mesh): they save at the negotiated stop step and exit
for a relaunch at the new size.

The coordination service owns a monotonically increasing *membership
epoch* over the active task set (``csrc/coordination/coord.cc``): lease
expiry or an explicit ``LEAVE`` shrinks the set and bumps the epoch, a
re-``REGISTER`` grows it and bumps again, and barriers release on the
active set rather than ``num_tasks``.  A
:class:`..cluster.coordination.MembershipWatcher` mirrors ``(epoch,
active_task_ids)`` into each worker; this module is what the training
side *does* with an epoch change, in one of two modes:

- **in-place degradation** (``mode="in_place"``, single-controller masked
  sync): an epoch change just flips the per-replica mask fed to
  ``build_masked_sync_train_step`` — survivors keep stepping at R<N with
  renormalized gradients, no stall.  A worker that finds *itself* outside
  the active set (its lease expired, it was explicitly evicted, or chaos
  made it LEAVE) pauses, re-registers when reachable again, restores from
  the chief's latest published checkpoint (its own weights went stale
  while it was masked out), and resumes — the grow half of the cycle.
- **checkpoint–reshard–resume** (``mode="reshard"``, multi-controller,
  where XLA's device topology is fixed at startup): the chief reacts to a
  shrink by publishing a *stop step* a margin ahead through the KV store;
  every process (lockstep in SPMD, so all at the same global step) takes
  the collective durable save at that step, the chief publishes the new
  cluster spec under ``dtf/elastic/cluster_spec``, and the processes exit
  with ``result.resharded`` set so the launcher can restart them into the
  smaller mesh through the existing cross-topology restore.  The margin
  must exceed ``watcher_interval x step_rate`` so every process learns of
  the stop step before reaching it (documented in fault_tolerance.md).

Every resize emits ``kind="recovery"`` telemetry (``elastic_shrink`` /
``elastic_grow`` from the watcher; ``elastic_leave`` / ``elastic_rejoin``
/ ``elastic_reshard`` from this controller) that ``tools/summarize_run``
rolls into the run report.
"""

from __future__ import annotations

import json
import time
from typing import Any

from ..cluster.coordination import CoordinationError, MembershipWatcher
from ..utils import faults

RESHARD_KEY = "dtf/elastic/reshard"
CLUSTER_SPEC_KEY = "dtf/elastic/cluster_spec"


class ElasticController:
    """Consumes membership epochs inside the training loop.

    ``on_step(state, step)`` is called once per completed step (after
    ``faults.on_step``, so a ``DTF_CHAOS`` ``evict_at_step`` directive is
    already armed when we look) and returns ``(state, stop)``: ``state``
    may be a freshly restored one after a rejoin, ``stop`` requests a
    loop exit (reshard mode only).
    """

    def __init__(self, *, watcher: MembershipWatcher, client,
                 task_index: int, num_workers: int,
                 supervisor=None, mode: str = "in_place",
                 is_chief: bool = False, telemetry=None,
                 print_fn=print, rejoin_timeout: float = 120.0,
                 poll_interval: float = 0.25,
                 reshard_margin_steps: int = 20):
        if mode not in ("in_place", "reshard"):
            raise ValueError(f"mode must be in_place or reshard, got {mode!r}")
        self._watcher = watcher
        self._client = client
        self._task = task_index
        self._num_workers = num_workers
        self._supervisor = supervisor
        self.mode = mode
        self._is_chief = is_chief
        self._telemetry = telemetry
        self._print = print_fn
        self._rejoin_timeout = rejoin_timeout
        self._poll = poll_interval
        self._margin = int(reshard_margin_steps)
        #: transition counters (test surface)
        self.transitions = {"left": 0, "rejoined": 0, "resharded": 0}
        self._reshard_request: dict | None = None

    def attach_telemetry(self, telemetry) -> None:
        self._telemetry = telemetry
        self._watcher.attach_telemetry(telemetry)

    def _emit(self, action: str, step: int, **fields) -> None:
        if self._telemetry is not None:
            self._telemetry.emit("recovery", step=max(int(step), 0),
                                 action=action, task=self._task, **fields)

    # ------------------------------------------------------------- hooks

    def on_step(self, state: Any, step: int) -> tuple[Any, bool]:
        # Surface a latched background-thread crash (dead heartbeat/health
        # thread) on the step loop: the masked hot path otherwise makes no
        # protocol calls, and a worker whose beats silently stopped would
        # train as a zombie until eviction — fail loudly instead.
        self._client.check_background()
        if self.mode == "reshard":
            return self._reshard_step(state, step)
        return self._in_place_step(state, step)

    # -- in-place degradation --------------------------------------------

    def _in_place_step(self, state: Any, step: int) -> tuple[Any, bool]:
        injector = faults.active()
        if injector is not None and injector.take_leave_request():
            # Chaos-driven deterministic eviction: LEAVE before the
            # partition window opens (an immediate epoch shrink — the
            # survivors resize without waiting out our lease).
            try:
                self._client.leave()
            except CoordinationError:
                pass
            injector.begin_partition()
            self.transitions["left"] += 1
            self._print(f"Worker {self._task}: left the replica set at "
                        f"global step {step} (injected eviction)")
            self._emit("elastic_leave", step)
            return self._await_rejoin(state, step), False
        epoch, active = self._watcher.snapshot()
        if epoch > 0 and self._task not in active:
            # The server evicted us (lease expiry while we stalled, or an
            # explicit RECONFIGURE): stop stepping — our gradients are
            # masked out anyway — and walk the rejoin path.
            self._print(f"Worker {self._task}: evicted from the replica "
                        f"set (epoch {epoch}) at global step {step}")
            self._emit("elastic_evicted", step, epoch=epoch)
            return self._await_rejoin(state, step), False
        return state, False

    def _await_rejoin(self, state: Any, step: int) -> Any:
        """Block until re-admitted: wait out any injected partition,
        re-register (the grow half of the epoch cycle), then restore the
        cluster's latest published checkpoint — the weights this worker
        holds predate the steps the survivors took without it."""
        deadline = time.monotonic() + self._rejoin_timeout
        while True:
            injector = faults.active()
            if injector is not None and injector.partitioned():
                time.sleep(self._poll)
                continue
            try:
                self._client.register(timeout=5.0,
                                      poll_interval=self._poll)
                break
            except CoordinationError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(self._poll)
        if self._supervisor is not None:
            state = self._supervisor.restore_for_rejoin()
        epoch, active = self._watcher.poll()
        restored = int(getattr(state, "global_step", 0))
        self.transitions["rejoined"] += 1
        self._print(f"Worker {self._task}: rejoined the replica set at "
                    f"epoch {epoch} (active {list(active)}); restored "
                    f"global step {restored}")
        self._emit("elastic_rejoin", restored, epoch=epoch,
                   active_count=len(active))
        return state

    # -- checkpoint-reshard-resume ---------------------------------------

    def _reshard_step(self, state: Any, step: int) -> tuple[Any, bool]:
        epoch, active = self._watcher.snapshot()
        shrunk = epoch > 0 and len(active) < self._num_workers
        if not shrunk and self._reshard_request is None:
            return state, False
        if self._reshard_request is None:
            self._reshard_request = self._negotiate_stop_step(step, epoch,
                                                              active)
            if self._reshard_request is None:
                return state, False
        request = self._reshard_request
        if step < int(request["stop_step"]):
            return state, False
        # Stop step reached — lockstep SPMD puts every process here at the
        # same global step, so the collective save below is consistent.
        if self._supervisor is not None:
            self._supervisor.maybe_save(state, force=True)
            self._supervisor.wait_until_finished()
        if self._is_chief:
            spec = {"epoch": request["epoch"],
                    "active": request["active"],
                    "num_workers": len(request["active"]),
                    "checkpoint_step": int(getattr(state, "global_step",
                                                   step))}
            try:
                self._client.kv_set(CLUSTER_SPEC_KEY, json.dumps(spec))
            except CoordinationError:
                self._print(f"Worker {self._task}: could not publish the "
                            "elastic cluster spec (coordinator "
                            "unreachable); relaunch from MEMBERS instead")
        self.transitions["resharded"] += 1
        self._print(f"Worker {self._task}: elastic reshard at global step "
                    f"{step} (epoch {request['epoch']}, active "
                    f"{request['active']}): checkpoint durable; exiting "
                    f"for relaunch into the smaller mesh")
        self._emit("elastic_reshard", step, epoch=request["epoch"],
                   active_count=len(request["active"]))
        return state, True

    def _negotiate_stop_step(self, step: int, epoch: int,
                             active: tuple[int, ...]) -> dict | None:
        """Chief publishes ``stop_step = now + margin``; everyone else
        polls for it (all processes observed the shrink through their own
        watchers, so the poll starts well before the stop step)."""
        if self._is_chief:
            request = {"epoch": epoch, "stop_step": int(step) + self._margin,
                       "active": list(active)}
            try:
                self._client.kv_set(RESHARD_KEY, json.dumps(request))
            except CoordinationError:
                return None  # retry next step
            self._print(f"Worker {self._task}: membership shrank to "
                        f"{list(active)} (epoch {epoch}); resharding at "
                        f"global step {request['stop_step']}")
            self._emit("elastic_reshard_requested", step, epoch=epoch,
                       stop_step=request["stop_step"])
            return request
        try:
            value = self._client.kv_get(RESHARD_KEY)
        except CoordinationError:
            return None
        if value is None:
            return None
        try:
            request = json.loads(value)
        except ValueError:
            return None
        if int(request.get("epoch", -1)) < epoch:
            return None  # stale request from an earlier resize
        return request
