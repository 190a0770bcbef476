"""Supervision: init-or-recover plus checkpointing, the
``tf.train.Supervisor`` equivalent (C9/N6).

Counterpart of ``distributed_tensorflow_tpu/training/supervisor.py``, with
the same behaviour (reference ``distributed.py:108-131``):

- the chief initializes or restores the state; non-chiefs poll every
  ``recovery_wait_secs`` until the chief signals through
  :data:`INIT_DONE_KEY` on the coordination service, then restore exactly
  the signaled step (``prepare_or_wait_for_session``, ``:121-125``);
- the chief checkpoints every ``save_interval_steps`` global steps, in the
  background; non-chiefs never save;
- retention keeps the last ``max_to_keep`` checkpoints plus, always, the
  newest one that passes (quick) integrity verification;
- a corrupt newest checkpoint is skipped for an older valid one, with
  ``recovery_events`` recording what happened; a corrupt chief-signaled
  step raises :class:`CheckpointCorruptionError`;
- :meth:`Supervisor.restore_for_rejoin` re-adopts the cluster's latest
  durable state.

Where the JAX package saves through orbax (asynchronously, sharding-aware),
the port writes with :func:`..tools.checkpoint_io.save_raw` and reads with
``checkpoint_io.read_item``: orbax's ``StandardSave`` layout without orbax,
so the JAX supervisor restores the port's checkpoints and the port restores
the JAX trainer's (its OCDBT layout needs ``tensorstore``).  ``save_raw``
is synchronous, so :meth:`Supervisor.maybe_save` copies the tree to the
host (the state is updated in place by the next step) and hands the write
and its manifest to a background thread, as the JAX supervisor overlaps
orbax's save and its manifest thread with the next steps; at most one save
is in flight, and the next save, :meth:`wait_until_finished` or
:meth:`close` finalizes it (init signal, retention).

With a ``torch.distributed`` process group the parameters are replicated
and identical on every rank, so only the chief writes and every rank
restores the signaled step: no save or delete is collective.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from ..tools import checkpoint_io
from ..tools._zarr_layout import read_item
from .state import checkpoint_tree, load_checkpoint_tree

INIT_DONE_KEY = "dtf/initialized"


class CheckpointCorruptionError(RuntimeError):
    """A checkpoint failed integrity verification where no fallback is
    allowed (an explicitly signaled restore step — restoring anything else
    would break the identical-state invariant across processes)."""


def _host_copy(tree):
    """The tree with every tensor leaf copied to host memory (numpy)."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu")
        return t.clone() if t.dtype == torch.bfloat16 else t.numpy().copy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class Supervisor:
    """Init-or-recover plus background checkpointing.

    Args mirror the reference call (``tf.train.Supervisor(is_chief,
    logdir, init_op, recovery_wait_secs, global_step)``,
    ``distributed.py:110-111``): ``init_fn`` plays ``init_op`` and returns
    the freshly initialized :class:`..training.state.TrainState`; the
    coordination client supplies the cross-process signalling the gRPC
    master provided.
    """

    def __init__(self, is_chief: bool, logdir: str,
                 init_fn: Callable[[], Any],
                 recovery_wait_secs: float = 1.0,
                 save_interval_steps: int = 1000,
                 coordination_client=None,
                 max_to_keep: int = 3):
        self.is_chief = is_chief
        self.logdir = os.path.abspath(logdir)
        self.init_fn = init_fn
        self.recovery_wait_secs = recovery_wait_secs
        self.save_interval_steps = save_interval_steps
        self._coord = coordination_client
        os.makedirs(self.logdir, exist_ok=True)
        self._ckpt_dir = os.path.join(self.logdir, "checkpoints")
        os.makedirs(self._ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._last_saved_step = -1
        # The step whose background write was issued and not finalized,
        # and the thread writing it (data, rename, manifest).
        self._pending_step: int | None = None
        self._save_thread: threading.Thread | None = None
        self._save_error: BaseException | None = None
        #: Recovery events (checkpoint fallbacks, corrupt-skip decisions)
        #: recorded during restore — buffered because restore usually runs
        #: before the telemetry bus exists; ``attach_telemetry`` flushes
        #: them as ``kind="recovery"`` records and wires future ones live.
        self.recovery_events: list[dict] = []
        self._telemetry = None

    # -- recovery telemetry -------------------------------------------------

    def attach_telemetry(self, telemetry) -> None:
        """Route recovery events into a :class:`..utils.telemetry.Telemetry`
        bus; events recorded before attachment are flushed here."""
        self._telemetry = telemetry
        for event in self.recovery_events:
            telemetry.emit("recovery", **event)

    def _record(self, action: str, **fields) -> None:
        event = dict(action=action, **fields)
        self.recovery_events.append(event)
        print(f"Supervisor: recovery event {action}: {fields}")
        if self._telemetry is not None:
            self._telemetry.emit("recovery", **event)

    def _step_dirs(self) -> dict[int, str]:
        return dict(checkpoint_io.list_step_dirs(self._ckpt_dir))

    def all_steps(self) -> list[int]:
        return sorted(self._step_dirs())

    # -- init / recovery ----------------------------------------------------

    def prepare_or_wait_for_state(self, timeout: float = 300.0):
        """The ``prepare_or_wait_for_session`` equivalent
        (``distributed.py:125``).

        Chief: restore the latest valid checkpoint if one exists (crash
        recovery), otherwise run ``init_fn``; then signal the exact step
        peers must restore (0 or 1 = fresh init).  Non-chief: poll until
        the chief signals, then build the same state (deterministic init,
        or that checkpoint), so every process holds identical state before
        the first collective."""
        if self.is_chief:
            state = self._restore_or_init()
            if self._coord is not None:
                self._coord.kv_set(INIT_DONE_KEY, str(int(state.global_step)))
            return state
        if self._coord is not None:
            value = self._coord.kv_wait(INIT_DONE_KEY, timeout=timeout,
                                        poll_interval=self.recovery_wait_secs)
            signaled = int(value)
            # global_step starts at 1 (reference parity); <=1 means the chief
            # initialized fresh — do NOT restore a (stale) checkpoint then.
            if signaled <= 1:
                return self._restore_or_init(target_step=-1)
            return self._restore_or_init(
                target_step=self._ckpt_step_for(signaled))
        return self._restore_or_init()

    def _ckpt_step_for(self, global_step: int) -> int | None:
        """Latest checkpoint at or below the signaled global step."""
        steps = [s for s in self.all_steps() if s <= global_step]
        return max(steps) if steps else None

    def _restore_or_init(self, target_step: int | None = None):
        """target_step: None = restore the newest *valid* checkpoint (corrupt
        ones are skipped with a recovery event); -1 = never restore (fresh
        init); an int = restore exactly that checkpoint step (corruption
        there raises :class:`CheckpointCorruptionError`)."""
        state = self.init_fn()
        if target_step == -1:
            return state
        steps = self.all_steps()
        if target_step is None:
            candidates = steps[::-1]
        elif target_step not in steps:
            raise CheckpointCorruptionError(
                f"chief-signaled checkpoint step {target_step} is not on "
                f"disk (available: {steps}); cannot reconstruct the state "
                "the chief holds")
        else:
            candidates = [target_step]
        skipped: list[int] = []
        dirs = self._step_dirs()
        for step in candidates:
            status, detail = checkpoint_io.verify_checkpoint(dirs[step],
                                                             full=True)
            if status == "corrupt":
                if target_step is not None:
                    raise CheckpointCorruptionError(
                        f"checkpoint step {step} (the chief-signaled restore "
                        f"point) failed integrity verification: {detail}")
                self._record("checkpoint_corrupt", step=step, detail=detail)
                skipped.append(step)
                continue
            state = self._restore_step(state, step, dirs[step])
            if skipped:
                self._record("checkpoint_fallback", step=step,
                             skipped=skipped,
                             detail=f"restored step {step}; newer "
                                    f"checkpoint(s) {skipped} corrupt")
                self._purge_corrupt(skipped)
            return state
        if skipped:
            self._record("checkpoint_restore_failed", skipped=skipped,
                         detail="no valid checkpoint found; fresh init")
            self._purge_corrupt(skipped)
        return state

    def _purge_corrupt(self, steps: list[int]) -> None:
        """Delete corrupt checkpoints the restore fell back past: they are
        dead bytes, and they would keep the on-disk step sequence
        non-monotonic (a save below the newest step on disk is skipped).
        The corruption detail survives in the recovery records."""
        for step in steps:
            if self._delete_step(step):
                self._record("corrupt_checkpoint_deleted", step=step)

    def _delete_step(self, step: int) -> bool:
        """Only the chief (the sole saver over the shared logdir)
        deletes."""
        if not self.is_chief:
            return False
        try:
            path = self._step_dirs().get(step)
            if path is not None:
                shutil.rmtree(path)
            return True
        except OSError as e:  # never let GC take training down
            self._record("retention_delete_failed", step=step,
                         detail=str(e))
            return False

    def _restore_step(self, state, step: int, step_dir: str):
        """Restore one verified step into ``state``.  A *structure*
        mismatch raises ``ValueError`` (a configuration problem, not
        corruption; eval mode turns it into flag advice)."""
        tree = read_item(os.path.join(step_dir, checkpoint_io.ITEM_NAME))
        return load_checkpoint_tree(state, tree)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_for_rejoin(self, timeout: float = 60.0):
        """Elastic-rejoin restore: a worker re-admitted to the replica set
        discards the weights it held while masked out and adopts the
        cluster's latest durable state — the chief's signaled step when a
        coordination client is attached (the chief re-publishes the signal
        at every durable save), else the newest valid checkpoint."""
        self.wait_until_finished()
        deadline = time.monotonic() + timeout
        while True:
            try:
                if not self.is_chief and self._coord is not None:
                    value = self._coord.kv_wait(
                        INIT_DONE_KEY, timeout=timeout,
                        poll_interval=self.recovery_wait_secs)
                    signaled = int(value)
                    if signaled <= 1:
                        return self._restore_or_init(target_step=-1)
                    return self._restore_or_init(
                        target_step=self._ckpt_step_for(signaled))
                return self._restore_or_init()
            except (FileNotFoundError, CheckpointCorruptionError) as e:
                if time.monotonic() >= deadline:
                    raise
                self._record("rejoin_restore_retry", detail=str(e)[:200])
                time.sleep(self.recovery_wait_secs)

    # -- checkpointing ------------------------------------------------------

    def maybe_save(self, state, force: bool = False) -> bool:
        """Chief-driven periodic checkpoint: a save when ``force`` or when
        ``save_interval_steps`` global steps passed since the last one
        (the JAX supervisor's step arithmetic).  Non-chiefs never save.

        A step at or below the newest one on disk is not written again
        (orbax's rule), but counts as saved."""
        if not self.is_chief:
            return False
        step = int(state.global_step)
        if not force and (step - self._last_saved_step
                          < self.save_interval_steps):
            return False
        # Finalize the PREVIOUS save (signal + retention) before issuing the
        # next one; at most one write is in flight.
        self._finalize_last_save()
        latest = self.latest_step()
        if latest is None or step > latest:
            tree = _host_copy(checkpoint_tree(state))
            self._save_thread = threading.Thread(
                target=self._write, args=(step, tree), daemon=True)
            self._save_thread.start()
        self._pending_step = step
        self._last_saved_step = step
        return True

    def _write(self, step: int, tree) -> None:
        try:
            checkpoint_io.save_raw(self._ckpt_dir, step, tree)
        except BaseException as e:  # re-raised by _finalize_last_save
            self._save_error = e

    def _finalize_last_save(self) -> None:
        """Wait out the in-flight write (data, rename, manifest), re-publish
        the init signal at the durable step, and apply retention."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            error, self._save_error = self._save_error, None
            raise error
        if self._pending_step is None:
            return
        step = self._pending_step
        self._pending_step = None
        if self._coord is not None:
            # A non-chief incarnation rejoining mid-run then pins its restore
            # to the cluster's LATEST durable step.
            try:
                self._coord.kv_set(INIT_DONE_KEY, str(step))
            except Exception:  # a signal refresh must never kill training
                pass
        self._apply_retention()

    def _apply_retention(self) -> None:
        """Keep the last ``max_to_keep`` checkpoints — plus, always, the
        newest one that passes (quick) integrity verification, so rotation
        can never delete the only restorable state while newer saves are
        corrupt.  ``max_to_keep`` of 0/None keeps everything."""
        if not self.max_to_keep or self.max_to_keep <= 0:
            return
        steps = self.all_steps()
        if len(steps) <= self.max_to_keep:
            return
        keep = set(steps[-self.max_to_keep:])
        dirs = self._step_dirs()
        for step in reversed(steps):
            status, _ = checkpoint_io.verify_checkpoint(dirs[step],
                                                        full=False)
            if status != "corrupt":
                keep.add(step)  # newest non-corrupt survives rotation
                break
        for step in steps:
            if step not in keep:
                self._delete_step(step)

    def wait_until_finished(self) -> None:
        self._finalize_last_save()

    def close(self) -> None:
        self.wait_until_finished()
