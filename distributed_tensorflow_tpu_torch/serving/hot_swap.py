"""Hot model swap — watch the checkpoint/anchor plane, verify, stage.

A serving process must pick up the training job's newer checkpoints
without restarting (and without dropping in-flight streams — the engine
side of that contract lives in :meth:`..serving.engine.DecodeEngine.
swap_params`).  The watcher here is the detection/loading half:

- **Discovery** — poll ``<logdir>/checkpoints`` for a step newer than the
  one being served (``tools/checkpoint_io.list_step_dirs``).  When a
  coordination client is supplied, the chief's init-done key
  (:data:`..training.supervisor.INIT_DONE_KEY` — republished at every
  durable save by ``training/supervisor.py``) is consulted first as a
  cheap "newest step" hint, so the common no-news poll is one KV round
  trip, not a directory walk.
- **Integrity** — a candidate is loaded only when
  ``tools/checkpoint_io.verify_checkpoint`` accepts it (``valid``, or
  ``unverified`` for legacy saves); a half-written or corrupt save is
  skipped this poll and retried when its manifest lands — the serving
  tier must never swap garbage into the hot path.
- **Staging** — the raw tree is restored and handed to ``swap_fn`` OFF
  the engine thread; the engine adopts it between steps.

The watcher is a daemon thread; failures are recorded as telemetry
(``kind="recovery"``, action ``swap_poll_error`` / ``swap_load_error``)
and retried next poll — a broken checkpoint plane degrades serving to
stale weights, never to a crash.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

from ..tools.checkpoint_io import list_step_dirs, verify_checkpoint
from ..training.supervisor import INIT_DONE_KEY
from ..utils import tracing


def newest_verified_step(ckpt_dir: str, min_step: int = -1
                         ) -> tuple[int, str] | None:
    """Newest step under ``ckpt_dir`` (> ``min_step``) whose directory
    passes integrity verification; skips corrupt candidates downward."""
    for step, step_dir in reversed(list_step_dirs(ckpt_dir)):
        if step <= min_step:
            return None
        status, _ = verify_checkpoint(step_dir)
        if status in ("valid", "unverified"):
            return step, step_dir
    return None


class ModelWatcher:
    """Poll-verify-load-stage loop feeding the engine's hot swap.

    ``load_fn(step) -> params`` restores the serving tree for a step (the
    CLI wires ``tools/serve.load_gpt_serving_model``); ``swap_fn(params,
    step)`` stages it (``DecodeEngine.swap_params`` behind the server's
    wakeup).
    """

    def __init__(self, logdir: str,
                 load_fn: Callable[[int], object],
                 swap_fn: Callable[[object, int], None], *,
                 initial_step: int = 0, poll_s: float = 2.0,
                 coord_client=None, telemetry=None):
        self._ckpt_dir = os.path.join(logdir, "checkpoints")
        self._load_fn = load_fn
        self._swap_fn = swap_fn
        self.current_step = int(initial_step)
        self._poll_s = float(poll_s)
        self._coord = coord_client
        self._telemetry = telemetry
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ polls

    def _hint_step(self) -> int | None:
        """The coordination plane's newest-durable-step hint, if any."""
        if self._coord is None:
            return None
        try:
            value = self._coord.kv_get(INIT_DONE_KEY)
            return int(value) if value is not None else None
        except Exception:
            return None  # the directory poll below is the ground truth

    def poll_once(self) -> int | None:
        """One discovery+verify+load+stage cycle; returns the step swapped
        in, or None when there was nothing newer (or the candidate failed
        verification/loading — retried next poll)."""
        hint = self._hint_step()
        if hint is not None and hint <= self.current_step:
            return None  # cheap no-news exit: nothing newer is durable
        try:
            found = newest_verified_step(self._ckpt_dir, self.current_step)
        except OSError as e:
            self._record("swap_poll_error", repr(e))
            return None
        if found is None:
            return None
        step, _ = found
        t0 = time.perf_counter()
        try:
            # The off-engine-thread half of a swap (restore + prepare) —
            # traced so a trace shows WHY the engine later paused.
            with tracing.span("serve.swap_load", step=step,
                              to_model_step=step):
                params = self._load_fn(step)
        except Exception as e:  # noqa: BLE001 — stale weights, not a crash
            self._record("swap_load_error", f"step {step}: {e!r}")
            return None
        self._swap_fn(params, step)
        self.current_step = step
        if self._telemetry is not None:
            self._telemetry.emit(
                "recovery", step=step, action="swap_staged",
                load_ms=round((time.perf_counter() - t0) * 1e3, 1))
        return step

    def _record(self, action: str, detail: str) -> None:
        if self._telemetry is not None:
            self._telemetry.emit("recovery", step=self.current_step,
                                 action=action, detail=detail[:300])

    # ---------------------------------------------------------- thread

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self._poll_s):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001
                    self._record("swap_poll_error", repr(e))

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="model-watcher")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "ModelWatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()
