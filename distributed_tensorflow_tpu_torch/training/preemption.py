"""Graceful preemption handling — checkpoint-and-exit on SIGTERM/SIGINT.

Copied from ``distributed_tensorflow_tpu/training/preemption.py`` (numpy and the standard library
only; the port's imports).

TPU pods preempt with a termination signal; the reference's only story was
restart-and-recover (Supervisor checkpoints, ``distributed.py:109-111``).
This module adds the proactive half: a signal flag the training loop polls
each step, so a preempted worker writes a final checkpoint at the exact step
it stopped and exits cleanly instead of dying mid-step and replaying from
the last periodic save.
"""

from __future__ import annotations

import os
import signal
import threading


class ShutdownSignal:
    """Latching signal flag: install as a context manager, poll ``requested``.

    Handlers are installed on ``__enter__`` and restored on ``__exit__``.
    The flag only latches; the loop decides when to act, so a step in
    flight always completes before the checkpoint is written.  By default
    both SIGTERM (pod preemption) and SIGINT (operator Ctrl-C) latch —
    an interactive interrupt deserves the same checkpoint-at-the-exact-step
    exit as a preemption.  ``signal_name`` records which signal fired
    (``"SIGTERM"``/``"SIGINT"``, or ``"trigger"`` for the programmatic
    path) so logs and telemetry can say *why* the run stopped.

    First signal: graceful (latch only).  A second signal while the latch
    is already set restores that signal's previous disposition and
    re-delivers it — a run hung before its next ``requested()`` poll (a
    stuck barrier, a long compile) must stay killable from the terminal,
    not swallow every Ctrl-C until ``__exit__``.

    ``add_callback`` registers hooks that run ONCE, at the moment the flag
    first latches (real signal or programmatic trigger) — the crash
    flight recorder dumps its ring here, so a preempted worker's last
    seconds reach disk even if the graceful checkpoint path never gets to
    run (docs/observability.md, "Flight recorder").  Callbacks run in the
    latching context (possibly a signal handler): they must be quick and
    must not raise — exceptions are swallowed.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict = {}
        # True once a REAL signal has latched; escalation keys on this,
        # not on the event — a programmatic trigger() must not turn the
        # next real signal into an immediate kill.
        self._signal_fired = False
        self._callbacks: list = []
        self._callbacks_ran = False
        #: Name of the signal that latched the flag (None until it fires).
        self.signal_name: str | None = None

    def requested(self) -> bool:
        return self._event.is_set()

    def add_callback(self, fn) -> None:
        """Run ``fn()`` once when the shutdown flag first latches."""
        self._callbacks.append(fn)

    def _run_callbacks(self) -> None:
        if self._callbacks_ran:
            return
        self._callbacks_ran = True
        for fn in self._callbacks:
            try:
                fn()
            except Exception:
                pass  # a dying run's hooks don't get to kill the exit path

    def trigger(self) -> None:
        """Programmatic trigger (tests; custom supervisors)."""
        if self.signal_name is None:
            self.signal_name = "trigger"
        self._event.set()
        self._run_callbacks()

    def _handler(self, signum, frame):
        if self._signal_fired:
            # Second signal: the operator means it.  Hand back the previous
            # disposition and re-deliver so a hung run actually dies.
            signal.signal(signum, self._previous.pop(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        self._signal_fired = True
        try:
            self.signal_name = signal.Signals(signum).name
        except ValueError:  # non-standard signal number
            self.signal_name = f"signal {signum}"
        self._event.set()
        self._run_callbacks()

    def __enter__(self) -> "ShutdownSignal":
        if threading.current_thread() is not threading.main_thread():
            # signal.signal would raise a cryptic "signal only works in main
            # thread of the main interpreter" ValueError; say what the
            # caller should actually do instead.
            raise RuntimeError(
                "ShutdownSignal must be entered on the main thread: Python "
                "delivers signals there and restricts signal.signal to it. "
                "Enter it on the main thread and share the object with "
                "other threads, or drive it via trigger().")
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
