"""Host→device input prefetching (SURVEY §7 hard part).

Copied from ``distributed_tensorflow_tpu/data/prefetch.py``.  In the port
the ``put_fn`` the training loop passes is
:func:`..training.loop.to_device`: a pinned-memory staging copy and a
``non_blocking=True`` transfer to the explicit device, issued from the
producer thread on the device's current stream (so ordered before the
step that reads it).  The JAX text below speaks of ``device_put``.

The reference feeds each step from host Python (``feed_dict``, reference
``distributed.py:137-138,145``): the accelerator idles while the host slices
the next batch and ships it.  TPU-natively the fix is a small pipeline: a
background thread pulls the *next* batch from the dataset and ``device_put``s
it (sharded across the mesh) while the current step is still running on
device, so at step boundaries the input is already resident in HBM.

:class:`DevicePrefetcher` is deliberately generic: ``batch_fn`` is any
zero-arg host batch source (the reference-shaped ``next_batch`` closure),
``put_fn`` the host→device placement (a sharded ``device_put``); depth 2 is
classic double-buffering.  Batch *order* is exactly the un-prefetched order —
only the timing moves.

:class:`StagedPrefetcher` is the multi-controller variant: SPMD requires
every process to enqueue device work in the same order, so the background
thread prepares *host* batches only (pure numpy — no JAX calls), and the
``device_put`` of batch i+1 is issued from the **main thread**, in a fixed
position relative to step dispatch (stage-ahead inside ``next()``).
``device_put`` is asynchronous, so the transfer still overlaps the running
step — overlap without a racing device stream.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable

from ..utils import tracing


def _drain(q: queue.Queue) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


class _ProduceStats:
    """Producer-side telemetry shared by both prefetchers: batches staged
    and time spent preparing them (excluding queue-full waits).  The
    optional callback feeds a streaming histogram so the run report can say
    whether the producer — not just the consumer wait — is the feed
    bottleneck."""

    def _init_produce_stats(
            self, observe_produce_ms: Callable[[float], None] | None) -> None:
        self._observe_produce_ms = observe_produce_ms
        self._produced = 0
        self._produce_ms_total = 0.0

    def _record_produce(self, ms: float) -> None:
        self._produced += 1
        self._produce_ms_total += ms
        if self._observe_produce_ms is not None:
            self._observe_produce_ms(ms)
        # Producer-thread span: batch prep appears on its own trace row
        # (thread name) in the exported cross-worker timeline, so "is the
        # producer the feed bottleneck" is visible per batch, not just as
        # a whole-run histogram.  No-op without an installed tracer.
        tracing.emit_span("prefetch_produce", time.time() - ms / 1000.0, ms)

    def stats(self) -> dict[str, float]:
        """Producer-side counters (read from any thread; approximate)."""
        return {"batches_produced": self._produced,
                "produce_ms_total": round(self._produce_ms_total, 3)}


class DevicePrefetcher(_ProduceStats):
    """Bounded-depth background feed: ``next()`` yields device-resident batches.

    The producer thread runs ``put_fn(batch_fn())`` ahead of consumption, at
    most ``depth`` batches deep (device_put from a non-main thread is safe in
    JAX; the bound caps HBM held by staged inputs at ``depth`` batches).
    Producer exceptions surface on the consumer's next ``next()`` call.
    """

    def __init__(self, batch_fn: Callable[[], Any], put_fn: Callable[[Any], Any],
                 depth: int = 2,
                 observe_produce_ms: Callable[[float], None] | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._batch_fn = batch_fn
        self._put_fn = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._init_produce_stats(observe_produce_ms)
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="prefetch-producer")
        self._thread.start()

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                item = self._put_fn(self._batch_fn())
                self._record_produce((time.perf_counter() - t0) * 1000.0)
                # Blocking put: no steady-state wakeups when the buffer is
                # full; close() drains the queue until this thread exits, so
                # a blocked put always gets released.
                self._q.put(item)
        except BaseException as e:  # surfaced to the consumer
            self._error = e
            self._stop.set()

    def next(self) -> Any:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                # Order matters: the producer sets _error before _stop, so
                # check _error again after observing _stop to avoid masking a
                # producer failure as a plain close.
                if self._stop.is_set():
                    if self._error is not None:
                        raise self._error
                    raise RuntimeError("DevicePrefetcher is closed")
                if self._error is not None:
                    raise self._error

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        return self.next()

    def close(self) -> None:
        self._stop.set()
        # Drain until the producer exits (it may complete one in-flight put
        # after the first drain), then drain the leftovers.
        deadline = time.monotonic() + 5.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            _drain(self._q)
            self._thread.join(timeout=0.05)
        _drain(self._q)

    def __enter__(self) -> "DevicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StagedPrefetcher(_ProduceStats):
    """Deterministic-dispatch-order prefetch for multi-controller SPMD.

    A background thread runs ``batch_fn()`` (host-side numpy only) into a
    bounded queue; ``next()`` returns the batch staged on the *previous*
    call and immediately stages the following one with ``put_fn`` from the
    calling (main) thread — so every process issues its ``device_put``s and
    step dispatches in the identical order, while the asynchronous transfer
    overlaps the in-flight step.  Same interface as
    :class:`DevicePrefetcher`.
    """

    def __init__(self, batch_fn: Callable[[], Any], put_fn: Callable[[Any], Any],
                 depth: int = 2,
                 observe_produce_ms: Callable[[float], None] | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._put_fn = put_fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._staged: Any = None
        self._batch_fn = batch_fn
        self._init_produce_stats(observe_produce_ms)
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="prefetch-producer")
        self._thread.start()

    def _produce(self) -> None:
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                item = self._batch_fn()  # host batch only — no JAX
                self._record_produce((time.perf_counter() - t0) * 1000.0)
                self._q.put(item)
        except BaseException as e:
            self._error = e
            self._stop.set()

    def _host_next(self) -> Any:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    if self._error is not None:
                        raise self._error
                    raise RuntimeError("StagedPrefetcher is closed")
                if self._error is not None:
                    raise self._error

    def next(self) -> Any:
        if self._staged is None:
            self._staged = self._put_fn(self._host_next())
        out = self._staged
        # Stage the NEXT batch now, from the main thread: the device_put is
        # enqueued before the caller dispatches the step that consumes
        # ``out``, in the same position on every process.
        self._staged = self._put_fn(self._host_next())
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        return self.next()

    def close(self) -> None:
        self._stop.set()
        self._staged = None
        deadline = time.monotonic() + 5.0
        while self._thread.is_alive() and time.monotonic() < deadline:
            _drain(self._q)
            self._thread.join(timeout=0.05)
        _drain(self._q)

    def __enter__(self) -> "StagedPrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
