"""Training loop, eval, metrics (C11/C12): the reference's observable
behaviour; the counterpart of ``distributed_tensorflow_tpu/training/loop.py``.

Matches the reference step loop (``distributed.py:133-165``): shuffled
``next_batch`` feed, validation on the full split every
``validation_every`` local steps, the per-step ``Worker N: traing step
... loss ... training accuracy`` line (the reference's spelling), stop when
the shared ``global_step`` reaches ``train_steps``, ``Training elapsed
time:`` and a final full-test-split accuracy print.

As in the JAX loop, the reference's extra forward pass for the train
accuracy (``:148-149``) is the train step's aux metric, and the host feed
overlaps the step: a background thread (:class:`..data.prefetch.
DevicePrefetcher`) prepares the next batch and copies it to the device
from pinned memory with ``non_blocking=True`` while the current step
runs.  The multi-controller sharded feed of the JAX loop is the trainer's
job here: with a process group each rank is handed its own shard of the
train split and feeds ``batch_size // world_size`` rows.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable

import numpy as np
import torch

from ..data.prefetch import DevicePrefetcher
from ..utils import faults, tracing
from ..utils.metrics import MetricsLogger, StepRateMeter
from ..utils.profiling import Timer, device_memory_stats
from ..utils.telemetry import Telemetry


@contextlib.contextmanager
def parameters_swapped(model: torch.nn.Module, params: dict | None):
    """Run the enclosed code with ``params`` ({name: tensor}) in the
    model's parameters, then put the model's own back (evaluation of the
    moving average)."""
    if params is None:
        yield
        return
    own = dict(model.named_parameters())
    saved = {n: p.detach().clone() for n, p in own.items()}
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])
    try:
        yield
    finally:
        with torch.no_grad():
            for n, p in own.items():
                p.copy_(saved[n])


def make_eval_fn(logits_fn: Callable, batch_limit: int = 16384):
    """Full-split accuracy like ``accuracy.eval``
    (``distributed.py:141-142,148,163``).

    ``logits_fn(model, images) -> logits``.  Returns ``evaluate(state,
    split) -> float`` where ``split`` has ``.images`` / ``.labels``
    (one-hot); the model runs in ``eval()`` mode without gradients, in
    batches of at most ``batch_limit`` rows on the model's device."""

    @torch.no_grad()
    def evaluate(state, split) -> float:
        model = state.model
        device = next(model.parameters()).device
        was_training = model.training
        model.eval()
        images, labels = split.images, split.labels
        n = images.shape[0]
        correct = 0
        try:
            for lo in range(0, n, batch_limit):
                hi = min(lo + batch_limit, n)
                x = torch.from_numpy(np.asarray(images[lo:hi])).to(device)
                y = torch.from_numpy(np.asarray(labels[lo:hi])).to(device)
                logits = logits_fn(model, x)
                correct += int((logits.argmax(-1) == y.argmax(-1)).sum())
        finally:
            model.train(was_training)
        return correct / max(n, 1)

    return evaluate


def to_device(batch: Any, device: torch.device) -> Any:
    """A host batch (tuples or dicts of numpy arrays) as tensors on
    ``device``: on a card, a pinned staging copy and a ``non_blocking``
    transfer on the current stream, ordered before the step that reads
    it."""
    def leaf(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)
    if isinstance(batch, dict):
        return {k: leaf(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(leaf(v) for v in batch)
    return leaf(batch)


class TrainLoopResult:
    def __init__(self):
        self.local_steps = 0
        self.final_global_step = 0
        self.train_time = 0.0
        self.test_accuracy = None
        self.validation_accuracies: list[tuple[int, float]] = []
        self.last_loss = None
        self.steps_per_sec = 0.0
        self.interrupted = False
        self.resharded = False


def run_training_loop(
    *,
    state,
    train_step: Callable,
    datasets,
    batch_size: int,
    train_steps: int,
    eval_fn: Callable,
    device: torch.device,
    task_index: int = 0,
    feed_split=None,
    feed_batch_size: int | None = None,
    validation_every: int = 10000,
    log_every: int = 1,
    supervisor=None,
    replica_mask_fn: Callable[[], Any] | None = None,
    print_fn: Callable[[str], None] = print,
    metrics_logger: MetricsLogger | None = None,
    telemetry: Telemetry | None = None,
    summary_writer=None,
    summary_histograms: bool = False,
    lr_fn: Callable[[int], float] | None = None,
    prefetch: int = 2,
    steps_per_call: int = 1,
    accum_steps: int = 1,
    shutdown=None,
    stat_publish_fn: Callable[[dict], None] | None = None,
    elastic=None,
) -> tuple[Any, TrainLoopResult]:
    """Run the reference's training loop shape against a train step.

    As the JAX ``run_training_loop``; the differences are the device and
    the feed.  ``device`` is where batches go.  ``feed_split`` (default
    ``datasets.train``) and ``feed_batch_size`` (default ``batch_size``)
    are this process's train stream and rows a step: the trainer passes
    ``datasets.train.shard(rank, world)`` and ``batch_size // world``
    under a process group.  ``batch_size`` stays the global batch (the
    examples/s of the metric records).

    ``replica_mask_fn`` supplies the R<N per-replica mask each step
    (masked sync).  ``supervisor`` receives ``maybe_save(state)`` after
    each step.  ``steps_per_call > 1`` means ``train_step`` is a scanned
    step (logging, validation and checkpoints at chunk boundaries; they
    must be multiples of it); ``accum_steps > 1`` an accumulating step
    (each call takes that many stacked microbatches, one optimizer step).
    ``shutdown`` (a :class:`..training.preemption.ShutdownSignal`) makes
    the loop checkpoint and return with ``result.interrupted`` when it
    latches.  ``telemetry`` turns on the per-step breakdown (data wait vs
    compute, the step synchronised with the device each step), eval and
    checkpoint pauses, MFU and device-memory high-watermarks in the same
    JSONL stream; ``stat_publish_fn`` receives a compact summary a logged
    step (best-effort).  ``elastic`` (a
    :class:`..training.elastic.ElasticController`) sees every completed
    step: it may swap in a restored state after a rejoin, or end the loop
    for a checkpoint-reshard-resume cycle (``result.resharded``; no final
    evaluation, the caller relaunches)."""
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if steps_per_call > 1 and accum_steps > 1:
        raise ValueError(
            f"steps_per_call={steps_per_call} and accum_steps={accum_steps} "
            "cannot combine (chunked dispatch of accumulated steps is not "
            "supported); pick one")
    if steps_per_call > 1:
        for name, every in (("log_every", log_every),
                            ("validation_every", validation_every)):
            if every and every % steps_per_call:
                raise ValueError(
                    f"{name}={every} must be a multiple of "
                    f"steps_per_call={steps_per_call} (or 0)")
        if replica_mask_fn is not None:
            raise ValueError(
                "steps_per_call > 1 is incompatible with masked (R<N) sync: "
                "the replica mask is sampled per step")
    result = TrainLoopResult()
    rate_meter = StepRateMeter()
    stack_n = steps_per_call if steps_per_call > 1 else accum_steps
    if feed_split is None:
        feed_split = datasets.train
    if feed_batch_size is None:
        feed_batch_size = batch_size

    def put(batch):
        return to_device(batch, device)

    if stack_n > 1:
        from ..parallel.sync import stack_microbatches

        def host_batch_fn():
            return stack_microbatches(
                [feed_split.next_batch(feed_batch_size)
                 for _ in range(stack_n)])
    else:
        def host_batch_fn():
            return feed_split.next_batch(feed_batch_size)

    prefetcher = None
    observe_produce = (telemetry.histogram("prefetch_produce_ms").record
                       if telemetry is not None else None)
    if prefetch:
        prefetcher = DevicePrefetcher(host_batch_fn, put, depth=prefetch,
                                      observe_produce_ms=observe_produce)

    try:
        with Timer() as train_timer:
            state = _step_loop(
                state=state, train_step=train_step, datasets=datasets,
                batch_size=batch_size, train_steps=train_steps,
                task_index=task_index, validation_every=validation_every,
                log_every=log_every, supervisor=supervisor, eval_fn=eval_fn,
                replica_mask_fn=replica_mask_fn, print_fn=print_fn,
                metrics_logger=metrics_logger, telemetry=telemetry,
                summary_writer=summary_writer,
                summary_histograms=summary_histograms, lr_fn=lr_fn,
                prefetcher=prefetcher, put=put, device=device,
                result=result, rate_meter=rate_meter,
                host_batch_fn=host_batch_fn, steps_per_call=steps_per_call,
                shutdown=shutdown, stat_publish_fn=stat_publish_fn,
                elastic=elastic)
    finally:
        if prefetcher is not None:
            prefetcher.close()

    result.train_time = train_timer.elapsed
    result.steps_per_sec = rate_meter.rate()
    print_fn(f"Training elapsed time:{result.train_time:f} s")

    if result.interrupted:
        print_fn(f"Worker {task_index}: shutdown requested; checkpointing at "
                 f"global step {result.final_global_step} and exiting")
    elif result.resharded:
        print_fn(f"Worker {task_index}: elastic reshard requested; "
                 f"checkpointed at global step {result.final_global_step} "
                 "and exiting for relaunch")
    else:
        test_accuracy = eval_fn(state, datasets.test)
        result.test_accuracy = test_accuracy
        print_fn(f"Worker {task_index}: test accuracy {test_accuracy:g}")
        if summary_writer is not None:
            summary_writer.scalar("accuracy/test", test_accuracy,
                                  result.final_global_step)
            summary_writer.flush()

    if telemetry is not None:
        telemetry.emit_summary(
            step=result.final_global_step,
            local_steps=result.local_steps,
            train_time_s=round(result.train_time, 3),
            steps_per_sec=round(result.steps_per_sec, 3),
            examples_per_sec=round(rate_meter.examples_per_sec(batch_size), 1),
            mfu=telemetry.mfu(result.steps_per_sec),
            interrupted=result.interrupted,
            resharded=result.resharded,
            test_accuracy=result.test_accuracy,
            **({"prefetch": prefetcher.stats()}
               if prefetcher is not None else {}))

    if supervisor is not None:
        supervisor.maybe_save(state, force=True)
        supervisor.wait_until_finished()
    return state, result


def _hbm_watermark(hbm_peak: dict, device: torch.device
                   ) -> tuple[int, int, int]:
    """Sample device memory and advance the host-side high-watermark:
    ``(bytes_in_use, peak_bytes, bytes_limit)``, the peak from the
    allocator's own ``max_memory_allocated`` (zeros on the CPU)."""
    stats = device_memory_stats(device)
    hbm_peak["peak"] = max(hbm_peak["peak"], stats["peak_bytes_in_use"],
                           stats["bytes_in_use"])
    return stats["bytes_in_use"], hbm_peak["peak"], stats["bytes_limit"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_loop(*, state, train_step, datasets, batch_size, train_steps,
               task_index, validation_every, log_every, supervisor, eval_fn,
               replica_mask_fn, print_fn, metrics_logger, telemetry,
               summary_writer, summary_histograms, lr_fn, prefetcher, put,
               device, result, rate_meter, host_batch_fn, steps_per_call,
               shutdown, stat_publish_fn=None, elastic=None):
    local_step = 0
    metrics = None
    data_wait_acc = compute_acc = 0.0
    hbm_peak = {"peak": 0}
    tracer = tracing.active()
    while True:
        wait_t0_unix = time.time()
        t0 = time.perf_counter()
        batch = (prefetcher.next() if prefetcher is not None
                 else put(host_batch_fn()))
        if telemetry is not None:
            data_wait_ms = (time.perf_counter() - t0) * 1000.0
            data_wait_acc += data_wait_ms
            telemetry.histogram("data_wait_ms").record(data_wait_ms)

        if validation_every and local_step % validation_every == 0:
            eval_t0_unix = time.time()
            t0 = time.perf_counter()
            validation_accuracy = eval_fn(state, datasets.validation)
            eval_ms = (time.perf_counter() - t0) * 1000.0
            result.validation_accuracies.append(
                (local_step, validation_accuracy))
            print_fn(f"Worker {task_index}: validation accuracy "
                     f"{validation_accuracy:g}")
            if telemetry is not None:
                telemetry.counter("eval_pauses").inc()
                telemetry.histogram("eval_ms").record(eval_ms)
                if tracer is not None:
                    tracer.emit_span("eval", eval_t0_unix, eval_ms,
                                     step=int(state.global_step))
                telemetry.emit("eval", step=int(state.global_step),
                               local_step=local_step,
                               validation_accuracy=validation_accuracy,
                               eval_ms=round(eval_ms, 3))
            elif metrics_logger is not None:
                metrics_logger.log(int(state.global_step),
                                   local_step=local_step,
                                   validation_accuracy=validation_accuracy)
            if summary_writer is not None:
                summary_writer.scalar("accuracy/validation",
                                      validation_accuracy,
                                      int(state.global_step))
                if summary_histograms:
                    step_now = int(state.global_step)
                    for name, p in state.model.named_parameters():
                        summary_writer.histogram(
                            "params/" + name.replace(".", "/"),
                            p.detach().float().cpu().numpy(), step_now)
                summary_writer.flush()

        compute_t0_unix = time.time()
        t0 = time.perf_counter()
        if replica_mask_fn is not None:
            state, metrics = train_step(state, batch, replica_mask_fn())
        else:
            state, metrics = train_step(state, batch)
        if telemetry is not None:
            # Honest device-compute time: the step synchronised with the
            # device, traded for the overlap; leave telemetry off to race
            # the host ahead.
            _sync(device)
            compute_ms = (time.perf_counter() - t0) * 1000.0
            compute_acc += compute_ms
            telemetry.histogram("compute_ms").record(compute_ms)
            telemetry.histogram("step_ms").record(data_wait_ms + compute_ms)
            if tracer is not None:
                step_now = int(metrics["global_step"])
                tracer.set_step(step_now)
                step_span = tracer.emit_span(
                    "step", wait_t0_unix,
                    (time.time() - wait_t0_unix) * 1000.0,
                    step=step_now,
                    data_wait_ms=round(data_wait_ms, 3),
                    compute_ms=round(compute_ms, 3))
                tracer.emit_span("data_wait", wait_t0_unix, data_wait_ms,
                                 step=step_now, parent_id=step_span)
                tracer.emit_span("compute", compute_t0_unix, compute_ms,
                                 step=step_now, parent_id=step_span)
        local_step += steps_per_call
        rate_meter.update(steps_per_call)

        if supervisor is not None:
            save_t0_unix = time.time()
            t0 = time.perf_counter()
            if supervisor.maybe_save(state) and telemetry is not None:
                save_ms = (time.perf_counter() - t0) * 1000.0
                telemetry.counter("checkpoints").inc()
                telemetry.histogram("checkpoint_ms").record(save_ms)
                telemetry.emit("checkpoint",
                               step=int(metrics["global_step"]),
                               local_step=local_step,
                               save_ms=round(save_ms, 3))
                if tracer is not None:
                    tracer.emit_span("checkpoint_save", save_t0_unix,
                                     save_ms,
                                     step=int(metrics["global_step"]))

        if log_every and local_step % log_every == 0:
            # One host sync per logged step (the reference's per-step
            # print, distributed.py:152-153; raise log_every to amortize).
            loss_value = float(metrics["loss"])
            step = int(metrics["global_step"])
            train_accuracy = float(metrics.get("accuracy", math.nan))
            result.last_loss = loss_value
            print_fn(
                f"Worker {task_index}: traing step {local_step} "
                f"(global step:{step}) loss {loss_value:f} "
                f"training accuracy {train_accuracy:g}")
            extra = ({"grad_norm": float(metrics["grad_norm"])}
                     if "grad_norm" in metrics else {})
            if lr_fn is not None:
                # global_step starts at 1 and increments per update, so the
                # update that produced this step had count step - 2.
                extra["learning_rate"] = float(lr_fn(max(step - 2, 0)))
            tele_fields = {}
            stat_payload = None
            if telemetry is not None:
                rate = rate_meter.rate()
                in_use, peak, limit = _hbm_watermark(hbm_peak, device)
                telemetry.gauge("hbm_peak_bytes").set(peak)
                tele_fields = dict(
                    data_wait_ms=round(data_wait_acc, 3),
                    compute_ms=round(compute_acc, 3),
                    mfu=telemetry.mfu(rate),
                    model_flops_per_sec=telemetry.model_flops_per_sec(rate),
                    hbm_bytes_in_use=in_use,
                    hbm_peak_bytes=peak,
                    hbm_bytes_limit=limit)
                stat_payload = dict(
                    step=step, loss=round(loss_value, 6),
                    step_ms=round(data_wait_acc + compute_acc, 3),
                    data_wait_ms=round(data_wait_acc, 3),
                    hbm_peak_bytes=peak)
                data_wait_acc = compute_acc = 0.0
                telemetry.emit(
                    "train_step", step=step, local_step=local_step,
                    loss=loss_value, accuracy=train_accuracy,
                    steps_per_sec=round(rate_meter.rate(), 3),
                    examples_per_sec=round(
                        rate_meter.examples_per_sec(batch_size), 1),
                    **extra, **tele_fields)
            elif metrics_logger is not None:
                metrics_logger.log(
                    step, local_step=local_step, loss=loss_value,
                    accuracy=train_accuracy,
                    steps_per_sec=round(rate_meter.rate(), 3),
                    examples_per_sec=round(
                        rate_meter.examples_per_sec(batch_size), 1),
                    **extra)
            if stat_publish_fn is not None and stat_payload is not None:
                try:
                    stat_publish_fn(stat_payload)
                except Exception:
                    # Live watching is best-effort by contract: a dead
                    # coordinator must not take training down.
                    pass
            if summary_writer is not None:
                summary_writer.scalars(
                    {"loss/train": loss_value,
                     "accuracy/train": train_accuracy,
                     "throughput/steps_per_sec": rate_meter.rate(),
                     **extra}, step)
        else:
            step = int(metrics["global_step"])

        # Chaos harness hook: a no-op single check unless an injector is
        # armed (deterministic kill-at-step for the fault-recovery tests).
        faults.on_step(step)
        # Elastic membership hook (after faults.on_step, so an
        # evict_at_step directive is armed before it looks): may hand back
        # a freshly restored state after a rejoin, or request a
        # checkpoint-reshard-resume exit.
        if elastic is not None:
            state, reshard_stop = elastic.on_step(state, step)
            if reshard_stop:
                result.resharded = True
                break
        # Shutdown wins over normal completion: under preemption the hard
        # kill can land during the (slow) final eval, so exit the
        # checkpoint-first path even if train_steps was reached this step.
        if shutdown is not None and shutdown.requested():
            result.interrupted = True
            break
        if step >= train_steps:
            break

    result.local_steps = local_step
    result.final_global_step = step
    return state
