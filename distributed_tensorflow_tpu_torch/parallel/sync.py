"""Synchronous replica training, the ``SyncReplicasOptimizer`` equivalent.

Counterpart of ``distributed_tensorflow_tpu/parallel/sync.py``.  There a
step is one jitted function: the batch is sharded over the ``data`` mesh
axis and XLA turns the gradient mean into an AllReduce.  Here a step runs
eagerly, one process per worker, and the mean across processes is an
explicit ``torch.distributed.all_reduce`` (:class:`GradientAllReduce`)
between the backward pass and the optimizer:

- **R == N (default)**: every rank computes the gradient of its local
  batch, one all-reduce sums the gradients (with the loss and the aux
  metrics riding in the same buffer), each rank divides by the world size
  and applies the same update, so the parameters stay bit-equal across
  ranks.
- **R < N stragglers** (:func:`build_masked_sync_train_step`): the
  coordination service marks dead or slow replicas and the step takes a
  per-replica 0/1 mask; masked gradients are dropped and the mean is
  renormalised over the live set, the reference's stale-gradient drop.

**The global batch.**  ``--batch_size`` is global, as in JAX.  With a
process group of W ranks each rank feeds ``batch_size // W`` rows (the
trainer requires W to divide the batch; ``DataSet.shard(rank, W)`` gives
each rank a disjoint stream).  Each rank's loss is the mean over its rows,
so the mean over ranks of those means is the global-batch mean, and a
two-rank step equals the one-process step on the concatenated batch up to
the order of the sums.  Without a process group a worker trains on the
whole batch alone (the JAX multi-process tests' single-controller
workers).

**Local data rows.**  A worker whose mesh has ``data > 1`` holds one
copy of the model a row (``TrainState.rows``, ``parallel/sharding.py``)
and splits its batch over them as JAX's ``P("data")`` splits it (row
``r`` takes the ``r``-th of ``n`` equal parts, on its own device; the
feed may hand the parts over already placed, :class:`RowBatches`).
Each row runs forward and backward on its part; the gradients' mean is
taken first over the rows (in process, within each DCN slice and then
across the slices, :meth:`..parallel.mesh.Mesh.row_slices`), then over
the workers (:class:`GradientAllReduce`, hierarchical with DCN slice
groups); the lead row's optimizer applies it once and every other row
takes the update (``sharding.copy_rows``), so the rows stay bit-equal.
A stateful step (BatchNorm) runs the worker's rows through the lead in
one forward, so each BatchNorm's statistics span every position's rows
(and, through the all-reduce, every worker's).

A model sharded over a single-process mesh (``attention_backend="ring"``
or ``"ulysses"``, tensor parallelism by ``parallel/sharding.shard_state``)
needs no all-reduce of its own: a replicated weight is one tensor, and
autograd sums every position's contribution into its gradient; a split
weight is its shards, one parameter each.  So the global norm (clipping,
``log_grad_norm``) counts each shard once, the moving average runs per
shard, and :class:`GradientAllReduce` flattens every shard.

**The stateful steps** (:func:`build_stateful_sync_train_step`,
:func:`build_scanned_stateful_sync_train_step`: ResNet-20's BatchNorm)
take their statistics over the GLOBAL batch, as the JAX step does under
GSPMD: the step hands its ``GradientAllReduce`` to the model, whose
BatchNorms all-reduce their per-channel sums over the workers' group in
the forward (and their gradients in the backward,
``models/resnet._moments``), so a two-rank step equals the
one-process step on the concatenated batch and the running statistics
(``TrainState.model_state``, updated in place) stay bit-equal across
the workers.  The async
half's helpers live here too, as in JAX: the hierarchical exchange's
topology map (:func:`slice_topology` and its exporter election) and the
intra-slice reduction (:func:`build_intra_slice_reduce`), used by
:mod:`..cluster.param_sync`.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..training.optimizers import global_norm
from ..training.state import TrainState
from .sharding import copy_rows, row_models

# loss_fn signature: (model, batch) -> (scalar_loss, aux_metrics_dict);
# rng-aware variants (needs_rng=True) take (model, batch, rng) instead.
LossFn = Callable[..., tuple[torch.Tensor, dict]]


class GradientAllReduce:
    """Sums tensors across the ranks of a ``torch.distributed`` process
    group in ONE collective: they are flattened into one fp32 buffer,
    all-reduced and copied back.  ``first_seconds`` is the first call's
    time (it sets up the backend's connections: NCCL builds its
    communicator there); ``seconds`` and ``calls`` accumulate the later
    calls'.  The buffer's device work is waited for before the clock
    starts, so each time is the collective's own, the wait for the
    slowest rank included.  ``group`` (default: every worker): over the
    global mesh, the ranks that share this rank's pipe coordinate (its
    data and seq line, ``parallel/mesh.RankAxes.grad_lines``)."""

    def __init__(self, group=None, slice_groups: tuple | None = None,
                 partials: int = 1):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        # Ranks of the group that hold parts of one data coordinate's
        # gradient (the seq axis across processes): their sum is that
        # coordinate's gradient, and the mean is over the rest.
        self.partials = partials
        # ``(within, across)``: with ``--dcn_data_parallel`` the sum runs
        # within this worker's DCN slice first, then across the slices
        # (``cluster/server.py`` forms the groups).
        self.slice_groups = slice_groups
        self.world_size = dist.get_world_size(group)
        self.first_seconds: float | None = None
        self.seconds = 0.0
        self.calls = 0

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: every tensor becomes its sum over the ranks (in fp32,
        or in float64 where one of them is)."""
        # Every shard of a tensor-parallel state too, each from its own
        # device.
        home = tensors[0].device
        dtype = (torch.float64 if any(t.dtype == torch.float64
                                      for t in tensors) else torch.float32)
        flat = torch.cat([t.detach().reshape(-1).to(home, dtype)
                          for t in tensors])
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        t0 = time.perf_counter()
        if self.slice_groups is None:
            self._dist.all_reduce(flat, group=self.group)
        else:
            for group in self.slice_groups:
                self._dist.all_reduce(flat, group=group)
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        if self.first_seconds is None:
            self.first_seconds = time.perf_counter() - t0
        else:
            self.seconds += time.perf_counter() - t0
            self.calls += 1
        offset = 0
        with torch.no_grad():
            for t in tensors:
                n = t.numel()
                t.copy_(flat[offset:offset + n].view_as(t))
                offset += n


class RowBatches(list):
    """A batch already split into a worker's data rows' parts, part ``r``
    on row ``r``'s device (the feed's form: ``training/loop.to_device``
    with several devices)."""


def _place(batch: Any, device) -> Any:
    def put(t):
        return (t.to(device, non_blocking=True) if torch.is_tensor(t)
                else t)
    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(put(v) for v in batch)
    return put(batch)


def row_parts(state: TrainState, batch: Any) -> list:
    """``[(model, part)]`` a data row: the batch split over the rows (its
    first dim, as ``P("data")``), each part on its row's device."""
    models = row_models(state)
    if len(models) == 1:
        return [(state.model, batch)]
    if isinstance(batch, RowBatches):
        parts = list(batch)
    else:
        n = len(models)
        parts = [_place(_split(batch, n, r), state.row_devices[r])
                 for r in range(n)]
    return list(zip(models, parts))


def _whole_batch(state: TrainState, batch: Any) -> Any:
    """The worker's rows as one batch on the lead's device."""
    if not isinstance(batch, RowBatches):
        return batch
    home = state.row_devices[0]
    parts = [_place(b, home) for b in batch]
    first = parts[0]
    if isinstance(first, dict):
        return {k: torch.cat([b[k] for b in parts]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(torch.cat(xs) for xs in zip(*parts))
    return torch.cat(parts)


def _row_slices(state: TrainState) -> list:
    return getattr(state, "row_slices", None) or [
        list(range(1 + len(state.rows or ())))]


def _sum_rows_(values: list, slices: list) -> None:
    """In place: ``values[0]`` (a list of tensors, the lead row's) becomes
    the sum of every row's list, within each DCN slice first (rows in
    order), then across the slices."""
    def add_(dst, src):
        torch._foreach_add_(dst, [t.to(d.device) for t, d in zip(src, dst)])
    heads = []
    for group in slices:
        head = values[group[0]]
        for r in group[1:]:
            add_(head, values[r])
        heads.append(head)
    for head in heads[1:]:
        add_(heads[0], head)


def _reduce_rows(state: TrainState, skip=frozenset()) -> None:
    """The lead's gradients become the sum of every data row's (the rows'
    own released); ``skip``: parameters reduced already (FSDP's slices)."""
    if not state.rows:
        return
    rows = [dict(m.named_parameters()) for m in state.rows]
    names, grads = [], [[] for _ in range(1 + len(rows))]
    for name, p in state.model.named_parameters():
        if p in skip or not p.requires_grad:
            continue
        names.append(name)
        for r, q in enumerate([p] + [row[name] for row in rows]):
            if q.grad is None:
                q.grad = torch.zeros_like(q)
            grads[r].append(q.grad)
    if names:
        _sum_rows_(grads, _row_slices(state))
    for row in rows:
        for name in names:
            row[name].grad = None


def _mean_over_rows(state: TrainState, losses: list, auxes: list
                    ) -> tuple[torch.Tensor, dict]:
    """The rows' losses and tensor aux metrics summed (the slice order of
    the gradients; the caller scales), the other aux values row 0's."""
    keys = [k for k, v in auxes[0].items() if torch.is_tensor(v)]
    # fp32, or float64 where the loss is (a float64 model's).
    dtype = torch.promote_types(losses[0].dtype, torch.float32)
    values = [[l.to(dtype).reshape(1)] + [a[k].detach().to(dtype).reshape(1)
                                          for k in keys]
              for l, a in zip(losses, auxes)]
    if len(values) > 1:
        _sum_rows_(values, _row_slices(state))
    loss = values[0][0].reshape(())
    aux = dict(auxes[0])
    aux.update({k: v.reshape(()) for k, v in zip(keys, values[0][1:])})
    return loss, aux


def _reduce_step(state: TrainState, loss: torch.Tensor, aux: dict,
                 reduce: GradientAllReduce | None, scale: float,
                 skip=frozenset(), rows: bool = True
                 ) -> tuple[torch.Tensor, dict]:
    """Sum the gradients (over the data rows, with ``rows``, then), the
    loss and the tensor aux metrics across the ranks and multiply them by
    ``scale`` (1 / the number of terms).  ``skip``: parameters whose
    gradients are reduced already (FSDP's slices, reduce-scattered)."""
    if rows:
        _reduce_rows(state, skip)
    params = [p for p in state.optimizer.params if p not in skip]
    for p in params:
        # Every rank reduces the same buffer layout: a parameter this
        # batch did not reach has a zero gradient (optax's semantics too).
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    keys = [k for k, v in aux.items() if torch.is_tensor(v)]
    scalars = torch.stack([loss.detach().float()]
                          + [aux[k].detach().float() for k in keys])
    if reduce is not None:
        reduce.sum_(grads + [scalars])
        # Every seq rank computes the whole loss (joined logits): the
        # scalars are counted once a data coordinate.
        scalars = scalars / reduce.partials
    if scale != 1.0:
        for g in grads:
            g.mul_(scale)
        scalars = scalars * scale
    return scalars[0], {**aux, **dict(zip(keys, scalars[1:]))}


def _finish(state: TrainState, loss, aux, ema_decay: float,
            log_grad_norm: bool) -> dict:
    metrics = {"loss": loss.detach(),
               **{k: v.detach() if torch.is_tensor(v) else v
                  for k, v in aux.items()}}
    if log_grad_norm:
        # The norm the optimizer clips by (an FSDP slice's squares summed
        # over the workers there).
        metrics["grad_norm"] = global_norm(state.optimizer.params)
    state.apply_gradients()
    copy_rows(state)
    if ema_decay > 0.0:
        _ema_update(ema_decay, state)
    metrics["global_step"] = state.global_step
    return metrics


class FsdpStep:
    """An FSDP state's collectives around a step
    (``parallel/sharding.FsdpExchange``): the split parameters gathered
    whole before the forward; after the backward their gradients
    reduce-scattered to each worker's slice as the mean over the workers
    (the sync step's all-reduce gives the same mean), the whole tensors
    released, and the rest of the gradients all-reduced as usual.  The
    global norm sums the slices' squares over the workers
    (``training/optimizers.global_norm``).  Built once per model
    (``for_state``)."""

    def __init__(self, state):
        from .sharding import FsdpExchange, row_models
        self.model = state.model
        self.exchange = FsdpExchange(row_models(state))
        self.slices = frozenset(m._parameters[a] for row in
                                self.exchange.rows for _, m, a, _ in row)

    @classmethod
    def for_state(cls, state, cache: dict, reduce):
        from .sharding import fsdp_entries, is_fsdp
        if not isinstance(state, TrainState) or not is_fsdp(state.model):
            return None
        if reduce is None and fsdp_entries(state.model)[0][3].workers > 1:
            raise ValueError("an FSDP state's step needs all_reduce (a "
                             "GradientAllReduce over the workers' group)")
        held = cache.get("fsdp")
        if held is None or held.model is not state.model:
            held = cache["fsdp"] = cls(state)
        return held


def _terms(state: TrainState, reduce: GradientAllReduce | None) -> int:
    """The data axis's positions: the worker's rows times the workers."""
    return ((1 + len(state.rows or ()))
            * (reduce.world_size // reduce.partials if reduce is not None
               else 1))


def _zero_rows(state: TrainState) -> None:
    state.optimizer.zero_grad()
    for model in state.rows or ():
        model.zero_grad(set_to_none=True)


def _train(state: TrainState) -> None:
    for model in row_models(state):
        model.train()


def _one_update(loss_fn: LossFn, needs_rng: bool, ema_decay: float,
                log_grad_norm: bool, reduce: GradientAllReduce | None,
                whole_batch: bool = False):
    """Per-batch gradient (mean across ranks) and optimizer update, shared
    by the plain and scanned builders.  An FSDP state (its parameters
    split over the data axis) runs its gather and reduce-scatter around
    the forward and backward (:class:`FsdpStep`).  ``whole_batch``: the
    worker's data rows run through the lead in one forward (the stateful
    steps)."""
    cache: dict = {}

    def update(state: TrainState, batch: Any):
        if whole_batch:
            scale = 1.0 / (reduce.world_size // reduce.partials
                           if reduce is not None else 1)
            parts = [(state.model, _whole_batch(state, batch))]
        else:
            scale = 1.0 / _terms(state, reduce)
            parts = row_parts(state, batch)
        _train(state)
        _zero_rows(state)
        fsdp = FsdpStep.for_state(state, cache, reduce)
        if fsdp is not None:
            fsdp.exchange.gather()
        losses, auxes = [], []
        try:
            for model, part in parts:
                if needs_rng:
                    loss, aux = loss_fn(model, part, state.rng)
                else:
                    loss, aux = loss_fn(model, part)
                loss.backward()
                # The graph goes (and with it the hold on FSDP's whole
                # parameters) before the gradients are reduce-scattered.
                losses.append(loss.detach())
                auxes.append(aux)
        finally:
            if fsdp is not None:
                fsdp.exchange.scatter(scale)
        loss, aux = _mean_over_rows(state, losses, auxes)
        if reduce is not None or state.rows:
            loss, aux = _reduce_step(state, loss, aux, reduce, scale,
                                     fsdp.slices if fsdp else frozenset(),
                                     rows=not whole_batch)
        return state, _finish(state, loss, aux, ema_decay, log_grad_norm)

    # ``update.cache["fsdp"]``: an FSDP state's FsdpStep (its exchange's
    # gather and reduce-scatter times), once the first step built it.
    update.cache = cache
    return update


def build_sync_train_step(loss_fn: LossFn, *, needs_rng: bool = False,
                          ema_decay: float = 0.0,
                          log_grad_norm: bool = False,
                          all_reduce: GradientAllReduce | None = None):
    """Returns ``step(state, batch) -> (state, metrics)``: forward in
    ``train()`` mode, backward, the gradient mean across ranks (with
    ``all_reduce``; the loss and aux metrics are then global means too),
    one optimizer step.

    ``needs_rng=True``: ``loss_fn(model, batch, state.rng)`` (dropout);
    the generator advances as the model draws from it.  ``ema_decay > 0``
    updates ``state.ema_params`` after each optimizer step.
    ``log_grad_norm=True`` adds the global L2 norm of the (reduced)
    gradients as ``grad_norm``.  Metric values stay on the device (0-dim
    tensors; the global step is an int): reading one waits for the step."""
    return _one_update(loss_fn, needs_rng, ema_decay, log_grad_norm,
                       all_reduce)


def build_scanned_sync_train_step(loss_fn: LossFn, *, num_steps: int,
                                  needs_rng: bool = False,
                                  ema_decay: float = 0.0,
                                  log_grad_norm: bool = False,
                                  all_reduce: GradientAllReduce | None = None):
    """``num_steps`` optimizer steps per call (``--steps_per_call``).

    JAX runs them as one ``lax.scan`` dispatch; here they are a Python loop
    over the stacked batches, semantically K calls of
    :func:`build_sync_train_step`.  Every leaf of ``batches`` has a
    leading ``[num_steps]`` axis (:func:`stack_microbatches`); the metrics
    are the last step's."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    one = _one_update(loss_fn, needs_rng, ema_decay, log_grad_norm,
                      all_reduce)

    def step(state: TrainState, batches: Any):
        metrics = None
        for i in range(num_steps):
            state, metrics = one(state, _index(batches, i))
        return state, metrics

    return step


def build_stateful_sync_train_step(stateful_loss_fn: Callable, *,
                                   all_reduce: GradientAllReduce | None
                                   = None):
    """Sync step for models with non-trainable state (BatchNorm).

    ``stateful_loss_fn(model, batch, all_reduce) -> (loss, aux)`` runs the
    model in ``train()`` mode: its BatchNorms normalise with the
    statistics of the global batch (every worker's rows, summed over
    ``all_reduce``'s group; this process's rows without one) and move
    their running statistics (``state.model_state``) in place.  The rest
    is :func:`build_sync_train_step`'s: the gradient mean across the
    ranks, one optimizer step; no rng, moving average or gradient norm
    (the JAX stateful step has none)."""
    return _one_update(lambda model, batch: stateful_loss_fn(
        model, batch, all_reduce), False, 0.0, False, all_reduce,
        whole_batch=True)


def build_scanned_stateful_sync_train_step(stateful_loss_fn: Callable, *,
                                           num_steps: int,
                                           all_reduce: GradientAllReduce
                                           | None = None):
    """``num_steps`` stateful steps per call (``--steps_per_call``), K
    calls of :func:`build_stateful_sync_train_step` over a
    ``[num_steps]``-stacked batch; the metrics are the last step's."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    one = build_stateful_sync_train_step(stateful_loss_fn,
                                         all_reduce=all_reduce)

    def step(state: TrainState, batches: Any):
        metrics = None
        for i in range(num_steps):
            state, metrics = one(state, _index(batches, i))
        return state, metrics

    return step


def build_accumulating_sync_train_step(
        loss_fn: LossFn, *, accum_steps: int, needs_rng: bool = False,
        ema_decay: float = 0.0, log_grad_norm: bool = False,
        all_reduce: GradientAllReduce | None = None):
    """Gradient accumulation (``--grad_accum_steps``): K microbatch
    gradients averaged, ONE optimizer step.

    Each call consumes a ``[accum_steps, ...]``-stacked batch, runs K
    forward/backward passes (autograd sums into ``.grad``), divides by K
    (and by the world size, after the all-reduce) and applies the mean
    once: a single step on the concatenated batch with one microbatch's
    activation memory.  ``global_step`` advances by 1 a call; the metrics
    are microbatch means."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    cache: dict = {}

    def step(state: TrainState, batches: Any):
        scale = 1.0 / (accum_steps * _terms(state, all_reduce))
        _train(state)
        _zero_rows(state)
        losses, auxes = [], []
        fsdp = FsdpStep.for_state(state, cache, all_reduce)
        if fsdp is not None:
            fsdp.exchange.gather()
        for i in range(accum_steps):
            for r, (model, batch) in enumerate(
                    row_parts(state, _index(batches, i))):
                if needs_rng:
                    loss, aux = loss_fn(model, batch, state.rng)
                else:
                    loss, aux = loss_fn(model, batch)
                loss.backward()
                loss = loss.detach()
                aux = {k: v.detach() if torch.is_tensor(v) else v
                       for k, v in aux.items()}
                if i == 0:
                    losses.append(loss)
                    auxes.append(aux)
                    continue
                losses[r] = losses[r] + loss
                auxes[r] = {k: v + aux[k] if torch.is_tensor(v) else v
                            for k, v in auxes[r].items()}
        if fsdp is not None:
            fsdp.exchange.scatter(scale)
        loss, aux = _mean_over_rows(state, losses, auxes)
        loss, aux = _reduce_step(state, loss, aux, all_reduce,
                                 scale, fsdp.slices if fsdp else frozenset())
        return state, _finish(state, loss, aux, ema_decay, log_grad_norm)

    return step


def stack_microbatches(batches: Sequence[Any]) -> Any:
    """Stack K host batches (tuples or dicts of arrays) along a new leading
    axis."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: np.stack([b[k] for b in batches]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack(xs) for xs in zip(*batches))
    return np.stack(batches)


def _index(batch: Any, i: int) -> Any:
    """Microbatch ``i`` of a stacked batch."""
    if isinstance(batch, RowBatches):
        return RowBatches(_index(b, i) for b in batch)
    if isinstance(batch, dict):
        return {k: v[i] for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(v[i] for v in batch)
    return batch[i]


def _split(batch: Any, n: int, i: int, dim: int = 0) -> Any:
    """Shard ``i`` of ``n`` equal shards along the batch dim (``dim``: 1
    for a stacked batch)."""
    def take(a):
        rows = a.shape[dim]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} replicas")
        k = rows // n
        index = [slice(None)] * dim + [slice(i * k, (i + 1) * k)]
        return a[tuple(index)]
    if isinstance(batch, dict):
        return {k: take(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(take(v) for v in batch)
    return take(batch)


def build_masked_sync_train_step(loss_fn: LossFn, num_replicas: int, *,
                                 all_reduce: GradientAllReduce | None = None,
                                 rank: int = 0):
    """R < N sync step: per-replica gradient masking with a renormalised
    mean.

    Returns ``step(state, batch, replica_mask) -> (state, metrics)`` where
    ``replica_mask`` is a float array of shape ``[num_replicas]`` (1.0 =
    include this replica's gradient, 0.0 = drop it — the reference's
    stale-gradient drop, ``distributed.py:92-99``).  This process holds
    ``num_replicas // world_size`` of the replicas (those from
    ``rank * local``), and splits its batch into that many equal shards, as
    the JAX step shards the batch over the ``data`` axis: each replica's
    loss is the mean over its shard.  The update is
    ``sum(w_r * grad_r) / max(sum(w), 1)``, identical on every rank (the
    mask is the same everywhere), and the loss and aux metrics are
    renormalised the same way.

    With a process group, a dead peer blocks the all-reduce until the
    group's timeout: use the mask to drop dead workers only without one
    (or where the peers are known to be alive), as the JAX package's
    single-controller workers do."""
    world = all_reduce.world_size if all_reduce is not None else 1
    if num_replicas % world:
        raise ValueError(f"{num_replicas} replicas do not divide over "
                         f"{world} ranks")
    local = num_replicas // world

    def step(state: TrainState, batch: Any, replica_mask):
        mask = np.asarray(replica_mask, np.float32).reshape(-1)
        if mask.shape != (num_replicas,):
            raise ValueError(f"replica_mask of shape {mask.shape}, expected "
                             f"({num_replicas},)")
        _train(state)
        _zero_rows(state)
        models = row_models(state)
        if local % len(models):
            raise ValueError(f"{local} replicas a worker over "
                             f"{len(models)} data rows")
        whole = _whole_batch(state, batch)
        loss = aux = None
        for j in range(local):
            # The worker's replicas in order over its data rows' copies.
            r = j * len(models) // local
            part = _split(whole, local, j)
            if state.rows:
                part = _place(part, state.row_devices[r])
            w = float(mask[rank * local + j])
            l, a = loss_fn(models[r], part)
            (l * w).backward()
            l = l.detach() * w
            a = {k: v.detach() * w if torch.is_tensor(v) else v
                 for k, v in a.items()}
            loss = l if loss is None else loss + l
            aux = a if aux is None else {
                k: v + a[k] if torch.is_tensor(v) else v
                for k, v in aux.items()}
        live = max(float(mask.sum()), 1.0)
        loss, aux = _reduce_step(state, loss, aux, all_reduce, 1.0 / live)
        return state, _finish(state, loss, aux, 0.0, False)

    return step


def full_mask(num_replicas: int) -> np.ndarray:
    """Mask including every replica (R == N), the default aggregation
    set."""
    return np.ones((num_replicas,), np.float32)


def replica_mask_from_tasks(alive, num_workers: int, devices_per_task: int,
                            members=None) -> np.ndarray:
    """Per-replica 0/1 float mask from per-TASK liveness bits.

    ``alive`` is the health view (who is answering heartbeats); ``members``
    (optional) is the elastic-membership view (who belongs to the replica
    set this epoch).  A task is included only when both agree; each task's
    bit is expanded to its ``devices_per_task`` replicas.  An all-dead view
    degenerates to all-alive: a step must never divide by zero, and a
    worker that cannot see anyone alive is better off trusting itself (the
    coordinator is probably the thing that is unreachable)."""
    bits = list(alive[:num_workers])
    if members is not None:
        bits = [a and m for a, m in zip(bits, members[:num_workers])]
    mask = np.repeat(np.asarray(bits, np.float32), devices_per_task)
    if mask.sum() < 1:
        mask[:] = 1.0
    return mask


def resolve_replicas_to_aggregate(replicas_to_aggregate: int | None,
                                  num_workers: int) -> int:
    """Reference default: R = num_workers when unset
    (``distributed.py:92-95``)."""
    return (num_workers if replicas_to_aggregate is None
            else replicas_to_aggregate)


@torch.no_grad()
def _ema_update(decay: float, state: TrainState) -> None:
    if state.ema_params is None:
        raise ValueError("ema_decay > 0 needs TrainState.create(..., "
                         "ema=True)")
    from .sharding import state_params
    for name, p in state_params(state).items():
        e = state.ema_params[name]
        e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)


def slice_topology(active, slice_size: int) -> list[tuple[int, ...]]:
    """Group the active task ids into slices of ``slice_size`` — the
    topology map of the hierarchical exchange (docs/param_exchange.md,
    "Hierarchical exchange").

    Tasks are sorted and grouped contiguously (pod slices are assigned
    contiguous task ranges by every launcher in this repo's lineage), the
    last slice absorbing the remainder of an uneven split.  The map is a
    pure function of ``(active, slice_size)``: every worker derives the
    identical grouping from the membership epoch's active set, with no
    negotiation — an evicted task simply vanishes from its slice at the
    next epoch and the map re-keys (the PR-5 evicted-owner rule one level
    up).
    """
    if slice_size < 1:
        raise ValueError(f"slice_size must be >= 1, got {slice_size}")
    tasks = sorted(active)
    if not tasks:
        return []
    slices = [tuple(tasks[lo:lo + slice_size])
              for lo in range(0, len(tasks), slice_size)]
    if (len(slices) > 1 and len(slices[-1]) < max(1, slice_size // 2)
            and len(slices[-2]) + len(slices[-1]) <= 32):
        # Runt slice: fold a too-small tail into its neighbor rather than
        # electing an exporter for one or two stragglers — but never past
        # 32 members, the u32 contributor-mask width the exchange levels
        # are built on (a 33-member fold would turn a valid config or an
        # elastic shrink into a per-exchange crash downstream).
        tail = slices.pop()
        slices[-1] = slices[-1] + tail
    return slices


def slice_exporters(slices) -> tuple[int, ...]:
    """Exporter election: the lowest task id of each slice — the one
    member that quantizes the slice-reduced delta and speaks to the other
    slices' exporters over DCN.  Pure function of the topology map, so
    (like shard ownership) every worker agrees without negotiation; the
    global chief (lowest active task) is always slice 0's exporter."""
    return tuple(min(s) for s in slices)


def slice_of_task(slices, task: int) -> int | None:
    """Index of the slice containing ``task`` (None when not a member)."""
    for g, members in enumerate(slices):
        if task in members:
            return g
    return None


def auto_slice_size(num_workers: int, dcn_slices: int = 1) -> int:
    """Slice size derived from the mesh topology: with ``dcn_slices`` ICI
    domains (the ``--dcn_data_parallel`` factor), workers split evenly
    into that many slices; otherwise 1 (every worker its own slice — the
    flat protocol's degenerate case)."""
    if dcn_slices > 1 and num_workers % dcn_slices == 0:
        return max(num_workers // dcn_slices, 1)
    return 1


def build_intra_slice_reduce(device: torch.device | str | None = None):
    """The intra-slice reduction: the mean of the local replicas' delta
    vectors, the ICI leg of the hierarchical exchange when a slice's
    members are local replicas (no KV traffic, no quantization).

    In JAX this is a jitted ``psum`` over the mesh's ``data`` axis.  Here
    the local replicas' deltas sit on one device (:mod:`.async_replicas`
    stacks them there), so it is one reduction on that device.  Returns
    ``reduce(stacked) -> mean``: ``stacked`` is ``[k, n]`` (one flat
    float32 delta a replica; a numpy array or a tensor), the result the
    float32 ``[n]`` mean as a host numpy array."""

    def reduce(stacked) -> np.ndarray:
        t = torch.as_tensor(stacked, dtype=torch.float32)
        if device is not None:
            t = t.to(device)
        return t.mean(dim=0).cpu().numpy()

    return reduce


def contiguous_shard_bounds(n: int, k: int) -> list[tuple[int, int]]:
    """Partition ``n`` elements into ``k`` contiguous shards, sizes within 1.

    The cross-replica update-sharding rule (Xu et al., arXiv:2004.13336):
    instead of every replica reducing the full parameter vector, replica
    ``i`` owns shard ``i`` of the flat buffer and reduces only that —
    turning an N-way full mirror into a reduce-scatter.  The first
    ``n % k`` shards carry the extra element, so the map is a pure
    function of ``(n, k)``: every worker derives identical bounds from
    the membership epoch's active count, with no negotiation.
    ``cluster/param_sync.py`` keys its compressed exchange on this.
    """
    if k < 1:
        raise ValueError(f"shard count must be >= 1, got {k}")
    base, extra = divmod(n, k)
    bounds = []
    lo = 0
    for i in range(k):
        hi = lo + base + (1 if i < extra else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds
