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

A model whose attention is sharded over a single-process mesh
(``attention_backend="ring"``) needs no all-reduce of its own: the
replicated weights are one set of tensors, and autograd sums every
shard's contribution into their gradients.

The stateful steps (BatchNorm models) wait for those models.  The async
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
    slowest rank included."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.world_size = dist.get_world_size(group)
        self.first_seconds: float | None = None
        self.seconds = 0.0
        self.calls = 0

    def sum_(self, tensors: Sequence[torch.Tensor]) -> None:
        """In place: every tensor becomes its sum over the ranks."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                          for t in tensors])
        if flat.is_cuda:
            torch.cuda.synchronize(flat.device)
        t0 = time.perf_counter()
        self._dist.all_reduce(flat, group=self.group)
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


def _reduce_step(state: TrainState, loss: torch.Tensor, aux: dict,
                 reduce: GradientAllReduce | None, scale: float
                 ) -> tuple[torch.Tensor, dict]:
    """Sum the gradients, the loss and the tensor aux metrics across the
    ranks and multiply them by ``scale`` (1 / the number of terms)."""
    for p in state.optimizer.params:
        # Every rank reduces the same buffer layout: a parameter this
        # batch did not reach has a zero gradient (optax's semantics too).
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in state.optimizer.params]
    keys = [k for k, v in aux.items() if torch.is_tensor(v)]
    scalars = torch.stack([loss.detach().float()]
                          + [aux[k].detach().float() for k in keys])
    if reduce is not None:
        reduce.sum_(grads + [scalars])
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
        metrics["grad_norm"] = global_norm(
            p.grad for p in state.optimizer.params if p.grad is not None)
    state.apply_gradients()
    if ema_decay > 0.0:
        _ema_update(ema_decay, state)
    metrics["global_step"] = state.global_step
    return metrics


def _one_update(loss_fn: LossFn, needs_rng: bool, ema_decay: float,
                log_grad_norm: bool, reduce: GradientAllReduce | None):
    """Per-batch gradient (mean across ranks) and optimizer update, shared
    by the plain and scanned builders."""
    scale = 1.0 / reduce.world_size if reduce is not None else 1.0

    def update(state: TrainState, batch: Any):
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        if needs_rng:
            loss, aux = loss_fn(model, batch, state.rng)
        else:
            loss, aux = loss_fn(model, batch)
        loss.backward()
        if reduce is not None:
            loss, aux = _reduce_step(state, loss, aux, reduce, scale)
        return state, _finish(state, loss, aux, ema_decay, log_grad_norm)

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
    world = all_reduce.world_size if all_reduce is not None else 1
    scale = 1.0 / (accum_steps * world)

    def step(state: TrainState, batches: Any):
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        loss_sum = None
        aux_sum: dict = {}
        for i in range(accum_steps):
            batch = _index(batches, i)
            if needs_rng:
                loss, aux = loss_fn(model, batch, state.rng)
            else:
                loss, aux = loss_fn(model, batch)
            loss.backward()
            loss = loss.detach()
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in aux.items():
                v = v.detach() if torch.is_tensor(v) else v
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        loss, aux = _reduce_step(state, loss_sum, aux_sum, all_reduce,
                                 scale)
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
    if isinstance(batch, dict):
        return {k: v[i] for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(v[i] for v in batch)
    return batch[i]


def _split(batch: Any, n: int, i: int) -> Any:
    """Shard ``i`` of ``n`` equal shards along the batch dim."""
    def take(a):
        rows = a.shape[0]
        if rows % n:
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n} replicas")
        k = rows // n
        return a[i * k:(i + 1) * k]
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
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        loss_sum = None
        aux_sum: dict = {}
        for j in range(local):
            w = float(mask[rank * local + j])
            loss, aux = loss_fn(model, _split(batch, local, j))
            (loss * w).backward()
            loss = loss.detach() * w
            loss_sum = loss if loss_sum is None else loss_sum + loss
            for k, v in aux.items():
                v = v.detach() * w if torch.is_tensor(v) else v
                aux_sum[k] = v if k not in aux_sum else aux_sum[k] + v
        live = max(float(mask.sum()), 1.0)
        loss, aux = _reduce_step(state, loss_sum, aux_sum, all_reduce,
                                 1.0 / live)
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
    for name, p in state.model.named_parameters():
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
