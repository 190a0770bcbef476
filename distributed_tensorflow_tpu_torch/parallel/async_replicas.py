"""Asynchronous replica mode: local-SGD replicas with a periodic merge.

Counterpart of ``distributed_tensorflow_tpu/parallel/async_replicas.py``,
the re-design of the reference's Hogwild PS updates (``opt.minimize``
without the sync wrapper, reference ``distributed.py:102``; SURVEY N4):

- each of the R local replicas holds its **own parameter copy**: the
  parameters are stacked ``[k, ...]`` on each device that holds k of
  them (:attr:`AsyncTrainState.stacks`), and a replica owns its views
  into its device's stack;
- each replica's optimizer (its own slots, updated in place, so memory is
  R times one copy) applies that replica's gradient to its views only.
  The local step calls **no collective** and reduces nothing across
  replicas;
- every ``sync_period`` calls (a host counter, as in JAX) the merge sets
  every copy to the mean (staleness bound = ``sync_period`` steps);
- ``global_step`` grows by R a local step: every replica applied an
  update, as each worker's apply bumped the PS counter.

Where JAX maps the step over the ``data`` mesh axis (``shard_map``), the
replicas here are a Python loop: the hand-written kernels are
``torch.autograd.Function``s without a vmap rule, so each replica runs
:func:`torch.func.functional_call` of the model on its views.  Replica
``r`` takes rows ``[r B/R, (r+1) B/R)`` of the batch, as the ``data``
axis shards it.

**R = the worker's local data positions.**  The trainer builds one
replica a local data position (``--device=cuda`` with several cards;
the CPU as ``DTF_TORCH_CPU_DEVICES`` positions), each on its position's
device
(``make_async_state(..., devices=)``): the replicas on one device are
stacked there, and a device holds a template copy of the model of its
own.  The workers average across processes through
:mod:`..cluster.param_sync`, as in JAX (its async workers never join a
global mesh: ``tests/test_multihost_jax.py::test_two_process_async_mode``).
At R = 1 the merge is skipped (a copy's mean is itself), so the loop
costs nothing on the device.  The CPU tests use R = 4 and 8, JAX's CPU
mesh.

Per-replica metrics stay stacked ``[R]`` on the device inside
:class:`HostMeanScalar`; ``float()`` averages them on the host, so only
the steps that log read the device.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

from ..training.optimizers import Optimizer
from ..training.state import TrainState, param_paths
from .sync import RowBatches, _index, _place, _split

LossFn = Callable[..., tuple[torch.Tensor, dict]]


class HostMeanScalar:
    """Lazy host-side mean of a per-replica stacked ``[R]`` metric."""

    def __init__(self, stacked: torch.Tensor):
        self._stacked = stacked

    @property
    def stacked(self) -> torch.Tensor:
        """The raw per-replica values (an ``[R]`` device tensor)."""
        return self._stacked

    def __float__(self) -> float:
        vals = self._stacked.detach().to("cpu", torch.float32).numpy()
        return float(vals.mean())

    def __format__(self, spec: str) -> str:
        return format(float(self), spec)

    def __repr__(self) -> str:
        return f"HostMeanScalar({float(self)})"


class _LossCall(nn.Module):
    """``loss_fn(model, batch)`` as a module call, so
    :func:`torch.func.functional_call` can run it on a replica's
    parameters."""

    def __init__(self, model: nn.Module, loss_fn: LossFn):
        super().__init__()
        self.model = model
        self._loss_fn = loss_fn

    def forward(self, batch):
        return self._loss_fn(self.model, batch)


@dataclasses.dataclass
class AsyncTrainState:
    """R replicas' parameters, one stack ``[k, ...]`` a device holding
    that device's k replicas (``stacks``, in replica order; ``params`` is
    the first), one optimizer a replica over its views.  ``models`` are
    the templates the replicas run (:func:`torch.func.functional_call`),
    one a device (``model`` is the first); a template's own parameters
    are its device's first replica's views (no copy of their own), and
    an evaluation runs ``model`` on the consensus through
    :func:`consensus_model`."""

    model: nn.Module
    params: dict            # state_dict name -> [k, ...] stacked tensor
    optimizers: list        # replica r's Optimizer over its views
    global_step: int        # total updates applied (R a local step)
    params_to_tree: Callable[[dict], dict] = None
    params_from_tree: Callable[[dict], dict] = None
    stacks: list = None     # one stack a device (default [params])
    models: list = None     # one template a device (default [model])

    @property
    def num_replicas(self) -> int:
        return len(self._views)

    def views(self, r: int) -> dict:
        """Replica ``r``'s parameters: views into the stacked tensors (the
        tensors its optimizer updates)."""
        return self._views[r]

    def replica_model(self, r: int) -> nn.Module:
        """The template replica ``r`` runs (the one of its device)."""
        return self._models[r]

    def __post_init__(self):
        self.stacks = self.stacks or [self.params]
        self.models = self.models or [self.model]
        self._views, self._models = [], []
        for stack, model in zip(self.stacks, self.models):
            k = next(iter(stack.values())).shape[0]
            self._views += [{n: t[r] for n, t in stack.items()}
                            for r in range(k)]
            self._models += [model] * k
        self._paths: dict | None = None
        self._host_bufs: dict = {}  # name -> the consensus's host buffer

    def paths(self) -> dict:
        """``{name: flax path}`` of the parameters."""
        if self._paths is None:
            self._paths = param_paths(self.params, self.params_to_tree)
        return self._paths

    # -- the JAX supervisor's tree, per-replica stacks --------------------

    def checkpoint_tree(self) -> dict:
        """``{params, opt_state, global_step}`` with every parameter and
        slot leaf stacked ``[R, ...]``, as the JAX supervisor saves an
        ``AsyncTrainState`` (``_stack`` broadcast every leaf, the slot
        counts too)."""
        from ..utils.pytree import tree_map
        params, slots = [], []
        for r, opt in enumerate(self.optimizers):
            views = self.views(r)
            params.append(self.params_to_tree(views))
            names = {v: n for n, v in views.items()}
            slots.append(opt.optax_state(names, self.params_to_tree))
        stack = (lambda *xs: np.stack([np.asarray(
            x.detach().cpu() if torch.is_tensor(x) else x) for x in xs]))
        return {"params": tree_map(stack, *params),
                "opt_state": tree_map(stack, *slots),
                "global_step": np.asarray(self.global_step, np.int32)}

    def load_checkpoint_tree(self, tree: dict) -> "AsyncTrainState":
        """Inverse of :meth:`checkpoint_tree` (either package's async
        checkpoint with the same R).  ``ValueError`` on another layout."""
        from ..utils.pytree import tree_map
        try:
            params_tree, opt_tree = tree["params"], tree.get("opt_state")
            global_step = int(tree["global_step"])
        except KeyError as e:
            raise ValueError(f"checkpoint tree lacks {e}") from None
        R = self.num_replicas
        for r, opt in enumerate(self.optimizers):
            pick = (lambda x, r=r: _replica(x, r, R))
            try:
                named = self.params_from_tree(tree_map(pick, params_tree))
            except (IndexError, TypeError) as e:
                raise ValueError(f"checkpoint params are not {R}-replica "
                                 f"stacks ({e})") from None
            views = self.views(r)
            if set(named) != set(views):
                raise ValueError(
                    f"parameters {sorted(set(named) ^ set(views))} differ")
            with torch.no_grad():
                for n, v in views.items():
                    if tuple(named[n].shape) != tuple(v.shape):
                        raise ValueError(
                            f"{n} of shape {tuple(named[n].shape)}, expected "
                            f"{tuple(v.shape)} (a checkpoint of another "
                            f"replica count or of the sync mode)")
                    v.copy_(named[n])
            opt.count = global_step - 1
            opt.load_optax_state(
                tree_map(pick, opt_tree) if opt_tree is not None else None,
                {v: n for n, v in views.items()}, self.params_from_tree,
                self.params_to_tree)
        self.global_step = global_step
        return self


def _replica(x, r: int, R: int):
    """Replica ``r``'s slice of a stacked ``[R, ...]`` leaf."""
    if np.ndim(x) == 0 or np.shape(x)[0] != R:
        raise IndexError(f"leaf of shape {tuple(np.shape(x))}")
    return x[r]


def make_async_state(state: TrainState, num_replicas: int,
                     devices=None) -> AsyncTrainState:
    """Convert a :class:`TrainState` into R stacked replicas of it: every
    replica starts at the state's parameters and optimizer slots (JAX's
    ``_make_async_state``).  ``devices`` (one a replica; default the
    parameters' device): the replicas on one device are stacked there,
    in the parameters' dtype, and every further device gets a copy of the
    model as its template.  Frozen parameters (``requires_grad`` off) get
    no optimizer slots.  A template's parameters become its first
    replica's views, so a device holds its replicas' copies of the
    parameters and no more."""
    if num_replicas < 1:
        raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    model = state.model
    named = dict(model.named_parameters())
    home = next(iter(named.values())).device
    devices = [torch.device(d) for d in (devices or [home] * num_replicas)]
    if len(devices) != num_replicas:
        raise ValueError(f"{len(devices)} devices for {num_replicas} "
                         "replicas")
    order = list(dict.fromkeys(devices))
    if [d for d in order for _ in range(devices.count(d))] != devices:
        raise ValueError("the replicas of one device must be consecutive")
    models = [model] + [_template_on(model, d) for d in order[1:]]
    stacks = []
    with torch.no_grad():
        for d in order:
            k = devices.count(d)
            stacks.append({n: p.detach().to(d).unsqueeze(0).repeat(
                (k,) + (1,) * p.dim()) for n, p in named.items()})
    trainable = [n for n, p in named.items() if p.requires_grad]
    src = state.optimizer
    astate = AsyncTrainState(
        model=model, params=stacks[0], optimizers=[],
        global_step=state.global_step, params_to_tree=state.params_to_tree,
        params_from_tree=state.params_from_tree, stacks=stacks,
        models=models)
    for r in range(num_replicas):
        views = [astate.views(r)[n] for n in trainable]
        opt = Optimizer(src.spec, views)
        opt.count = src.count
        for n, v in zip(trainable, views):
            slots = src.base.state.get(named[n])
            if slots:
                opt.base.state[v] = {k: (t.to(v.device).clone()
                                         if torch.is_tensor(t) and t.dim()
                                         else t.clone() if torch.is_tensor(t)
                                         else t) for k, t in slots.items()}
        astate.optimizers.append(opt)
    for template, stack in zip(models, stacks):
        for n, p in template.named_parameters():
            p.data = stack[n][0]
    return astate


def _template_on(model: nn.Module, device: torch.device) -> nn.Module:
    """A copy of ``model`` on ``device`` (its inputs' device too)."""
    copied = copy.deepcopy(model).to(device)
    if isinstance(getattr(copied, "device", None), torch.device):
        copied.device = device
    return copied


def _local_update(loss_fn: LossFn):
    """One collective-free update of every replica: replica ``r``'s
    gradient of its batch shard, applied to its own copy only."""

    def update(astate: AsyncTrainState, batch: Any):
        R = astate.num_replicas
        calls = {}
        losses, auxes = [], []
        for r in range(R):
            model = astate.replica_model(r)
            if id(model) not in calls:
                model.train()
                calls[id(model)] = _LossCall(model, loss_fn)
            call = calls[id(model)]
            views = astate.views(r)
            opt = astate.optimizers[r]
            train = {id(v) for v in opt.params}
            # Detached aliases of the views, marked for autograd: the
            # forward reads the replica's storage, the gradients land on
            # the aliases and the optimizer updates the views in place.
            inputs = {}
            leaves = []
            for n, v in views.items():
                if id(v) in train:
                    a = v.detach().requires_grad_(True)
                    leaves.append((v, a))
                else:
                    a = v
                inputs[f"model.{n}"] = a
            part = (batch[r] if isinstance(batch, RowBatches) else
                    _place(_split(batch, R, r), views[next(iter(views))]
                           .device))
            loss, aux = torch.func.functional_call(call, inputs, (part,))
            grads = torch.autograd.grad(loss, [a for _, a in leaves],
                                        allow_unused=True)
            for (v, a), g in zip(leaves, grads):
                v.grad = torch.zeros_like(v) if g is None else g
            opt.step()
            for v, _ in leaves:
                v.grad = None
            losses.append(loss.detach())
            auxes.append({k: (x.detach() if torch.is_tensor(x) else x)
                          for k, x in aux.items()})
        astate.global_step += R
        home = losses[0].device
        metrics = {"loss": torch.stack([x.to(home) for x in losses])}
        for k in auxes[0]:
            if torch.is_tensor(auxes[0][k]):
                metrics[k] = torch.stack([a[k].to(home) for a in auxes])
        return astate, metrics

    return update


def merge_params(astate: AsyncTrainState) -> dict:
    """Consensus parameters (the mean over every replica, summed in
    float32 a stack at a time on the first replica's device, returned in
    each leaf's dtype): for eval and checkpointing.  One replica's copy
    is its own mean (a view, no device work)."""
    if astate.num_replicas == 1:
        return {n: t[0] for n, t in astate.params.items()}
    out = {}
    for n, t in astate.params.items():
        total = t.float().sum(dim=0)
        for stack in astate.stacks[1:]:
            total.add_(stack[n].float().sum(dim=0).to(t.device))
        out[n] = total.div_(astate.num_replicas).to(t.dtype)
    return out


@contextlib.contextmanager
def consensus_model(astate: AsyncTrainState):
    """The template model with the consensus in its parameters, for the
    enclosed code (an evaluation).  At R = 1 its parameters are the
    replica's, so nothing moves; at R > 1 they point at the mean for the
    duration, then back at replica 0's views."""
    if astate.num_replicas == 1:
        yield astate.model
        return
    own = dict(astate.model.named_parameters())
    merged = merge_params(astate)
    for n, p in own.items():
        p.data = merged[n]
    try:
        yield astate.model
    finally:
        for n, p in own.items():
            p.data = astate.params[n][0]


def build_merge_step():
    """``merge(astate) -> astate``: every replica's copy replaced by the
    cross-replica mean, in place (one reduction a leaf on the device).
    Optimizer slots stay local (local-SGD convention)."""

    @torch.no_grad()
    def merge(astate: AsyncTrainState) -> AsyncTrainState:
        if astate.num_replicas == 1:
            return astate
        for n, mean in merge_params(astate).items():
            for stack in astate.stacks:
                t = stack[n]
                t.copy_(mean.to(t.device).unsqueeze(0).expand_as(t))
        return astate

    return merge


def host_tree(astate: AsyncTrainState, named: dict | None = None) -> dict:
    """The consensus (or ``named``) as the flax-named host tree the
    cross-process exchange publishes (:mod:`..cluster.param_sync`): each
    leaf in its own dtype, bf16 as :class:`..cluster.param_sync.BF16`
    words, in the JAX package's leaf order.

    The consensus is copied, on the calling thread, into host buffers the
    state keeps (pinned when the replicas are on a card): the tree's
    leaves view them, and the next call overwrites them (the trainer takes
    a snapshot only once the exchange of the last one is over).  On the
    CPU too the tree is a copy, never a view of the parameters the
    optimizers go on updating.  No exchange thread touches a device
    tensor."""
    from ..cluster.param_sync import _host
    if named is None:
        named = {n: _host_copy(astate, n, t)
                 for n, t in merge_params(astate).items()}
    tree: dict = {}
    for n, path in astate.paths().items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = _host(named[n])
    return tree


def _host_copy(astate: AsyncTrainState, name: str,
               t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into the state's host buffer for ``name``, pinned when
    ``t`` is on a card."""
    buf = astate._host_bufs.get(name)
    if buf is None:
        buf = astate._host_bufs[name] = torch.empty(
            t.shape, dtype=t.dtype, pin_memory=t.device.type == "cuda")
    buf.copy_(t)
    return buf


def _named(astate: AsyncTrainState, tree: dict) -> dict:
    """``{name: host tensor}`` from a flax-named host tree, each leaf in
    its own dtype (bf16 words as a bf16 tensor: a copy to the device
    moves 2 bytes a value)."""
    from ..cluster.param_sync import _to_f32, is_bf16
    out = {}
    for n, path in astate.paths().items():
        node = tree
        for key in path.split("/"):
            node = node[key]
        if is_bf16(node):
            words = np.ascontiguousarray(node).view(np.int16)
            out[n] = torch.from_numpy(words).view(torch.bfloat16)
        else:
            out[n] = torch.from_numpy(np.ascontiguousarray(_to_f32(node)))
    return out


@torch.no_grad()
def adopt_consensus(astate: AsyncTrainState, avg_tree: dict
                    ) -> AsyncTrainState:
    """Replace every replica's copy with a host-side consensus tree (the
    device half of the cross-process exchange): broadcast across the
    stacked axis in the stacked dtype, IN PLACE (a ``copy_`` into the
    stacked tensors: no second stacked tree is allocated)."""
    for n, a in _named(astate, avg_tree).items():
        for stack in astate.stacks:
            t = stack[n]
            t.copy_(a.to(t.device, t.dtype).unsqueeze(0).expand_as(t))
    return astate


@torch.no_grad()
def adopt_consensus_delta(astate: AsyncTrainState, avg_tree: dict,
                          snap_tree: dict) -> AsyncTrainState:
    """Apply a one-period-stale consensus as a DELTA, ``params += avg -
    snapshot`` per replica (the :class:`..cluster.param_sync.
    OverlappedAverager` contract: local steps taken while the exchange ran
    are kept).  The delta is computed on the host in float32 at merged
    size and added in the stacked dtype, in place: no float32 copy of the
    stacked tree on the device."""
    avg, snap = _named(astate, avg_tree), _named(astate, snap_tree)
    for n in astate.params:
        d = avg[n].float() - snap[n].float()
        for stack in astate.stacks:
            t = stack[n]
            t.add_(d.to(t.dtype).to(t.device).unsqueeze(0))
    return astate


def build_async_local_step(loss_fn: LossFn):
    """The collective-free local step (``step(astate, batch) -> (astate,
    metrics)`` with raw stacked ``[R]`` metric tensors)."""
    return _local_update(loss_fn)


def _wrap_metrics(astate: AsyncTrainState, raw: dict) -> dict:
    metrics = {k: HostMeanScalar(v) for k, v in raw.items()}
    metrics["global_step"] = astate.global_step
    return metrics


def build_async_train_step(loss_fn: LossFn, state: TrainState, *,
                           num_replicas: int, sync_period: int = 16,
                           devices=None):
    """Convert a TrainState into R async replicas and build their step.

    Returns ``(step_fn, async_state)`` with ``step_fn(astate, batch) ->
    (astate, metrics)``: the collective-free local step every call and the
    merge only on every ``sync_period``-th call (a host counter:
    restarting the loop restarts the merge phase).  ``metrics["loss"]``
    and the aux metrics are :class:`HostMeanScalar`;
    ``metrics["global_step"]`` is the state's int.  ``devices``: each
    replica's (:func:`make_async_state`)."""
    if sync_period < 1:
        raise ValueError(f"sync_period must be >= 1, got {sync_period}")
    astate = make_async_state(state, num_replicas, devices)
    local_step = build_async_local_step(loss_fn)
    merge = build_merge_step()
    calls = {"n": 0}

    def step(astate: AsyncTrainState, batch):
        astate, raw = local_step(astate, batch)
        calls["n"] += 1
        if calls["n"] % sync_period == 0:
            astate = merge(astate)
        return astate, _wrap_metrics(astate, raw)

    return step, astate


def build_scanned_async_train_step(loss_fn: LossFn, state: TrainState, *,
                                   num_replicas: int, sync_period: int = 16,
                                   merge: bool = True, devices=None):
    """One call = ``sync_period`` local steps + one merge (JAX runs them
    as one ``lax.scan`` dispatch; here a loop).  ``step_fn(astate,
    batches)`` consumes a ``[sync_period, ...]``-stacked batch
    (:func:`.sync.stack_microbatches`); the metrics are the last
    microstep's.  ``merge=False`` drops the merge too: the replicas
    diverge until the caller merges (:func:`build_merge_step`).
    ``devices``: each replica's (:func:`make_async_state`)."""
    if sync_period < 1:
        raise ValueError(f"sync_period must be >= 1, got {sync_period}")
    astate = make_async_state(state, num_replicas, devices)
    local_step = build_async_local_step(loss_fn)
    merge_step = build_merge_step()

    def step(astate: AsyncTrainState, batches):
        raw = None
        for i in range(sync_period):
            astate, raw = local_step(astate, _index(batches, i))
        if merge:
            astate = merge_step(astate)
        return astate, _wrap_metrics(astate, raw)

    return step, astate
