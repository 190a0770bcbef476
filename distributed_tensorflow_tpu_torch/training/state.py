"""Training state: the model (parameters), its optimizer and the global
step.

Counterpart of ``distributed_tensorflow_tpu/training/state.py``.  The JAX
``TrainState`` is an immutable pytree that each step replaces; here the
model and the optimizer's slots are updated IN PLACE and
:meth:`TrainState.apply_gradients` returns the same object.

:func:`checkpoint_tree` and :func:`load_checkpoint_tree` convert a state to
and from the tree the JAX supervisor checkpoints (``{params, opt_state,
global_step[, ema_params][, model_state]}`` with flax's names and optax's
slot layout), so each package restores the other's checkpoints.
A state with several local data rows (``TrainState.rows``) checkpoints
its lead row: every row holds the same parameters (each FSDP slice its
own, gathered whole).  ``model_state`` is a model's non-trainable state: ResNet-20's BatchNorm
running statistics (its buffers), flax's ``batch_stats`` tree in the
checkpoint (the JAX supervisor's ``model_state`` entry).  A tensor-parallel
state (``parallel/sharding.shard_state``) holds its split parameters as
shards, an FSDP state (``parallel/sharding.fsdp_state``) its worker's
slices; its checkpoint tree gathers them into whole arrays (for FSDP a
collective: every worker builds the tree at the same step,
:func:`tree_is_collective`) and loading splits them again, so its
checkpoint is an unsharded run's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

import torch
from torch import nn

from .optimizers import Optimizer, OptimizerSpec


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    # The reference initialises global_step to 1 (distributed.py:65).
    global_step: int = 1
    # Training-time generator (dropout); None for deterministic models.
    rng: torch.Generator | None = None
    # Exponential moving average of the parameters (None = disabled),
    # updated by ema-aware train steps after each optimizer step.
    ema_params: dict[str, torch.Tensor] | None = None
    # Non-trainable model state, ``{buffer name: tensor}`` (the tensors
    # themselves: BatchNorm's running statistics, updated in place by a
    # training-mode forward); None for stateless models.
    model_state: dict[str, torch.Tensor] | None = None
    # ``state_dict`` <-> the JAX package's parameter tree (the model's
    # ``params_to_jax`` / ``params_from_jax``); the default splits and
    # joins the names at their dots.
    params_to_tree: Callable[[dict], dict] = None
    params_from_tree: Callable[[dict], dict] = None
    # The worker's other local data rows (``parallel/sharding.py``): each
    # its own copy of the model on its positions, ``model`` being row 0;
    # ``row_devices`` each row's first device, ``row_slices`` the rows by
    # DCN slice (``parallel/mesh.Mesh.row_slices``).  None with one row.
    rows: list | None = None
    row_devices: list | None = None
    row_slices: list | None = None

    def __post_init__(self):
        if self.params_to_tree is None:
            self.params_to_tree = nested_tree
        if self.params_from_tree is None:
            self.params_from_tree = flat_names

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec, *,
               rng: torch.Generator | None = None,
               ema: bool = False, params_to_tree=None,
               params_from_tree=None,
               model_state: dict | None = None) -> "TrainState":
        """``ema=True`` starts the moving average at a copy of the
        parameters, as the trainer does in JAX.  ``model_state``: the
        model's non-trainable tensors (``{buffer name: tensor}``)."""
        ema_params = ({n: p.detach().clone()
                       for n, p in model.named_parameters()} if ema else None)
        return cls(model=model, optimizer=tx.init(model.parameters()),
                   rng=rng, ema_params=ema_params,
                   model_state=model_state,
                   params_to_tree=params_to_tree,
                   params_from_tree=params_from_tree)

    def apply_gradients(self) -> "TrainState":
        """One optimizer step from the parameters' ``.grad``."""
        self.optimizer.step()
        self.global_step += 1
        return self



def nested_tree(state_dict: dict) -> dict:
    """``{"a.b": t}`` -> ``{"a": {"b": t}}`` (fp32 numpy leaves)."""
    tree: dict = {}
    for name, t in state_dict.items():
        *parents, leaf = name.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().to("cpu", torch.float32).numpy()
    return tree


def flat_names(tree: dict, prefix: str = "") -> dict:
    """Inverse of :func:`nested_tree` (fp32 CPU tensor leaves)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flat_names(value, name + "."))
        else:
            t = (value.detach() if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.array(value, np.float32)))
            out[name] = t.to("cpu", torch.float32)
    return out


def _param_names(state: TrainState) -> dict:
    from ..parallel.sharding import state_params
    return {p: n for n, p in state_params(state).items()}


def _tree_fns(state: TrainState):
    """``(to_tree, from_tree)`` between ``{name: tensor}`` dicts of the
    model's own parameter names and the JAX package's tree: a parameter
    split over the model axis (``parallel/sharding.py``) is gathered into
    one whole array on the way out and split again on the way in, so a
    sharded run's checkpoint is an unsharded run's."""
    from ..parallel.sharding import (FsdpExchange, gather_named, is_fsdp,
                                     is_sharded, row_models,
                                     split_fsdp_named, split_named)
    model = state.model
    fsdp = is_fsdp(model)
    if _pipe_ranks(model) is not None:
        return _pipe_tree_fns(state)
    if not (fsdp or is_sharded(model)):
        return state.params_to_tree, state.params_from_tree
    exchange = FsdpExchange(row_models(state)) if fsdp else None

    def to_tree(named):
        if exchange is not None:
            named = exchange.gather_named(named)
        return state.params_to_tree(gather_named(model, named))

    def from_tree(tree):
        return split_fsdp_named(model, split_named(
            model, state.params_from_tree(tree)))
    return to_tree, from_tree


def _pipe_ranks(model):
    """The pipe axis's mesh of a pipelined model whose stages are split
    over processes (``models/gpt.PipelinedGptLM.pipe_mesh``), else
    None."""
    return getattr(model, "pipe_mesh", None)


def _pipe_tree_fns(state: TrainState):
    """``(to_tree, from_tree)`` of a pipeline across processes: every
    pipe rank's ``{name: tensor}`` joined over the pipe group (a
    collective: every rank builds the tree at the same step) into the
    whole model's, and a tree cut to this rank's own entries."""
    import torch.distributed as dist
    from ..parallel.mesh import PIPE_AXIS
    from ..parallel.transport import link
    group = link(_pipe_ranks(state.model), PIPE_AXIS)

    def to_tree(named):
        mine = {n: t.detach().to("cpu", torch.float32)
                for n, t in named.items()}
        parts = [None] * group.size
        dist.all_gather_object(parts, mine, group=group.group)
        whole = {}
        for part in parts:
            whole.update(part)
        return state.params_to_tree(whole)

    return to_tree, state.params_from_tree


def tree_is_collective(state) -> bool:
    """True when building ``state``'s checkpoint tree is a collective (its
    parameters split over the workers by FSDP, or its pipeline's stages
    over the pipe ranks): every worker then builds it at the same save
    step, and the chief writes it."""
    from ..parallel.sharding import is_fsdp
    return isinstance(state, TrainState) and (
        is_fsdp(state.model) or _pipe_ranks(state.model) is not None)


def param_paths(names, to_tree: Callable[[dict], dict]) -> dict:
    """``{state_dict name: flax path}`` (``a/b``, the JAX package's
    ``path_str``) for the parameter ``names`` under a model's ``to_tree``,
    found by converting one marker value a name.  A tree that stacks
    several parameters into one leaf (the pipelined GPT's ``stages``,
    a chunk's layers) maps each of them to that leaf's path."""
    from ..utils.pytree import tree_paths
    names = list(names)
    marked = to_tree({n: torch.tensor(float(i)) for i, n in enumerate(names)})
    # (NaN: an entry another process holds, the pipeline's ranks.)
    return {names[int(i)]: path for path, leaf in tree_paths(marked)
            for i in np.asarray(leaf).reshape(-1) if i == i}


def mark_stacked_leaves(model: nn.Module, to_tree: Callable[[dict], dict]
                        ) -> None:
    """Mark the parameters that one leaf of ``model``'s JAX tree stacks
    (the pipelined GPT's layers: ``stages`` [n_pipe, per, ...]) with a
    shared ``stack_group``, so the optimizer rules that read a whole leaf
    (lamb's trust ratio, adafactor's block RMS) take it over the stack,
    as optax does over the stacked array."""
    named = dict(model.named_parameters())
    by_path: dict = {}
    for name, path in param_paths(named, to_tree).items():
        by_path.setdefault(path, []).append(named[name])
    for params in by_path.values():
        if len(params) > 1:
            key = object()
            for p in params:
                p.stack_group = key


def apply_freeze(state: TrainState, spec: OptimizerSpec) -> TrainState:
    """Freeze the parameters a :func:`..training.optimizers.freeze_except`
    spec does not train (``requires_grad`` off) and re-init the optimizer
    from the spec, so the frozen ones carry no slots (the JAX trainer
    re-inits ``opt_state`` from the wrapped transformation)."""
    named = dict(state.model.named_parameters())
    paths = param_paths(named, state.params_to_tree)
    for name, p in named.items():
        p.requires_grad_(paths[name] in spec.trainable)
    state.optimizer = spec.init(state.model.parameters())
    return state


def checkpoint_tree(state: TrainState) -> dict:
    """The tree the JAX supervisor saves for this state (``_pure_tree``):
    parameters, optimizer slots in optax's layout, the global step as an
    int32 scalar, the moving average when there is one and the model
    state (flax's ``batch_stats``) when there is one.  An async
    state (:class:`..parallel.async_replicas.AsyncTrainState`) gives its
    own, with per-replica stacks."""
    if not isinstance(state, TrainState):
        return state.checkpoint_tree()
    from ..parallel.sharding import state_params
    to_tree, _ = _tree_fns(state)
    params = {n: p.detach() for n, p in state_params(state).items()}
    tree = {"params": to_tree(params),
            "opt_state": state.optimizer.optax_state(_param_names(state),
                                                     to_tree),
            "global_step": np.asarray(state.global_step, np.int32)}
    if state.ema_params is not None:
        tree["ema_params"] = to_tree(state.ema_params)
    if state.model_state is not None:
        tree["model_state"] = nested_tree(state.model_state)
    return tree


def load_checkpoint_tree(state: TrainState, tree: dict) -> TrainState:
    """Load a checkpoint tree (of either package) into ``state`` in place.

    Raises ``ValueError`` when the tree does not fit the state (other
    parameter names or shapes, another optimizer layout): a configuration
    problem, which eval mode turns into flag advice.  The moving average
    follows the JAX supervisor: a checkpoint without one re-seeds an
    EMA-enabled state from the restored weights, and one with it restores
    into an EMA-disabled state by dropping it.  The model state is
    restored where the tree has it (the JAX supervisor's rule); one that
    does not fit raises ``ValueError``."""
    if not isinstance(state, TrainState):
        return state.load_checkpoint_tree(tree)
    from ..parallel.sharding import copy_rows, state_params
    to_tree, from_tree = _tree_fns(state)
    try:
        params = from_tree(tree["params"])
        with torch.no_grad():
            own = state_params(state)
            if set(params) != set(own):
                raise ValueError(
                    f"parameters {sorted(set(params) ^ set(own))} differ")
            for name, p in own.items():
                if tuple(params[name].shape) != tuple(p.shape):
                    raise ValueError(f"{name} of shape "
                                     f"{tuple(params[name].shape)}, expected "
                                     f"{tuple(p.shape)}")
                p.copy_(params[name].to(p.device))
        global_step = int(tree["global_step"])
    except KeyError as e:
        raise ValueError(f"checkpoint tree lacks {e}") from None
    state.optimizer.count = global_step - 1
    state.optimizer.load_optax_state(tree.get("opt_state"),
                                     _param_names(state), from_tree, to_tree)
    state.global_step = global_step
    if state.ema_params is not None:
        saved = tree.get("ema_params")
        ema = (from_tree(saved) if saved is not None
               else {n: p.detach() for n, p in own.items()})
        for name, e in state.ema_params.items():
            e.copy_(ema[name].to(e.device))
    if state.model_state is not None and "model_state" in tree:
        saved = flat_names(tree["model_state"])
        if set(saved) != set(state.model_state):
            raise ValueError(f"model state "
                             f"{sorted(set(saved) ^ set(state.model_state))}"
                             " differs")
        with torch.no_grad():
            for name, t in state.model_state.items():
                if tuple(saved[name].shape) != tuple(t.shape):
                    raise ValueError(f"model state {name} of shape "
                                     f"{tuple(saved[name].shape)}, expected "
                                     f"{tuple(t.shape)}")
                t.copy_(saved[name].to(t.device))
    copy_rows(state)
    return state
