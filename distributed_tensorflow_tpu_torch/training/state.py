"""Training state: the model (parameters), its optimizer and the global
step.

Counterpart of ``distributed_tensorflow_tpu/training/state.py``.  The JAX
``TrainState`` is an immutable pytree that each step replaces; here the
model and the optimizer's slots are updated IN PLACE and
:meth:`TrainState.apply_gradients` returns the same object.

:func:`checkpoint_tree` and :func:`load_checkpoint_tree` convert a state to
and from the tree the JAX supervisor checkpoints (``{params, opt_state,
global_step[, ema_params]}`` with flax's names and optax's slot layout),
so each package restores the other's checkpoints.
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
    # ``state_dict`` <-> the JAX package's parameter tree (the model's
    # ``params_to_jax`` / ``params_from_jax``); the default splits and
    # joins the names at their dots.
    params_to_tree: Callable[[dict], dict] = None
    params_from_tree: Callable[[dict], dict] = None

    def __post_init__(self):
        if self.params_to_tree is None:
            self.params_to_tree = nested_tree
        if self.params_from_tree is None:
            self.params_from_tree = flat_names

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec, *,
               rng: torch.Generator | None = None,
               ema: bool = False, params_to_tree=None,
               params_from_tree=None) -> "TrainState":
        """``ema=True`` starts the moving average at a copy of the
        parameters, as the trainer does in JAX."""
        ema_params = ({n: p.detach().clone()
                       for n, p in model.named_parameters()} if ema else None)
        return cls(model=model, optimizer=tx.init(model.parameters()),
                   rng=rng, ema_params=ema_params,
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
    return {p: n for n, p in state.model.named_parameters()}


def param_paths(names, to_tree: Callable[[dict], dict]) -> dict:
    """``{state_dict name: flax path}`` (``a/b``, the JAX package's
    ``path_str``) for the parameter ``names`` under a model's ``to_tree``,
    found by converting one marker value a name."""
    from ..utils.pytree import tree_paths
    names = list(names)
    marked = to_tree({n: torch.tensor(float(i)) for i, n in enumerate(names)})
    return {names[int(np.asarray(leaf))]: path
            for path, leaf in tree_paths(marked)}


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
    int32 scalar, and the moving average when there is one.  An async
    state (:class:`..parallel.async_replicas.AsyncTrainState`) gives its
    own, with per-replica stacks."""
    if not isinstance(state, TrainState):
        return state.checkpoint_tree()
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    tree = {"params": state.params_to_tree(params),
            "opt_state": state.optimizer.optax_state(_param_names(state),
                                                     state.params_to_tree),
            "global_step": np.asarray(state.global_step, np.int32)}
    if state.ema_params is not None:
        tree["ema_params"] = state.params_to_tree(state.ema_params)
    return tree


def load_checkpoint_tree(state: TrainState, tree: dict) -> TrainState:
    """Load a checkpoint tree (of either package) into ``state`` in place.

    Raises ``ValueError`` when the tree does not fit the state (other
    parameter names or shapes, another optimizer layout): a configuration
    problem, which eval mode turns into flag advice.  The moving average
    follows the JAX supervisor: a checkpoint without one re-seeds an
    EMA-enabled state from the restored weights, and one with it restores
    into an EMA-disabled state by dropping it."""
    if not isinstance(state, TrainState):
        return state.load_checkpoint_tree(tree)
    try:
        params = state.params_from_tree(tree["params"])
        with torch.no_grad():
            own = dict(state.model.named_parameters())
            if set(params) != set(own):
                raise ValueError(
                    f"parameters {sorted(set(params) ^ set(own))} differ")
            for name, p in own.items():
                if tuple(params[name].shape) != tuple(p.shape):
                    raise ValueError(f"{name} of shape "
                                     f"{tuple(params[name].shape)}, expected "
                                     f"{tuple(p.shape)}")
                p.copy_(params[name])
        global_step = int(tree["global_step"])
    except KeyError as e:
        raise ValueError(f"checkpoint tree lacks {e}") from None
    state.optimizer.count = global_step - 1
    state.optimizer.load_optax_state(tree.get("opt_state"),
                                     _param_names(state),
                                     state.params_from_tree)
    state.global_step = global_step
    if state.ema_params is not None:
        saved = tree.get("ema_params")
        ema = (state.params_from_tree(saved) if saved is not None
               else {n: p.detach() for n, p in own.items()})
        for name, e in state.ema_params.items():
            e.copy_(ema[name])
    return state
