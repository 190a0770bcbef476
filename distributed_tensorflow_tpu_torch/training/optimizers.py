"""Optimizers and learning-rate schedules, with optax's semantics.

Counterpart of ``distributed_tensorflow_tpu/training/optimizers.py``.
:func:`make_optimizer` returns an :class:`OptimizerSpec`, the port's
``optax.GradientTransformation``: ``spec.init(params)`` builds the
:class:`Optimizer` over a module's parameters, as ``tx.init(params)``
builds an optax state.  The update is composed in the JAX order
(outermost first): global-norm gradient clip, then coupled weight decay
(L2: ``g + wd * p``, for every optimizer without built-in decay), then
the base rule at the scheduled rate.  ``sgd``, ``momentum``,
``nesterov``, ``adam`` and ``adamw`` are ``torch.optim``'s rules with
optax's constants (Adam b1 0.9, b2 0.999, eps 1e-8); ``adamw``'s
decoupled decay is ``p - lr (u + wd p)``, which ``torch.optim.AdamW``'s
``p (1 - lr wd) - lr u`` equals.  ``lamb``, ``adagrad``, ``rmsprop`` and
``adafactor`` are optax's rules written out (:class:`_OptaxRule`), with
optax's constants: lamb b1 0.9, b2 0.999, eps 1e-6 and the trust ratio
over the decayed update; adagrad's accumulator from 0.1, eps 1e-7;
rmsprop's decay 0.9 and eps 1e-8 inside the root, then the momentum
trace; adafactor's factored second moments (``v_row``/``v_col`` for a
leaf whose two largest dims reach 128, else a full ``v``), decay rate
0.8, update clipped to an RMS of 1, scaled by the parameter's RMS (at
least 1e-3), eps 1e-30.  Schedules count optimizer steps from 0, as
optax's state does.

A rule whose update reads a whole leaf (lamb's trust ratio, adafactor's
row and column means and RMS scalings) takes a split parameter whole:
the tensor-parallel shards of one parameter (``parallel/sharding.py``
marks them ``tp_split``) and a worker's FSDP slice (``fsdp_info``) are
pieces of one leaf, and the rule sees the sums over every piece (for
FSDP, over the workers too).  Slots shaped like their parameter are
split as it is; adafactor's factored slots are held whole by every
piece (replicated, as JAX places a slot that its parameter's spec cannot
partition).

:func:`freeze_except` (``--trainable_params``) trains only the parameters
whose flax path matches a pattern: the frozen ones get no update and no
slots, and the checkpoint layout is optax's ``multi_transform`` state.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Iterable

import numpy as np
import torch

OPTIMIZERS = ("sgd", "momentum", "nesterov", "adam", "adamw", "lamb",
              "adagrad", "rmsprop", "adafactor")
SCHEDULES = ("constant", "cosine", "linear", "rsqrt")

Schedule = Callable[[int], float]

# Optimizers whose update rule includes decoupled weight decay; for the
# rest, a nonzero weight_decay is L2 regularization chained in front.
_BUILTIN_DECAY = ("adamw", "lamb", "adafactor")
# The rules written out here (optax's), beside torch.optim's.
_OPTAX_RULES = ("lamb", "adagrad", "rmsprop", "adafactor")


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda step: init

    def rate(step: int) -> float:
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end
    return rate


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax ``join_schedules``: the second schedule sees the step shifted
    by the boundary."""
    return lambda step: first(step) if step < boundary else \
        second(step - boundary)


def constant_schedule(learning_rate: float) -> Schedule:
    """A fixed rate.  Tagged ``constant``: optax keeps no state for a
    float rate where a schedule keeps a step count, and the checkpoint
    layout (:meth:`Optimizer.optax_state`) follows which it is."""
    def rate(step: int) -> float:
        return learning_rate
    rate.constant = True
    return rate


def make_schedule(name: str, learning_rate: float, *,
                  warmup_steps: int = 0, decay_steps: int = 0,
                  end_lr_factor: float = 0.0) -> Schedule:
    """A learning-rate schedule as a function of the optimizer step
    (0-based).  ``decay_steps`` is the total horizon; the decaying part
    spans ``decay_steps - warmup_steps``; ``end_lr_factor`` sets the final
    rate as a fraction of the peak.  ``constant`` ignores everything but
    the warmup (a linear ramp to the fixed rate)."""
    if name not in SCHEDULES:
        raise ValueError(f"Unknown lr schedule {name!r}; one of {SCHEDULES}")
    if warmup_steps < 0:
        raise ValueError(f"warmup_steps must be >= 0, got {warmup_steps}")
    if name != "constant":
        if decay_steps <= 0:
            raise ValueError(f"lr schedule {name!r} needs decay_steps > 0 "
                             f"(got {decay_steps}); pass the training horizon")
        if warmup_steps >= decay_steps:
            raise ValueError(f"warmup_steps={warmup_steps} must be in "
                             f"[0, decay_steps={decay_steps})")
    end_value = learning_rate * end_lr_factor
    ramp = _linear(0.0, learning_rate, warmup_steps)

    if name == "constant":
        return ramp if warmup_steps else constant_schedule(learning_rate)
    if name == "cosine":
        # optax warmup_cosine_decay_schedule: cosine from the peak to
        # end_value over decay_steps - warmup_steps, after the ramp.
        span = decay_steps - warmup_steps
        alpha = end_value / learning_rate if learning_rate else 0.0

        def cosine(step: int) -> float:
            frac = min(step, span) / span
            return learning_rate * ((1 - alpha) * 0.5
                                    * (1 + math.cos(math.pi * frac)) + alpha)
        return _join(ramp, cosine, warmup_steps) if warmup_steps else cosine
    if name == "linear":
        decay = _linear(learning_rate, end_value, decay_steps - warmup_steps)
        return _join(ramp, decay, warmup_steps) if warmup_steps else decay

    # rsqrt: linear warmup, then lr * sqrt(warmup / global_step).
    base = max(warmup_steps, 1)

    def rsqrt(step_after_warmup: int) -> float:
        return learning_rate * math.sqrt(
            base / max(step_after_warmup + base, base))
    return _join(ramp, rsqrt, warmup_steps) if warmup_steps else rsqrt


def global_norm(params: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm of the parameters' gradients (``.grad``; a parameter
    without one counts zero), in fp32 (a 0-dim tensor on the first
    gradient's device).  A parameter split over the model axis is its
    shards, each counted once.  A worker's FSDP slice (marked
    ``fsdp_info`` by ``parallel/sharding.fsdp_state``) is one piece of a
    gradient whose other pieces the other positions hold (this worker's
    other data rows' slices are among ``params``): the slices' squares
    are summed over the process group, the replicated
    gradients' added once, so every worker clips and logs the one global
    norm.  That sum is a collective, which every worker reaches at the
    same point of its step.  A pipeline across processes holds each pipe
    rank's own stages (their parameters marked ``pipe_mesh`` by
    ``models/registry.py``): the squares are summed over the pipe group
    as well, a collective too."""
    own, split, workers, pipe_mesh = [], [], 1, None
    for p in params:
        pipe_mesh = getattr(p, "pipe_mesh", pipe_mesh)
        if p.grad is not None:
            sq = p.grad.detach().float().pow(2).sum()
            info = getattr(p, "fsdp_info", None)
            (split if info is not None else own).append(sq)
            if info is not None:
                workers = info.workers
    home = (own or split)[0].device
    total = torch.zeros((), dtype=torch.float32, device=home)
    if split:
        import torch.distributed as dist
        pieces = torch.stack([x.to(split[0].device) for x in split]).sum()
        if workers > 1:
            dist.all_reduce(pieces)
        total = total + pieces.to(home)
    if own:
        total = total + torch.stack([x.to(home) for x in own]).sum()
    if pipe_mesh is not None:
        import torch.distributed as dist
        from ..parallel.mesh import PIPE_AXIS
        from ..parallel.transport import link
        dist.all_reduce(total, group=link(pipe_mesh, PIPE_AXIS).group)
    return total.sqrt()


class Optimizer:
    """A base rule over ``params`` (``base``: a ``torch.optim`` optimizer,
    or :class:`_OptaxRule` for optax's own rules) behind optax's chain:
    :meth:`step` reads each parameter's ``.grad``, clips by global norm,
    sets the scheduled rate and applies the base rule (which adds coupled
    decay to the gradient where it applies).  Updates the parameters IN
    PLACE, where optax returns new ones.  It updates every tensor of
    ``params`` (:meth:`OptimizerSpec.init` leaves the frozen ones out)."""

    def __init__(self, spec: "OptimizerSpec", params):
        self.spec = spec
        self.params = list(params)
        self.count = 0
        lr0 = spec.schedule(0)
        wd = spec.weight_decay
        if spec.name in ("sgd", "momentum", "nesterov"):
            momentum = 0.0 if spec.name == "sgd" else spec.momentum
            self.base = torch.optim.SGD(
                self.params, lr=lr0, momentum=momentum,
                nesterov=spec.name == "nesterov", weight_decay=wd)
        elif spec.name == "adam":
            self.base = torch.optim.Adam(self.params, lr=lr0,
                                         betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=wd)
        elif spec.name == "adamw":
            self.base = torch.optim.AdamW(self.params, lr=lr0,
                                          betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=wd)
        else:
            self.base = _OptaxRule(spec, self.params, lr0)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            # optax updates every leaf; a parameter the loss did not reach
            # has a zero gradient, not none (its moments still decay).
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip = self.spec.grad_clip_norm
        if clip > 0.0:
            norm = global_norm(self.params)
            # optax clip_by_global_norm: g / norm * max_norm when the norm
            # reaches the limit, untouched below it.
            below = norm < clip
            for p in self.params:
                n = norm.to(p.grad.device, p.grad.dtype)
                p.grad.copy_(torch.where(below.to(p.grad.device), p.grad,
                                         p.grad / n * clip))
        lr = self.spec.schedule(self.count)
        for group in self.base.param_groups:
            group["lr"] = lr
        if isinstance(self.base, _OptaxRule):
            self.base.count = self.count
        self.base.step()
        self.count += 1

    # -- optax's checkpoint layout ----------------------------------------

    def optax_state(self, names: dict, to_tree: Callable[[dict], dict]):
        """The slots in the layout optax gives the JAX package's
        ``make_optimizer(...)`` state, so each package restores the other's
        checkpoints: ``names`` maps each parameter to its ``state_dict``
        name, ``to_tree`` turns a ``{name: tensor}`` dict into the model's
        flax tree.  ``sgd`` is ``[identity, lr]``, ``momentum`` /
        ``nesterov`` ``[{trace}, lr]``, ``adam`` ``[{count, mu, nu}, lr]``,
        ``adamw`` ``[{count, mu, nu}, decay, lr]``, ``lamb`` ``[{count,
        mu, nu}, decay, trust, lr]``, ``adagrad`` ``[{sum_of_squares},
        lr]``, ``rmsprop`` ``[{nu}, lr, {trace}]``, ``adafactor``
        ``[{count, v_row, v_col, v}, clip, lr, rms, (decay,) sign]``, where
        ``lr`` is None for a fixed rate and ``{count}`` for a schedule (the
        other entries are stateless: None); a clip and a
        coupled decay chain in front as Nones (their optax states are
        empty).  A frozen spec (:func:`freeze_except`) wraps that in
        ``multi_transform``'s ``{inner_states: {freeze: {inner_state:
        None}, train: {inner_state: ...}}}``, each slot tree None at the
        frozen leaves (optax's ``MaskedNode``)."""
        spec = self.spec

        def slot(key: str) -> dict:
            out = {}
            # A frozen spec's slot trees span every parameter (``names``),
            # the frozen ones masked to None below.
            for p in (names if spec.trainable is not None else self.params):
                v = self.base.state.get(p, {}).get(key)
                out[names[p]] = torch.zeros_like(p) if v is None else v
            tree = to_tree(out)
            for path in self._placeholders(key, names, to_tree):
                # A stacked leaf's placeholder is optax's one [1].
                _set_leaf(tree, path, np.zeros((1,), np.float32))
            if spec.trainable is not None:
                tree = _mask_tree(tree, spec.trainable)
            return tree

        count = np.asarray(self.count, np.int32)
        lr = (None if getattr(spec.schedule, "constant", False)
              else {"count": count})
        if spec.name == "sgd":
            base = [None, lr]
        elif spec.name in ("momentum", "nesterov"):
            base = [{"trace": slot("momentum_buffer")}, lr]
        elif spec.name in _OPTAX_RULES:
            base = _rule_layout(spec, lr, {k: count if k == "count"
                                           else slot(k)
                                           for k in _RULE_SLOTS[spec.name]})
        else:
            adam = {"count": count, "mu": slot("exp_avg"),
                    "nu": slot("exp_avg_sq")}
            base = [adam, None, lr] if spec.name == "adamw" else [adam, lr]
        chain = _chain_prefix(spec)
        state = chain + [base] if chain else base
        if spec.trainable is not None:
            state = {"inner_states": {"freeze": {"inner_state": None},
                                      "train": {"inner_state": state}}}
        return state

    def _placeholders(self, key: str, names: dict, to_tree) -> dict:
        """``{flax path: the leaf's shape in the tree}`` of adafactor's
        ``[1]`` placeholders for slot ``key`` (``v_row`` and ``v_col`` of
        an unfactored leaf, ``v`` of a factored one).  optax keeps one
        ``[1]`` a leaf; where the tree stacks several parameters into a
        leaf (the pipelined GPT's layers) ``to_tree`` stacks their
        placeholders, to ``[n_pipe, per, 1]``."""
        if self.spec.name != "adafactor" or key == "count":
            return {}
        from ..utils.pytree import tree_paths
        from .state import param_paths
        held = {names[p] for leaf in self.base.leaves for p in leaf.pieces
                if (_factored_dims(leaf.shape) is None) == (key != "v")}
        if not held:
            return {}
        paths = param_paths(names.values(), to_tree)
        shapes = {path: np.shape(leaf) for path, leaf in tree_paths(to_tree(
            {n: torch.zeros(1) for n in names.values()}))}
        return {paths[n]: shapes[paths[n]] for n in held
                if n in paths and shapes[paths[n]] != (1,)}

    def _unstack_placeholders(self, key: str, tree, names: dict, to_tree):
        """``tree`` (a checkpoint's slot tree) with each of optax's ``[1]``
        placeholders broadcast to the shape ``to_tree`` stacks it to
        (inverse of :meth:`optax_state`'s collapse)."""
        if to_tree is None:
            return tree
        for path, shape in self._placeholders(key, names, to_tree).items():
            leaf = _get_leaf(tree, path)
            if leaf is not None and tuple(np.shape(leaf)) != tuple(shape):
                _set_leaf(tree, path, np.broadcast_to(
                    np.asarray(leaf, np.float32).reshape(-1)[:1]
                    .reshape((1,) * len(shape)), shape).copy())
        return tree

    def load_optax_state(self, opt_state, names: dict,
                         from_tree: Callable[[dict], dict],
                         to_tree: Callable[[dict], dict] | None = None
                         ) -> None:
        """Inverse of :meth:`optax_state` (a checkpoint of either package;
        ``to_tree``, the model's, places adafactor's placeholders in a
        stacked tree).  Raises ``ValueError`` when ``opt_state`` is not
        this optimizer's layout (another ``--optimizer``, schedule, clip,
        decay or ``--trainable_params``)."""
        spec = self.spec
        if spec.trainable is not None:
            # The frozen leaves' Nones are dropped before the slot trees
            # reach ``from_tree``.
            raw_from_tree = from_tree

            def from_tree(tree):
                return raw_from_tree(_drop_none(tree))
        try:
            if spec.trainable is not None:
                inner = opt_state["inner_states"]
                if inner["freeze"]["inner_state"] is not None:
                    raise ValueError("freeze")
                opt_state = inner["train"]["inner_state"]
            chain = _chain_prefix(spec)
            if chain:
                if len(opt_state) != len(chain) + 1 or any(
                        x is not None for x in opt_state[:-1]):
                    raise ValueError("chain")
                opt_state = opt_state[-1]
            count = None
            if spec.name in _OPTAX_RULES:
                lr, state = _read_rule_layout(spec, opt_state)
                slots = {k: from_tree(self._unstack_placeholders(
                    k, state[k], names, to_tree))
                         for k in _RULE_SLOTS[spec.name] if k != "count"}
                if "count" in state:
                    count = int(state["count"])
            else:
                if len(opt_state) != (3 if spec.name == "adamw" else 2):
                    raise ValueError("length")
                lr, state = opt_state[-1], opt_state[0]
                if spec.name == "sgd":
                    if state is not None:
                        raise ValueError("sgd")
                    slots = {}
                elif spec.name in ("momentum", "nesterov"):
                    slots = {"momentum_buffer": from_tree(state["trace"])}
                else:
                    slots = {"exp_avg": from_tree(state["mu"]),
                             "exp_avg_sq": from_tree(state["nu"])}
                    count = int(state["count"])
            if (lr is None) != getattr(spec.schedule, "constant", False):
                raise ValueError("schedule")
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"checkpoint opt_state is not the layout of "
                             f"optimizer {spec.name!r} ({e})") from None
        for key, tree in slots.items():
            missing = {names[p] for p in self.params} - set(tree)
            if missing:
                raise ValueError(f"checkpoint opt_state lacks {sorted(missing)}")
        for p in self.params:
            st = {}
            for key, tree in slots.items():
                st[key] = tree[names[p]].to(p.device, p.dtype).clone()
            if "exp_avg" in slots:
                st["step"] = torch.tensor(float(count), dtype=torch.float32)
            self.base.state[p] = st
        if lr is not None:
            self.count = int(lr["count"])
        elif count is not None:
            self.count = count


# ------------------------------------------------------ optax's own rules

#: Each written-out rule's slots under optax's names (``count``: the
#: rule's update count, a scalar of its state).
_RULE_SLOTS = {"lamb": ("count", "mu", "nu"),
               "adagrad": ("sum_of_squares",),
               "rmsprop": ("nu", "trace"),
               "adafactor": ("count", "v_row", "v_col", "v")}


def _rule_layout(spec: "OptimizerSpec", lr, state: dict) -> list:
    """The optax chain state of a written-out rule (``state``: its slot
    trees and count by :data:`_RULE_SLOTS` name; ``lr``: None or
    ``{count}``)."""
    if spec.name == "lamb":
        return [state, None, None, lr]
    if spec.name == "adagrad":
        return [state, lr]
    if spec.name == "rmsprop":
        return [{"nu": state["nu"]}, lr, {"trace": state["trace"]}]
    decay = [None] if spec.weight_decay > 0.0 else []
    return [state, None, lr, None, *decay, None]


def _read_rule_layout(spec: "OptimizerSpec", opt_state) -> tuple:
    """Inverse of :func:`_rule_layout`: ``(lr, {name: slot tree or
    count})``; raises ``ValueError`` on another layout."""
    if spec.name == "rmsprop":
        if len(opt_state) != 3 or set(opt_state[0]) != {"nu"}:
            raise ValueError("length")
        return opt_state[1], {"nu": opt_state[0]["nu"],
                              "trace": opt_state[2]["trace"]}
    want = len(_rule_layout(spec, None, {}))
    lr_at = {"lamb": 3, "adagrad": 1, "adafactor": 2}[spec.name]
    if len(opt_state) != want or any(
            x is not None for i, x in enumerate(opt_state)
            if i not in (0, lr_at)):
        raise ValueError("length")
    state = opt_state[0]
    if set(state) != set(_RULE_SLOTS[spec.name]):
        raise ValueError(f"slots {sorted(state)}")
    return opt_state[lr_at], state


def _factored_dims(shape: tuple) -> tuple | None:
    """optax ``_factored_dims`` at ``min_dim_size_to_factor=128``: the
    two largest dims ``(d1, d0)`` (``np.argsort``'s order, ties
    included) when the second largest reaches 128, else None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _f32(x: float) -> float:
    """``x`` rounded to fp32 (optax's constants are fp32 scalars)."""
    return float(np.float32(x))


class _Leaf:
    """One parameter as the JAX tree holds it: its tensor-parallel shards
    (``pieces``, in model-coordinate order, split along ``dim``; one
    piece when it is not split), each of them this worker's FSDP slice
    when ``fsdp`` (the slices' ``FsdpInfo``) is set; or, under FSDP over
    several local data positions (``dim`` None, ``local``), the
    positions' slices in row order (``fsdp`` row 0's)."""

    def __init__(self, pieces: list, dim: int | None, fsdp,
                 local: bool = False):
        self.pieces = pieces
        self.dim = dim
        self.fsdp = fsdp
        self.local = local

    @property
    def shape(self) -> tuple:
        shape = list(self.fsdp.shape if self.fsdp is not None
                     else self.pieces[0].shape)
        if len(self.pieces) > 1 and not self.local:
            shape[self.dim] *= len(self.pieces)
        return tuple(shape)

    def whole(self, ts: list) -> torch.Tensor:
        """The whole tensor of per-piece tensors ``ts`` (with FSDP over
        several workers a collective)."""
        from ..parallel.sharding import fsdp_whole
        if self.local:
            return fsdp_whole(ts, self.fsdp)
        if self.fsdp is not None:
            ts = [fsdp_whole(t, self.fsdp) for t in ts]
        if len(ts) == 1:
            return ts[0]
        home = ts[0].device
        return torch.cat([t.to(home) for t in ts], dim=self.dim)

    def part(self, whole: torch.Tensor, i: int) -> torch.Tensor:
        """Piece ``i``'s part of ``whole`` (inverse of :meth:`whole`)."""
        if self.local:
            x = whole.chunk(self.fsdp.world,
                            dim=self.fsdp.dim)[self.fsdp.rank + i]
            return x.to(self.pieces[i].device)
        x = (whole.chunk(len(self.pieces), dim=self.dim)[i]
             if len(self.pieces) > 1 else whole)
        if self.fsdp is not None:
            x = x.chunk(self.fsdp.world, dim=self.fsdp.dim)[self.fsdp.rank]
        return x.to(self.pieces[i].device)

    def sum(self, values: list) -> torch.Tensor:
        """The sum of per-piece 0-dim ``values`` over the whole leaf (with
        FSDP over several workers an all-reduce over them)."""
        total = _total(values)
        if self.fsdp is not None and self.fsdp.workers > 1:
            import torch.distributed as dist
            dist.all_reduce(total)
        return total


def _leaves(params: list) -> list:
    """``params`` grouped into :class:`_Leaf` s: the shards of one split
    parameter (``tp_split``: ``(key, index, count, dim)``) form one
    leaf, and so do the local data positions' FSDP slices of one
    parameter (``fsdp_local``: ``(key, row)``)."""
    out, groups = [], {}
    for p in params:
        fsdp = getattr(p, "fsdp_info", None)
        split = getattr(p, "tp_split", None)
        local = getattr(p, "fsdp_local", None)
        if local is not None:
            key, r = local
            if key not in groups:
                groups[key] = _Leaf([None] * fsdp.local, None, None, True)
                out.append(groups[key])
            groups[key].pieces[r] = p
            if r == 0:
                groups[key].fsdp = fsdp
            continue
        if split is None:
            out.append(_Leaf([p], None, fsdp))
            continue
        key, j, n, dim = split
        if key not in groups:
            groups[key] = _Leaf([None] * n, dim, fsdp)
            out.append(groups[key])
        groups[key].pieces[j] = p
    return out


class _OptaxRule:
    """optax's ``lamb``, ``adagrad``, ``rmsprop(momentum=...)`` or
    ``adafactor(min_dim_size_to_factor=128)`` over ``params``, in
    ``torch.optim``'s shape: ``state[p]`` holds ``p``'s slots under
    optax's names (initialised as optax's ``init`` does), ``param_groups``
    the rate, ``step()`` updates in place from ``.grad`` (clipped by
    :class:`Optimizer`).  ``count`` is the number of updates before this
    one (optax's state count), set by :class:`Optimizer`."""

    def __init__(self, spec: "OptimizerSpec", params: list, lr: float):
        self.spec = spec
        self.param_groups = [{"lr": lr, "params": params}]
        self.leaves = _leaves(params)
        # The leaves one JAX leaf stacks (``stack_group``: the pipelined
        # GPT's layers) share the whole-leaf statistics.
        stacks = {}
        for leaf in self.leaves:
            key = getattr(leaf.pieces[0], "stack_group", None)
            stacks.setdefault(id(leaf) if key is None else key,
                              []).append(leaf)
        self.groups = list(stacks.values())
        self.count = 0
        self.state = {}
        for leaf in self.leaves:
            for p in leaf.pieces:
                self.state[p] = self._init_slots(leaf, p)

    def _init_slots(self, leaf: _Leaf, p: torch.Tensor) -> dict:
        name = self.spec.name
        if name == "lamb":
            return {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
        if name == "adagrad":
            return {"sum_of_squares": torch.full_like(p, 0.1)}
        if name == "rmsprop":
            return {"nu": torch.zeros_like(p), "trace": torch.zeros_like(p)}
        one = p.new_zeros((1,))
        dims = _factored_dims(leaf.shape)
        if dims is None:
            return {"v_row": one, "v_col": one.clone(),
                    "v": torch.zeros_like(p)}
        shape = list(leaf.shape)
        d1, d0 = dims
        return {"v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:]),
                "v": one}

    @torch.no_grad()
    def step(self) -> None:
        lr = self.param_groups[0]["lr"]
        wd = self.spec.weight_decay
        update = getattr(self, "_" + self.spec.name)
        for group in self.groups:
            grads = []
            for leaf in group:
                g = [p.grad for p in leaf.pieces]
                if wd > 0.0 and self.spec.name not in _BUILTIN_DECAY:
                    # optax add_decayed_weights ahead of the rule (coupled).
                    g = [x + wd * p for x, p in zip(g, leaf.pieces)]
                grads.append(g)
            update(group, grads, lr)

    def _lamb(self, group: list, grads: list, lr: float) -> None:
        # scale_by_adam(b1, b2, eps=1e-6) -> add_decayed_weights(wd) ->
        # scale_by_trust_ratio() -> scale_by_learning_rate(lr).
        b1, b2, eps = 0.9, 0.999, 1e-6
        t = self.count + 1
        c1 = _f32(1.0 - np.float32(b1) ** np.float32(t))
        c2 = _f32(1.0 - np.float32(b2) ** np.float32(t))
        updates, p_sq, u_sq = [], [], []
        for leaf, leaf_grads in zip(group, grads):
            us = []
            for p, g in zip(leaf.pieces, leaf_grads):
                st = self.state[p]
                st["mu"] = (1 - b1) * g + b1 * st["mu"]
                st["nu"] = (1 - b2) * (g * g) + b2 * st["nu"]
                u = (st["mu"] / c1) / (torch.sqrt(st["nu"] / c2) + eps)
                us.append(u + self.spec.weight_decay * p)
            updates.append(us)
            p_sq.append(leaf.sum([p.pow(2).sum() for p in leaf.pieces]))
            u_sq.append(leaf.sum([u.pow(2).sum() for u in us]))
        p_norm, u_norm = _total(p_sq).sqrt(), _total(u_sq).sqrt()
        trust = torch.where((p_norm == 0) | (u_norm == 0),
                            torch.ones_like(p_norm), p_norm / u_norm)
        for leaf, us in zip(group, updates):
            for p, u in zip(leaf.pieces, us):
                p.add_(u * trust.to(u.device) * -lr)

    def _adagrad(self, group: list, grads: list, lr: float) -> None:
        # scale_by_rss(initial_accumulator_value=0.1, eps=1e-7) ->
        # scale_by_learning_rate(lr).
        for leaf, leaf_grads in zip(group, grads):
            for p, g in zip(leaf.pieces, leaf_grads):
                st = self.state[p]
                s = g * g + st["sum_of_squares"]
                st["sum_of_squares"] = s
                inv = torch.where(s > 0, torch.rsqrt(s + 1e-7),
                                  torch.zeros_like(s))
                p.add_(inv * g * -lr)

    def _rmsprop(self, group: list, grads: list, lr: float) -> None:
        # scale_by_rms(decay=0.9, eps=1e-8, eps_in_sqrt) ->
        # scale_by_learning_rate(lr) -> trace(momentum).
        decay, m = 0.9, self.spec.momentum
        for leaf, leaf_grads in zip(group, grads):
            for p, g in zip(leaf.pieces, leaf_grads):
                st = self.state[p]
                st["nu"] = (1 - decay) * (g * g) + decay * st["nu"]
                u = torch.rsqrt(st["nu"] + 1e-8) * g * -lr
                st["trace"] = u + m * st["trace"]
                p.add_(st["trace"])

    def _adafactor(self, group: list, grads: list, lr: float) -> None:
        # scale_by_factored_rms(decay_rate=0.8, eps=1e-30) ->
        # clip_by_block_rms(1.0) -> scale_by_learning_rate(lr, flip_sign=
        # False) -> scale_by_param_block_rms(1e-3) ->
        # [add_decayed_weights(wd)] -> scale(-1), the block RMS over the
        # whole leaf (a stack's every layer).  optax's decay_rate_t =
        # 1 - t ** -0.8 and 1 - decay_rate_t, each rounded to fp32.
        t = torch.tensor(self.count + 1, dtype=torch.float32)
        keep = _f32(1.0 - float(t ** -0.8))
        new = _f32(1.0 - keep)
        scaled, u_sq, p_sq, n = [], [], [], 0
        for leaf, leaf_grads in zip(group, grads):
            pieces = leaf.pieces
            states = [self.state[p] for p in pieces]
            g = leaf.whole(leaf_grads)
            p = leaf.whole([x.detach() for x in pieces])
            g2 = g * g + 1e-30
            dims = _factored_dims(leaf.shape)
            if dims is not None:
                d1, d0 = dims
                v_row = keep * states[0]["v_row"] + new * g2.mean(dim=d0)
                v_col = keep * states[0]["v_col"] + new * g2.mean(dim=d1)
                mean = v_row.mean(dim=d1 - 1 if d1 > d0 else d1,
                                  keepdim=True)
                u = (g * ((v_row / mean) ** -0.5).unsqueeze(d0)
                     * (v_col ** -0.5).unsqueeze(d1))
                for x, st in zip(pieces, states):
                    st["v_row"] = v_row.to(x.device)
                    st["v_col"] = v_col.to(x.device)
            else:
                v = keep * leaf.whole([st["v"] for st in states]) + new * g2
                u = g * v ** -0.5
                for i, st in enumerate(states):
                    st["v"] = leaf.part(v, i)
            scaled.append((leaf, u, p))
            u_sq.append((u * u).sum())
            p_sq.append((p * p).sum())
            n += u.numel()
        clip = torch.clamp(torch.sqrt(_total(u_sq) / n), min=1.0)
        rms = torch.sqrt(_total(p_sq) / n)
        rms = torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
        for leaf, u, p in scaled:
            u = u / clip.to(u.device)
            u = u * lr
            u = u * rms.to(u.device)
            if self.spec.weight_decay > 0.0:
                u = u + self.spec.weight_decay * p
            u = -u
            for i, x in enumerate(leaf.pieces):
                x.add_(leaf.part(u, i))


def _get_leaf(tree, path: str):
    node = tree
    for key in path.split("/"):
        if node is None:
            return None
        node = node[int(key) if isinstance(node, list) else key]
    return node


def _set_leaf(tree, path: str, value) -> None:
    *parents, last = path.split("/")
    node = tree
    for key in parents:
        node = node[int(key) if isinstance(node, list) else key]
    node[int(last) if isinstance(node, list) else last] = value


def _total(values: list) -> torch.Tensor:
    """The sum of 0-dim tensors (on the first one's device)."""
    return torch.stack([v.to(values[0].device) for v in values]).sum()


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` built, before it has parameters."""

    name: str
    schedule: Schedule
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    #: Flax paths (``a/b``) of the trainable parameters when
    #: :func:`freeze_except` froze the rest; None trains every parameter.
    trainable: frozenset | None = None

    def init(self, params) -> Optimizer:
        """The optimizer over the parameters of ``params`` that require a
        gradient (a frozen one gets no update and no slots)."""
        return Optimizer(self, [p for p in params if p.requires_grad])


def freeze_except(tx: OptimizerSpec, params: dict, pattern: str
                  ) -> tuple[OptimizerSpec, int, int]:
    """Selective fine-tuning (``--trainable_params``): only parameters
    whose flax path (``hid/kernel``, as the JAX package's ``path_str``)
    matches ``pattern`` train.  ``params`` is the flax-named tree
    (:func:`..training.state.checkpoint_tree`'s ``params``).  Returns
    ``(frozen_spec, n_trainable, n_total)``; :func:`..training.state.
    apply_freeze` turns a state's frozen parameters off and re-inits its
    optimizer from the spec, so frozen parameters get no update and no
    slots (optax's ``set_to_zero`` partition)."""
    from ..utils.pytree import tree_paths

    pat = re.compile(pattern)
    paths = tree_paths(params)
    n_total = sum(int(np.size(leaf)) for _, leaf in paths)
    trainable = frozenset(p for p, _ in paths if pat.search(p))
    n_train = sum(int(np.size(leaf)) for p, leaf in paths if p in trainable)
    if n_train == 0:
        raise ValueError(
            f"--trainable_params pattern {pattern!r} matches no parameters; "
            "nothing would train")
    return dataclasses.replace(tx, trainable=trainable), n_train, n_total


def _mask_tree(tree, trainable: frozenset, prefix: str = ""):
    """``tree`` with every leaf whose path is not in ``trainable`` set to
    None."""
    if isinstance(tree, dict):
        return {k: _mask_tree(v, trainable, f"{prefix}{k}/")
                for k, v in tree.items()}
    return tree if prefix[:-1] in trainable else None


def _drop_none(tree):
    """A slot tree without its None (masked) leaves."""
    if isinstance(tree, dict):
        out = {k: _drop_none(v) for k, v in tree.items() if v is not None}
        return {k: v for k, v in out.items()
                if not (isinstance(v, dict) and not v)}
    return tree


def make_optimizer(name: str, learning_rate, *, momentum: float = 0.9,
                   weight_decay: float = 0.0,
                   grad_clip_norm: float = 0.0) -> OptimizerSpec:
    """An optimizer by name; ``learning_rate`` is a float or a schedule
    from :func:`make_schedule`."""
    if name not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer {name!r}; one of {OPTIMIZERS}")
    schedule = (learning_rate if callable(learning_rate)
                else constant_schedule(float(learning_rate)))
    return OptimizerSpec(name=name, schedule=schedule, momentum=momentum,
                         weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm)


def _chain_prefix(spec: OptimizerSpec) -> list:
    """The optax states chained in front of the base rule (the JAX
    ``make_optimizer``'s clip and coupled decay; both are empty)."""
    chain = []
    if spec.grad_clip_norm > 0.0:
        chain.append(None)
    if spec.weight_decay > 0.0 and spec.name not in _BUILTIN_DECAY:
        chain.append(None)
    return chain


def _flag_schedule(FLAGS) -> Schedule:
    """The schedule the ``--optimizer`` override uses (the JAX package's
    one resolution of the flag surface)."""
    decay_steps = getattr(FLAGS, "decay_steps", 0) or FLAGS.train_steps
    return make_schedule(getattr(FLAGS, "lr_schedule", "constant"),
                         FLAGS.learning_rate,
                         warmup_steps=getattr(FLAGS, "warmup_steps", 0),
                         decay_steps=decay_steps,
                         end_lr_factor=getattr(FLAGS, "end_lr_factor", 0.0))


def schedule_from_flags(FLAGS) -> Schedule | None:
    """The ``--optimizer`` override's learning-rate schedule, or None when
    no override is active (each model's own optimizer then sets its
    rate).  The loop logs it beside the loss."""
    if not (getattr(FLAGS, "optimizer", "") or ""):
        return None
    return _flag_schedule(FLAGS)


def from_flags(FLAGS, *, default=None) -> OptimizerSpec | None:
    """Optimizer from the CLI surface; ``default`` (None: the model's own)
    when ``--optimizer`` is empty.  Any explicit name takes full control:
    the schedule horizon defaults to ``--train_steps``."""
    name = getattr(FLAGS, "optimizer", "") or ""
    if not name:
        ignored = [flag for flag, active in (
            ("grad_clip_norm", getattr(FLAGS, "grad_clip_norm", 0.0) > 0),
            ("weight_decay", getattr(FLAGS, "weight_decay", 0.0) > 0),
            ("warmup_steps", getattr(FLAGS, "warmup_steps", 0) > 0),
            ("lr_schedule",
             getattr(FLAGS, "lr_schedule", "constant") != "constant"),
        ) if active]
        if ignored:
            print("WARNING: " + ", ".join(f"--{f}" for f in ignored)
                  + " ignored without --optimizer (the model's own optimizer "
                  "is in effect); set --optimizer to apply them")
        return default
    return make_optimizer(name, _flag_schedule(FLAGS),
                          momentum=getattr(FLAGS, "momentum", 0.9),
                          weight_decay=getattr(FLAGS, "weight_decay", 0.0),
                          grad_clip_norm=getattr(FLAGS, "grad_clip_norm", 0.0))
