"""Optimizers and learning-rate schedules, with optax's semantics.

Counterpart of ``distributed_tensorflow_tpu/training/optimizers.py``.
:func:`make_optimizer` returns an :class:`OptimizerSpec`, the port's
``optax.GradientTransformation``: ``spec.init(params)`` builds the
:class:`Optimizer` over a module's parameters, as ``tx.init(params)``
builds an optax state.  The update is composed in the JAX order
(outermost first): global-norm gradient clip, then coupled weight decay
(L2: ``g + wd * p``, for every optimizer without built-in decay), then
the base rule at the scheduled rate.  The base rules are ``torch.optim``'s
with optax's constants (Adam b1 0.9, b2 0.999, eps 1e-8); ``adamw``'s
decoupled decay is ``p - lr (u + wd p)``, which ``torch.optim.AdamW``'s
``p (1 - lr wd) - lr u`` equals.  Schedules count optimizer steps from 0,
as optax's state does.

:func:`freeze_except` (``--trainable_params``) trains only the parameters
whose flax path matches a pattern: the frozen ones get no update and no
slots, and the checkpoint layout is optax's ``multi_transform`` state.

``lamb``, ``adagrad``, ``rmsprop`` and ``adafactor`` raise: their optax
constants differ from ``torch.optim``'s and need their own parity work
(ROADMAP.md, section 1, item 7a).
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
PORTED = ("sgd", "momentum", "nesterov", "adam", "adamw")
SCHEDULES = ("constant", "cosine", "linear", "rsqrt")

Schedule = Callable[[int], float]


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
    ``fsdp_split`` by ``parallel/sharding.fsdp_state``) is one piece of a
    gradient whose other pieces the other workers hold: the slices'
    squares are summed over the process group, the replicated
    gradients' added once, so every worker clips and logs the one global
    norm.  That sum is a collective, which every worker reaches at the
    same point of its step."""
    own, split = [], []
    for p in params:
        if p.grad is not None:
            sq = p.grad.detach().float().pow(2).sum()
            (split if getattr(p, "fsdp_split", False) else own).append(sq)
    home = (own or split)[0].device
    total = torch.zeros((), dtype=torch.float32, device=home)
    if split:
        import torch.distributed as dist
        pieces = torch.stack([x.to(split[0].device) for x in split]).sum()
        dist.all_reduce(pieces)
        total = total + pieces.to(home)
    if own:
        total = total + torch.stack([x.to(home) for x in own]).sum()
    return total.sqrt()


class Optimizer:
    """A ``torch.optim`` optimizer over ``params`` behind optax's chain:
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
        else:
            self.base = torch.optim.AdamW(self.params, lr=lr0,
                                          betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=wd)

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
        ``adamw`` ``[{count, mu, nu}, decay, lr]``, where ``lr`` is None
        for a fixed rate and ``{count}`` for a schedule; a clip and a
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

    def load_optax_state(self, opt_state, names: dict,
                         from_tree: Callable[[dict], dict]) -> None:
        """Inverse of :meth:`optax_state` (a checkpoint of either package).
        Raises ``ValueError`` when ``opt_state`` is not this optimizer's
        layout (another ``--optimizer``, schedule, clip, decay or
        ``--trainable_params``)."""
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
            want = 3 if spec.name == "adamw" else 2
            if len(opt_state) != want:
                raise ValueError("length")
            lr = opt_state[-1]
            if (lr is None) != getattr(spec.schedule, "constant", False):
                raise ValueError("schedule")
            state = opt_state[0]
            if spec.name == "sgd":
                if state is not None:
                    raise ValueError("sgd")
                slots = {}
            elif spec.name in ("momentum", "nesterov"):
                slots = {"momentum_buffer": from_tree(state["trace"])}
            else:
                slots = {"exp_avg": from_tree(state["mu"]),
                         "exp_avg_sq": from_tree(state["nu"])}
                adam_count = int(state["count"])
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
                st["step"] = torch.tensor(float(adam_count),
                                          dtype=torch.float32)
            self.base.state[p] = st
        if lr is not None:
            self.count = int(lr["count"])
        elif "exp_avg" in slots:
            self.count = adam_count


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
    if name not in PORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (its optax constants "
            "differ from torch.optim's); see ROADMAP.md, section 1, item 7a")
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
    if spec.weight_decay > 0.0 and spec.name != "adamw":
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
