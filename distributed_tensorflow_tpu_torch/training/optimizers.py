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

``lamb``, ``adagrad``, ``rmsprop`` and ``adafactor`` raise: their optax
constants differ from ``torch.optim``'s and need their own parity work
(ROADMAP.md, PyTorch port).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable

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
        return ramp if warmup_steps else (lambda step: learning_rate)
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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors, in fp32 (a 0-dim tensor)."""
    sq = [t.detach().float().pow(2).sum() for t in tensors]
    return torch.stack(sq).sum().sqrt()


class Optimizer:
    """A ``torch.optim`` optimizer over ``params`` behind optax's chain:
    :meth:`step` reads each parameter's ``.grad``, clips by global norm,
    sets the scheduled rate and applies the base rule (which adds coupled
    decay to the gradient where it applies).  Updates the parameters IN
    PLACE, where optax returns new ones."""

    def __init__(self, spec: "OptimizerSpec", params):
        self.spec = spec
        self.params = [p for p in params if p.requires_grad]
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
            norm = global_norm(p.grad for p in self.params)
            # optax clip_by_global_norm: g / norm * max_norm when the norm
            # reaches the limit, untouched below it.
            below = norm < clip
            for p in self.params:
                n = norm.to(p.grad.dtype)
                p.grad.copy_(torch.where(below, p.grad, p.grad / n * clip))
        lr = self.spec.schedule(self.count)
        for group in self.base.param_groups:
            group["lr"] = lr
        self.base.step()
        self.count += 1


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """What :func:`make_optimizer` built, before it has parameters."""

    name: str
    schedule: Schedule
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0

    def init(self, params) -> Optimizer:
        return Optimizer(self, params)


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
            "differ from torch.optim's); see ROADMAP.md, PyTorch port")
    schedule = (learning_rate if callable(learning_rate)
                else (lambda step, lr=float(learning_rate): lr))
    return OptimizerSpec(name=name, schedule=schedule, momentum=momentum,
                         weight_decay=weight_decay,
                         grad_clip_norm=grad_clip_norm)
