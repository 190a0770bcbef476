"""Training state: the model (parameters), its optimizer and the global
step.

Counterpart of ``distributed_tensorflow_tpu/training/state.py``.  The JAX
``TrainState`` is an immutable pytree that each step replaces; here the
model and the optimizer's slots are updated IN PLACE and
:meth:`TrainState.apply_gradients` returns the same object.
"""

from __future__ import annotations

import dataclasses

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

    @classmethod
    def create(cls, model: nn.Module, tx: OptimizerSpec, *,
               rng: torch.Generator | None = None,
               ema: bool = False) -> "TrainState":
        """``ema=True`` starts the moving average at a copy of the
        parameters, as the trainer does in JAX."""
        ema_params = ({n: p.detach().clone()
                       for n, p in model.named_parameters()} if ema else None)
        return cls(model=model, optimizer=tx.init(model.parameters()),
                   rng=rng, ema_params=ema_params)

    def apply_gradients(self) -> "TrainState":
        """One optimizer step from the parameters' ``.grad``."""
        self.optimizer.step()
        self.global_step += 1
        return self

