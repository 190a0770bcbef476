"""The synchronous train step, in one process.

Counterpart of ``distributed_tensorflow_tpu/parallel/sync.py``'s
``build_sync_train_step``.  There the step is one jitted function whose
gradient mean over the ``data`` mesh axis XLA turns into an AllReduce;
here it runs eagerly in one process.  A model whose attention is
sharded over a mesh (``attention_backend="ring"``) needs no all-reduce
of its own: the replicated weights are one set of tensors, and autograd
sums every shard's contribution into their gradients, which is what
GSPMD's AllReduce over ``data`` and ``seq`` does in the JAX step.  The
gradient all-reduce across processes over ``torch.distributed`` is later
work (ROADMAP.md, PyTorch port).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..training.optimizers import global_norm
from ..training.state import TrainState

# loss_fn signature: (model, batch) -> (scalar_loss, aux_metrics_dict);
# rng-aware variants (needs_rng=True) take (model, batch, rng) instead.
LossFn = Callable[..., tuple[torch.Tensor, dict]]


def build_sync_train_step(loss_fn: LossFn, *, needs_rng: bool = False,
                          ema_decay: float = 0.0,
                          log_grad_norm: bool = False):
    """Returns ``step(state, batch) -> (state, metrics)``: forward in
    ``train()`` mode, backward, one optimizer step.

    ``needs_rng=True``: ``loss_fn(model, batch, state.rng)`` (dropout);
    the generator advances as the model draws from it.  ``ema_decay > 0``
    updates ``state.ema_params`` after each optimizer step.
    ``log_grad_norm=True`` adds the global L2 norm of the raw gradients as
    ``grad_norm``.  Metric values stay on the device (0-dim tensors; the
    global step is an int): reading one waits for the step."""

    def step(state: TrainState, batch: Any):
        model = state.model
        model.train()
        state.optimizer.zero_grad()
        if needs_rng:
            loss, aux = loss_fn(model, batch, state.rng)
        else:
            loss, aux = loss_fn(model, batch)
        loss.backward()
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
        return state, metrics

    return step


@torch.no_grad()
def _ema_update(decay: float, state: TrainState) -> None:
    if state.ema_params is None:
        raise ValueError("ema_decay > 0 needs TrainState.create(..., "
                         "ema=True)")
    for name, p in state.model.named_parameters():
        e = state.ema_params[name]
        e.mul_(decay).add_(p.detach().to(e.dtype), alpha=1.0 - decay)
