"""Mixture-of-Experts FFN, its experts over the ``expert`` mesh axis.

Counterpart of ``distributed_tensorflow_tpu/ops/moe.py`` (GShard/Switch
dense dispatch): tokens route within groups (one a sequence by default)
to the top-k of ``E`` experts under a static per-group capacity ``C =
ceil(capacity_factor * k * S / E)``; a token past an expert's capacity
is dropped (its combine weight is 0) and keeps its share of the gate
denominator.  The router is fp32 end to end; the Switch load-balance loss
comes from the pre-capacity top-1 assignment.  Dispatch and combine are
one-hot einsums (dispatch in the compute dtype, combine in fp32) and the
experts' FFN a batched matmul over the stacked weights: plain PyTorch
matmuls, as the JAX package's are plain XLA matmuls (no Pallas kernel
runs here).

Parameters keep flax's names and layouts: ``router/kernel`` [H, E]
(fp32), ``experts/wi/kernel`` [E, H, I], ``experts/wi/bias`` [E, I],
``experts/wo/kernel`` [E, I, H], ``experts/wo/bias`` [E, H].
:func:`moe_sharding_rules` puts the stacked weights on ``expert``; where
``parallel/sharding.shard_state`` split them, the forward routes once on
the replicated activations (the JAX batch is not sharded over
``expert``), sends each position's slice of the dispatched ``[E, G*C,
H]`` to the position that owns those experts (the all-to-all; a copy
where the positions share a card), runs that position's experts there
and gathers the outputs back for the combine.

The aux loss, flax's ``moe_losses`` collection in JAX, is the module's
``aux_loss`` (set by each forward); :func:`collect_aux_loss` reads and
clears it over a model's MoE layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import P, shards

AUX_LOSS_COLLECTION = "moe_losses"
#: Default load-balance loss coefficient (the JAX package's).
DEFAULT_AUX_WEIGHT = 0.01


class StackedDense(nn.Module):
    """``E`` dense layers stacked on a leading dim: ``kernel`` [E, in,
    out], ``bias`` [E, out] (flax's vmapped ``nn.Dense``)."""

    def __init__(self, experts: int, d_in: int, d_out: int, *,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(experts, d_in, d_out,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(experts, d_out,
                                             dtype=param_dtype,
                                             device=device))

    def pieces(self) -> list:
        """``[(kernel, bias)]`` a position that holds experts: one pair,
        or the expert-axis shards in coordinate order."""
        kernels = shards(self, "kernel")
        if kernels is None:
            return [(self.kernel, self.bias)]
        biases = shards(self, "bias") or list(
            self.bias.chunk(len(kernels), dim=0))
        return list(zip(kernels, biases))


class Experts(nn.Module):
    def __init__(self, experts: int, hidden: int, intermediate: int,
                 device=None):
        super().__init__()
        self.wi = StackedDense(experts, hidden, intermediate, device=device)
        self.wo = StackedDense(experts, intermediate, hidden, device=device)


def _expert_ffn(x: torch.Tensor, wi, bi, wo, bo, dtype) -> torch.Tensor:
    """[e, N, H] -> [e, N, H] through each expert's dense -> tanh gelu ->
    dense in ``dtype`` (flax's compute dtype on fp32 parameters)."""
    h = torch.bmm(x.to(dtype), wi.to(dtype)) + bi.to(dtype)[:, None, :]
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, wo.to(dtype)) + bo.to(dtype)[:, None, :]


class MoeMlp(nn.Module):
    """Top-k gated mixture-of-experts FFN, a drop-in for a dense MLP
    block: ``[..., hidden]`` in and out (the leading dims flattened into
    tokens for routing).  ``dtype``: the compute dtype of the dispatch and
    the experts."""

    def __init__(self, hidden: int, num_experts: int,
                 intermediate_size: int, *, top_k: int = 2,
                 capacity_factor: float = 2.0,
                 dtype: torch.dtype = torch.float32,
                 group_size: int | None = None, device=None):
        super().__init__()
        from ..models.gpt import Dense
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.group_size = group_size
        self.router = Dense((hidden,), (num_experts,), dtype=torch.float32,
                            param_dtype=torch.float32, use_bias=False,
                            device=device)
        self.experts = Experts(num_experts, hidden, intermediate_size,
                               device)
        self.aux_loss = None

    def route(self, groups: torch.Tensor) -> tuple:
        """``(combine [G, S, E, C] fp32, aux)`` for ``groups`` [G, S, H]:
        iterative top-k with per-group capacity (slot i fills experts
        after slots < i, GShard's order)."""
        G, S, _ = groups.shape
        E = self.num_experts
        k = min(self.top_k, E)
        C = max(1, math.ceil(self.capacity_factor * k * S / E))
        probs = torch.softmax(self.router(groups.to(torch.float32)), dim=-1)
        fills = probs.new_zeros(G, E)
        remaining = probs
        selections = []
        for _ in range(k):
            onehot = F.one_hot(remaining.argmax(-1), E).to(torch.float32)
            pos = onehot.cumsum(dim=1) - onehot + fills[:, None, :]
            pos_t = (pos * onehot).sum(-1)
            kept = onehot * (pos_t < C).to(torch.float32)[..., None]
            gate = (remaining * onehot).sum(-1)
            selections.append((gate, kept, pos_t))
            fills = fills + kept.sum(dim=1)
            remaining = remaining * (1.0 - onehot)
        # Switch's balance loss over every token, from the pre-capacity
        # top-1: E * sum_e(fraction routed to e * mean prob of e).
        top1 = F.one_hot(probs.argmax(-1), E).to(torch.float32)
        aux = E * (top1.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
        # Dropped slots keep their share of the denominator (GShard).
        denom = torch.clamp(sum(g for g, _, _ in selections), min=1e-9)
        slots = torch.arange(C, device=probs.device, dtype=torch.float32)
        combine = probs.new_zeros(G, S, E, C)
        for gate, kept, pos_t in selections:
            # one_hot(pos_t, C), all zeros at or past the capacity.
            slot = (pos_t[..., None] == slots).to(torch.float32)
            combine = combine + ((gate / denom)[..., None, None]
                                 * kept[..., None] * slot[..., None, :])
        return combine, aux

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape, hidden = x.shape, x.shape[-1]
        tokens = x.reshape(-1, hidden)
        T = tokens.shape[0]
        S = self.group_size or (x.shape[-2] if x.dim() >= 3 else T)
        if T % S:
            raise ValueError(f"{T} tokens not divisible by group size {S}")
        G, E = T // S, self.num_experts
        groups = tokens.reshape(G, S, hidden)
        combine, self.aux_loss = self.route(groups)
        C = combine.shape[-1]
        dispatch = (combine > 0.0).to(self.dtype)
        expert_in = torch.einsum("gsec,gsh->egch", dispatch,
                                 groups.to(self.dtype)).reshape(
                                     E, G * C, hidden)
        wi, wo = self.experts.wi.pieces(), self.experts.wo.pieces()
        home = x.device
        # One slice of the experts a position (one piece unsharded): the
        # dispatched rows go to the position that owns their experts, its
        # outputs come back for the combine.
        outs = [_expert_ffn(xe.to(ki.device), ki, bi, ko, bo, self.dtype)
                .to(home)
                for xe, (ki, bi), (ko, bo) in zip(
                    expert_in.chunk(len(wi), dim=0), wi, wo)]
        expert_out = torch.cat(outs, dim=0).reshape(E, G, C, hidden)
        out = torch.einsum("gsec,egch->gsh", combine,
                           expert_out.to(torch.float32))
        return out.to(x.dtype).reshape(shape)


def moe_sharding_rules(prefix: str = "") -> list:
    """(regex, spec) rules placing the stacked expert weights over
    ``expert``, for a model's wider rule set (BERT-MoE's, ahead of its
    tensor-parallel rules)."""
    return [
        (prefix + r"experts/(wi|wo)/kernel", P("expert", None, None)),
        (prefix + r"experts/(wi|wo)/bias", P("expert", None)),
    ]


def collect_aux_loss(model: nn.Module) -> torch.Tensor:
    """Mean load-balancing loss over the MoE layers of ``model`` that ran
    a forward since the last call (each layer's ``aux_loss``, cleared
    here); a 0-dim zero when none did."""
    losses = []
    for m in model.modules():
        if isinstance(m, MoeMlp) and m.aux_loss is not None:
            losses.append(m.aux_loss)
            m.aux_loss = None
    if not losses:
        return torch.zeros((), dtype=torch.float32)
    return sum(losses) / len(losses)
