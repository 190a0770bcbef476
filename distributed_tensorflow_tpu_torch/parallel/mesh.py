"""Device meshes: named axes over an array of devices.

Counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``, the
subset that ring attention needs: the axis names and
:func:`create_mesh`.  The JAX mesh is a ``jax.sharding.Mesh`` that
``shard_map`` programs over; here a :class:`Mesh` is a numpy object array
of :class:`torch.device` with the same axis names, and one process drives
every shard of it (single controller, as a JAX program over a mesh).

- ``data``  — data parallelism (batch axis)
- ``seq``   — sequence/context parallelism (ring attention)
- ``model`` — tensor parallelism (heads; not ported yet, see ROADMAP.md)

Axes of size 1 are kept, so one set of rules works at any scale.

:class:`ParallelConfig` is the trainer's declarative layout, so far for
the data axis alone: its data replicas are the sync trainer's worker
processes (one replica a worker, the reference's ``num_workers``).  A
layout that asks for tensor, sequence, pipeline or expert parallelism,
FSDP or a DCN factor raises ``NotImplementedError`` (ROADMAP.md, section
1, item 6), as do ``pipe``, ``expert`` and the DCN factor of
:func:`create_mesh`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"

# The JAX package's order with pipe and expert left out: model innermost,
# data outermost.
AXIS_ORDER = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)


class Mesh:
    """``devices``: an object array of :class:`torch.device`, one dim per
    name in ``axis_names``.  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for "
                             f"{len(axis_names)} axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                devices: Sequence | None = None) -> Mesh:
    """A named mesh over ``devices``.

    One axis size may be -1 (inferred from the device count).  ``devices``
    defaults to every visible CUDA device, and then, as in the JAX
    package, the mesh must use them all.  An explicit list may name one
    device more than once: ``create_mesh(seq=4, devices=[cuda0] * 4)``
    runs four sequence shards on one card (the ring's hop between shards
    on one device is a re-indexing, between devices a copy), and the CPU
    tests build ``devices=[cpu] * 8``.  JAX's ``create_mesh`` requires
    distinct devices."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= (for "
                               "example [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    sizes = {DATA_AXIS: data, SEQ_AXIS: seq, MODEL_AXIS: model}
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError("At most one mesh axis may be -1")
    fixed = math.prod(v for v in sizes.values() if v != -1)
    if unknown:
        if n % fixed != 0:
            raise ValueError(f"{n} devices not divisible by fixed axes "
                             f"product {fixed}")
        sizes[unknown[0]] = n // fixed
    total = math.prod(sizes.values())
    if total != n:
        raise ValueError(f"Mesh of {total} devices but {n} available")
    array = np.empty(n, dtype=object)
    array[:] = devices
    return Mesh(array.reshape(tuple(sizes[a] for a in AXIS_ORDER)),
                AXIS_ORDER)


_QUANT_ARMS = ("off", "int8")
_ATTENTION_BACKENDS = ("auto", "xla", "pallas", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Declarative parallelism layout (the JAX package's fields):
    ``data`` (``-1``: every worker), ``model``, ``seq``, ``pipe``,
    ``expert``, ``dcn_data``, ``microbatch`` (gradient accumulation),
    ``quantize``, ``attention``, ``fsdp`` and ``fsdp_min_size``.  Only a
    data-parallel layout is ported."""

    data: int = -1
    model: int = 1
    seq: int = 1
    pipe: int = 1
    expert: int = 1
    dcn_data: int = 1
    microbatch: int = 1
    quantize: str = "off"
    attention: str = "auto"
    fsdp: bool = False
    fsdp_min_size: int = 2 ** 16

    def __post_init__(self):
        for name in ("model", "seq", "pipe", "expert", "dcn_data",
                     "microbatch"):
            v = getattr(self, name)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"ParallelConfig.{name} must be a "
                                 f"positive int, got {v!r}")
        if not isinstance(self.data, int) or (self.data < 1
                                              and self.data != -1):
            raise ValueError(f"ParallelConfig.data must be a positive int "
                             f"or -1 (infer), got {self.data!r}")
        if self.quantize not in _QUANT_ARMS:
            raise ValueError(f"ParallelConfig.quantize must be one of "
                             f"{_QUANT_ARMS}, got {self.quantize!r}")
        if self.attention not in _ATTENTION_BACKENDS:
            raise ValueError(f"ParallelConfig.attention must be one of "
                             f"{_ATTENTION_BACKENDS}, "
                             f"got {self.attention!r}")
        unported = [f"{name}={getattr(self, name)}" for name in
                    ("model", "seq", "pipe", "expert", "dcn_data")
                    if getattr(self, name) > 1]
        if self.fsdp:
            unported.append("fsdp")
        if unported:
            raise NotImplementedError(
                f"parallel layout {', '.join(unported)} is not ported yet "
                "(the trainer's data axis only); see ROADMAP.md, section "
                "1, item 6")

    def describe(self) -> str:
        """Compact label, e.g. ``dp2-mb1``."""
        parts = [f"dp{self.data}", f"mb{self.microbatch}"]
        if self.quantize != "off":
            parts.append(self.quantize)
        return "-".join(parts)

    @classmethod
    def from_flags(cls, FLAGS: Any) -> "ParallelConfig":
        """The CLI flag set -> one declarative layout (the trainer's
        path); missing attributes take the defaults."""
        g = lambda name, default: getattr(FLAGS, name, default)
        return cls(
            data=-1,
            model=g("tensor_parallel", 1),
            seq=g("sequence_parallel", 1),
            pipe=g("pipeline_parallel", 1),
            expert=g("expert_parallel", 1),
            dcn_data=g("dcn_data_parallel", 1),
            microbatch=g("grad_accum_steps", 1),
            quantize="int8" if g("gpt_matmul_int8", False) else "off",
            attention=g("attention_backend", "auto"),
            fsdp=g("fsdp", False),
            fsdp_min_size=g("fsdp_min_size", 2 ** 16),
        )
