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
``pipe``, ``expert``, the DCN factor and ``ParallelConfig`` are later
work (ROADMAP.md, PyTorch port).
"""

from __future__ import annotations

import math
from typing import Sequence

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
