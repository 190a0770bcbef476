"""Device meshes: named axes over an array of devices.

Counterpart of ``distributed_tensorflow_tpu/parallel/mesh.py``.  The JAX
mesh is a ``jax.sharding.Mesh`` that ``shard_map`` programs (and GSPMD)
run over; here a :class:`Mesh` is a numpy object array of
:class:`torch.device` with the same axis names, and one process drives
every position of it (single controller, as a JAX program over a mesh):

- ``data``  — data parallelism (batch axis)
- ``seq``   — sequence/context parallelism (ring and ulysses attention)
- ``pipe``  — pipeline parallelism (layer stages: :mod:`.pipeline`)
- ``expert``— expert parallelism (the MoE's stacked expert weights,
  ``ops/moe.py``, split over it)
- ``model`` — tensor parallelism (heads and hidden columns, Megatron's
  layout: :mod:`.sharding`, ``models/gpt.py``)

Axes of size 1 are kept, so one set of rules works at any scale.  A
collective between positions is a ``.to(device)`` copy plus an op on
tensors; where two positions share a device (the tests' ``[cpu] * 8``,
one card driving several positions), the copy is a no-op and the code
path is the same.

**The global mesh** (:func:`global_mesh`, the sync trainer's): JAX's
mesh reshapes the devices of every process, so any axis may cross a
process boundary.  Here the mesh covers ``num_workers x local
positions`` in process-major order and the same reshape applies; each
worker process (one rank, one card) keeps a :class:`Mesh` of its own
positions, and :class:`RankAxes` (``Mesh.ranks``) says, for every axis,
its coordinate and the ranks along it.  Where the non-data axes fit in
a worker every axis but ``data`` stays inside it; where they do not,
the outer ones cross processes: ``seq`` and ``pipe`` (their hops run
over ``torch.distributed`` process groups, :mod:`.transport`), not yet
``expert`` or ``model`` (ROADMAP.md, 8f).

:class:`ParallelConfig` is the trainer's declarative layout.  The data
axis is ``worker processes x local positions``: a worker's mesh is
``data x seq x pipe x expert x model`` over the devices it drives, its
``data`` rows the local data positions (``data=-1``: the worker's share
of the visible cards over the other axes, :func:`local_data_size`), each
row holding its own copy of the model (``parallel/sharding.py``), laid
over the worker's cards by :func:`worker_positions`.  FSDP shards over
the whole data axis (:func:`.sharding.fsdp_state`).  ``dcn_data`` is the
data axis's outer factor: the positions are ordered slice-major
(:func:`_slice_major`) and a gradient's mean is taken within a slice,
then across the slices (:mod:`.sync`).  :func:`save_run_profile` /
:func:`load_run_profile` write and read the JAX package's run-profile
JSON.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

AXIS_ORDER = (DATA_AXIS, SEQ_AXIS, PIPE_AXIS, EXPERT_AXIS, MODEL_AXIS)


def _slice_major(devices, n_groups: int):
    """Order devices so consecutive blocks share a pod slice (JAX's
    ``_slice_major``).  Grouping key: a device's ``slice_index`` when it
    has one, else its ``process_index`` (a :class:`torch.device` has
    neither: one group).  On a real topology (more than one key) the
    group count must equal the DCN factor, or it raises; a single key
    falls back to even positional chunking."""
    keyed: dict = {}
    for d in devices:
        key = getattr(d, "slice_index", None)
        if key is None:
            key = getattr(d, "process_index", 0)
        keyed.setdefault(key, []).append(d)
    groups = [keyed[k] for k in sorted(keyed)]
    if len(groups) == 1:
        per = len(devices) // n_groups
        groups = [list(devices[i * per:(i + 1) * per])
                  for i in range(n_groups)]
    elif len(groups) != n_groups or len({len(g) for g in groups}) != 1:
        raise ValueError(
            f"dcn_data={n_groups} does not match the device topology: "
            f"{len(groups)} slice/process groups of sizes "
            f"{[len(g) for g in groups]}; set dcn_data to the slice count "
            "so the inner mesh axes stay on intra-slice ICI")
    return [d for group in groups for d in group]


class Mesh:
    """``devices``: an object array of :class:`torch.device`, one dim per
    name in ``axis_names``.  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 dcn_data: int = 1):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of rank {devices.ndim} for "
                             f"{len(axis_names)} axis names")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        #: The DCN slices the ``data`` axis spans (its outer factor).
        self.dcn_data = dcn_data
        #: This process's place in a mesh across processes
        #: (:func:`global_mesh`), None for a mesh of one process.
        self.ranks: RankAxes | None = None

    @property
    def shape(self) -> dict:
        """This process's axis sizes (an axis that crosses processes has
        size 1 here: :attr:`global_shape` has its size)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def global_shape(self) -> dict:
        """The axis sizes over every process (:attr:`shape` without
        ranks)."""
        return dict(self.ranks.shape) if self.ranks is not None \
            else self.shape

    def crosses(self, axis: str) -> bool:
        """True where ``axis`` runs over processes (its positions are
        ranks)."""
        return self.ranks is not None and axis in self.ranks.cross

    def _derived(self, devices: np.ndarray, dcn_data: int) -> "Mesh":
        out = Mesh(devices, self.axis_names, dcn_data)
        out.ranks = self.ranks
        return out

    def grid(self, model: int = 0) -> np.ndarray:
        """The ``[data, seq]`` devices of model column ``model`` (pipe
        and expert at their one position)."""
        index = [slice(None)] * self.devices.ndim
        for axis in (PIPE_AXIS, EXPERT_AXIS):
            index[self.axis_names.index(axis)] = 0
        index[self.axis_names.index(MODEL_AXIS)] = model
        return self.devices[tuple(index)]

    def pipe_devices(self) -> list:
        """The device of each pipe coordinate (every other axis at 0):
        where stage ``s`` of a pipeline lives (:mod:`.pipeline`)."""
        return self.axis_devices(PIPE_AXIS)

    def axis_devices(self, axis: str) -> list:
        """The device of each coordinate of ``axis`` (every other axis at
        0): where a parameter split over ``axis`` keeps its shard ``j``."""
        index = [0] * self.devices.ndim
        out = []
        for j in range(self.shape[axis]):
            index[self.axis_names.index(axis)] = j
            out.append(self.devices[tuple(index)])
        return out

    def model_devices(self) -> list:
        """The device of each model coordinate (data, seq, pipe and
        expert at 0): where a parameter's shard ``j`` lives."""
        return self.axis_devices(MODEL_AXIS)

    def column(self, j: int) -> "Mesh":
        """Model column ``j`` as a mesh of its own (model axis of size 1):
        the ring or ulysses attention of the heads shard ``j`` holds."""
        axis = self.axis_names.index(MODEL_AXIS)
        return self._derived(self.devices.take([j], axis=axis),
                             self.dcn_data)

    def row(self, r: int) -> "Mesh":
        """Data row ``r`` as a mesh of its own (data axis of size 1): the
        positions that hold one copy of the model."""
        axis = self.axis_names.index(DATA_AXIS)
        return self._derived(self.devices.take([r], axis=axis), 1)

    def row_slices(self) -> list:
        """The data rows grouped by DCN slice (``[[0, 1], [2, 3]]`` for
        ``data=4, dcn_data=2``; one group of every row when the axis
        spans one slice or less)."""
        n = self.shape[DATA_AXIS]
        k = self.dcn_data if self.dcn_data > 1 and n % self.dcn_data == 0 \
            else 1
        per = n // k
        return [list(range(i * per, (i + 1) * per)) for i in range(k)]


def create_mesh(data: int = -1, model: int = 1, seq: int = 1,
                pipe: int = 1, expert: int = 1,
                devices: Sequence | None = None,
                dcn_data: int = 1) -> Mesh:
    """A named mesh over ``devices``.

    One axis size may be -1 (inferred from the device count).  The axis
    order puts ``model`` innermost and ``data`` outermost, as the JAX
    package's.  ``devices`` defaults to every visible CUDA device, and
    then, as in the JAX package, the mesh must use them all.  An explicit
    list may name one device more than once: ``create_mesh(seq=4,
    devices=[cuda0] * 4)`` runs four sequence shards on one card, and the
    CPU tests build ``devices=[cpu] * 8``.  JAX's ``create_mesh``
    requires distinct devices.  ``dcn_data > 1`` orders the devices
    slice-major (:func:`_slice_major`), so the ``data`` axis's outer
    factor of ``dcn_data`` crosses the slices and every other axis, and
    the inner data factor, stays inside one."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= (for "
                               "example [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    sizes = {DATA_AXIS: data, SEQ_AXIS: seq, PIPE_AXIS: pipe,
             EXPERT_AXIS: expert, MODEL_AXIS: model}
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
    if dcn_data > 1:
        if sizes[DATA_AXIS] % dcn_data:
            raise ValueError(
                f"data axis {sizes[DATA_AXIS]} not divisible by "
                f"dcn_data={dcn_data} (the DCN factor is the data axis's "
                "outer segment)")
        devices = _slice_major(devices, dcn_data)
    array = np.empty(n, dtype=object)
    array[:] = devices
    return Mesh(array.reshape(tuple(sizes[a] for a in AXIS_ORDER)),
                AXIS_ORDER, dcn_data=dcn_data)


#: The axes whose positions may be ranks of their own (their hops and sums
#: run over process groups); ``model`` and ``expert`` across processes are
#: ROADMAP.md's 8f.
CROSS_AXES = (SEQ_AXIS, PIPE_AXIS)


def cross_process_error(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} across worker processes is not ported yet; see ROADMAP.md, "
        "section 1, item 6, 8f")


def _rank_lines(shape: dict, num_workers: int, local: int,
                free: Sequence[str]) -> list:
    """Every line of ranks along the ``free`` axes: the positions that
    share their coordinates on every other axis, as the ranks that hold
    them (in coordinate order, each once), one list a distinct line, in
    the order of the lines' first positions (the same on every rank)."""
    ids = np.arange(num_workers * local).reshape(
        [shape[a] for a in AXIS_ORDER])
    fixed = [i for i, a in enumerate(AXIS_ORDER) if a not in free]
    lines: dict = {}
    for index in np.ndindex(ids.shape):
        ranks = lines.setdefault(tuple(index[i] for i in fixed), [])
        rank = int(ids[index]) // local
        if rank not in ranks:
            ranks.append(rank)
    out = []
    for ranks in lines.values():
        if ranks not in out:        # lines inside one process repeat
            out.append(ranks)
    return out


@dataclasses.dataclass
class RankAxes:
    """A worker process's place in the global mesh.  ``shape``: the axis
    sizes over every process; ``rank`` this process's rank of
    ``num_workers``, each holding ``local`` positions; ``coords`` its
    coordinate on each axis (its first position's); ``cross`` the axes
    other than ``data`` whose positions are ranks; ``groups`` the process
    groups ``cluster/server.py`` forms for them (by axis name) and for
    ``"grad"``, the ranks a gradient's sum runs over (the data and seq
    lines through this rank, :meth:`grad_lines`)."""

    shape: dict
    rank: int
    num_workers: int
    local: int
    coords: dict
    cross: tuple
    groups: dict = dataclasses.field(default_factory=dict, repr=False)
    #: ``parallel/transport.AxisLink`` a crossing axis, made at first use.
    links: dict = dataclasses.field(default_factory=dict, repr=False)

    def lines(self, free: Sequence[str]) -> list:
        """Every line of ranks along ``free`` (:func:`_rank_lines`)."""
        return _rank_lines(self.shape, self.num_workers, self.local, free)

    def line(self, free: Sequence[str]) -> list:
        """The line along ``free`` through this rank."""
        return next(l for l in self.lines(free) if self.rank in l)

    def axis_ranks(self, axis: str) -> list:
        """The ranks along ``axis`` through this rank, in coordinate
        order (``[rank]`` for an axis inside the process)."""
        return self.line((axis,))

    def grad_lines(self) -> list:
        """The gradient groups: ranks that share the pipe, expert and
        model coordinates (a replicated parameter's gradient is summed
        over data and seq, as JAX's ``psum`` over both axes)."""
        return self.lines((DATA_AXIS, SEQ_AXIS))

    @property
    def seq_parts(self) -> int:
        """The ranks of a gradient group that hold parts of one data
        coordinate's gradient (``seq`` across processes), whose sum is
        that coordinate's gradient."""
        return self.shape[SEQ_AXIS] if SEQ_AXIS in self.cross else 1

    def __deepcopy__(self, memo):
        # One layout a process, its process groups with it: a deep copy of
        # a model that holds the mesh (a data row's) shares it.
        return self

    def group(self, key: str):
        """The process group of ``key`` (an axis, or ``"grad"``)."""
        group = self.groups.get(key)
        if group is None:
            raise RuntimeError(
                f"no process group for {key!r}: cluster/server.Server forms "
                "the mesh's groups")
        return group


def global_mesh(*, num_workers: int, rank: int, positions: Sequence,
                data: int = -1, model: int = 1, seq: int = 1, pipe: int = 1,
                expert: int = 1, local_dcn: int = 1) -> Mesh:
    """Worker ``rank``'s part of the mesh over ``num_workers`` processes
    of ``len(positions)`` positions each (``positions``: this process's
    devices), laid process-major and reshaped as :func:`create_mesh`
    (``data`` outermost, ``model`` innermost; ``data=-1`` resolved over
    the global count, as JAX resolves it over ``jax.devices()``).  Where
    the non-data axes' product divides a worker's positions, every axis
    but ``data`` stays inside the worker; where it exceeds them the outer
    axes cross the processes, whole: ``seq`` and ``pipe`` (``model``,
    ``expert`` or an axis split between processes and positions raise,
    ROADMAP.md 8f).  Returns the :class:`Mesh` of this process's
    positions (``local_dcn``: the DCN slices among its data rows) with
    :class:`RankAxes` as ``ranks``."""
    local = len(positions)
    sizes = {DATA_AXIS: data, SEQ_AXIS: seq, PIPE_AXIS: pipe,
             EXPERT_AXIS: expert, MODEL_AXIS: model}
    fixed = seq * pipe * expert * model
    total = num_workers * local
    if data == -1:
        if total % fixed:
            raise ValueError(f"{total} devices not divisible by fixed axes "
                             f"product {fixed}")
        sizes[DATA_AXIS] = total // fixed
    if math.prod(sizes.values()) != total:
        raise ValueError(f"Mesh of {math.prod(sizes.values())} devices but "
                         f"{total} available")
    ids = np.arange(total).reshape([sizes[a] for a in AXIS_ORDER])
    own = np.argwhere((ids // local) == rank)
    local_shape, coords, cross = {}, {}, []
    for i, axis in enumerate(AXIS_ORDER):
        held = sorted({int(c) for c in own[:, i]})
        coords[axis] = held[0]
        local_shape[axis] = len(held)
        if axis == DATA_AXIS or len(held) == sizes[axis]:
            continue
        if len(held) > 1:
            raise cross_process_error(
                f"the {axis} axis split between processes and positions "
                f"({sizes[axis]} over {len(held)} a process)")
        if axis not in CROSS_AXES:
            raise cross_process_error(f"the {axis} axis")
        cross.append(axis)
    ranks = RankAxes(shape=sizes, rank=rank, num_workers=num_workers,
                     local=local, coords=coords, cross=tuple(cross))
    mesh = create_mesh(**{a: local_shape[a] for a in AXIS_ORDER},
                       devices=list(positions), dcn_data=local_dcn)
    mesh.ranks = ranks
    return mesh


def data_parallel_mesh(num_devices: int | None = None,
                       devices: Sequence | None = None) -> Mesh:
    """Pure data-parallel mesh, the reference's replica topology."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is not None:
        devices = devices[:num_devices]
    return create_mesh(data=len(devices), devices=devices)


def data_sharded(mesh: Mesh, *, extra_dims: int = 0) -> tuple:
    """The spec of batch-major tensors split along ``data`` (a
    :class:`.sharding.P` value)."""
    from .sharding import P
    return P(DATA_AXIS, *([None] * extra_dims))


def batch_sharding(mesh: Mesh) -> tuple:
    """The input batches' spec: dim 0 over ``data`` and, with a
    non-trivial ``seq`` axis, dim 1 over ``seq`` (a
    :class:`.sharding.P` value; the port places no input by it)."""
    from .sharding import P
    if mesh.shape[SEQ_AXIS] > 1:
        return P(DATA_AXIS, SEQ_AXIS)
    return P(DATA_AXIS)


def stacked_batch_sharding(mesh: Mesh) -> tuple:
    """The spec of a stack of K batches (leading microstep dim
    unsharded)."""
    from .sharding import P
    if mesh.shape[SEQ_AXIS] > 1:
        return P(None, DATA_AXIS, SEQ_AXIS)
    return P(None, DATA_AXIS)


def num_replicas(mesh: Mesh) -> int:
    """Number of data-parallel replicas (the reference's ``num_workers``)."""
    return mesh.shape[DATA_AXIS]


# The CPU counts as this many devices for ``data=-1`` (default one): a
# worker run with ``--device=cpu`` lays that many data positions on it, as
# JAX's CPU backend does with ``--xla_force_host_platform_device_count``.
CPU_DEVICES_ENV = "DTF_TORCH_CPU_DEVICES"


def local_data_size(name: str, fixed: int, num_workers: int = 1) -> int:
    """A worker's local data positions for ``data=-1``: the devices it
    drives over the other axes' product ``fixed`` (at least one row).
    ``cuda`` (no index) drives the worker's share of the visible cards
    (``device_count // num_workers``, at least one), ``cuda:N`` one card,
    and ``cpu`` ``$DTF_TORCH_CPU_DEVICES`` devices (default one)."""
    device = torch.device(name)
    if device.type == "cpu":
        count = int(os.environ.get(CPU_DEVICES_ENV) or 1)
    elif device.index is not None:
        count = 1
    elif not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device=cpu to run on the CPU")
    else:
        count = max(1, torch.cuda.device_count() // num_workers)
    return max(1, count // fixed)


def worker_positions(name: str, task_index: int, positions: int) -> list:
    """The devices of a worker's ``positions`` mesh positions (its ``data
    x seq x pipe x expert x model``, data outermost) for the ``--device``
    value ``name``: ``cuda`` lays them round robin over the visible cards
    from card ``task_index x positions``, as worker ``i`` with one
    position takes card ``i`` mod the count; an explicit ``cuda:N`` or
    ``cpu`` holds every position."""
    device = torch.device(name)
    if device.type != "cuda" or device.index is not None:
        return [device] * positions
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --device=cpu to run on the CPU")
    count = torch.cuda.device_count()
    return [torch.device("cuda", (task_index * positions + p) % count)
            for p in range(positions)]


_QUANT_ARMS = ("off", "int8")
_ATTENTION_BACKENDS = ("auto", "xla", "pallas", "ring", "ulysses")


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Declarative parallelism layout (the JAX package's fields):
    ``data`` (``-1``: the rest of the devices), ``model``, ``seq``,
    ``pipe``, ``expert``, ``dcn_data``, ``microbatch`` (gradient
    accumulation), ``quantize``, ``attention`` (``auto``: ring when
    ``seq > 1``), ``fsdp`` and ``fsdp_min_size``.  Every layout parses
    and describes itself."""

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
        self.validate()

    def validate(self) -> None:
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
        if self.seq > 1 and self.attention in ("xla", "pallas"):
            raise ValueError(
                f"seq={self.seq} needs a sequence-parallel attention "
                f"backend (ring/ulysses/auto), got {self.attention!r}")

    def axis_sizes(self) -> dict[str, int]:
        """Mesh axis name -> size (``data`` may still be -1 here)."""
        return {DATA_AXIS: self.data, SEQ_AXIS: self.seq,
                PIPE_AXIS: self.pipe, EXPERT_AXIS: self.expert,
                MODEL_AXIS: self.model}

    def total_devices(self, n_available: int | None = None) -> int:
        """Devices this layout occupies (resolving ``data=-1`` against
        ``n_available``, which is then required)."""
        fixed = self.model * self.seq * self.pipe * self.expert
        if self.data != -1:
            return fixed * self.data
        if n_available is None:
            raise ValueError("data=-1 needs n_available to resolve")
        if n_available % fixed:
            raise ValueError(f"{n_available} devices not divisible by the "
                             f"fixed axes product {fixed}")
        return n_available

    def resolve(self, n_available: int) -> "ParallelConfig":
        """Concrete copy: ``data=-1`` filled in from ``n_available``."""
        total = self.total_devices(n_available)
        if total > n_available:
            raise ValueError(f"layout needs {total} devices, only "
                             f"{n_available} available")
        fixed = self.model * self.seq * self.pipe * self.expert
        return dataclasses.replace(self, data=total // fixed)

    def resolved_attention(self) -> str:
        """``auto`` resolved against the seq axis (ring when seq > 1)."""
        if self.attention != "auto":
            return self.attention
        return "ring" if self.seq > 1 else "xla"

    def describe(self) -> str:
        """Compact label, e.g. ``dp4-tp2-mb2-int8``."""
        parts = [f"dp{self.data}"]
        for tag, v in (("tp", self.model), ("sp", self.seq),
                       ("pp", self.pipe), ("ep", self.expert),
                       ("dcn", self.dcn_data)):
            if v > 1:
                parts.append(f"{tag}{v}")
        parts.append(f"mb{self.microbatch}")
        if self.quantize != "off":
            parts.append(self.quantize)
        if self.fsdp:
            parts.append("fsdp")
        return "-".join(parts)

    def build_mesh(self, devices: Sequence | None = None) -> Mesh:
        """The layout as a named mesh.  A fully concrete config takes a
        device prefix of the size it needs; ``data=-1`` spans every
        device (default: every visible card).  ``devices`` may repeat a
        device (positions sharing a card)."""
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("CUDA is not available; pass devices=")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        total = self.total_devices(len(devices))
        if total > len(devices):
            raise ValueError(f"layout {self.describe()} needs {total} "
                             f"devices, only {len(devices)} available")
        return create_mesh(data=self.data, model=self.model, seq=self.seq,
                           pipe=self.pipe, expert=self.expert,
                           devices=devices[:total], dcn_data=self.dcn_data)

    def batch_sharding(self, mesh: Mesh, *, stacked: bool = False) -> tuple:
        """The input-batch spec of this layout (``stacked``: the
        microstep-stacked layouts)."""
        return (stacked_batch_sharding(mesh) if stacked
                else batch_sharding(mesh))

    def place_state(self, mesh: Mesh, state: Any, rules: Any = None) -> Any:
        """Place a TrainState on ``mesh`` under this layout: FSDP, else
        the bundle's tensor-parallel ``rules`` (they engage only when the
        mesh has a non-trivial ``model``/``expert`` axis), else
        replicated; a mesh with ``data > 1`` gives every data row its own
        copy (:mod:`.sharding`)."""
        from .sharding import fsdp_state, replicate_state, shard_state
        use_rules = rules is not None and (
            mesh.shape[MODEL_AXIS] > 1 or mesh.shape[EXPERT_AXIS] > 1)
        if self.fsdp:
            return fsdp_state(mesh, state, rules if use_rules else None,
                              min_size=self.fsdp_min_size)
        if use_rules:
            return shard_state(mesh, state, rules)
        return replicate_state(mesh, state)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ParallelConfig":
        """Strict parse: unknown keys are an error (a typo'd profile key
        must never silently fall back to the default layout)."""
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown ParallelConfig key(s) {unknown}; "
                             f"known: {sorted(known)}")
        return cls(**d)

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


# The autotuner's artifact: the winning ParallelConfig with the workload,
# serving knobs and tuning evidence, as the JAX package writes it (its
# CLI's --profile is not ported yet: ROADMAP.md, item 8).
PROFILE_SCHEMA = "dtf_run_profile/v1"


def save_run_profile(path: str, parallel: ParallelConfig | None, *,
                     workload: dict | None = None,
                     serving: dict | None = None,
                     tuning: dict | None = None) -> dict:
    """Write a run profile; returns the payload written."""
    payload: dict[str, Any] = {"schema": PROFILE_SCHEMA}
    if parallel is not None:
        payload["parallel"] = parallel.to_dict()
    if workload:
        payload["workload"] = dict(workload)
    if serving:
        payload["serving"] = dict(serving)
    if tuning:
        payload["tuning"] = dict(tuning)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return payload


def load_run_profile(path: str) -> dict:
    """Read and validate a run profile: the schema is pinned, and the
    ``parallel`` section (when present) must parse into a
    ParallelConfig."""
    with open(path) as fh:
        payload = json.load(fh)
    if not isinstance(payload, dict) \
            or payload.get("schema") != PROFILE_SCHEMA:
        raise ValueError(
            f"{path} is not a {PROFILE_SCHEMA} run profile "
            f"(schema={payload.get('schema') if isinstance(payload, dict) else None!r})")
    if "parallel" in payload:
        ParallelConfig.from_dict(payload["parallel"])
    return payload
