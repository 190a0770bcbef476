"""Parameter-placement rules over a mesh's ``model`` and ``expert`` axes.

Counterpart of ``distributed_tensorflow_tpu/parallel/sharding.py``: an
ordered list of (regex, spec) rules matched against flax parameter paths
(``layer0/qkv/kernel``), the first match winning and no match meaning
replicated.  A spec is a :class:`P`, the ``PartitionSpec`` of the JAX
package: one entry per dimension, an axis name, a tuple of them or None.

Placement is single-controller, as :mod:`.mesh` is.  A parameter whose
spec fits splits into its shards along the dimension the ``model`` axis
(or the ``expert`` axis: the MoE's stacked expert weights) names: shard
``j`` is an ``nn.Parameter`` of its own, registered on the owning module
as ``<name>_shard<j>`` and living on the mesh device of that axis's
coordinate ``j`` (:meth:`.mesh.Mesh.axis_devices`).  The module
records the split in ``tp_shards`` (name -> :class:`ShardInfo`), and
:func:`full` gathers the whole tensor where a computation needs it.
Every other parameter stays one replicated tensor on the first device; a
copy carries it to the other positions and autograd sums its gradient.
Optimizer slots live per shard (a shard is a parameter to the optimizer),
as the JAX package's slots follow their parameter's path;
:func:`gather_named` and :func:`split_named` turn ``{name: tensor}``
dicts between the shard names and the whole names, so a checkpoint holds
whole arrays in the JAX layout.

**Data rows.**  A mesh with ``data > 1`` (the worker's local data
positions) gives every data row its own copy of the model, placed on
the row's positions as a one-row mesh would place it (``TrainState.rows``
holds rows 1..n-1; ``state.model`` is row 0, the lead).  The sync step
(``parallel/sync.py``) runs each row on its rows of the batch, takes the
gradients' mean over the rows and then over the workers, applies the
update once with the lead's optimizer and copies it into every other
row (:func:`copy_rows`), so every row holds the same bits.

FSDP (:func:`fsdp_state`, ZeRO-3 over ``data``): the data axis is
``worker processes x local positions``; each position keeps its own
slice of every large parameter (and of its optimizer slots and moving
average) along the dimension JAX's :func:`fsdp_spec` picks, under the
parameter's own name in its row's model; :class:`FsdpExchange` gathers
them whole for a step (the local slices joined, then an all-gather over
the workers) and reduce-scatters the gradients back (``parallel/
sync.py``), and :func:`split_fsdp_named` / :meth:`FsdpExchange.
gather_named` turn checkpoint trees between slices and whole arrays (the
gather a collective: every worker calls it).  Checkpoints hold the
unsharded tree: every data row is equal, so row 0's is written.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import re
from typing import Any, Sequence

import torch
from torch import nn

from .mesh import DATA_AXIS, EXPERT_AXIS, MODEL_AXIS, Mesh


class P(tuple):
    """``jax.sharding.PartitionSpec``: a tuple of per-dimension entries
    (an axis name, a tuple of axis names, or None), printed as JAX prints
    it."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    __str__ = __repr__


class ShardingRules:
    """Ordered (regex, :class:`P`) rules applied to flattened parameter
    paths.  First match wins; no match means replicated."""

    def __init__(self, rules: Sequence[tuple[str, P]] = ()) -> None:
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path: str, value: Any = None) -> P:
        for pat, spec in self._rules:
            if pat.search(path):
                return spec
        return P()

    def tree_shardings(self, mesh: Mesh, tree: Any,
                       warn_label: str | None = None) -> Any:
        """A tree of specs shaped like ``tree`` (nested dicts, lists and
        tuples of leaves with a ``shape``).  A spec that cannot partition
        its leaf (rank overflow or indivisible dim) falls back to
        replicated; ``warn_label`` (placing parameters, where that means a
        misconfigured rule) prints a warning naming the leaf."""
        def walk(node, path):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                return type(node)(walk(v, path + (i,))
                                  for i, v in enumerate(node))
            return self._fitted(mesh, path_str(path), node, warn_label)
        return walk(tree, ())

    def _fitted(self, mesh: Mesh, path: str, leaf: Any,
                warn_label: str | None) -> P:
        spec = self.spec_for(path, leaf)
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if not _spec_fits(mesh, spec, shape):
            if warn_label is not None:
                print(f"WARNING: sharding rule {spec} cannot partition "
                      f"{warn_label} {path} {shape} on this "
                      "mesh — leaving it replicated")
            spec = P()
        return spec


def _spec_fits(mesh: Mesh, spec: P, shape: tuple) -> bool:
    """True when ``spec`` can partition an array of ``shape`` on ``mesh``:
    no more entries than dims, and every assigned dim divisible by the
    product of its mesh axes."""
    if len(spec) > len(shape):
        return False
    for dim, entry in zip(shape, spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        need = math.prod(mesh.shape[a] for a in axes)
        if dim % need:
            return False
    return True


def path_str(path: tuple) -> str:
    """A key path as ``a/b/c`` for regex matching."""
    return "/".join(str(k) for k in path)


REPLICATED_RULES = ShardingRules(())


# ------------------------------------------------------------ placement


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """How one parameter is split: along ``dim`` into the parameters
    ``names`` (in the coordinate order of the axis ``spec`` names), by
    ``spec``."""

    dim: int
    names: tuple
    spec: P


def _infos(module: nn.Module) -> dict:
    return module.__dict__.get("tp_shards", {})


def shards(module: nn.Module, name: str) -> list | None:
    """The shards of ``module``'s parameter ``name`` in model-coordinate
    order, or None where it is not sharded."""
    info = _infos(module).get(name)
    if info is None:
        return None
    return [module._parameters[n] for n in info.names]


def shard_dim(module: nn.Module, name: str) -> int | None:
    """The dimension ``name`` is split along, or None."""
    info = _infos(module).get(name)
    return None if info is None else info.dim


def full(module: nn.Module, name: str):
    """``module``'s parameter ``name`` whole: itself, or its shards
    concatenated on shard 0's device (differentiable: the gradient goes
    back to each shard)."""
    parts = shards(module, name)
    if parts is None:
        return getattr(module, name)
    home = parts[0].device
    return torch.cat([p.to(home) for p in parts], dim=shard_dim(module, name))


def is_sharded(model: nn.Module) -> bool:
    return any(_infos(m) for m in model.modules())


def _sharded_entries(model: nn.Module):
    """``(whole name, ShardInfo, shard names)`` of every sharded
    parameter of ``model``."""
    for prefix, module in model.named_modules():
        for name, info in _infos(module).items():
            pre = f"{prefix}." if prefix else ""
            yield pre + name, info, [pre + n for n in info.names]


def gather_named(model: nn.Module, named: dict) -> dict:
    """``{state_dict name: tensor}`` with every sharded parameter's shards
    (by their names) replaced by the whole tensor under its own name
    (shards absent from ``named`` are left out).  A tensor of another
    shape than its shard (an optimizer slot that the parameter's spec
    cannot partition, as adafactor's factored ``v_row``) is held whole
    by every shard: shard 0's is the whole."""
    out = dict(named)
    for whole, info, names in _sharded_entries(model):
        if not all(n in out for n in names):
            continue
        parts = [out.pop(n) for n in names]
        if tuple(parts[0].shape) != _shard_shape(model, names[0]):
            out[whole] = parts[0]
            continue
        home = parts[0].device
        out[whole] = torch.cat([p.to(home) for p in parts], dim=info.dim)
    return out


def _shard_shape(model: nn.Module, name: str) -> tuple:
    """The shape of shard ``name`` whole: its FSDP slices gathered."""
    p = model.get_parameter(name)
    info = getattr(p, "fsdp_info", None)
    return tuple(info.shape) if info is not None else tuple(p.shape)


def split_named(model: nn.Module, named: dict) -> dict:
    """Inverse of :func:`gather_named`: whole tensors split into the
    shards' names (each piece on the whole tensor's device); a tensor of
    another shape than the whole parameter goes whole to every shard."""
    out = dict(named)
    for whole, info, names in _sharded_entries(model):
        if whole in out:
            t = out.pop(whole)
            shape = list(_shard_shape(model, names[0]))
            shape[info.dim] *= len(names)
            pieces = (t.chunk(len(names), dim=info.dim)
                      if tuple(t.shape) == tuple(shape)
                      else [t] * len(names))
            for n, piece in zip(names, pieces):
                out[n] = piece
    return out


def _split_axis(mesh: Mesh, spec: P) -> tuple:
    """``(dim, axis)``: the dimension ``spec`` puts on a non-trivial
    ``model`` or ``expert`` axis, and that axis (``(None, None)``: the
    leaf is replicated over the mesh).  ``data`` is the worker processes
    (:func:`fsdp_state` splits over it, not this mesh); any other axis it
    names must have size 1, and one leaf splits over one axis."""
    dim = found = None
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            if mesh.shape[axis] == 1 or axis == DATA_AXIS:
                continue
            if axis not in (MODEL_AXIS, EXPERT_AXIS):
                raise ValueError(
                    f"a parameter's spec {spec} names the {axis!r} axis, "
                    "which holds no parameter shard")
            if found is not None:
                raise ValueError(
                    f"spec {spec} splits one parameter over two "
                    "in-process axes")
            dim, found = i, axis
    return dim, found


def _data_dim(spec: P) -> int | None:
    """The dimension ``spec`` puts on ``data`` (None: not sharded)."""
    for i, entry in enumerate(spec):
        if entry is not None and DATA_AXIS in (
                entry if isinstance(entry, tuple) else (entry,)):
            return i
    return None


def _owner(model: nn.Module, name: str):
    prefix, _, attr = name.rpartition(".")
    return (model.get_submodule(prefix) if prefix else model), attr


def _named_slots(state) -> dict:
    """``{parameter name: optimizer slot dict}`` of ``state``."""
    own = state.optimizer.base.state
    return {n: own[p] for n, p in state.model.named_parameters()
            if p in own}


def _slot_piece(v, shape, n: int, dim: int, j: int, device):
    """Shard ``j``'s part of one optimizer slot: a tensor of the
    parameter's shape split as the parameter is, any other tensor (Adam's
    step count) copied: each shard's optimizer updates its own."""
    if not torch.is_tensor(v):
        return v
    if v.shape == shape:
        return v.chunk(n, dim=dim)[j].to(device).clone()
    return v.clone()


def _rebuild_optimizer(state, slots: dict) -> None:
    """A fresh optimizer over the state's (new) parameters
    (:func:`state_params`), carrying the old one's step count and its
    slots (``slots``: by the new names)."""
    old = state.optimizer
    named = state_params(state)
    state.optimizer = old.spec.init(named.values())
    state.optimizer.count = old.count
    held = set(state.optimizer.params)
    for name, p in named.items():
        if name in slots and p in held:
            state.optimizer.base.state[p] = slots[name]


def _move(state, home: torch.device) -> None:
    """Every parameter that is not sharded (and its slots and moving
    average) onto ``home``, the mesh's first device, and the model's
    buffers (its non-trainable state, ``TrainState.model_state``: the
    same tensors, moved in place, stay replicated)."""
    with torch.no_grad():
        for buf in state.model.buffers():
            if buf.device != home:
                buf.data = buf.data.to(home)
        for name, p in state.model.named_parameters():
            if p.device != home:
                p.data = p.data.to(home)
                for key, v in state.optimizer.base.state.get(p, {}).items():
                    if torch.is_tensor(v) and v.dim():
                        state.optimizer.base.state[p][key] = v.to(home)
                if state.ema_params is not None:
                    state.ema_params[name] = state.ema_params[name].to(home)


# ------------------------------------------------------------- data rows


def row_models(state) -> list:
    """Every local data row's model: the lead (``state.model``), then
    ``state.rows``."""
    return [state.model, *(getattr(state, "rows", None) or ())]


def state_params(state) -> dict:
    """``{name: parameter}`` that ``state``'s optimizer updates and its
    checkpoint holds: the lead row's parameters and, under FSDP over
    local positions, every other row's slices as ``<name>@<row>``."""
    named = dict(state.model.named_parameters())
    for r, model in enumerate(getattr(state, "rows", None) or (), start=1):
        for name, p in model.named_parameters():
            if getattr(p, "fsdp_info", None) is not None:
                named[f"{name}@{r}"] = p
    return named


def _set_mesh(model: nn.Module, mesh: Mesh) -> None:
    """The model's modules that hold a mesh (the GPT blocks' ``mesh``)
    take ``mesh``."""
    for module in model.modules():
        if hasattr(module, "mesh"):
            module.mesh = mesh


def _place_rows(mesh: Mesh, state: Any, place) -> Any:
    """``place(row_mesh, state)`` for every data row of ``mesh``.  Row 0
    is ``state`` itself (the lead); every other row places a deep copy of
    the model as it was before (a throwaway state carries it through
    ``place``), and ``state.rows`` keeps those models,
    ``state.row_devices`` each row's first device (where its rows of the
    batch go) and ``state.row_slices`` the rows by DCN slice."""
    n = mesh.shape[DATA_AXIS]
    if n == 1:
        return place(mesh, state)
    if getattr(state, "rows", None):
        raise ValueError("the state's data rows are placed already")
    from ..training.state import TrainState
    template = copy.deepcopy(state.model)
    place(mesh.row(0), state)
    rows = []
    for r in range(1, n):
        model = template if r == n - 1 else copy.deepcopy(template)
        row = TrainState(model=model,
                         optimizer=state.optimizer.spec.init(
                             model.parameters()),
                         params_to_tree=state.params_to_tree,
                         params_from_tree=state.params_from_tree)
        place(mesh.row(r), row)
        if isinstance(getattr(model, "device", None), torch.device):
            # The model's own device: where its inputs go.
            model.device = mesh.row(r).model_devices()[0]
        rows.append(row.model)
    state.rows = rows
    state.row_devices = [mesh.row(r).model_devices()[0] for r in range(n)]
    state.row_slices = mesh.row_slices()
    return state


@torch.no_grad()
def copy_rows(state: Any) -> None:
    """Every other data row takes the lead's parameters (each row keeps
    its own FSDP slices) and buffers (BatchNorm's running statistics):
    the update applied once, given to every row."""
    rows = getattr(state, "rows", None)
    if not rows:
        return
    lead = dict(state.model.named_parameters())
    bufs = dict(state.model.named_buffers())
    for model in rows:
        dst, src = [], []
        for name, p in model.named_parameters():
            if getattr(p, "fsdp_info", None) is None:
                dst.append(p)
                src.append(lead[name].to(p.device))
        for name, b in model.named_buffers():
            dst.append(b)
            src.append(bufs[name].to(b.device))
        if dst:
            torch._foreach_copy_(dst, src)


def replicate_state(mesh: Mesh, state: Any) -> Any:
    """Every parameter one tensor on the mesh's first device, used by
    every position of a data row: the data-parallel layout (the gradient
    sums over the positions that read it, through autograd; over the data
    rows and workers, the reductions of :mod:`.sync`).  With ``data >
    1`` each row holds a copy on its own first device.  ``global_step``
    and the rng stay as they are."""
    def place(row_mesh, st):
        _move(st, row_mesh.model_devices()[0])
        if mesh.shape[DATA_AXIS] > 1:
            _set_mesh(st.model, row_mesh)
        return st
    return _place_rows(mesh, state, place)


def shard_state(mesh: Mesh, state: Any, rules: ShardingRules) -> Any:
    """Place a TrainState under tensor-parallel ``rules``, IN PLACE (the
    model's parameters are replaced by their shards; the optimizer is
    rebuilt over them with its slots split the same way, as the JAX
    package's slots follow their parameter's path; the moving average
    too).  A rule that cannot partition its parameter prints the JAX
    package's warning and leaves it replicated.  ``global_step`` and the
    rng stay replicated.  The model's modules that hold a mesh (the GPT
    blocks' ``mesh``) take this one.  With ``data > 1`` every data row
    holds its own copy of its shards, on the row's positions."""
    return _place_rows(mesh, state,
                       lambda row_mesh, st: _shard_row(row_mesh, st, rules))


def _shard_row(mesh: Mesh, state: Any, rules: ShardingRules) -> Any:
    from ..training.state import param_paths
    model = state.model
    if is_sharded(model):
        raise ValueError("the state's parameters are sharded already")
    home = mesh.model_devices()[0]
    _move(state, home)
    named = dict(model.named_parameters())
    paths = param_paths(named, state.params_to_tree)
    slots = _named_slots(state)
    with torch.no_grad():
        # In the JAX tree's order (keys sorted at every level), so the
        # warnings come in the JAX package's order.
        for name in sorted(named, key=lambda n: paths[n].split("/")):
            p = named[name]
            spec = rules._fitted(mesh, paths[name], p, "param")
            dim, axis = _split_axis(mesh, spec)
            if dim is None:
                continue
            devices = mesh.axis_devices(axis)
            n = len(devices)
            module, attr = _owner(model, name)
            del module._parameters[attr]
            names = tuple(f"{attr}_shard{j}" for j in range(n))
            pre = name[:len(name) - len(attr)]
            # One key per split parameter: the optimizer's rules that read
            # a whole leaf group its shards by it.
            key = object()
            for j, (sn, piece) in enumerate(zip(names, p.chunk(n, dim=dim))):
                shard = nn.Parameter(piece.to(devices[j]).clone(),
                                     requires_grad=p.requires_grad)
                shard.tp_split = (key, j, n, dim)
                module.register_parameter(sn, shard)
            module.__dict__.setdefault("tp_shards", {})[attr] = ShardInfo(
                dim, names, spec)
            whole_slots = slots.pop(name, None)
            if whole_slots is not None:
                for j, sn in enumerate(names):
                    slots[pre + sn] = {
                        k: _slot_piece(v, p.shape, n, dim, j, devices[j])
                        for k, v in whole_slots.items()}
            if state.ema_params is not None:
                ema = state.ema_params.pop(name)
                for j, (sn, piece) in enumerate(zip(names, ema.chunk(
                        n, dim=dim))):
                    state.ema_params[pre + sn] = piece.to(devices[j]).clone()
    _rebuild_optimizer(state, slots)
    _set_mesh(model, mesh)
    return state


def apply_rules(mesh: Mesh, tree: Any, rules: ShardingRules,
                warn_label: str | None = None) -> Any:
    """A tree of arrays or tensors as its per-leaf shard lists: each
    leaf whose fitted spec splits it over ``model`` (or ``expert``)
    becomes the list of its pieces (piece ``j`` on that axis's device
    ``j``), every other leaf a one-element list on the first device."""
    home = mesh.model_devices()[0]
    specs = rules.tree_shardings(mesh, tree, warn_label)

    def place(leaf, spec):
        t = torch.as_tensor(leaf)
        dim, axis = _split_axis(mesh, spec)
        if dim is None:
            return [t.to(home)]
        devices = mesh.axis_devices(axis)
        return [x.to(d) for x, d in zip(t.chunk(len(devices), dim=dim),
                                        devices)]

    def walk(node, spec):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not isinstance(node, P):
            return type(node)(walk(v, s) for v, s in zip(node, spec))
        return place(node, spec)
    return walk(tree, specs)


# ------------------------------------------------------------------ FSDP


def fsdp_spec(base: P, shape: tuple, axis_size: int, *,
              axis_name: str = DATA_AXIS, min_size: int = 2 ** 16) -> P:
    """Extend ``base`` (a TP spec or ``P()``) with the data axis, ZeRO/FSDP:
    the LARGEST dim of ``shape`` not claimed by ``base`` and divisible by
    ``axis_size`` shards over ``axis_name``.  Leaves smaller than
    ``min_size`` elements keep the base spec; ``base`` comes back
    unchanged when no dim qualifies."""
    if axis_size <= 1 or math.prod(shape) < min_size or len(base) > len(shape):
        return base
    entries = list(base) + [None] * (len(shape) - len(base))
    best = -1
    for i, (e, d) in enumerate(zip(entries, shape)):
        if e is None and d % axis_size == 0 and (best < 0 or d > shape[best]):
            best = i
    if best < 0:
        return base
    entries[best] = axis_name
    return P(*entries)


class FsdpRules(ShardingRules):
    """Shape-aware rule set: the TP rules first, then FSDP over the data
    axis (:func:`fsdp_spec`)."""

    def __init__(self, base: ShardingRules | None, axis_size: int, *,
                 min_size: int = 2 ** 16) -> None:
        super().__init__(())
        self._base = base or REPLICATED_RULES
        self._axis_size = axis_size
        self._min_size = min_size

    def spec_for(self, path: str, value: Any = None) -> P:
        base = self._base.spec_for(path, value)
        shape = tuple(getattr(value, "shape", ()) or ())
        if not shape:
            return base
        return fsdp_spec(base, shape, self._axis_size,
                         min_size=self._min_size)


@dataclasses.dataclass(frozen=True)
class FsdpInfo:
    """One parameter's FSDP split: this position holds piece ``rank`` of
    ``world`` along ``dim`` of the ``shape`` (the parameter whole, or its
    tensor-parallel shard whole), by the composed ``spec``.  ``world`` is
    the whole data axis, ``workers x local``, and ``rank`` the position's
    index on it (worker-major: a worker's ``local`` positions hold
    consecutive pieces)."""

    dim: int
    world: int
    rank: int
    shape: tuple
    spec: P
    local: int = 1

    @property
    def workers(self) -> int:
        return self.world // self.local


def _fsdp_infos(module: nn.Module) -> dict:
    return module.__dict__.get("fsdp_shards", {})


def fsdp_entries(model: nn.Module) -> list:
    """``(state_dict name, module, attribute, FsdpInfo)`` of every
    parameter of ``model`` split over the workers, in ``named_modules``
    order (the same on every worker)."""
    out = []
    for prefix, module in model.named_modules():
        for attr, info in _fsdp_infos(module).items():
            out.append(((f"{prefix}." if prefix else "") + attr, module,
                        attr, info))
    return out


def is_fsdp(model: nn.Module) -> bool:
    return any(_fsdp_infos(m) for m in model.modules())


def _whole_shapes(model: nn.Module) -> dict:
    """``{parameter name: (whole name, whole shape)}``: a tensor-parallel
    shard maps to the parameter it splits."""
    out = {n: (n, tuple(p.shape)) for n, p in model.named_parameters()}
    for whole, info, names in _sharded_entries(model):
        shape = list(out[names[0]][1])
        shape[info.dim] *= len(names)
        for n in names:
            out[n] = (whole, tuple(shape))
    return out


def fsdp_state(mesh: Mesh, state: Any, rules: ShardingRules | None = None,
               *, min_size: int = 2 ** 16) -> Any:
    """ZeRO-3/FSDP placement, IN PLACE: each parameter that
    :class:`FsdpRules` (the tensor-parallel ``rules`` first, then the
    largest free dim divisible by the data axis, at least ``min_size``
    elements) shards over ``data`` keeps only each position's slice, under
    its own name in the position's row model (recorded in its module's
    ``fsdp_shards``; the slice carries it as ``fsdp_info`` for the global
    norm, ``training/optimizers.global_norm``, and the optimizer's
    whole-leaf rules), and so do its optimizer slots (the lead's
    optimizer is rebuilt over every row's slices, :func:`state_params`)
    and its moving average.  ``global_step`` and the rng stay replicated.

    The data axis is ``workers x local positions``: the sync trainer's
    process group (the default group) times ``mesh``'s ``data`` rows, so
    each position's slice has the shape of JAX's ``addressable_shards``
    on a mesh with that data axis.  With a data axis of one the state
    stays replicated, as a JAX mesh with ``data=1``.  ``rules`` with a
    non-trivial ``model`` axis first split the state over the mesh's
    positions (:func:`shard_state`, every data row its own shards); a
    tensor-parallel shard is then split over ``workers x local rows``
    along the dim the composed spec gives ``data`` (JAX's ``P("data",
    "model")``): each position holds JAX's addressable shard."""
    import torch.distributed as dist
    n = mesh.shape[DATA_AXIS]
    tp = rules is not None and mesh.shape[MODEL_AXIS] > 1
    if tp:
        shard_state(mesh, state, rules)
    else:
        replicate_state(mesh, state)
    workers = (dist.get_world_size()
               if dist.is_available() and dist.is_initialized() else 1)
    world = workers * n
    if world < 2:
        return state
    if is_fsdp(state.model):
        raise ValueError("the state's parameters are FSDP-sharded already")
    from ..training.state import param_paths
    rank = dist.get_rank() * n if workers > 1 else 0
    models = row_models(state)
    fsdp = FsdpRules(rules, world, min_size=min_size)
    named = dict(state.model.named_parameters())
    wholes = _whole_shapes(state.model)
    paths = param_paths({w for w, _ in wholes.values()},
                        state.params_to_tree)
    slots = _named_slots(state)
    with torch.no_grad():
        for name, p in named.items():
            whole, shape = wholes[name]
            spec = fsdp._fitted(mesh, paths[whole],
                                torch.empty(shape, device="meta"), None)
            dim = _data_dim(spec)
            if dim is None:
                continue
            whole_slots = slots.pop(name, None)
            ema = (state.ema_params.pop(name)
                   if state.ema_params is not None else None)
            # The local slices of one leaf: one leaf to the optimizer.
            key = object()
            for r, model in enumerate(models):
                q = model.get_parameter(name)
                module, attr = _owner(model, name)
                pos = rank + r
                piece = nn.Parameter(q.chunk(world, dim=dim)[pos].clone(),
                                     requires_grad=q.requires_grad)
                info = FsdpInfo(dim, world, pos, tuple(q.shape), spec, n)
                piece.fsdp_info = info
                if n > 1:
                    piece.fsdp_local = (key, r)
                if hasattr(q, "tp_split"):
                    piece.tp_split = q.tp_split
                module._parameters[attr] = piece
                module.__dict__.setdefault("fsdp_shards", {})[attr] = info
                label = row_name(name, r)
                if whole_slots is not None:
                    slots[label] = {k: _slot_piece(v, p.shape, world, dim,
                                                   pos, q.device)
                                    for k, v in whole_slots.items()}
                if ema is not None:
                    state.ema_params[label] = ema.chunk(
                        world, dim=dim)[pos].to(q.device).clone()
    _rebuild_optimizer(state, slots)
    return state


def row_name(name: str, r: int) -> str:
    """The :func:`state_params` name of row ``r``'s slice of ``name``."""
    return name if r == 0 else f"{name}@{r}"


def fsdp_whole(pieces: Sequence[torch.Tensor],
               info: FsdpInfo) -> torch.Tensor:
    """The whole tensor of one worker's local ``pieces`` (its positions'
    slices in row order) of a leaf split by ``info``: the pieces joined
    on the first one's device, then, with several workers, an all-gather
    over the default process group (every worker calls it).  The
    pieces travel in fp32 (gloo's collectives and the sums are fp32)
    and the whole comes back in the pieces' dtype."""
    import torch.distributed as dist
    if torch.is_tensor(pieces):
        pieces = [pieces]
    home = pieces[0].device
    chunk = (pieces[0] if len(pieces) == 1 else torch.cat(
        [t.detach().to(home) for t in pieces], dim=info.dim))
    if info.workers == 1:
        return chunk.detach().clone() if len(pieces) == 1 else chunk
    src = chunk.detach().to(torch.float32)
    if info.dim != 0 or not src.is_contiguous():
        # gloo takes the input and output as pieces stacked along dim 0.
        src = src.contiguous()
    stage = torch.empty((info.workers * src.shape[0], *src.shape[1:]),
                        dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(stage, src)
    if info.dim == 0:
        whole = stage
    else:
        whole = torch.cat(stage.chunk(info.workers), dim=info.dim)
        del stage
    return whole.to(pieces[0].dtype)


class FsdpExchange:
    """The FSDP step's collectives over the data axis, one a split
    parameter, for the row models ``models`` (a state's
    :func:`row_models`, or one model): :meth:`gather` joins each
    parameter's local slices and all-gathers them over the workers into a
    whole tensor, and swaps it in (as a leaf parameter the step's
    backward fills; the rows on one device share it, so their gradients
    add up in one tensor); :meth:`scatter` swaps the slices back, sums
    each whole gradient over the devices that hold one, reduce-scatters
    it over the workers and gives each row's slice its piece, as the mean
    over the data axis, releasing each whole gradient as it goes.  A
    leaf split along dim 0 is gathered straight into its whole tensor
    and reduce-scattered straight from its gradient; along another dim
    it passes through a staging buffer of its own size (the pieces
    worker-major).  ``gather_s`` / ``scatter_s`` and ``calls``
    accumulate each pass's time (the device work waited for before and
    after it, the staging copies included), as ``parallel/sync.
    GradientAllReduce`` times its own."""

    def __init__(self, models):
        import torch.distributed as dist
        self._dist = dist
        models = [models] if isinstance(models, nn.Module) else list(models)
        self.rows = [fsdp_entries(m) for m in models]
        self.entries = self.rows[0]
        self.gather_s = self.scatter_s = 0.0
        self.calls = 0
        self._held = None

    def _sync(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def _slices(self, i: int) -> list:
        """Entry ``i``'s slice in every row (row order)."""
        return [row[i][1]._parameters[row[i][2]] for row in self.rows]

    def _gather_all(self, pieces: list, entries=None) -> list:
        import time
        if not pieces:
            return []
        self._sync(pieces[0][0])
        t0 = time.perf_counter()
        wholes = [fsdp_whole(p, info) for p, (_, _, _, info) in zip(
            pieces, self.entries if entries is None else entries)]
        self._sync(pieces[0][0])
        self.gather_s += time.perf_counter() - t0
        return wholes

    def gather(self) -> None:
        held = [self._slices(i) for i in range(len(self.entries))]
        wholes = self._gather_all(held)
        for i, (w, slices) in enumerate(zip(wholes, held)):
            by_device: dict = {}
            for row, s in zip(self.rows, slices):
                _, module, attr, _ = row[i]
                if s.device not in by_device:
                    by_device[s.device] = nn.Parameter(
                        w.to(s.device), requires_grad=s.requires_grad)
                module._parameters[attr] = by_device[s.device]
        self._held = held

    def _release(self) -> list:
        """The slices swapped back into their modules; returns, a split
        parameter, the whole parameters the step ran with (one a device
        that held one, their only references)."""
        held, self._held = self._held, None
        if held is None:
            return []
        wholes = []
        for i, slices in enumerate(held):
            seen = []
            for row, s in zip(self.rows, slices):
                _, module, attr, _ = row[i]
                w = module._parameters[attr]
                if not any(w is x for x in seen):
                    seen.append(w)
                module._parameters[attr] = s
            wholes.append(seen)
        return wholes

    def scatter(self, scale: float = 1.0) -> None:
        """Each slice's ``.grad``: its piece of the whole gradient, summed
        over the data axis, times ``scale``; the slices swapped back."""
        import time
        held = self._held
        wholes = self._release()
        if not wholes:
            return
        self._sync(held[0][0])
        t0 = time.perf_counter()
        for i, (slices, (_, _, _, info)) in enumerate(zip(held,
                                                          self.entries)):
            ws, wholes[i] = wholes[i], None
            home = slices[0].device
            g = None
            for w in ws:
                x = (w.grad if w.grad is not None
                     else torch.zeros_like(w)).detach().to(home,
                                                           torch.float32)
                g = x if g is None else g.add_(x)
                w.grad = None
            del ws
            if info.workers > 1:
                if info.dim != 0:
                    g = torch.cat(g.chunk(info.workers, dim=info.dim))
                g = g.contiguous()
                shape = list(slices[0].shape)
                shape[info.dim] *= info.local
                out = torch.empty(shape, dtype=torch.float32, device=home)
                self._dist.reduce_scatter_tensor(out, g)
                g = out
            if scale != 1.0:
                g = g.mul_(scale)
            for s, part in zip(slices, g.chunk(info.local, dim=info.dim)):
                s.grad = torch.empty_like(s).copy_(part)
            del g
        self._sync(held[0][0])
        self.scatter_s += time.perf_counter() - t0
        self.calls += 1

    def gather_named(self, named: dict) -> dict:
        """``{name: tensor}`` (parameters, slots or a moving average by
        :func:`state_params` name) with every split entry's slices (the
        lead's under its name, row ``r``'s as ``<name>@<r>``) replaced by
        the whole tensor under its name: a collective, every worker calls
        it.  A tensor of another shape than its slice (a slot its
        parameter's spec cannot partition, as adafactor's factored
        ``v_row``) is held whole by every position and stays as it is."""
        out = dict(named)
        split, pieces = [], []
        for name, module, attr, info in self.entries:
            labels = [row_name(name, r) for r in range(len(self.rows))]
            if any(label not in out for label in labels):
                raise ValueError("gather_named needs every split parameter")
            got = [out.pop(label) for label in labels]
            out[name] = got[0]
            if got[0].shape == module._parameters[attr].shape:
                split.append((name, module, attr, info))
                pieces.append(got)
        for (name, *_), whole in zip(split, self._gather_all(pieces, split)):
            out[name] = whole
        return out


def split_fsdp_named(model: nn.Module, named: dict) -> dict:
    """Inverse of :meth:`FsdpExchange.gather_named` for the lead row
    ``model``: each split entry's whole tensor cut to this worker's
    positions' slices (the lead's under its name, row ``r``'s as
    ``<name>@<r>``; no collective); a tensor of another shape than the
    whole goes to every row as it is."""
    out = dict(named)
    for name, _, _, info in fsdp_entries(model):
        if name not in out:
            continue
        t = out[name]
        whole = tuple(t.shape) == tuple(info.shape)
        pieces = t.chunk(info.world, dim=info.dim) if whole else None
        for r in range(info.local):
            out[row_name(name, r)] = (pieces[info.rank + r] if whole
                                      else t)
    return out


class fsdp_gathered:
    """``with fsdp_gathered(state):`` the split parameters whole for the
    block (evaluation, a digest; ``state`` a TrainState, its data rows
    with it, or one model), the slices back after it; a collective on
    entry, every worker enters it.  A no-op for a model without FSDP
    splits."""

    def __init__(self, state):
        models = (row_models(state) if hasattr(state, "optimizer")
                  else [state])
        self.exchange = (FsdpExchange(models) if is_fsdp(models[0])
                         else None)

    def __enter__(self):
        if self.exchange is not None:
            self.exchange.gather()
        return self

    def __exit__(self, *exc):
        if self.exchange is not None:
            self.exchange._release()
        return False
