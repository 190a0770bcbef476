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

FSDP (:func:`fsdp_state`, ZeRO-3 over ``data``): the data axis is the
sync trainer's worker processes, so each worker keeps its own slice of
every large parameter (and of its optimizer slots and moving average)
along the dimension JAX's :func:`fsdp_spec` picks, under the parameter's
own name; :class:`FsdpExchange` all-gathers them whole for a step and
reduce-scatters the gradients back (``parallel/sync.py``), and
:func:`gather_fsdp_named` / :func:`split_fsdp_named` turn checkpoint
trees between slices and whole arrays (the gather a collective: every
worker calls it).
"""

from __future__ import annotations

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
    """A fresh optimizer over the model's (new) parameters, carrying the
    old one's step count and its slots (``slots``: by the new names)."""
    old = state.optimizer
    state.optimizer = old.spec.init(state.model.parameters())
    state.optimizer.count = old.count
    for name, p in state.model.named_parameters():
        if name in slots and p in set(state.optimizer.params):
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


def replicate_state(mesh: Mesh, state: Any) -> Any:
    """Every parameter one tensor on the mesh's first device, used by
    every position: the data-parallel layout (the gradient sums over the
    positions that read it, through autograd; over workers, the
    all-reduce of :mod:`.sync`).  ``global_step`` and the rng stay as
    they are."""
    _move(state, mesh.model_devices()[0])
    return state


def shard_state(mesh: Mesh, state: Any, rules: ShardingRules) -> Any:
    """Place a TrainState under tensor-parallel ``rules``, IN PLACE (the
    model's parameters are replaced by their shards; the optimizer is
    rebuilt over them with its slots split the same way, as the JAX
    package's slots follow their parameter's path; the moving average
    too).  A rule that cannot partition its parameter prints the JAX
    package's warning and leaves it replicated.  ``global_step`` and the
    rng stay replicated.  The model's modules that hold a mesh (the GPT
    blocks' ``mesh``) take this one.  One process holds one data replica
    here: a mesh with ``data > 1`` beside ``model > 1`` raises."""
    from ..training.state import param_paths
    n_model = mesh.shape[MODEL_AXIS]
    if mesh.shape[DATA_AXIS] > 1 and n_model * mesh.shape[EXPERT_AXIS] > 1:
        raise NotImplementedError(
            f"data={mesh.shape[DATA_AXIS]} with model={n_model} or expert="
            f"{mesh.shape[EXPERT_AXIS]} in one process is not ported yet "
            "(the data axis is the worker processes); see ROADMAP.md, "
            "section 1, item 6, slice 8d")
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
    for module in model.modules():
        if hasattr(module, "mesh"):
            module.mesh = mesh
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
    """One parameter's FSDP split: this worker holds piece ``rank`` of
    ``world`` along ``dim`` of the ``shape`` (the parameter whole, or its
    tensor-parallel shard whole), by the composed ``spec``."""

    dim: int
    world: int
    rank: int
    shape: tuple
    spec: P


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
    largest free dim divisible by the workers, at least ``min_size``
    elements) shards over ``data`` keeps only this worker's slice, under
    its own name (recorded in its module's ``fsdp_shards``; the slice
    carries it as ``fsdp_info`` for the global norm,
    ``training/optimizers.global_norm``, and the optimizer's whole-leaf
    rules), and so do its optimizer slots
    (the optimizer is rebuilt over the slices) and its moving average.
    ``global_step`` and the rng stay replicated.

    ``data`` is the sync trainer's process group (the default group):
    its size is the JAX run's global data axis, so each worker's
    slice has the shape of JAX's ``addressable_shards[0]`` on a
    ``data=N`` mesh.  Without a group of two or more the state stays
    replicated, as a JAX mesh with ``data=1``.  ``rules`` with a
    non-trivial ``model`` axis first split the state over the mesh's
    positions (:func:`shard_state`); a tensor-parallel shard is then
    split over the workers along the dim the composed spec gives
    ``data`` (JAX's ``P("data", "model")``)."""
    import torch.distributed as dist
    if mesh.shape[DATA_AXIS] > 1:
        raise NotImplementedError(
            f"data={mesh.shape[DATA_AXIS]} in one process is not ported "
            "yet (the data axis is the worker processes); see ROADMAP.md, "
            "section 1, item 6, slice 8d")
    if rules is not None and mesh.shape[MODEL_AXIS] > 1:
        shard_state(mesh, state, rules)
    else:
        replicate_state(mesh, state)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if world < 2:
        return state
    if is_fsdp(state.model):
        raise ValueError("the state's parameters are FSDP-sharded already")
    from ..training.state import param_paths
    rank = dist.get_rank()
    model = state.model
    fsdp = FsdpRules(rules, world, min_size=min_size)
    named = dict(model.named_parameters())
    wholes = _whole_shapes(model)
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
            module, attr = _owner(model, name)
            piece = nn.Parameter(p.chunk(world, dim=dim)[rank].clone(),
                                 requires_grad=p.requires_grad)
            info = FsdpInfo(dim, world, rank, tuple(p.shape), spec)
            piece.fsdp_info = info
            if hasattr(p, "tp_split"):
                piece.tp_split = p.tp_split
            module._parameters[attr] = piece
            module.__dict__.setdefault("fsdp_shards", {})[attr] = info
            if name in slots:
                slots[name] = {k: _slot_piece(v, p.shape, world, dim, rank,
                                              p.device)
                               for k, v in slots[name].items()}
            if state.ema_params is not None:
                state.ema_params[name] = state.ema_params[name].chunk(
                    world, dim=dim)[rank].clone()
    _rebuild_optimizer(state, slots)
    return state


def fsdp_whole(piece: torch.Tensor, info: FsdpInfo) -> torch.Tensor:
    """The whole tensor of this worker's ``piece`` of a leaf split by
    ``info`` (an all-gather over the default process group: every worker
    calls it).  The pieces travel in fp32 (gloo's collectives and the
    sums are fp32) and the whole comes back in ``piece``'s dtype."""
    import torch.distributed as dist
    src = piece.detach().to(torch.float32).contiguous()
    stage = torch.empty((info.world * src.shape[0], *src.shape[1:]),
                        dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(stage, src)
    if info.dim == 0:
        whole = stage
    else:
        # gloo takes the output as the pieces stacked along dim 0.
        whole = torch.cat(stage.chunk(info.world), dim=info.dim)
        del stage
    return whole.to(piece.dtype)


class FsdpExchange:
    """The FSDP step's collectives over the workers (the default process
    group), one a split parameter: :meth:`gather` all-gathers each slice
    into a whole tensor of its own and swaps it in (as a leaf parameter
    the step's backward fills); :meth:`scatter` swaps the slices back and
    reduce-scatters each whole gradient, as the mean over the workers,
    into its slice's ``.grad``, releasing each whole gradient as it goes.
    A leaf split along dim 0 is gathered straight into its whole tensor
    and reduce-scattered straight from its gradient; along another dim it
    passes through a staging buffer of its own size (the pieces
    rank-major).  ``gather_s`` / ``scatter_s`` and ``calls`` accumulate
    each pass's time (the device work waited for before and after it,
    the staging copies included), as ``parallel/sync.GradientAllReduce``
    times its own."""

    def __init__(self, model: nn.Module):
        import torch.distributed as dist
        self._dist = dist
        self.entries = fsdp_entries(model)
        self.world = self.entries[0][3].world if self.entries else 1
        self.gather_s = self.scatter_s = 0.0
        self.calls = 0
        self._held = None

    def _sync(self, t: torch.Tensor) -> None:
        if t.is_cuda:
            torch.cuda.synchronize(t.device)

    def _gather_all(self, pieces: list, entries=None) -> list:
        import time
        if not pieces:
            return []
        self._sync(pieces[0])
        t0 = time.perf_counter()
        wholes = [fsdp_whole(p, info) for p, (_, _, _, info) in zip(
            pieces, self.entries if entries is None else entries)]
        self._sync(pieces[0])
        self.gather_s += time.perf_counter() - t0
        return wholes

    def gather(self) -> None:
        slices = [m._parameters[a] for _, m, a, _ in self.entries]
        wholes = self._gather_all(slices)
        for (_, module, attr, _), s, w in zip(self.entries, slices, wholes):
            module._parameters[attr] = nn.Parameter(
                w, requires_grad=s.requires_grad)
        self._held = slices

    def _release(self) -> list:
        """The slices swapped back into their modules; returns the whole
        parameters the step ran with (their only reference)."""
        slices, self._held = self._held, None
        if slices is None:
            return []
        wholes = []
        for (_, module, attr, _), s in zip(self.entries, slices):
            wholes.append(module._parameters[attr])
            module._parameters[attr] = s
        return wholes

    def scatter(self, scale: float = 1.0) -> None:
        """Each slice's ``.grad``: its piece of the whole gradient, summed
        over the workers, times ``scale``; the slices swapped back."""
        import time
        slices = self._held
        wholes = self._release()
        if not wholes:
            return
        self._sync(slices[0])
        t0 = time.perf_counter()
        for i, (s, (_, _, _, info)) in enumerate(zip(slices, self.entries)):
            w, wholes[i] = wholes[i], None
            g = w.grad if w.grad is not None else torch.zeros_like(w)
            w.grad = None
            del w
            g = g.detach().to(torch.float32)
            if info.dim == 0:
                g = g.contiguous()
            else:
                g = torch.cat(g.chunk(self.world, dim=info.dim))
            out = torch.empty(s.shape, dtype=torch.float32, device=g.device)
            self._dist.reduce_scatter_tensor(out, g)
            del g
            if scale != 1.0:
                out.mul_(scale)
            s.grad = out.to(s.device, s.dtype)
        self._sync(slices[0])
        self.scatter_s += time.perf_counter() - t0
        self.calls += 1

    def gather_named(self, named: dict) -> dict:
        """``{name: tensor}`` (parameters, slots or a moving average by
        parameter name) with every split entry's slice replaced by the
        whole tensor: a collective, every worker calls it.  A tensor of
        another shape than its slice (a slot its parameter's spec cannot
        partition, as adafactor's factored ``v_row``) is held whole by
        every worker and stays as it is."""
        out = dict(named)
        if any(e[0] not in out for e in self.entries):
            raise ValueError("gather_named needs every split parameter")
        split = [e for e in self.entries
                 if out[e[0]].shape == e[1]._parameters[e[2]].shape]
        for (name, *_), whole in zip(split, self._gather_all(
                [out[e[0]] for e in split], split)):
            out[name] = whole
        return out


def split_fsdp_named(model: nn.Module, named: dict) -> dict:
    """Inverse of :meth:`FsdpExchange.gather_named`: each split entry's
    whole tensor cut to this worker's slice (no collective); a tensor of
    another shape than the whole stays as it is."""
    out = dict(named)
    for name, _, _, info in fsdp_entries(model):
        if name in out and tuple(out[name].shape) == tuple(info.shape):
            out[name] = out[name].chunk(info.world, dim=info.dim)[info.rank]
    return out


class fsdp_gathered:
    """``with fsdp_gathered(model):`` the split parameters whole for the
    block (evaluation, a digest), the slices back after it; a collective
    on entry, every worker enters it.  A no-op for a model without
    FSDP splits."""

    def __init__(self, model: nn.Module):
        self.exchange = FsdpExchange(model) if is_fsdp(model) else None

    def __enter__(self):
        if self.exchange is not None:
            self.exchange.gather()
        return self

    def __exit__(self, *exc):
        if self.exchange is not None:
            self.exchange._release()
        return False
