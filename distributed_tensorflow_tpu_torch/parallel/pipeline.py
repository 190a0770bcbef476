"""Pipeline parallelism: layer stages over the ``pipe`` mesh axis.

Counterpart of ``distributed_tensorflow_tpu/parallel/pipeline.py``.
There each pipe rank is a device of a ``shard_map`` program, the
schedule is a ``lax.scan`` over ticks and an activation hop is a
``ppermute``.  Here the pipe axis lives in one process or crosses
processes (``parallel/mesh.global_mesh``).  In one process that process
drives every stage (single controller, as :mod:`.mesh` and the ring
do), stage ``s`` lives on the mesh's pipe device ``s``
(:meth:`.mesh.Mesh.pipe_devices`; on one card they share it) and a hop
is a ``.to(device)`` of the activation onto the next stage's device.
Across processes each pipe rank holds its own chunks and runs only its
own slots of the schedule; at the end of each tick the tick's
activations go forward and its cotangents back in one batch of sends and
receives over the pipe group (:func:`.transport.exchange`; both ends
derive the batch from the static table), and the loss and aux metrics
of the last stage reach every pipe rank as JAX's one-hot ``psum``.  The
schedules are the JAX package's, as static Python tables:

- **GPipe** (:func:`make_pipeline_fn`): the batch cut into ``n_micro``
  micro-batches, stage ``s`` runs micro-batch ``m`` at tick ``s + m``;
  the backward is autograd through the tick loop, ``remat`` recomputes
  each stage in it (``torch.utils.checkpoint``, as ``jax.checkpoint`` in
  JAX).  Its train step is the plain sync step over a loss that runs
  the schedule (``models/gpt.make_pipelined_gpt_apply``).  Autograd
  cannot run through ticks across processes: there GPipe's step is
  :func:`build_gpipe_train_step`, its forward slots and then its
  backward slots (:func:`schedule_gpipe`) run as 1F1B's are, the same
  gradients as autograd's in one process.
- **1F1B** (:func:`schedule_1f1b`, :func:`build_1f1b_pipeline_train_step`)
  and **interleaved 1F1B** (:func:`schedule_interleaved`,
  :func:`build_interleaved_1f1b_train_step`): each tick a stage may run
  one forward and one backward.  Only each in-flight micro-batch's stage
  input is stashed; the backward slot recomputes the stage forward from
  it and calls ``torch.autograd.backward`` with the cotangent the next
  stage sent (the loss gradient at the last stage), accumulating the
  parameter gradients.  So activation memory is bounded by the pipe
  depth, not the micro-batch count, and no autograd runs through the
  schedule.  The embedding runs outside the stages on the whole batch
  and takes its gradient from stage 0's input cotangents; the loss is
  the mean over micro-batches.

An idle slot of a schedule (JAX's ``-1``, a masked no-op of a static
shape there) launches nothing here.  A forward slot of the LAST chunk
only stashes its input: JAX computes that stage output and discards it
(its ``ppermute`` goes back to rank 0, which ignores it), and the
backward slot recomputes it.

The step builders take the port's state (``state.model`` with ``embed``,
``stages`` and ``head``: ``stages[c]`` is global chunk ``c``, on pipe
device ``c % n_pipe``, as ``models/gpt.PipelinedGptLM`` lays them out)
where JAX's take the ``{"embed", "stages", "head"}`` parameter tree
placed by ``shard_stacked_params``/``shard_interleaved_params``;
``stage_fn(stage, x)``, ``loss_head_fn(head, y, micro_batch)`` and
``embed_fn(embed, batch)`` keep JAX's meaning.
The data axis is ``worker processes x local rows``: each local data
row holds a pipelined copy of the model on its own pipe positions
(``parallel/sharding._place_rows``) and runs the schedule on its rows of
the batch; the rows' gradients add, and with ``all_reduce``
(``parallel/sync.GradientAllReduce`` over the ranks that share this
pipe coordinate) the step takes the mean over the workers, as the plain
sync step does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.pytree import tree_leaves, tree_map
from .mesh import PIPE_AXIS, Mesh


def _device_of(stage) -> torch.device:
    """Where a stage's parameters live (its input goes there)."""
    if isinstance(stage, torch.nn.Module):
        return next(stage.parameters()).device
    return tree_leaves(stage)[0].device


def _stage(stage_params: Any, c: int):
    """Chunk ``c`` of ``stage_params``: a sequence of per-chunk entries
    (a ``ModuleList``, a list of trees), or a stacked tree indexed on its
    leading dim (the gradient then flows back into the stack)."""
    if isinstance(stage_params, (list, tuple, torch.nn.ModuleList,
                                 torch.nn.ParameterList)):
        return stage_params[c]
    return tree_map(lambda p: p[c], stage_params)


def _micro(tree: Any, n_micro: int) -> list:
    """A batch tree's batch-major leaves cut into ``n_micro`` equal
    micro-batches, as a list of trees."""
    B = tree_leaves(tree)[0].shape[0]
    if B % n_micro:
        raise ValueError(f"local batch {B} not divisible by {n_micro} "
                         "microbatches")
    mb = B // n_micro
    return [tree_map(lambda a: a[m * mb:(m + 1) * mb], tree)
            for m in range(n_micro)]


def make_pipeline_fn(mesh: Mesh, stage_fn: Callable, *, n_micro: int,
                     remat: bool = True) -> Callable:
    """``fn(stage_params, x) -> y`` running a GPipe schedule.

    ``stage_fn(stage, x) -> x'`` is one stage's shape-preserving
    computation; ``stage_params`` holds the ``n_pipe`` stages (a sequence,
    or a tree stacked along a leading stage dim).  ``x``'s batch dim must
    divide into ``n_micro`` micro-batches; ``y`` is the last stage's
    output for the whole batch, on ``x``'s device.  Differentiable:
    autograd runs back through the ticks (with ``remat`` each stage's
    forward is recomputed in the backward)."""
    n_pipe = mesh.shape[PIPE_AXIS]
    if mesh.crosses(PIPE_AXIS):
        raise ValueError("GPipe through autograd runs in one process; "
                         "across processes use build_gpipe_train_step")

    def run(stage, x):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, stage, x, use_reentrant=False)
        return stage_fn(stage, x)

    def pipeline_fn(stage_params, x):
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"local batch {B} not divisible by {n_micro} "
                             "microbatches")
        micro = x.chunk(n_micro)
        outs = [None] * n_micro
        held = {}
        for t in range(n_pipe + n_micro - 1):
            for s in range(n_pipe):
                m = t - s
                if not 0 <= m < n_micro:
                    continue            # a bubble slot: nothing runs
                x_in = micro[m] if s == 0 else held.pop((s, m))
                stage = _stage(stage_params, s)
                y = run(stage, x_in.to(_device_of(stage)))
                if s == n_pipe - 1:
                    outs[m] = y
                else:
                    held[(s + 1, m)] = y
        return torch.cat([o.to(x.device) for o in outs])

    return pipeline_fn


def schedule_1f1b(n_pipe: int, n_micro: int):
    """Static 1F1B schedule: per-tick (F, B) micro-batch indices per stage,
    ``[n_ticks][n_pipe]`` lists (-1 = idle).  Stage ``s`` keeps at most
    ``n_pipe - s`` micro-batches in flight (GPipe keeps ``n_micro``).
    Computed by the JAX package's greedy, dependency-respecting
    simulation."""
    P, M = n_pipe, n_micro
    fwd_done = [[-1] * M for _ in range(P)]
    bwd_done = [[-1] * M for _ in range(P)]
    fnext = [0] * P
    bnext = [0] * P
    F, B = [], []
    t = 0
    while any(b < M for b in bnext):
        f_row, b_row = [-1] * P, [-1] * P
        for s in range(P):
            m = fnext[s]
            if m < M and (m - bnext[s]) < (P - s):
                if s == 0 or (0 <= fwd_done[s - 1][m] <= t - 1):
                    f_row[s] = m
        for s in range(P):
            if f_row[s] >= 0:
                fwd_done[s][f_row[s]] = t
                fnext[s] += 1
        for s in range(P):
            m = bnext[s]
            if m < M:
                if s == P - 1:
                    ok = 0 <= fwd_done[s][m] <= t  # same-tick F then B
                else:
                    ok = 0 <= bwd_done[s + 1][m] <= t - 1
                if ok:
                    b_row[s] = m
        for s in range(P):
            if b_row[s] >= 0:
                bwd_done[s][b_row[s]] = t
                bnext[s] += 1
        F.append(f_row)
        B.append(b_row)
        t += 1
        if t > 4 * (P + M) + 8:  # pragma: no cover - schedule bug guard
            raise RuntimeError("1F1B schedule failed to converge")
    return F, B


def schedule_gpipe(n_pipe: int, n_micro: int):
    """GPipe as a static (F, B) table of 1F1B's form: stage ``s`` runs
    micro-batch ``m``'s forward at tick ``s + m``, then, after every
    forward, its backward at ``n_pipe + n_micro - 1 + (n_pipe - 1 - s) +
    m`` (the last stage first, micro-batches in order)."""
    P, M = n_pipe, n_micro
    fwd = P + M - 1
    F = [[t - s if 0 <= t - s < M else -1 for s in range(P)]
         for t in range(fwd)]
    B = [[-1] * P for _ in range(fwd)]
    for t in range(fwd):
        F.append([-1] * P)
        B.append([t - (P - 1 - s) if 0 <= t - (P - 1 - s) < M else -1
                  for s in range(P)])
    return F, B


def schedule_interleaved(n_pipe: int, n_micro: int, n_virtual: int):
    """Static interleaved-1F1B schedule (Megatron virtual pipeline stages):
    ``n_pipe * n_virtual`` chunks, rank ``s`` hosting chunks ``{s, n_pipe
    + s, ...}``.  Requires ``n_micro % n_pipe == 0``.  Returns ``(F, B)``
    as ``[n_ticks][n_pipe]`` lists of ``(global_chunk, micro)`` or None,
    the JAX package's simulation."""
    P, M, v = n_pipe, n_micro, n_virtual
    if M % P:
        raise ValueError(
            f"interleaved schedule needs n_micro ({M}) divisible by "
            f"n_pipe ({P})")
    V = P * v
    order = [(i, g * P + r) for g in range(M // P) for i in range(v)
             for r in range(P)]
    N = len(order)
    fwd_done: dict = {}
    bwd_done: dict = {}
    fptr = [0] * P
    bptr = [0] * P
    F, B = [], []
    caps = [(P - s - 1) * 2 + (v - 1) * P + 1 for s in range(P)]
    t = 0
    while any(b < N for b in bptr):
        f_row: list = [None] * P
        b_row: list = [None] * P
        for s in range(P):
            kf = fptr[s]
            if kf < N and (kf - bptr[s]) < caps[s]:
                i, m = order[kf]
                c = i * P + s
                if c == 0 or fwd_done.get((c - 1, m), t) <= t - 1:
                    f_row[s] = (c, m)
        for s, slot in enumerate(f_row):
            if slot:
                fwd_done[slot] = t
                fptr[s] += 1
        for s in range(P):
            kb = bptr[s]
            if kb < N:
                i, m = order[kb]
                c = (v - 1 - i) * P + s   # B sweeps chunks high-to-low
                if c == V - 1:
                    ok = fwd_done.get((c, m), t + 1) <= t
                else:
                    ok = bwd_done.get((c + 1, m), t) <= t - 1
                if ok:
                    b_row[s] = (c, m)
        for s, slot in enumerate(b_row):
            if slot:
                bwd_done[slot] = t
                bptr[s] += 1
        F.append(f_row)
        B.append(b_row)
        t += 1
        if t > 8 * (V + M) + 16:  # pragma: no cover - schedule bug guard
            raise RuntimeError("interleaved schedule failed to converge")
    return F, B


def _slots(rows) -> list:
    """1F1B rows (micro-batch or -1 per stage) as ``(chunk, micro)``
    slots, the interleaved schedule's form (chunk = stage)."""
    return [[(s, m) if m >= 0 else None for s, m in enumerate(row)]
            for row in rows]


def _grads_mul_(params, factor: float) -> None:
    for p in params:
        if p.grad is not None:
            p.grad.mul_(factor)


def _tick_messages(f_row, b_row, last: int, n_pipe: int) -> list:
    """The tick's hops in the order both ends post them: ``(kind, chunk,
    micro, source position, destination position)`` for each forward
    slot's activation (to the next chunk) and each backward slot's
    cotangent (to the previous one)."""
    out = []
    for slot in f_row:
        if slot is not None and slot[0] < last:
            c, m = slot
            out.append(("f", c + 1, m, c % n_pipe, (c + 1) % n_pipe))
    for slot in b_row:
        if slot is not None and slot[0] > 0:
            c, m = slot
            out.append(("b", c - 1, m, c % n_pipe, (c - 1) % n_pipe))
    return out


class _Ranks:
    """The pipe group's part of a step across processes: this rank's
    position on the pipe axis and the axis's link (every hop carries one
    micro-batch's activation or its cotangent)."""

    def __init__(self, mesh: Mesh):
        from .transport import link
        self.link = link(mesh, PIPE_AXIS)
        self.me = self.link.coord
        self.aux_keys = None

    def owns(self, c: int) -> bool:
        return c % self.link.size == self.me

    def exchange(self, f_row, b_row, last: int, sent: dict, act) -> dict:
        """Post the tick's sends (``sent``: by ``(kind, chunk, micro)``)
        and receives; returns the received tensors by key."""
        from .transport import exchange
        msgs = _tick_messages(f_row, b_row, last, self.link.size)
        sends = [(k[4], sent.pop(k[:3])) for k in msgs if k[3] == self.me]
        keys = [k[:3] for k in msgs if k[4] == self.me]
        got = exchange(self.link, sends,
                       [(k[3], *act) for k in msgs if k[4] == self.me])
        return dict(zip(keys, got))

    def metrics(self, loss, aux: dict, device) -> tuple:
        """The last stage's loss and tensor aux metrics on every pipe
        rank (JAX's one-hot ``psum`` over ``pipe``)."""
        import torch.distributed as dist
        from .transport import psum_from
        last = self.link.size - 1
        if self.aux_keys is None:
            keys = [sorted(aux) if self.me == last else None]
            dist.broadcast_object_list(keys, src=self.link.ranks[last],
                                       group=self.link.group)
            self.aux_keys = keys[0]
        vals = None
        if self.me == last:
            vals = torch.stack([loss] + [aux[k] for k in self.aux_keys])
        vals = psum_from(self.link, vals, last, (1 + len(self.aux_keys),),
                         torch.float32, device)
        return vals[0], dict(zip(self.aux_keys, vals[1:]))


def _run_schedule(model, batch, F, B, n_micro: int, stage_fn, loss_head_fn,
                  embed_fn, ranks: _Ranks | None = None,
                  act_fn=None) -> tuple:
    """One step's schedule: the stage and head gradients (their mean over
    micro-batches) in the parameters' ``.grad``, the embedding's from
    stage 0's input cotangents.  Returns ``(loss, aux, peak_stash)``:
    the mean loss and aux metrics over micro-batches (fp32) and the most
    stage inputs held at once.  Each stage's input goes to its stage's
    device.  With ``ranks`` (``pipe`` across processes) only this rank's
    chunks run, the tick's hops go over the pipe group, and
    ``act_fn(model, batch, n_micro)`` gives a hop's ``(shape, dtype,
    device)``."""
    stages = model.stages
    last = len(stages) - 1
    mine = ranks.owns if ranks is not None else (lambda c: True)
    rest = _micro(batch, n_micro)
    x = None
    if mine(0):
        x = (embed_fn(model.embed, batch) if embed_fn is not None
             else batch[0])
        micro_x = x.detach().chunk(n_micro)
    act = act_fn(model, batch, n_micro) if ranks is not None else None
    stash, ybuf, dxbuf, sent = {}, {}, {}, {}
    dx0 = [None] * n_micro
    losses, auxes = [], []
    peak = 0
    for f_row, b_row in zip(F, B):
        for slot in f_row:
            if slot is None or not mine(slot[0]):
                continue
            c, m = slot
            x_in = (micro_x[m] if c == 0 else ybuf.pop((c, m))).to(
                _device_of(stages[c]))
            stash[(c, m)] = x_in
            if c < last:
                with torch.no_grad():
                    y = stage_fn(stages[c], x_in)
                if ranks is not None:
                    sent[("f", c + 1, m)] = y
                else:
                    ybuf[(c + 1, m)] = y
        peak = max(peak, len(stash))
        for slot in b_row:
            if slot is None or not mine(slot[0]):
                continue
            c, m = slot
            xb = stash.pop((c, m)).detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(stages[c], xb)
                if c == last:
                    loss_m, aux_m = loss_head_fn(model.head, y, rest[m])
                    torch.autograd.backward(loss_m)
                    losses.append(loss_m.detach().float())
                    auxes.append({k: v.detach().float() for k, v in
                                  aux_m.items()})
                else:
                    torch.autograd.backward(
                        y, dxbuf.pop((c, m)).to(y.device))
            if c == 0:
                dx0[m] = xb.grad
            elif ranks is not None:
                sent[("b", c - 1, m)] = xb.grad
            else:
                dxbuf[(c - 1, m)] = xb.grad
        if ranks is not None:
            for (kind, c, m), t in ranks.exchange(f_row, b_row, last, sent,
                                                  act).items():
                (ybuf if kind == "f" else dxbuf)[(c, m)] = t
    inv_m = 1.0 / n_micro
    head = list(model.head.parameters()) if model.head is not None else []
    _grads_mul_(list(stages.parameters()) + head, inv_m)
    if x is not None and embed_fn is not None and x.requires_grad:
        # (A frozen embedding, ``--trainable_params``, takes none.)
        dx = torch.cat([d.to(x.device) for d in dx0]) * inv_m
        x.backward(dx.to(x.dtype))
    loss = torch.stack(losses).sum() * inv_m if losses else None
    aux = {k: torch.stack([a[k] for a in auxes]).sum() * inv_m
           for k in (auxes[0] if auxes else {})}
    if ranks is not None:
        loss, aux = ranks.metrics(loss, aux, act[2])
    return loss, aux, peak


def _scheduled_step(mesh: Mesh, F, B, stage_fn, loss_head_fn, n_micro: int,
                    embed_fn, all_reduce, log_grad_norm: bool, act_fn=None):
    from .sync import (_finish, _mean_over_rows, _reduce_step, _terms,
                       _train, _zero_rows, row_parts)
    if mesh.crosses(PIPE_AXIS) and act_fn is None:
        raise ValueError("a pipeline across processes needs act_fn (a "
                         "hop's shape, dtype and device)")
    held: dict = {}

    def step(state, batch):
        if mesh.crosses(PIPE_AXIS) and "ranks" not in held:
            held["ranks"] = _Ranks(mesh)
        _train(state)
        _zero_rows(state)
        losses, auxes = [], []
        for model, part in row_parts(state, batch):
            loss, aux, peak = _run_schedule(
                model, part, F, B, n_micro, stage_fn, loss_head_fn,
                embed_fn, held.get("ranks"), act_fn)
            step.peak_stash = max(step.peak_stash, peak)
            losses.append(loss)
            auxes.append(aux)
        loss, aux = _mean_over_rows(state, losses, auxes)
        if all_reduce is not None or state.rows:
            loss, aux = _reduce_step(state, loss, aux, all_reduce,
                                     1.0 / _terms(state, all_reduce))
        return state, _finish(state, loss, aux, 0.0, log_grad_norm)

    step.peak_stash = 0
    return step


def build_gpipe_train_step(
        mesh: Mesh, stage_fn: Callable, loss_head_fn: Callable, *,
        n_micro: int, embed_fn: Callable | None = None, all_reduce=None,
        log_grad_norm: bool = False, act_fn=None):
    """GPipe's train step as explicit slots (:func:`schedule_gpipe`): every
    micro-batch's forward, stage by stage, each stage's input stashed,
    then every backward, the stage recomputed from its input (GPipe's
    ``remat``); the same gradients as autograd through the ticks.  The
    pipeline across processes runs GPipe so (autograd cannot cross them);
    the arguments are :func:`build_1f1b_pipeline_train_step`'s."""
    n_pipe = mesh.global_shape[PIPE_AXIS]
    F, B = schedule_gpipe(n_pipe, n_micro)
    step = _scheduled_step(mesh, _slots(F), _slots(B), stage_fn,
                           loss_head_fn, n_micro, embed_fn, all_reduce,
                           log_grad_norm, act_fn)
    step.schedule = (F, B)
    return step


def build_1f1b_pipeline_train_step(
        mesh: Mesh, stage_fn: Callable, loss_head_fn: Callable, *,
        n_micro: int, embed_fn: Callable | None = None, all_reduce=None,
        log_grad_norm: bool = False, act_fn=None):
    """1F1B pipeline train step with a hand-rolled backward.

    ``state.model``: ``embed`` (its input from ``embed_fn(embed, batch)``;
    without ``embed_fn`` ``batch[0]`` is the input and nothing embeds),
    ``stages`` (``n_pipe`` of them, stage ``s`` on pipe device ``s``),
    ``head`` (or None).  ``stage_fn(stage, x) -> x'`` is shape-preserving;
    ``loss_head_fn(head, y_micro, micro_batch) -> (loss, aux)`` runs at
    the last stage on each micro-batch (total loss: the mean over
    micro-batches).  Returns ``step(state, batch) -> (state, metrics)``;
    ``step.schedule`` is ``(F, B)`` and ``step.peak_stash`` the most
    stage inputs the steps so far held at once.  With ``pipe`` across
    processes ``act_fn(model, batch, n_micro)`` gives a hop's ``(shape,
    dtype, device)``."""
    n_pipe = mesh.global_shape[PIPE_AXIS]
    F, B = schedule_1f1b(n_pipe, n_micro)
    step = _scheduled_step(mesh, _slots(F), _slots(B), stage_fn,
                           loss_head_fn, n_micro, embed_fn, all_reduce,
                           log_grad_norm, act_fn)
    step.schedule = (F, B)
    return step


def build_interleaved_1f1b_train_step(
        mesh: Mesh, stage_fn: Callable, loss_head_fn: Callable, *,
        n_micro: int, n_virtual: int, embed_fn: Callable | None = None,
        all_reduce=None, log_grad_norm: bool = False, act_fn=None):
    """Interleaved-1F1B (virtual pipeline stages) train step: as
    :func:`build_1f1b_pipeline_train_step` over ``n_pipe * n_virtual``
    chunks (``state.model.stages[c]`` is global chunk ``c``, on pipe
    device ``c % n_pipe``; the checkpoint tree stacks them [v, n_pipe,
    ...], chunk ``i * n_pipe + s`` at [i, s]) on
    :func:`schedule_interleaved`; stash and buffers are keyed by
    ``(chunk, micro)``, so JAX's fixed-depth buffers (its
    ``_min_buffer_slots``) have no counterpart here."""
    n_pipe = mesh.global_shape[PIPE_AXIS]
    F, B = schedule_interleaved(n_pipe, n_micro, n_virtual)
    step = _scheduled_step(mesh, F, B, stage_fn, loss_head_fn, n_micro,
                           embed_fn, all_reduce, log_grad_norm, act_fn)
    step.schedule = (F, B)
    return step
