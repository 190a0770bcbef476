"""Hops and sums between the ranks of a mesh axis that crosses processes.

The JAX package moves data along a mesh axis with ``jax.lax.ppermute``
(a permutation of the axis's positions) and sums it with ``psum``; where
the axis crosses processes (``parallel/mesh.global_mesh``: ``seq`` and
``pipe``), each of its positions is a rank here and these are its
counterparts over the axis's ``torch.distributed`` process group
(``cluster/server.py`` forms it):

- :func:`start_hop`: one hop of a permutation (``ppermute``'s), every
  rank's send and receive posted together (``dist.batch_isend_irecv``),
  so a ring of sends cannot deadlock;
- :func:`exchange`: several sends and receives posted together (a
  pipeline tick's activations and cotangents);
- :func:`psum_from` and :func:`gather_seq`: a value of one coordinate
  given to every rank, and the seq shards of a tensor joined, both as a
  sum where the other ranks add zeros (JAX's one-hot ``psum``: exact).

The transport is chosen once from the group's backend and printed by the
trainer, never after a failure: NCCL sends CUDA tensors card to card;
gloo's send and receive take CPU tensors, so where ranks share a card
over gloo a hop stages through host memory (its bytes as ``uint8``,
whatever the dtype).  Gloo's sums take CUDA tensors as they are.  A hop
that fails raises.
"""

from __future__ import annotations

from typing import Sequence

import torch


class AxisLink:
    """One crossing axis as this rank sees it: ``ranks`` the global
    ranks along it in coordinate order, ``coord`` this rank's, ``group``
    its process group, ``via_host`` whether CUDA tensors stage through
    the host (a gloo group)."""

    def __init__(self, ranks: Sequence[int], coord: int, group,
                 backend: str):
        self.ranks = list(ranks)
        self.coord = coord
        self.group = group
        self.backend = str(backend)
        self.via_host = self.backend == "gloo"

    @property
    def size(self) -> int:
        return len(self.ranks)

    def describe(self) -> str:
        how = ("host-staged send/recv" if self.via_host
               else "device send/recv")
        return f"{self.backend} over ranks {self.ranks} ({how})"


def link(mesh, axis: str) -> AxisLink:
    """The :class:`AxisLink` of ``mesh``'s crossing ``axis`` (cached on
    its ``ranks``)."""
    import torch.distributed as dist
    ranks = mesh.ranks
    held = ranks.links.get(axis)
    if held is None:
        group = ranks.group(axis)
        held = ranks.links[axis] = AxisLink(
            ranks.axis_ranks(axis), ranks.coords[axis], group,
            dist.get_backend(group))
    return held


def _wire(x: torch.Tensor, via_host: bool) -> torch.Tensor:
    x = x.detach().contiguous()
    if via_host and x.is_cuda:
        return x.reshape(-1).view(torch.uint8).cpu()
    return x


class _Pending:
    """Posted receives: :meth:`wait` finishes every op of the batch and
    returns the received tensors on their devices."""

    def __init__(self, works, bufs: list, like: list):
        self.works, self.bufs, self.like = works, bufs, like

    def wait(self) -> list:
        for w in self.works:
            w.wait()
        out = []
        for buf, (shape, dtype, device, staged) in zip(self.bufs, self.like):
            if staged:
                buf = buf.to(device, non_blocking=False).view(dtype) \
                    .reshape(shape)
            out.append(buf)
        return out


def _post(link_: AxisLink, sends: list, recvs: list) -> _Pending:
    """Post ``sends`` (``(coord, tensor)``) and ``recvs`` (``(coord,
    shape, dtype, device)``) in one batch, in the given order (both ends
    derive it from the same table)."""
    import torch.distributed as dist
    ops, bufs, like = [], [], []
    for coord, x in sends:
        ops.append(dist.P2POp(dist.isend, _wire(x, link_.via_host),
                              link_.ranks[coord], link_.group))
    for coord, shape, dtype, device in recvs:
        staged = link_.via_host and torch.device(device).type == "cuda"
        if staged:
            n = torch.Size(shape).numel() * torch.empty(
                (), dtype=dtype).element_size()
            buf = torch.empty(n, dtype=torch.uint8)
        else:
            buf = torch.empty(shape, dtype=dtype, device=device)
        ops.append(dist.P2POp(dist.irecv, buf, link_.ranks[coord],
                              link_.group))
        bufs.append(buf)
        like.append((tuple(shape), dtype, device, staged))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Pending(works, bufs, like)


def start_hop(link_: AxisLink, x: torch.Tensor | None, perm) -> _Pending:
    """One hop of the permutation ``perm`` (``(source, destination)``
    coordinate pairs): this rank sends ``x`` to its destination and
    receives its source's tensor of ``x``'s shape and dtype.  Returns the
    posted hop; its ``wait()`` gives ``[received]``."""
    me = link_.coord
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    return _post(link_, [(d, x) for d in dst],
                 [(s, x.shape, x.dtype, x.device) for s in src])


def exchange(link_: AxisLink, sends: list, recvs: list) -> list:
    """Every send and receive of one step posted together and waited for
    (see :func:`_post`); returns the received tensors in ``recvs``'
    order."""
    if not sends and not recvs:
        return []
    return _post(link_, sends, recvs).wait()


def psum_from(link_: AxisLink, x: torch.Tensor | None, src: int, shape,
              dtype, device) -> torch.Tensor:
    """Coordinate ``src``'s ``x`` on every rank of the axis: a sum where
    every other rank adds zeros (JAX's one-hot ``psum``, exact); fp32 on
    the wire."""
    import torch.distributed as dist
    if link_.coord == src:
        buf = x.detach().to(device, torch.float32).clone()
    else:
        buf = torch.zeros(shape, dtype=torch.float32, device=device)
    dist.all_reduce(buf, group=link_.group)
    return buf.to(dtype)


class _GatherSeq(torch.autograd.Function):
    """The seq shards of ``x`` (this rank's along ``dim``) joined on every
    rank; the backward takes this rank's part of the gradient (every rank
    computes the same function of the joined tensor)."""

    @staticmethod
    def forward(ctx, x, link_, dim):
        import torch.distributed as dist
        ctx.link, ctx.dim = link_, dim
        n, me = link_.size, link_.coord
        shape = list(x.shape)
        ctx.part = shape[dim]
        shape[dim] *= n
        buf = torch.zeros(shape, dtype=torch.float32, device=x.device)
        buf.narrow(dim, me * ctx.part, ctx.part).copy_(x.detach())
        dist.all_reduce(buf, group=link_.group)
        return buf.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        part = g.narrow(ctx.dim, ctx.link.coord * ctx.part, ctx.part)
        return part.contiguous(), None, None


def gather_seq(x: torch.Tensor, link_: AxisLink, dim: int = 1
               ) -> torch.Tensor:
    """Differentiable join of the ranks' seq shards along ``dim``."""
    return _GatherSeq.apply(x, link_, dim)
