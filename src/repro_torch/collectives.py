"""Collectives over process groups, the port's counterparts of the
``jax.lax`` collectives that the reference calls inside ``shard_map``.

A mesh axis is a dim of the ``DeviceMesh`` in force
(``models.sharding.use_mesh``); ``axis_groups`` gives the process groups
of the named axes, and a collective over several axes is one over each in
turn.  Each function runs its collective on the tensors where they are:
nothing is copied to the host here (a backend may stage a CUDA tensor
through host memory on its own, as gloo does).

Autograd follows ``shard_map``'s transposes.  Every rank backpropagates the
same cotangent of a value that is replicated over an axis, so:

* ``psum`` (and ``pmean``) of a varying value is replicated: its backward
  is the identity (divided by the axis size for ``pmean``);
* ``pvary`` marks where a replicated value enters a computation that
  varies over the axis: the identity forward, a ``psum`` backward, which
  adds up the partial cotangents of the ranks.

``all_gather``, ``all_to_all`` and ``ppermute`` carry no gradient.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

from .models.sharding import current_mesh

__all__ = ["axis_groups", "axis_index", "psum", "pmean", "pvary", "all_gather",
           "all_to_all", "ppermute"]

Groups = Sequence[dist.ProcessGroup]


def axis_groups(axes: Sequence[str]) -> List[dist.ProcessGroup]:
    """The process groups of ``axes`` of the mesh in force, leaving out
    axes of size 1 (which need no collective)."""
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError("no mesh in force (models.sharding.use_mesh)")
    names = list(mesh.mesh_dim_names)
    return [mesh.get_group(a) for a in axes if mesh.shape[names.index(a)] > 1]


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` of the mesh in force."""
    return current_mesh().get_local_rank(axis)


def _size(groups: Groups) -> int:
    n = 1
    for g in groups:
        n *= dist.get_world_size(g)
    return n


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, mean):
        out = x.clone()
        for g in groups:
            dist.all_reduce(out, group=g)
        ctx.n = _size(groups) if mean else None
        return out if ctx.n is None else out.div_(ctx.n)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.n is None else g / ctx.n), None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


def psum(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``groups``, on every rank."""
    return _PSum.apply(x, tuple(groups), False) if groups else x


def pmean(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``groups``, on every rank."""
    return _PSum.apply(x, tuple(groups), True) if groups else x


def pvary(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """``x`` as is; in the backward pass its cotangent summed over
    ``groups``."""
    return _PVary.apply(x, tuple(groups)) if groups else x


def all_gather(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x``, in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def all_to_all(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """x: (n, ...), row i for rank i.  Returns (n, ...) whose row i is the
    row that rank i held for this rank (``lax.all_to_all`` over dim 0,
    untiled)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ppermute(x: torch.Tensor, group: dist.ProcessGroup,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: each pair (src, dst) of ``perm`` (ranks of
    ``group``) sends src's ``x`` to dst; a rank that receives nothing gets
    zeros.  ``x`` has the same shape and dtype on every rank and is read
    only where this rank is a source.  The transpose is the same call with
    each pair reversed.  One ``all_to_all_single`` whose splits are zero but
    for the pairs, which every backend takes (gloo has no send/recv of CUDA
    tensors)."""
    if not perm:
        return torch.zeros_like(x)
    me, n = dist.get_rank(group), dist.get_world_size(group)
    send = [0] * n
    recv = [0] * n
    for s, d in perm:
        if s == me:
            send[d] = x.numel()
        if d == me:
            recv[s] = x.numel()
    flat = x.reshape(-1)
    out = torch.empty(sum(recv), dtype=x.dtype, device=x.device)
    dist.all_to_all_single(out, flat.contiguous() if sum(send) else flat[:0], recv, send,
                           group=group)
    return out.view(x.shape) if sum(recv) else torch.zeros_like(x)
