"""Collectives over named mesh axes: the port's counterparts of ``jax.lax``'s.

Each takes ``axis``, a mesh axis name or a tuple of them, bound by the
active mesh (``with mesh:``, parallel/mesh.py), as ``shard_map`` binds axis
names in the JAX package; an axis name with no active mesh raises, as JAX's
unbound axis name does. An axis of one rank makes each an identity.

* ``all_gather(x, axis)``: tiled on dim 0, differentiable. Its backward is
  the reduce-scatter SUM of the cotangent, JAX's transpose of
  ``all_gather``: a gathered tensor's cotangents from every rank are summed
  back to the rank that owns its rows.
* ``psum``, ``pmean``, ``pmax``, ``psum_scatter`` (tiled on dim 0):
  forward only (the train steps use them on gradients and metrics).
* ``axis_index``, ``axis_size``.
* ``ppermute(x, axis, perm)``: ``lax.ppermute``, differentiable; its
  backward sends the cotangent back along the inverse permutation (JAX's
  transpose). A rank that no pair sends to gets zeros. It gathers ``x``
  over the axis and each rank picks its source's block, which is right for
  every permutation and takes the same call on NCCL and gloo.
* The conjugate pair of Megatron's tensor parallelism, for an axis over
  which a computation is replicated (each rank holds the same loss):
  ``copy_to`` is the identity forward and a psum of the cotangent backward
  (in front of a column-parallel product, whose ranks each send back a
  partial input gradient); ``reduce_from`` is a psum forward and the
  identity backward (after a row-parallel product, whose partial outputs
  it sums). ``gather_from(x, axis, dim)`` concatenates the ranks' blocks
  along ``dim`` forward and keeps this rank's block of the cotangent
  backward (a column-parallel output needed whole: the vocab-parallel
  logits, the patch embedding's channels).
* ``broadcast(x, axis, src, shape)``: rank ``src`` of the axis sends its
  ``x`` to every rank, differentiable: the backward sums the cotangent over
  the axis, which rank ``src`` keeps (a layer that one rank of ``fsdp``
  holds whole, parallel/fsdp.py).

Every call into ``torch.distributed`` sits here. NCCL and gloo take the
same calls: gloo runs ``all_gather_into_tensor``, ``reduce_scatter_tensor``
and ``all_reduce`` on CUDA tensors too (torch 2.11; ``chip_smoke.py`` phase
14 checks each one's result on the card over gloo), so no op is routed by
backend.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from pgica_tpu_torch.parallel.mesh import AxisName, MeshContext, active_mesh

# torch 2.13 renames the tensor-in, tensor-out collectives (the old names warn); torch 2.11 has the old only
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def _mesh(axis: AxisName) -> MeshContext:
    mesh = active_mesh()
    if mesh is None:
        raise ValueError(f"unbound axis name {axis!r}: no device mesh is active (enter one with `with mesh:`)")
    return mesh


def axis_size(axis: AxisName) -> int:
    return _mesh(axis).axis_size(axis)


def axis_index(axis: AxisName) -> int:
    return _mesh(axis).axis_index(axis)


def _gather(x: torch.Tensor, mesh: MeshContext, axis: AxisName) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x
    out = x.new_empty((mesh.axis_size(axis) * x.shape[0],) + x.shape[1:])
    _all_gather_single(out, x.contiguous(), group=group)
    return out


def _scatter(x: torch.Tensor, mesh: MeshContext, axis: AxisName) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.axis_size(axis)
    if x.shape[0] % n:
        raise ValueError(f"psum_scatter: dimension 0 of {tuple(x.shape)} is not divisible by {n} ranks")
    out = x.new_empty((x.shape[0] // n,) + x.shape[1:])
    _reduce_scatter_single(out, x.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return _scatter(grad, ctx.mesh, ctx.axis), None, None


def all_gather(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on dim 0 in axis-index order (``tiled=True``)."""
    mesh = mesh or _mesh(axis)
    if mesh.axis_size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis)


def psum_scatter(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """The sum over ``axis`` of ``x``, of which this rank keeps its block of dim 0 (``tiled=True``)."""
    return _scatter(x, mesh or _mesh(axis), axis)


def _all_reduce(x: torch.Tensor, axis: AxisName, op, mesh: Optional[MeshContext]) -> torch.Tensor:
    mesh = mesh or _mesh(axis)
    group = mesh.group(axis)
    if group is None:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    return _all_reduce(x, axis, dist.ReduceOp.SUM, mesh)


def pmax(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    return _all_reduce(x, axis, dist.ReduceOp.MAX, mesh)


def pmean(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    mesh = mesh or _mesh(axis)
    return psum(x, axis, mesh) / mesh.axis_size(axis)


def _psum_raw(x: torch.Tensor, mesh: MeshContext, axis: AxisName) -> torch.Tensor:
    group = mesh.group(axis)
    if group is None:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def _permute(x: torch.Tensor, mesh: MeshContext, axis: AxisName, source: dict) -> torch.Tensor:
    """This rank's block of ``x`` gathered over ``axis`` from ``source[my index]`` (zeros without one)."""
    gathered = _gather(x.contiguous()[None], mesh, axis)
    src = source.get(mesh.axis_index(axis))
    return torch.zeros_like(x) if src is None else gathered[src].clone()


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _permute(x, mesh, axis, {dst: src for src, dst in perm})

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.mesh, ctx.axis, {src: dst for src, dst in ctx.perm}), None, None, None


def ppermute(x: torch.Tensor, axis: AxisName, perm, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """``lax.ppermute``: rank ``src`` of ``axis`` sends ``x`` to rank ``dst`` for each (src, dst) in ``perm``."""
    mesh = mesh or _mesh(axis)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if mesh.axis_size(axis) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Ppermute.apply(x, mesh, axis, perm)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _psum_raw(grad, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _psum_raw(x, mesh, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, x.shape[dim]
        return _gather(x.movedim(dim, 0), mesh, axis).movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        start = ctx.mesh.axis_index(ctx.axis) * ctx.size
        return grad.narrow(ctx.dim, start, ctx.size).contiguous(), None, None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, src, shape):
        ctx.mesh, ctx.axis, ctx.src, ctx.in_shape = mesh, axis, src, x.shape
        out = x.detach().clone() if mesh.axis_index(axis) == src else x.new_empty(shape)
        dist.broadcast(out, group=mesh.group(axis), group_src=src)
        return out

    @staticmethod
    def backward(ctx, grad):
        total = _psum_raw(grad, ctx.mesh, ctx.axis)
        mine = total if ctx.mesh.axis_index(ctx.axis) == ctx.src else grad.new_zeros(ctx.in_shape)
        return mine, None, None, None, None


def broadcast(x: torch.Tensor, axis: AxisName, src: int, shape, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Rank ``src`` of ``axis``'s ``x`` (of ``shape``) on every rank; the others' ``x`` gives only the dtype and
    device. Backward: the cotangent's sum over ``axis``, kept by rank ``src`` (zeros of ``x``'s shape elsewhere)."""
    mesh = mesh or _mesh(axis)
    if mesh.axis_size(axis) == 1:
        return x
    return _Broadcast.apply(x, mesh, axis, src, tuple(shape))


def copy_to(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Identity forward, psum over ``axis`` backward (Megatron's copy to the tensor-parallel region)."""
    mesh = mesh or _mesh(axis)
    return x if mesh.axis_size(axis) == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, axis: AxisName, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """Psum over ``axis`` forward, identity backward (Megatron's reduce from the tensor-parallel region)."""
    mesh = mesh or _mesh(axis)
    return x if mesh.axis_size(axis) == 1 else _ReduceFrom.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, axis: AxisName, dim: int = -1, mesh: Optional[MeshContext] = None) -> torch.Tensor:
    """The ranks' blocks concatenated along ``dim`` in axis-index order; backward keeps this rank's block."""
    mesh = mesh or _mesh(axis)
    if mesh.axis_size(axis) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim % x.dim())
