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
