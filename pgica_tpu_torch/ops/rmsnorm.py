"""RMSNorm, forward and backward: plain PyTorch versions, CUDA kernel wrappers, autograd, module.

Mirrors pgica_tpu/ops/layernorm.py:119-148,248-355: the mean square in
float32 over the last axis, ``y = x * rstd * weight`` cast back to x's dtype,
with one float32 ``weight`` (the JAX ``scale``). Two kernels:

* ``csrc/rmsnorm_fwd.cu`` replaces the Pallas ``_rms_fwd_kernel`` (:119) and
  also writes rstd in float32 for the backward pass.
* ``csrc/rmsnorm_bwd.cu`` replaces ``_rms_bwd_kernel`` (:127): dx in x's
  dtype, and dweight in float32 summed over all rows in one cooperative
  launch — each block's partial sum over the rows :func:`bwd_partition`
  gives it, then, after a grid-wide barrier, the partials added in a fixed
  order, so the sum does not vary from run to run, and a row whose dy is 0
  adds exactly 0.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs the plain version. The JAX package's TPU-tuned thresholds
(``_auto_on``) are not carried over: every RMSNorm of the port runs through
the kernel on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pgica_tpu_torch.ops import _kernels

MAX_PARTS = 114  # csrc/rmsnorm_bwd.cu kMaxParts: co-resident on any H100, one block on each of 114 SMs (PCIe)


def bwd_partition(rows: int) -> int:
    """The backward kernel's blocks G, and the rows of its ``partials`` scratch (each ``H`` wide).

    Block b takes the rows b, b + G, b + 2G, ... in order and writes one partial
    row of dweight. G depends on the row count alone, never on the card, so the
    sums' order, and so their bits, are the same on every H100; and rows added
    after the last ones keep every earlier row's place in that order.
    """
    return min(rows, MAX_PARTS)


def bwd_scratch(rows: int, hidden: int, device) -> torch.Tensor:
    """The backward kernel's ``partials``: block b writes its float32 dweight row at ``[b]``."""
    return torch.empty((bwd_partition(rows), hidden), dtype=torch.float32, device=device)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: returns (y in x's dtype, rstd f32 of shape x.shape[:-1])."""
    xf = x.to(torch.float32)
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    y = xf * rstd * weight.to(torch.float32)
    return y.to(x.dtype), rstd.squeeze(-1)


def rms_norm_bwd_ref(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, rstd: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel over (rows, H): (dx in x's dtype, dweight f32)."""
    xhat = x.to(torch.float32) * rstd[:, None]
    dyf = dy.to(torch.float32)
    dxhat = dyf * weight.to(torch.float32)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0)


def _check_rows(name: str, x: torch.Tensor) -> None:
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (rows, H) tensor, got {tuple(x.shape)}")
    if x.shape[1] % 8 or x.data_ptr() % 16:  # the kernels move rows in 16-byte vectors
        raise ValueError(f"{name}: H must be a multiple of 8 and x 16-byte aligned, got H = {x.shape[1]}")


def _check_vector(name: str, what: str, t: torch.Tensor, n: int, x: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.shape != (n,) or t.device != x.device or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous float32 ({n},) on {x.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary")


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper over (rows, H): returns (y, rstd) like :func:`rms_norm_ref`."""
    if x.device.type == "cpu":
        return rms_norm_ref(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_fwd: unsupported device {x.device}")
    _check_rows("rms_norm_fwd", x)
    rows, hidden = x.shape
    _check_vector("rms_norm_fwd", "weight", weight, hidden, x)
    y = torch.empty_like(x)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, rstd
    _kernels.launch(
        "rmsnorm_fwd",
        x.data_ptr(), weight.data_ptr(), y.data_ptr(), rstd.data_ptr(), rows, hidden, float(eps),
        _kernels.DTYPE_CODES[x.dtype], _kernels.stream_handle(x),
    )
    return y, rstd


def rms_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, rstd: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel wrapper over (rows, H): returns what :func:`rms_norm_bwd_ref` does."""
    if x.device.type == "cpu":
        return rms_norm_bwd_ref(x, weight, dy, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd: unsupported device {x.device}")
    _check_rows("rms_norm_bwd", x)
    rows, hidden = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"rms_norm_bwd: dy must be contiguous {x.dtype} {tuple(x.shape)} on {x.device}")
    if dy.data_ptr() % 16:
        raise ValueError("rms_norm_bwd: dy must start on a 16-byte boundary")
    _check_vector("rms_norm_bwd", "weight", weight, hidden, x)
    if rstd.dtype != torch.float32 or rstd.shape != (rows,) or rstd.device != x.device or not rstd.is_contiguous():
        raise ValueError(f"rms_norm_bwd: rstd must be contiguous float32 ({rows},) on {x.device}")
    dx = torch.empty_like(x)
    dweight = torch.empty(hidden, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dweight.zero_()
    partials = bwd_scratch(rows, hidden, x.device)
    _kernels.launch(
        "rmsnorm_bwd",
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dweight.data_ptr(),
        partials.data_ptr(), rows, hidden, partials.shape[0], _kernels.DTYPE_CODES[x.dtype], _kernels.stream_handle(x),
    )
    return dx, dweight


class _RMSNorm(torch.autograd.Function):
    """Forward kernel, saving rstd; backward through the backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, rstd = rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        dx, dweight = rms_norm_bwd(x, weight, dy.contiguous(), rstd)
        return dx, dweight, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis; leading axes are flattened to rows. Differentiable."""
    hidden = x.shape[-1]
    x2 = x.reshape(-1, hidden).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x2, weight, eps).view(x.shape)
    return rms_norm_fwd(x2, weight, eps)[0].view(x.shape)


class RMSNorm(nn.Module):
    """RMSNorm with one float32 ``weight`` (the JAX ``scale``), eps 1e-5 by default.

    As :class:`~pgica_tpu_torch.ops.layernorm.LayerNorm`: the input is cast
    to the compute ``dtype`` first (JAX layernorm.py:351-355) and the output
    comes back in it; ``weight`` stays a float32 master that the kernel reads
    as it is, and a bf16 copy of the model puts it back in float32 holding
    the bf16-rounded value (models/model.py ``frozen_copy``).
    """

    def __init__(self, hidden: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x.to(self.dtype), self.weight, self.eps)
