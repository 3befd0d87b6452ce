"""LayerNorm, forward and backward: plain PyTorch versions, CUDA kernel wrappers, autograd, module.

Mirrors pgica_tpu/ops/layernorm.py:63-116,168-245,358-406: statistics in
float32 over the last axis, ``y = (x - mu) * rstd * weight + bias`` cast back
to x's dtype, with float32 ``weight``/``bias`` (the JAX ``scale``/``bias``).
Two kernels:

* ``csrc/layernorm_fwd.cu`` replaces the Pallas ``_fwd_kernel`` (:75) and
  also writes mu and rstd in float32 for the backward pass.
* ``csrc/layernorm_bwd.cu`` replaces ``_bwd_kernel`` (:88): dx in x's dtype,
  and dweight/dbias in float32 summed over all rows in one cooperative
  launch — each block's partial sums over the rows :func:`bwd_partition`
  gives it, then, after a grid-wide barrier, the partials added in a fixed
  order, so the sums do not vary from run to run.

Both kernels move a row in 16-byte slots, at most ``MAX_ROW_SLOTS`` of them
(H up to 8,192 in bf16, 4,096 in f32); any H up to that works, a width that
is not a multiple of the slot through the kernels' element-by-element
instance.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs :func:`layer_norm_ref`. The JAX package's TPU-tuned
thresholds (``_auto_on``, layernorm.py:45-60) are not carried over: every
LayerNorm of the port runs through the kernel on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pgica_tpu_torch.ops import _kernels


MAX_ROW_SLOTS = 1024  # csrc/layernorm_{fwd,bwd}.cu: 256 threads of 4 slots a row


def _check_width(name: str, x: torch.Tensor) -> None:
    widest = MAX_ROW_SLOTS * (16 // x.element_size())
    if x.shape[1] > widest:
        raise ValueError(f"{name}: H = {x.shape[1]} is wider than the kernel's {widest} for {x.dtype}")


def layer_norm_ref(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: returns (y in x's dtype, mu f32, rstd f32); mu/rstd are x.shape[:-1]."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd * weight.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype), mu.squeeze(-1), rstd.squeeze(-1)


def layer_norm_fwd(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel wrapper over (rows, H): returns (y, mu, rstd) like :func:`layer_norm_ref`."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_fwd: unsupported device {x.device}")
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"layer_norm_fwd: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"layer_norm_fwd: x must be a contiguous (rows, H) tensor, got {tuple(x.shape)}")
    _check_width("layer_norm_fwd", x)
    rows, hidden = x.shape
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (hidden,) or not p.is_contiguous():
            raise ValueError(f"layer_norm_fwd: {name} must be contiguous float32 ({hidden},)")
        if p.device != x.device:
            raise ValueError(f"layer_norm_fwd: {name} is on {p.device}, x on {x.device}")
    y = torch.empty_like(x)
    mu = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mu, rstd
    _kernels.launch(
        "layernorm_fwd",
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), rows, hidden, float(eps), _kernels.DTYPE_CODES[x.dtype],
        _kernels.stream_handle(x),
    )
    return y, mu, rstd


MAX_PARTS = 228  # co-resident on any H100: 114 SMs (PCIe) x 2 blocks (csrc/layernorm_bwd.cu launch bounds)
MIN_ROWS_PER_PART = 4


def bwd_partition(rows: int, hidden: int) -> Tuple[int, int]:
    """The backward kernel's row partition: (rows per block, blocks).

    Block b takes rows [b * per, (b + 1) * per) and writes one partial row of
    dweight and of dbias. It depends on (rows, H) alone, never on the card, so
    the sums' order, and so their bits, are the same on every H100. Every
    width up to ``MAX_ROW_SLOTS`` keeps the blocks within the co-residency
    cap, so ``hidden`` does not move it today.
    """
    per = max(MIN_ROWS_PER_PART, -(-rows // MAX_PARTS))
    return per, -(-rows // per)


def layer_norm_bwd_ref(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel over (rows, H): (dx in x's dtype, dweight f32, dbias f32)."""
    xhat = (x.to(torch.float32) - mu[:, None]) * rstd[:, None]
    dyf = dy.to(torch.float32)
    dxhat = dyf * weight.to(torch.float32)
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    return dx.to(x.dtype), (dyf * xhat).sum(dim=0), dyf.sum(dim=0)


def layer_norm_bwd(
    x: torch.Tensor, weight: torch.Tensor, dy: torch.Tensor, mu: torch.Tensor, rstd: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernel wrapper over (rows, H): returns what :func:`layer_norm_bwd_ref` does."""
    if x.device.type == "cpu":
        return layer_norm_bwd_ref(x, weight, dy, mu, rstd)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_bwd: unsupported device {x.device}")
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"layer_norm_bwd: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"layer_norm_bwd: x must be a contiguous (rows, H) tensor, got {tuple(x.shape)}")
    _check_width("layer_norm_bwd", x)
    rows, hidden = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device or not dy.is_contiguous():
        raise ValueError(f"layer_norm_bwd: dy must be contiguous {x.dtype} {tuple(x.shape)} on {x.device}")
    for name, t, n in (("weight", weight, hidden), ("mu", mu, rows), ("rstd", rstd, rows)):
        if t.dtype != torch.float32 or t.shape != (n,) or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"layer_norm_bwd: {name} must be contiguous float32 ({n},) on {x.device}")
    dx = torch.empty_like(x)
    dweight = torch.empty(hidden, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    if rows == 0:
        return dx, dweight.zero_(), dbias.zero_()
    per, n_parts = bwd_partition(rows, hidden)
    partials = torch.empty((2, n_parts, hidden), dtype=torch.float32, device=x.device)
    _kernels.launch(
        "layernorm_bwd",
        x.data_ptr(), weight.data_ptr(), dy.data_ptr(), mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
        dweight.data_ptr(), dbias.data_ptr(), partials.data_ptr(), rows, hidden, per,
        _kernels.DTYPE_CODES[x.dtype], _kernels.stream_handle(x),
    )
    return dx, dweight, dbias


class _LayerNorm(torch.autograd.Function):
    """Forward kernel, saving mu and rstd; backward through the backward kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        y, mu, rstd = layer_norm_fwd(x, weight, bias, eps)
        ctx.save_for_backward(x, weight, mu, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mu, rstd = ctx.saved_tensors
        dx, dweight, dbias = layer_norm_bwd(x, weight, dy.contiguous(), mu, rstd)
        return dx, dweight, dbias, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; leading axes are flattened to rows. Differentiable."""
    hidden = x.shape[-1]
    x2 = x.reshape(-1, hidden).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or bias.requires_grad):
        return _LayerNorm.apply(x2, weight, bias, eps).view(x.shape)
    return layer_norm_fwd(x2, weight, bias, eps)[0].view(x.shape)


class LayerNorm(nn.Module):
    """LayerNorm with float32 ``weight``/``bias`` (the JAX ``scale``/``bias``), eps 1e-5.

    The input is cast to the compute ``dtype`` first, as the JAX module does
    (``x.astype(self.dtype)``), and the output comes back in it. The
    parameters stay float32 masters that the kernel reads as they are. When
    the model casts a copy for bf16 inference it puts them back in float32,
    keeping the bf16-rounded values the JAX package's ``cast_floating``
    produces.
    """

    def __init__(self, hidden: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x.to(self.dtype), self.weight, self.bias, self.eps)
