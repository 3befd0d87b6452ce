"""LayerNorm forward: the plain PyTorch version, the CUDA kernel's wrapper and the module.

Mirrors pgica_tpu/ops/layernorm.py:63-85,358-406: statistics in float32 over
the last axis, ``y = (x - mu) * rstd * weight + bias`` cast back to x's
dtype, with float32 ``weight``/``bias`` (the JAX ``scale``/``bias``). The
kernel (csrc/layernorm_fwd.cu) replaces the Pallas ``_fwd_kernel``
(layernorm.py:75) and also writes mu and rstd in float32, as that kernel does
for the backward pass.

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


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; leading axes are flattened to rows."""
    hidden = x.shape[-1]
    y, _, _ = layer_norm_fwd(x.reshape(-1, hidden).contiguous(), weight, bias, eps)
    return y.view(x.shape)


class LayerNorm(nn.Module):
    """LayerNorm with float32 ``weight``/``bias`` (the JAX ``scale``/``bias``), eps 1e-5.

    The parameters stay float32 when the module is cast for bf16 inference
    (the model casts them back, keeping the bf16-rounded values the JAX
    package's ``cast_floating`` produces), because the kernel reads float32
    gamma and beta.
    """

    def __init__(self, hidden: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(hidden, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)
