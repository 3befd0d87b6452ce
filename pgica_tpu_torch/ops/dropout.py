"""Dropout with the keep probability quantized to t/256 (port of pgica_tpu/ops/dropout.py).

The JAX package's ``FastDropout`` draws 8 random bits per element and keeps
an element when its byte is below ``t = round((1 - rate) * 256)``, clamped to
[1, 255]; kept elements are scaled by ``256 / t`` — the same t — so that
E[dropout(x)] == x exactly. The realized drop rate is quantized (rate 0.1
drops 26/256 = 0.1016). Rate 0 and deterministic calls are the identity.

Here the bytes come from ``torch.randint`` on an explicit ``torch.Generator``.
The mask stream cannot match JAX's (another generator); tests compare the
semantics, not the bits. This is plain PyTorch, not a kernel: the JAX
package has no kernel for it either.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def keep_threshold(rate: float) -> int:
    """t: an element is kept when its random byte is below t; the scale is 256 / t."""
    return min(max(int(round((1.0 - rate) * 256)), 1), 255)


def fast_dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout from one random byte per element (see the module docstring)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    t = keep_threshold(rate)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8, device=x.device, generator=generator)
    return torch.where(bits < t, x * (256.0 / t), torch.zeros_like(x))


class FastDropout(nn.Module):
    """Dropout module. ``generator=None`` is the deterministic (eval) call, as the
    JAX module's ``deterministic=True``: training passes the step's generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if generator is None or self.rate <= 0.0:
            return x
        return fast_dropout(x, self.rate, generator)
