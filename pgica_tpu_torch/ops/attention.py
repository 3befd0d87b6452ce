"""Multi-head attention dispatch over (batch, heads, seq, head_dim) tensors.

Mirrors pgica_tpu/ops/attention.py:25-79. ``dot_product_attention`` sends
``mask=None`` and key-padding masks (B, 1, 1, Sk) to the flash-attention
kernel wrapper (the mask becomes a per-key additive bias through
:func:`key_padding_bias`), and general masks to :func:`xla_attention`, the
plain softmax path that keeps the JAX function's name. The model builds the
key bias once per forward with :func:`key_padding_bias` and hands it to every
layer's attention. The JAX dispatch's TPU-tuned crossover
(``_pallas_supported``: head_dim >= 128 and seq >= 256) is not carried over:
every self-attention of the port runs through the kernels on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from pgica_tpu_torch.ops.flash_attention import NEG_INF, flash_attention


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    causal: bool,
) -> torch.Tensor:
    """Plain softmax attention. q, k, v: (B, H, S, D); mask: (B, 1|H, Sq, Sk), 0 = masked.

    Same order as the JAX reference: f32 scores divided by sqrt(d), causal as
    ``tril(k=Sk-Sq)``, softmax, weights cast to v's dtype before PV.
    """
    depth = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), k.to(torch.float32))
    scores = scores / depth**0.5
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        scores = torch.where(keep, scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask.to(torch.bool), scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", weights.to(v.dtype), v)


def key_padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """Key mask (B, Sk), 0 = masked, as the kernel's additive bias: float32 0 or NEG_INF."""
    return torch.where(mask.to(torch.bool), 0.0, NEG_INF)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Scaled dot-product attention; ``mask`` broadcastable to (B, H, Sq, Sk), 0 = masked."""
    if mask is None:
        return flash_attention(q, k, v, None, causal)
    if mask.dim() == 4 and mask.shape[1] == 1 and mask.shape[2] == 1:
        bias = key_padding_bias(mask[:, 0, 0, :].expand(q.shape[0], k.shape[2]))
        return flash_attention(q, k, v, bias, causal)
    return xla_attention(q, k, v, mask, causal)
