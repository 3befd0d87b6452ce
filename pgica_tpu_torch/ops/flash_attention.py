"""Flash-attention forward: the plain PyTorch version and the CUDA kernel's wrapper.

Mirrors pgica_tpu/ops/flash_attention.py:34-78,183-217,295-326. Layout is
(batch, heads, seq, head_dim), as in the JAX package. The kernel
(csrc/flash_attn_fwd.cu) replaces the Pallas ``_fwd_kernel``
(flash_attention.py:34): online softmax in float32, a per-key additive bias
(B, Sk) in float32 shared across heads, an optional causal mask with the JAX
kernel's semantics ``rows >= cols``, and it returns O in the input dtype
plus the row logsumexp in float32.

Where the port is likely to differ from the JAX package:

* Finite mask fill. ``NEG_INF = -1e9`` is a finite additive bias, as in both
  JAX paths (flash_attention.py:31,323, attention.py:22): a row whose keys
  are all masked averages V instead of giving 0 or NaN. The port keeps it.
* Causal exclusion. Keys above the causal diagonal get p = 0 here, where
  the JAX kernel fills their scores with NEG_INF. Results agree except on a
  causal row whose keys are all padding: the port averages V over the keys
  at or before the row, the JAX kernel over the keys of the blocks it
  visited (block-size dependent), the plain JAX path over all keys.
* Scale and cast order. The kernel and :func:`flash_attention_ref` scale q
  by 1/sqrt(d) before QK^T and keep p in float32 for PV; the plain JAX path
  (attention.py:35,43) divides the scores and casts the softmax weights to
  v's dtype first. In bf16 the two differ at bf16 rounding level.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs :func:`flash_attention_ref`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pgica_tpu_torch.ops import _kernels

NEG_INF = -1.0e9
HEAD_DIMS = (16, 32, 64, 128)  # the kernel is templated on these


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: (o in q's dtype, lse f32 (B, H, Sq))."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = (q.to(torch.float32) * (1.0 / d**0.5)) @ k.to(torch.float32).transpose(-1, -2)
    if bias is not None:
        s = s + bias[:, None, None, :]
    if causal:  # keys above the diagonal are left out, not filled
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)  # the kernel starts m at NEG_INF
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (p @ v.to(torch.float32)) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper: q (B, H, Sq, D), k and v (B, H, Sk, D), bias None or (B, Sk) f32."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    if q.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"flash_attention_fwd: q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention_fwd: expected (B, H, S, D) q, k, v with k.shape == v.shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {d} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be contiguous {q.dtype} on {q.device}")
        if t.data_ptr() % 16:  # the kernel stages rows with 16-byte loads
            raise ValueError(f"flash_attention_fwd: {name} must start on a 16-byte boundary")
    if bias is not None and (
        bias.shape != (b, sk) or bias.dtype != torch.float32
        or bias.device != q.device or not bias.is_contiguous()
    ):
        raise ValueError(f"flash_attention_fwd: bias must be contiguous float32 ({b}, {sk}) on {q.device}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    _kernels.launch(
        "flash_attn_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b * h, h, sq, sk, d, int(causal), 1.0 / d**0.5,
        _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q),
    )
    return o, lse


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Attention output only; see :func:`flash_attention_fwd`."""
    return flash_attention_fwd(q, k, v, bias, causal)[0]
