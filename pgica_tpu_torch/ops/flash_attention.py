"""Flash attention, forward and backward: plain PyTorch versions, CUDA kernel wrappers, autograd.

Mirrors pgica_tpu/ops/flash_attention.py:34-167,183-292,295-326. Layout is
(batch, heads, seq, head_dim), as in the JAX package. Three kernels:

* ``csrc/flash_attn_fwd.cu`` replaces the Pallas ``_fwd_kernel`` (:34):
  online softmax in float32, a per-key additive bias (B, Sk) in float32
  shared across heads, an optional causal mask ``rows >= cols``; it returns
  O in the input dtype and the row logsumexp in float32. Two kernels, chosen
  by :func:`fwd_on_tensor_cores` from the dtype and Sq: bf16 at Sq >=
  ``TC_MIN_SQ`` runs on the tensor cores (``flash_attn_fwd_tc``, P rounded
  once to bf16 for PV); decode, short Sq and float32 run on the CUDA cores
  in f32 (``flash_attn_fwd``).
* ``csrc/flash_attn_bwd.cu`` replaces ``_bwd_dq_kernel`` (:130) and
  ``_bwd_dkv_kernel`` (:81). ``delta = rowsum(dO * O)``, which the JAX
  wrapper computes apart (:233), is folded into the dQ kernel: it runs first
  and writes delta for the dK/dV kernel. The two stay split, as in the JAX
  package, so neither needs atomics. Both dispatch by dtype: bf16 runs on
  the tensor cores (``flash_attn_bwd_dkv_tc``, P and dS as two bf16 parts
  each in their products; ``flash_attn_bwd_dq_tc``, dS rounded once to bf16
  in dS K), float32 on the CUDA cores in full f32 FMAs
  (``flash_attn_bwd_dkv_f32``, ``flash_attn_bwd_dq_f32``: the same
  FlashAttention-2 layout, register-tiled).

Masking follows the plain JAX path (attention.py:_xla_attention), which is
what the JAX package runs at these shapes: a masked key (bias <= NEG_INF, or
above the causal diagonal) scores exactly ``NEG_INF = -1e9``. A row that
keeps any key gives it p = 0; a row whose keys are all masked averages V over
all Sk keys. In the backward every masked key gets ds = 0, so such a row adds
dO / Sk to every key's dV and nothing to dq or dk — what ``jax.grad`` of
``_xla_attention`` gives. The Pallas backward zeroes such a row's p instead
(:106-108) and so disagrees with XLA's own gradient there.

Scale and cast order: the kernels and the plain versions scale q by
1/sqrt(d) before QK^T and keep p in float32 for PV; the plain JAX path
(attention.py:35,43) divides the scores and casts the softmax weights to v's
dtype first. In bf16 the two differ at bf16 rounding level.

Dispatch is by device only: a CUDA tensor launches the kernel (or raises), a
CPU tensor runs the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pgica_tpu_torch.ops import _kernels

NEG_INF = -1.0e9
HEAD_DIMS = (16, 32, 64, 72, 128)  # the kernels are templated on these (72: SigLIP so400m)
# Sq from which a bf16 forward runs on the tensor cores. Measured on the H100 over a cache of 129 keys
# (chip_smoke.py phase 3, PERF.md §6): at Sq 1 and 2 the CUDA-core kernel is as fast or faster (a few
# q rows fill little of a 16-row mma tile), from Sq 3 the tensor cores win at D 64 and 128.
TC_MIN_SQ = 3


def fwd_on_tensor_cores(dtype: torch.dtype, sq: int) -> bool:
    """Whether the forward runs on the tensor cores: bf16 at Sq >= ``TC_MIN_SQ``; f32 never."""
    return dtype == torch.bfloat16 and sq >= TC_MIN_SQ


def _scores(q, k, bias, causal):
    """f32 scores of q scaled by 1/sqrt(d), masked keys at NEG_INF, and the keep mask."""
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = (q.to(torch.float32) * (1.0 / d**0.5)) @ k.to(torch.float32).transpose(-1, -2)
    keep = torch.ones((1, 1, 1, sk), dtype=torch.bool, device=q.device)
    if bias is not None:
        s = s + bias[:, None, None, :]
        keep = (bias > NEG_INF)[:, None, None, :]
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        keep = keep & (rows >= torch.arange(sk, device=q.device)[None, :])
    return torch.where(keep, s, NEG_INF), keep


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: (o in q's dtype, lse f32 (B, H, Sq))."""
    s, _ = _scores(q, k, bias, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p @ v.to(torch.float32)) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    causal: bool,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels: (dq, dk, dv in the input dtypes, delta f32).

    A row whose keys are all masked is found from its lse (about NEG_INF,
    as the Pallas kernels test it): it spreads dO evenly over the Sk keys'
    dV and has ds = 0.
    """
    sk, d = k.shape[2], q.shape[3]
    s, keep = _scores(q, k, bias, causal)
    without_key = (lse <= 0.5 * NEG_INF)[..., None]
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    p = torch.where(without_key, 1.0 / sk, p)
    dof = do.to(torch.float32)
    delta = (dof * o.to(torch.float32)).sum(-1)
    dv = p.transpose(-1, -2) @ dof
    dp = dof @ v.to(torch.float32).transpose(-1, -2)
    ds = torch.where(keep & ~without_key, p * (dp - delta[..., None]), 0.0) * (1.0 / d**0.5)
    dq = ds @ k.to(torch.float32)
    dk = ds.transpose(-1, -2) @ q.to(torch.float32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), delta


def _check(name: str, q, k, v, bias) -> None:
    """Raise on what the kernels do not take."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got {q.device}")
    if q.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"{name}: expected (B, H, S, D) q, k, v with k.shape == v.shape, "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, h, _, d = q.shape
    sk = k.shape[2]
    if k.shape[:2] != (b, h) or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if bias is not None and (
        bias.shape != (b, sk) or bias.dtype != torch.float32
        or bias.device != q.device or not bias.is_contiguous()
    ):
        raise ValueError(f"{name}: bias must be contiguous float32 ({b}, {sk}) on {q.device}")


def _check_operand(name: str, t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    if t.dtype != like.dtype or t.device != like.device or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous {like.dtype} on {like.device}")
    if t.data_ptr() % 16:  # the kernels stage rows with 16-byte loads
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary")


def _bias_ptr(bias: Optional[torch.Tensor]):
    return None if bias is None else bias.data_ptr()


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
    tensor_cores: Optional[bool] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper: q (B, H, Sq, D), k and v (B, H, Sk, D), bias None or (B, Sk) f32.

    ``tensor_cores`` picks the kernel on the card; None takes :func:`fwd_on_tensor_cores`
    (True or False only to measure one kernel against the other).
    """
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: unsupported device {q.device}")
    _check("flash_attention_fwd", q, k, v, bias)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand("flash_attention_fwd", t, q, name)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if tensor_cores is None:
        tensor_cores = fwd_on_tensor_cores(q.dtype, sq)
    elif tensor_cores and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_fwd: the tensor-core kernel takes bfloat16, got {q.dtype}")
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * h * sq == 0:
        return o, lse
    _kernels.launch(
        "flash_attn_fwd",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _bias_ptr(bias),
        o.data_ptr(), lse.data_ptr(), b * h, h, sq, sk, d, int(causal), 1.0 / d**0.5,
        _kernels.DTYPE_CODES[q.dtype], int(tensor_cores), _kernels.stream_handle(q),
    )
    return o, lse


def flash_attention_bwd_dq(q, k, v, bias, causal, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor]:
    """dQ kernel wrapper: returns (dq in q's dtype, delta = rowsum(dO * O) f32 (B, H, Sq)).

    bf16 inputs go to the tensor-core kernel, float32 ones to the f32 CUDA-core kernel.
    """
    _check("flash_attention_bwd_dq", q, k, v, bias)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_operand("flash_attention_bwd_dq", t, q, name)
    b, h, sq, d = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd_dq: lse must be contiguous float32 ({b}, {h}, {sq}) on {q.device}")
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _kernels.launch(
        "flash_attn_bwd_dq",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _bias_ptr(bias), o.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), delta.data_ptr(), b * h, h, sq, k.shape[2], d, int(causal),
        1.0 / d**0.5, _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q),
    )
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, bias, causal, lse, delta, do) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel wrapper: returns (dk, dv) in k's dtype; ``delta`` from the dQ kernel.

    bf16 inputs go to the tensor-core kernel, float32 ones to the f32 CUDA-core kernel.
    """
    _check("flash_attention_bwd_dkv", q, k, v, bias)
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        _check_operand("flash_attention_bwd_dkv", t, q, name)
    b, h, sq, d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                f"flash_attention_bwd_dkv: {name} must be contiguous float32 ({b}, {h}, {sq}) on {q.device}")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _kernels.launch(
        "flash_attn_bwd_dkv",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _bias_ptr(bias), lse.data_ptr(), delta.data_ptr(),
        do.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, sq, k.shape[2], d, int(causal),
        1.0 / d**0.5, _kernels.DTYPE_CODES[q.dtype], _kernels.stream_handle(q),
    )
    return dk, dv


def flash_attention_bwd(q, k, v, bias, causal, o, lse, do) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the two backward kernels on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, bias, causal, o, lse, do)[:3]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device {q.device}")
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, delta = flash_attention_bwd_dq(q, k, v, bias, causal, o, lse, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, causal, lse, delta, do)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, saving o and lse; backward through the two backward kernels.

    The bias is a mask, not a parameter: it gets no gradient, as in the JAX
    package (flash_attention.py:288).
    """

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        o, lse = flash_attention_fwd(q, k, v, bias, causal)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, ctx.causal, o, lse, do.contiguous())
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Attention output; differentiable in q, k and v through the backward kernels."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bias, causal)
    return flash_attention_fwd(q, k, v, bias, causal)[0]
