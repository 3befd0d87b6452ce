"""Fused linear + cross-entropy: plain PyTorch versions, CUDA kernel wrappers, autograd.

Mirrors pgica_tpu/ops/fused_ce.py:47-50,178-274,397-422: per-row target
log-probabilities straight from hidden states and the (weight-tied)
embedding, ``logp[r] = h[r] . W[y[r]] - logsumexp_v(h[r] . W[v])``, without
the (rows, vocab) logits ever reaching device memory on the card. Three
kernels, all in ``csrc/fused_ce.cu``:

* ``fused_ce_fwd`` replaces the Pallas ``_fwd_kernel`` (:60): logp and the
  per-row logsumexp (saved for the backward), both float32.
* ``fused_ce_bwd_dh`` replaces ``_bwd_dh_kernel`` (:108):
  ``dh = g * (onehot - p) @ W`` in h's dtype.
* ``fused_ce_bwd_dw`` replaces ``_bwd_dw_kernel`` (:134):
  ``dW = ((onehot - p) * g)^T @ h`` in W's dtype, the same from run to run.

h and W may each be float32 or bf16 (the stage-2 policy passes bf16 hidden
states with its float32 master W, the reference bf16 with bf16). Rows and
vocab need no alignment; d must be a multiple of 8 on the card. Dispatch is
by device only: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the plain version, which materializes the logits as the JAX package's
XLA fallback does (:345-351).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from pgica_tpu_torch.ops import _kernels

FWD_ROWS = 64  # csrc/fused_ce.cu: kFwdRows
VOCAB_TILE = 128  # csrc/fused_ce.cu: kVTile
BLOCKS_PER_SM = 8  # the forward splits the vocab until there are about this many blocks per SM


def fused_ce_fwd_ref(
    hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (logp, lse), both float32 (N,); the logits are computed in float32."""
    logits = hidden.to(torch.float32) @ embedding.to(torch.float32).T
    logp = torch.log_softmax(logits, dim=-1).gather(-1, targets.long()[:, None])[:, 0]
    return logp, torch.logsumexp(logits, dim=-1)


def token_logprobs_ref(hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The port of ``_xla_token_logprobs``: f32 ``log_softmax(h @ W^T)`` at the targets, (N,)."""
    return fused_ce_fwd_ref(hidden, embedding, targets)[0]


def _coeff_ref(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """(onehot - p) * g, float32 (N, V), as the JAX fallback writes it (fused_ce.py:345-349)."""
    logits = hidden.to(torch.float32) @ embedding.to(torch.float32).T
    p = torch.exp(logits - lse[:, None])
    onehot = torch.zeros_like(p).scatter_(-1, targets.long()[:, None], 1.0)
    return (onehot - p) * g.to(torch.float32)[:, None]


def fused_ce_bwd_dh_ref(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """Plain dh = coeff @ W in h's dtype (N, d)."""
    coeff = _coeff_ref(hidden, embedding, targets, lse, g)
    return (coeff @ embedding.to(torch.float32)).to(hidden.dtype)


def fused_ce_bwd_dw_ref(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """Plain dW = coeff^T @ h in W's dtype (V, d)."""
    coeff = _coeff_ref(hidden, embedding, targets, lse, g)
    return (coeff.T @ hidden.to(torch.float32)).to(embedding.dtype)


def fused_ce_bwd_ref(hidden, embedding, targets, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward as the JAX fallback writes it: (dh in h's dtype, dW in W's dtype)."""
    coeff = _coeff_ref(hidden, embedding, targets, lse, g)
    dh = (coeff @ embedding.to(torch.float32)).to(hidden.dtype)
    return dh, (coeff.T @ hidden.to(torch.float32)).to(embedding.dtype)


def _check(name: str, hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor, *rows) -> None:
    """What the kernels take: contiguous, 16-byte aligned (N, d) and (V, d), d % 8 == 0, one card."""
    if hidden.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {hidden.device}")
    for what, t in (("hidden", hidden), ("embedding", embedding)):
        if t.dtype not in _kernels.DTYPE_CODES:
            raise TypeError(f"{name}: {what} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be a contiguous, 16-byte aligned 2-D tensor")
        if t.device != hidden.device:
            raise ValueError(f"{name}: {what} is on {t.device}, hidden on {hidden.device}")
    n, d = hidden.shape
    if embedding.shape[1] != d or d % 8:
        raise ValueError(f"{name}: hidden (N, {d}) and embedding {tuple(embedding.shape)} need one d, a multiple of 8")
    if targets.shape != (n,) or targets.device != hidden.device:
        raise ValueError(f"{name}: targets must be ({n},) on {hidden.device}")
    for t in rows:  # lse, g
        if t.shape != (n,) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != hidden.device:
            raise ValueError(f"{name}: lse and g must be contiguous float32 ({n},) on {hidden.device}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def vocab_splits(rows: int, vocab: int, sm_count: int) -> Tuple[int, int]:
    """(splits, span): the forward's vocab split, so that there are ~8 blocks per SM.

    ``span`` is a multiple of ``VOCAB_TILE``; every split is non-empty.
    """
    row_tiles = -(-rows // FWD_ROWS)
    tiles = -(-vocab // VOCAB_TILE)
    want = max(1, min(tiles, -(-BLOCKS_PER_SM * sm_count // row_tiles)))
    per = -(-tiles // want)
    return -(-tiles // per), per * VOCAB_TILE


def _codes(hidden: torch.Tensor, embedding: torch.Tensor) -> Tuple[int, int]:
    return _kernels.DTYPE_CODES[hidden.dtype], _kernels.DTYPE_CODES[embedding.dtype]


def fused_ce_fwd(
    hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper: (logp, lse), float32 (N,), like :func:`fused_ce_fwd_ref`."""
    if hidden.device.type == "cpu":
        return fused_ce_fwd_ref(hidden, embedding, targets)
    _check("fused_ce_fwd", hidden, embedding, targets)
    n, d = hidden.shape
    vocab = embedding.shape[0]
    logp = torch.empty(n, dtype=torch.float32, device=hidden.device)
    lse = torch.empty_like(logp)
    if n == 0:
        return logp, lse
    splits, span = vocab_splits(n, vocab, _sm_count(hidden.device.index or 0))
    partials = torch.empty((3, splits, n), dtype=torch.float32, device=hidden.device)
    y = targets.to(torch.int32).contiguous()
    _kernels.launch(
        "fused_ce_fwd",
        hidden.data_ptr(), embedding.data_ptr(), y.data_ptr(), partials.data_ptr(), logp.data_ptr(),
        lse.data_ptr(), n, vocab, d, splits, span, *_codes(hidden, embedding), _kernels.stream_handle(hidden),
    )
    return logp, lse


def _bwd(name: str, out: torch.Tensor, hidden, embedding, targets, lse, g) -> torch.Tensor:
    _check(name, hidden, embedding, targets, lse, g)
    n, d = hidden.shape
    if n == 0:
        return out.zero_()
    y = targets.to(torch.int32).contiguous()
    _kernels.launch(
        name,
        hidden.data_ptr(), embedding.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(), out.data_ptr(),
        n, embedding.shape[0], d, *_codes(hidden, embedding), _kernels.stream_handle(hidden),
    )
    return out


def fused_ce_bwd_dh(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """dh kernel wrapper: (N, d) in h's dtype, like :func:`fused_ce_bwd_dh_ref`."""
    if hidden.device.type == "cpu":
        return fused_ce_bwd_dh_ref(hidden, embedding, targets, lse, g)
    return _bwd("fused_ce_bwd_dh", torch.empty_like(hidden), hidden, embedding, targets, lse, g)


def fused_ce_bwd_dw(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """dW kernel wrapper: (V, d) in W's dtype, like :func:`fused_ce_bwd_dw_ref`."""
    if hidden.device.type == "cpu":
        return fused_ce_bwd_dw_ref(hidden, embedding, targets, lse, g)
    return _bwd("fused_ce_bwd_dw", torch.empty_like(embedding), hidden, embedding, targets, lse, g)


class _FusedTokenLogprobs(torch.autograd.Function):
    """Forward kernel, saving lse; backward through the dh and dW kernels."""

    @staticmethod
    def forward(ctx, hidden, embedding, targets):
        logp, lse = fused_ce_fwd(hidden, embedding, targets)
        ctx.save_for_backward(hidden, embedding, targets, lse)
        return logp

    @staticmethod
    def backward(ctx, g):
        hidden, embedding, targets, lse = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dh = fused_ce_bwd_dh(hidden, embedding, targets, lse, g) if ctx.needs_input_grad[0] else None
        dw = fused_ce_bwd_dw(hidden, embedding, targets, lse, g) if ctx.needs_input_grad[1] else None
        return dh, dw, None


def fused_token_logprobs(hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Target-token log-probs for flattened rows: (N, d), (V, d), (N,) -> float32 (N,). Differentiable."""
    hidden = hidden.contiguous()
    if torch.is_grad_enabled() and (hidden.requires_grad or embedding.requires_grad):
        return _FusedTokenLogprobs.apply(hidden, embedding, targets)
    return fused_ce_fwd(hidden, embedding, targets)[0]
