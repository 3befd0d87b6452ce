"""Fused linear + cross-entropy: plain PyTorch versions, CUDA kernel wrappers, autograd.

Mirrors pgica_tpu/ops/fused_ce.py:47-50,178-274,397-422: per-row target
log-probabilities straight from hidden states and the (weight-tied)
embedding, ``logp[r] = h[r] . W[y[r]] - logsumexp_v(h[r] . W[v])``, without
the (rows, vocab) logits ever reaching device memory on the card. Three
kernels:

* ``fused_ce_fwd`` (``csrc/fused_ce.cu``) replaces the Pallas ``_fwd_kernel``
  (:60): logp and the per-row logsumexp (saved for the backward), both
  float32. One block per 128 x 128 tile of scores (:func:`fwd_tiles`) writes
  each row's (max, sum, target score) partial; a second kernel combines
  them in vocab order.
* ``fused_ce_bwd_dh`` and ``fused_ce_bwd_dw`` (``csrc/fused_ce_bwd.cu``)
  replace ``_bwd_dh_kernel`` (:108) and ``_bwd_dw_kernel`` (:134):
  ``dh = g * (onehot - p) @ W`` in h's dtype and ``dW = ((onehot - p) *
  g)^T @ h`` in W's dtype. The vocab is walked in chunks of
  :func:`dh_vocab_chunk` columns. dW takes the rows with g != 0 first
  (:func:`fused_ce_bwd_dw`).

All three run one GEMM template on the tensor cores (``csrc/fce_gemm.cuh``)
for every type pair, each the same from run to run: a bf16 operand goes in
as it is, an f32 one (the master W, an f32 h, and in the backward's product
always the f32 coefficients) as bf16 parts whose products are summed in f32
(three parts for the scores, two for the product), so the result keeps f32
accuracy (the source notes have the error argument). The forward's scores
take the backward's passes, so its lse is the one the backward's scores
imply.

h and W may each be float32 or bf16 (the stage-2 policy passes bf16 hidden
states with its float32 master W, the reference bf16 with bf16). Rows and
vocab need no alignment; d must be a multiple of 8 on the card. Dispatch is
by device only: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the plain version, which materializes the logits as the JAX package's
XLA fallback does (:345-351).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pgica_tpu_torch.ops import _kernels

GEMM_TILE = 128  # csrc/fce_gemm.cuh: kBM = kBN, the forward's tiles and the unit of the backward's vocab chunks
MAX_GRID_Y = 65535  # CUDA's limit on a grid's second dimension: the forward's column tiles
DH_SCRATCH_BYTES = 256 * 2**20  # cap on the backward's coefficient scratch (two bf16 parts, rows x chunk each)


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


def fwd_tiles(vocab: int) -> int:
    """Column tiles of the forward: its grid is (rows, vocab) in ``GEMM_TILE`` squares of scores,
    and each column tile writes a (max, sum, target score) partial per row, f32 (``12 * rows *
    tiles`` bytes of scratch). Raises past ``MAX_GRID_Y`` tiles."""
    tiles = -(-vocab // GEMM_TILE)
    if tiles > MAX_GRID_Y:
        raise ValueError(f"fused_ce_fwd: a vocab of {vocab} needs {tiles} column tiles, more than {MAX_GRID_Y}")
    return tiles


def dh_vocab_chunk(rows: int, vocab: int) -> int:
    """Vocab columns per chunk of the dh and dW kernels: a multiple of ``GEMM_TILE``, as
    many as keep its coefficient scratch (``2 * 2 * rows * chunk`` bytes) within
    ``DH_SCRATCH_BYTES`` (one tile at the least), and no more than the vocab
    needs. The kernel walks ``ceil(vocab / chunk)`` chunks, each non-empty."""
    fit = max(1, DH_SCRATCH_BYTES // (4 * max(rows, 1) * GEMM_TILE))
    return GEMM_TILE * min(fit, -(-vocab // GEMM_TILE))


def _codes(hidden: torch.Tensor, embedding: torch.Tensor) -> Tuple[int, int]:
    return _kernels.DTYPE_CODES[hidden.dtype], _kernels.DTYPE_CODES[embedding.dtype]


def _split_scratch(t: torch.Tensor) -> Optional[torch.Tensor]:
    """Room for the three bf16 parts of an f32 operand; None for a bf16 one (it goes in as it is)."""
    return torch.empty((3, *t.shape), dtype=torch.bfloat16, device=t.device) if t.dtype == torch.float32 else None


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_ce_fwd(
    hidden: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel wrapper: (logp, lse), float32 (N,), like :func:`fused_ce_fwd_ref`.

    On the card it allocates the kernel's scratch: the partials of
    :func:`fwd_tiles` and the three bf16 parts of an f32 operand (of the f32
    master W: 3.2 GB at Llama-3-8B's (128256, 4096)), freed on return.
    """
    if hidden.device.type == "cpu":
        return fused_ce_fwd_ref(hidden, embedding, targets)
    _check("fused_ce_fwd", hidden, embedding, targets)
    n, d = hidden.shape
    vocab = embedding.shape[0]
    logp = torch.empty(n, dtype=torch.float32, device=hidden.device)
    lse = torch.empty_like(logp)
    if n == 0:
        return logp, lse
    partials = torch.empty((3, fwd_tiles(vocab), n), dtype=torch.float32, device=hidden.device)
    h_split, w_split = _split_scratch(hidden), _split_scratch(embedding)
    y = targets.to(torch.int32).contiguous()
    _kernels.launch(
        "fused_ce_fwd",
        hidden.data_ptr(), embedding.data_ptr(), y.data_ptr(), _ptr(h_split), _ptr(w_split), partials.data_ptr(),
        logp.data_ptr(), lse.data_ptr(), n, vocab, d, *_codes(hidden, embedding), _kernels.stream_handle(hidden),
    )
    return logp, lse


def fused_ce_bwd_dh(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """dh kernel wrapper: (N, d) in h's dtype, like :func:`fused_ce_bwd_dh_ref`.

    On the card it allocates the kernel's scratch: the coefficients of one
    vocab chunk (two bf16 parts, <= ``DH_SCRATCH_BYTES``), the f32 sums when
    there is more than one chunk, and the three bf16 parts of an f32 operand
    (of the f32 master W: 6 bytes per element of W, 3.2 GB at Llama-3-8B's
    (128256, 4096)).
    """
    if hidden.device.type == "cpu":
        return fused_ce_bwd_dh_ref(hidden, embedding, targets, lse, g)
    _check("fused_ce_bwd_dh", hidden, embedding, targets, lse, g)
    n, d = hidden.shape
    vocab = embedding.shape[0]
    dh = torch.empty_like(hidden)
    if n == 0:
        return dh
    dev = hidden.device
    chunk = dh_vocab_chunk(n, vocab)
    h_split, w_split = _split_scratch(hidden), _split_scratch(embedding)
    coeff = torch.empty((2, n, chunk), dtype=torch.bfloat16, device=dev)
    acc = torch.empty((n, d), dtype=torch.float32, device=dev) if vocab > chunk else None
    y = targets.to(torch.int32).contiguous()
    _kernels.launch(
        "fused_ce_bwd_dh",
        hidden.data_ptr(), embedding.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(), dh.data_ptr(),
        _ptr(h_split), _ptr(w_split), coeff.data_ptr(), _ptr(acc), n, vocab, d, chunk, *_codes(hidden, embedding),
        _kernels.stream_handle(hidden),
    )
    return dh


def live_rows_first(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, live): the row indices with those whose g != 0 first, each group in its order, and
    the count of such rows as an int32 0-d tensor on g's device (no host sync)."""
    order = torch.argsort((g == 0).to(torch.uint8), stable=True)
    return order, (g != 0).sum(dtype=torch.int32)


def fused_ce_bwd_dw(hidden, embedding, targets, lse, g) -> torch.Tensor:
    """dW kernel wrapper: (V, d) in W's dtype, like :func:`fused_ce_bwd_dw_ref`.

    On the card the kernel takes the rows reordered by :func:`live_rows_first`:
    its sums over rows then group the live rows' terms the same way whatever
    masked rows (g = 0) lay between them, so dW is bit-identical to dW over the
    live rows alone, and the masked rows cost no work. The wrapper allocates
    the scratch: the coefficients of one vocab chunk (two bf16 parts, as dh's)
    and the three bf16 parts of an f32 operand (3.2 GB for Llama-3-8B's f32 W).
    """
    if hidden.device.type == "cpu":
        return fused_ce_bwd_dw_ref(hidden, embedding, targets, lse, g)
    _check("fused_ce_bwd_dw", hidden, embedding, targets, lse, g)
    n, d = hidden.shape
    vocab = embedding.shape[0]
    dw = torch.empty_like(embedding)
    if n == 0:
        return dw.zero_()
    order, live = live_rows_first(g)
    hidden = hidden.index_select(0, order)
    y = targets.index_select(0, order).to(torch.int32)
    lse, g = lse.index_select(0, order), g.index_select(0, order)
    chunk = dh_vocab_chunk(n, vocab)
    h_split, w_split = _split_scratch(hidden), _split_scratch(embedding)
    coeff = torch.empty((2, chunk, -(-n // 8) * 8), dtype=torch.bfloat16, device=hidden.device)
    _kernels.launch(
        "fused_ce_bwd_dw",
        hidden.data_ptr(), embedding.data_ptr(), y.data_ptr(), lse.data_ptr(), g.data_ptr(), live.data_ptr(),
        dw.data_ptr(), _ptr(h_split), _ptr(w_split), coeff.data_ptr(), n, vocab, d, chunk,
        *_codes(hidden, embedding), _kernels.stream_handle(hidden),
    )
    return dw


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
