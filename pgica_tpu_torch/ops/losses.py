"""Training losses (port of pgica_tpu/ops/losses.py:32-107,145-217,287-338).

* ``ntxent_loss``: the symmetric InfoNCE of stage 1 over one batch's local
  negatives. Global negatives gathered across devices (the JAX
  ``axis_name``) wait for the parallel slice.
* ``sequence_logprobs`` (from logits) and ``sequence_logprobs_from_hidden``
  (through the fused linear-CE kernels, ops/fused_ce.py: the logits never
  exist): per-sequence log-probabilities under the causal shift.
* ``dpo_loss``: DPO with a frozen reference (or reference-free), label
  smoothing and the four reward metrics; ``caption_cross_entropy``: the
  stage-0 token cross-entropy.

All losses compute in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pgica_tpu_torch.ops.fused_ce import fused_token_logprobs


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def ntxent_loss(
    image_embeddings: torch.Tensor,
    text_embeddings: torch.Tensor,
    temperature: float = 0.5,
    axis_name: Optional[str] = None,
    normalized: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE: (loss, {loss_i2t, loss_t2i, contrastive_accuracy}).

    Embeddings are (B, D), L2-normalized unless ``normalized=False``. Row i's
    positive is column i of the (B, B) similarity matrix.
    """
    if axis_name is not None:
        raise NotImplementedError(
            "ntxent_loss: negatives gathered over a device axis wait for the parallel slice "
            "(ROADMAP §1 item 13)"
        )
    img = image_embeddings.to(torch.float32)
    txt = text_embeddings.to(torch.float32)
    if not normalized:
        img, txt = l2_normalize(img), l2_normalize(txt)
    labels = torch.arange(img.shape[0], device=img.device)
    logits_i2t = img @ txt.T / temperature
    loss_i2t = F.cross_entropy(logits_i2t, labels)
    loss_t2i = F.cross_entropy(logits_i2t.T, labels)
    loss = 0.5 * (loss_i2t + loss_t2i)
    acc = (logits_i2t.argmax(dim=-1) == labels).to(torch.float32).mean()
    return loss, {"loss_i2t": loss_i2t, "loss_t2i": loss_t2i, "contrastive_accuracy": acc}


def _shifted_token_logprobs(logits: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(B, S-1) f32 log-probs of token t+1 under position t's logits."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    return logp.gather(-1, ids[:, 1:].long()[..., None])[..., 0]


def _masked_sum(tok_logp: torch.Tensor, attention_mask: torch.Tensor, length_normalized: bool) -> torch.Tensor:
    """Sum of (B, S-1) token log-probs over the targets' mask; mean over valid tokens if normalized."""
    mask = attention_mask[:, 1:].to(torch.float32)
    summed = (tok_logp * mask).sum(dim=-1)
    if length_normalized:
        summed = summed / mask.sum(dim=-1).clamp_min(1.0)
    return summed


def sequence_logprobs(
    logits: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    length_normalized: bool = False,
) -> torch.Tensor:
    """Per-sequence log-probability of ``input_ids`` under ``logits`` (B, S, V) -> (B,).

    Position t's logits predict token t+1; padding is excluded through
    ``attention_mask``; ``length_normalized`` averages over valid tokens.
    """
    return _masked_sum(_shifted_token_logprobs(logits, input_ids), attention_mask, length_normalized)


def sequence_logprobs_from_hidden(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    length_normalized: bool = False,
    mesh=None,
) -> torch.Tensor:
    """:func:`sequence_logprobs` with logits = hidden @ embedding^T, through the fused
    linear-CE kernels: hidden (B, S, d), embedding (V, d) -> (B,) float32."""
    if mesh is not None:
        raise NotImplementedError(
            "sequence_logprobs_from_hidden: the vocab-parallel path (mesh) waits for the parallel "
            "slice (ROADMAP §1 item 13)"
        )
    b, s, d = hidden.shape
    rows = hidden[:, :-1].reshape(b * (s - 1), d)
    targets = input_ids[:, 1:].reshape(-1)
    tok_logp = fused_token_logprobs(rows, embedding, targets).reshape(b, s - 1)
    return _masked_sum(tok_logp, attention_mask, length_normalized)


def dpo_loss(
    policy_chosen_logps: torch.Tensor,
    policy_rejected_logps: torch.Tensor,
    reference_chosen_logps: Optional[torch.Tensor] = None,
    reference_rejected_logps: Optional[torch.Tensor] = None,
    beta: float = 0.1,
    label_smoothing: float = 0.0,
    reference_free: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DPO on the implicit reward ``beta * (logpi - logref)``: (loss, {reward_margin,
    reward_accuracy, chosen_reward, rejected_reward}). ``reference_free`` (or no
    reference) drops the reference terms."""
    no_ref = reference_free or reference_chosen_logps is None
    pi_diff = policy_chosen_logps - policy_rejected_logps
    ref_diff = torch.zeros_like(pi_diff) if no_ref else reference_chosen_logps - reference_rejected_logps
    logits = (pi_diff - ref_diff).to(torch.float32)
    losses = (
        -F.logsigmoid(beta * logits) * (1.0 - label_smoothing)
        - F.logsigmoid(-beta * logits) * label_smoothing
    )
    chosen_reward = beta * (policy_chosen_logps - (0.0 if no_ref else reference_chosen_logps))
    rejected_reward = beta * (policy_rejected_logps - (0.0 if no_ref else reference_rejected_logps))
    metrics = {
        "reward_margin": (chosen_reward - rejected_reward).mean(),
        "reward_accuracy": (chosen_reward > rejected_reward).to(torch.float32).mean(),
        "chosen_reward": chosen_reward.mean(),
        "rejected_reward": rejected_reward.mean(),
    }
    return losses.mean(), metrics


def caption_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
    """Shifted, padding-masked token cross entropy: the mean over valid tokens."""
    mask = attention_mask[:, 1:].to(torch.float32)
    return -(_shifted_token_logprobs(logits, labels) * mask).sum() / mask.sum().clamp_min(1.0)
