"""Training losses (port of pgica_tpu/ops/losses.py:32-338).

* ``ntxent_loss``: the symmetric InfoNCE of stage 1. With ``axis_name`` (a
  mesh axis or a tuple of them, bound by the active mesh) the negatives
  are global: this rank's rows are scored against both modalities'
  embeddings gathered over the axis, with labels offset by
  ``axis_index * local_b``; the gather's backward sums each embedding's
  cotangents back to its rank (parallel/collectives.py).
* ``ntxent_loss_fused``: the same loss through the fused linear-CE kernels
  (ops/fused_ce.py), each direction a target log-likelihood whose
  "vocabulary" is the other modality's (gathered) embeddings, so the
  (B, B_global) logits never reach device memory.
* ``sequence_logprobs`` (from logits) and ``sequence_logprobs_from_hidden``
  (through the fused linear-CE kernels, ops/fused_ce.py: the logits never
  exist): per-sequence log-probabilities under the causal shift.
  With ``mesh`` (a ``model`` axis of more than one rank) the log-probs go
  through the vocab-parallel fused CE on this rank's block of the vocab
  (JAX losses.py:145-205).
* ``cp_shift_targets``, ``cp_sequence_logprob_partials`` and
  ``cp_sequence_logprob_partials_from_hidden``: the context-parallel
  partial sums of one sequence shard, the causal shift crossing to the
  next shard through ``ppermute`` (JAX losses.py:220-285).
* ``dpo_loss``: DPO with a frozen reference (or reference-free), label
  smoothing and the four reward metrics; ``caption_cross_entropy``: the
  stage-0 token cross-entropy.

All losses compute in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from pgica_tpu_torch.ops.fused_ce import fused_token_logprobs, fused_token_logprobs_tp
from pgica_tpu_torch.parallel import collectives
from pgica_tpu_torch.parallel.mesh import AxisName


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def ntxent_loss(
    image_embeddings: torch.Tensor,
    text_embeddings: torch.Tensor,
    temperature: float = 0.5,
    axis_name: Optional[AxisName] = None,
    normalized: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE: (loss, {loss_i2t, loss_t2i, contrastive_accuracy}).

    Embeddings are (B, D), L2-normalized unless ``normalized=False``. Row i's
    positive is column i of the (B, B) similarity matrix; with ``axis_name``
    column ``axis_index * B + i`` of the (B, B_global) one, the accuracy over
    this rank's rows.
    """
    img = image_embeddings.to(torch.float32)
    txt = text_embeddings.to(torch.float32)
    if not normalized:
        img, txt = l2_normalize(img), l2_normalize(txt)
    local_b = img.shape[0]
    labels = torch.arange(local_b, device=img.device)
    if axis_name is not None:
        global_img = collectives.all_gather(img, axis_name)
        global_txt = collectives.all_gather(txt, axis_name)
        labels = labels + collectives.axis_index(axis_name) * local_b
        logits_i2t = img @ global_txt.T / temperature
        logits_t2i = txt @ global_img.T / temperature
    else:
        logits_i2t = img @ txt.T / temperature
        logits_t2i = logits_i2t.T
    loss_i2t = F.cross_entropy(logits_i2t, labels)
    loss_t2i = F.cross_entropy(logits_t2i, labels)
    loss = 0.5 * (loss_i2t + loss_t2i)
    acc = (logits_i2t.argmax(dim=-1) == labels).to(torch.float32).mean()
    return loss, {"loss_i2t": loss_i2t, "loss_t2i": loss_t2i, "contrastive_accuracy": acc}


def ntxent_loss_fused(
    image_embeddings: torch.Tensor,
    text_embeddings: torch.Tensor,
    temperature: float = 0.5,
    axis_name: Optional[AxisName] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`ntxent_loss` on L2-normalized embeddings through ``fused_token_logprobs``: (loss,
    {loss_i2t, loss_t2i}); the accuracy needs whole logits rows and is left out (JAX losses.py:110-142).

    i2t: h = img / temperature against W = txt; t2i: h = txt / temperature
    against W = img; row i's target is i. Both in float32. Where one tensor
    is h in one direction and W in the other, autograd sums its two gradients.
    With ``axis_name``, h is this rank's (B_loc, D) rows and W the (B_glob, D)
    embeddings gathered over the axis, row i's target ``axis_index * B_loc + i``;
    the dW kernel's gradient leaves through the gather's backward.
    """
    img = image_embeddings.to(torch.float32).contiguous()
    txt = text_embeddings.to(torch.float32).contiguous()
    labels = torch.arange(img.shape[0], device=img.device)
    w_img, w_txt = img, txt
    if axis_name is not None:
        w_img = collectives.all_gather(img, axis_name)
        w_txt = collectives.all_gather(txt, axis_name)
        labels = labels + collectives.axis_index(axis_name) * img.shape[0]
    loss_i2t = -fused_token_logprobs(img / temperature, w_txt, labels).mean()
    loss_t2i = -fused_token_logprobs(txt / temperature, w_img, labels).mean()
    loss = 0.5 * (loss_i2t + loss_t2i)
    return loss, {"loss_i2t": loss_i2t, "loss_t2i": loss_t2i}


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


def _vocab_block(embedding: torch.Tensor, vocab_size: int, axis: str) -> torch.Tensor:
    """This rank's (V/tp, d) block of the vocab: the embedding itself if it is the block already (a
    tensor-parallel ``wte``), else a whole one padded by zero rows to a multiple of the axis and cut
    (its gradient, partial on each rank, summed over the axis by ``copy_to``)."""
    n = collectives.axis_size(axis)
    if embedding.shape[0] * n == vocab_size and embedding.shape[0] != vocab_size:
        return embedding
    if embedding.shape[0] != vocab_size:
        raise ValueError(f"embedding of {embedding.shape[0]} rows is neither the vocab of {vocab_size} nor "
                         f"a block of it over {n} ranks")
    vloc = -(-vocab_size // n)
    whole = collectives.copy_to(embedding, axis)
    if vloc * n != vocab_size:
        whole = torch.cat([whole, whole.new_zeros(vloc * n - vocab_size, whole.shape[1])])
    return whole[collectives.axis_index(axis) * vloc:(collectives.axis_index(axis) + 1) * vloc]


def _token_logprobs(rows: torch.Tensor, embedding: torch.Tensor, targets: torch.Tensor, vocab_size: Optional[int],
                    vocab_axis: Optional[str]) -> torch.Tensor:
    """Fused log-probs of (N, d) rows; vocab-parallel over ``vocab_axis`` when it is given."""
    if vocab_axis is None:
        return fused_token_logprobs(rows, embedding, targets)
    block = _vocab_block(embedding, vocab_size, vocab_axis)
    return fused_token_logprobs_tp(rows, block.contiguous(), targets, vocab_axis, true_vocab=vocab_size)


def _tp_axis(mesh, vocab_axis: str) -> Optional[str]:
    return vocab_axis if mesh is not None and mesh.shape[vocab_axis] > 1 else None


def sequence_logprobs_from_hidden(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    length_normalized: bool = False,
    mesh=None,
    vocab_size: Optional[int] = None,
    vocab_axis: str = "model",
) -> torch.Tensor:
    """:func:`sequence_logprobs` with logits = hidden @ embedding^T, through the fused
    linear-CE kernels: hidden (B, S, d), embedding (V, d) -> (B,) float32.

    With ``mesh`` whose ``vocab_axis`` has more than one rank (bound, ``with
    mesh:``), the vocab-parallel route: ``embedding`` is this rank's block of
    the ``vocab_size`` rows (a tensor-parallel ``wte``) or the whole table,
    which is then padded to a multiple of the axis and cut here; the rows
    are this rank's, replicated over the axis."""
    b, s, d = hidden.shape
    rows = hidden[:, :-1].reshape(b * (s - 1), d)
    targets = input_ids[:, 1:].reshape(-1)
    tok_logp = _token_logprobs(rows, embedding, targets, vocab_size or embedding.shape[0],
                               _tp_axis(mesh, vocab_axis)).reshape(b, s - 1)
    return _masked_sum(tok_logp, attention_mask, length_normalized)


def cp_shift_targets(input_ids: torch.Tensor, attention_mask: torch.Tensor,
                     axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """This shard's (targets, float32 target mask), both (B, S_local), of the global causal shift.

    Local position t predicts global position t + 1: the shard's last target
    is the next shard's first column (``ppermute``); the global final
    position predicts nothing and is masked on the last shard. A target's
    validity is its position's attention mask, as in the unsharded shift.
    """
    n = collectives.axis_size(axis_name)
    perm = [((i + 1) % n, i) for i in range(n)]  # the next shard sends to me
    nxt_ids = collectives.ppermute(input_ids[:, :1].contiguous(), axis_name, perm)
    nxt_mask = collectives.ppermute(attention_mask[:, :1].contiguous(), axis_name, perm)
    targets = torch.cat([input_ids[:, 1:], nxt_ids], dim=1)
    tmask = torch.cat([attention_mask[:, 1:], nxt_mask], dim=1).to(torch.float32)
    if collectives.axis_index(axis_name) == n - 1:
        tmask[:, -1] = 0.0
    return targets, tmask


def cp_sequence_logprob_partials(logits: torch.Tensor, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                                 axis_name: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """This shard's (log-prob sum, target count), both (B,), of the (B, S_local, V) logits; summed over
    ``axis_name`` they are :func:`sequence_logprobs` of the whole sequences and their token counts."""
    targets, tmask = cp_shift_targets(input_ids, attention_mask, axis_name)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    tok = logp.gather(-1, targets.long()[..., None])[..., 0]
    return (tok * tmask).sum(dim=-1), tmask.sum(dim=-1)


def cp_sequence_logprob_partials_from_hidden(
    hidden: torch.Tensor,
    embedding: torch.Tensor,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    axis_name: str,
    mesh=None,
    vocab_size: Optional[int] = None,
    vocab_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`cp_sequence_logprob_partials` through the fused linear-CE kernels (the logits never exist);
    with ``mesh`` whose ``vocab_axis`` has more than one rank, vocab-parallel on the shard's rows."""
    b, s, d = hidden.shape
    targets, tmask = cp_shift_targets(input_ids, attention_mask, axis_name)
    tok = _token_logprobs(hidden.reshape(b * s, d), embedding, targets.reshape(-1),
                          vocab_size or embedding.shape[0], _tp_axis(mesh, vocab_axis)).reshape(b, s)
    return (tok * tmask).sum(dim=-1), tmask.sum(dim=-1)


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
