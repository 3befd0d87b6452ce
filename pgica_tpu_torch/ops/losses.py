"""Contrastive training losses (port of pgica_tpu/ops/losses.py:32-84).

``ntxent_loss`` is the symmetric InfoNCE of stage 1 over one batch's local
negatives. Global negatives gathered across devices (the JAX ``axis_name``)
wait for the parallel slice. All losses compute in float32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


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
