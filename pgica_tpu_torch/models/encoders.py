"""Text encoder tower (port of pgica_tpu/models/encoders.py).

A transformer LM (GPT-2 or Llama, models/lm.py) over caption tokens (no LM
head), masked mean pooling with the divisor clamped to at least 1, and the
projection head. The JAX parameter tree names it ``text_encoder/backbone``
and ``text_encoder/projection``; the port keeps the names.

``freeze_backbone`` detaches the backbone's hidden states (JAX
encoders.py:66, ``stop_gradient``), so no gradient reaches the backbone;
the trainer also leaves it out of the optimizer unless LoRA trains its
adapters. ``shared_backbone`` is the ``share_text_tower`` LM (JAX
``shared_lm``), owned by the top-level module and referenced here without
registering it; its tied head is skipped in this forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pgica_tpu_torch.models.lm import TransformerLM
from pgica_tpu_torch.models.presets import LMConfig
from pgica_tpu_torch.models.vit import ProjectionHead


def masked_mean_pool(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the unmasked tokens; the divisor is clamped to >= 1 (JAX encoders.py:22-27)."""
    mask_f = mask.to(hidden.dtype)[..., None]
    return (hidden * mask_f).sum(dim=1) / mask_f.sum(dim=1).clamp_min(1.0)


class TextEncoder(nn.Module):
    """Transformer text tower + masked mean pooling + projection head."""

    def __init__(
        self,
        config: LMConfig,
        projection_dim: int = 512,
        dropout: float = 0.1,
        freeze_backbone: bool = False,
        dtype: torch.dtype = torch.float32,
        shared_backbone: Optional[TransformerLM] = None,
    ):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        if shared_backbone is not None:
            object.__setattr__(self, "backbone", shared_backbone)  # not a child: the top-level module owns it
        else:
            self.backbone = TransformerLM(config, with_lm_head=False, dtype=dtype)
        self.projection = ProjectionHead(config.hidden_size, projection_dim, dropout, dtype)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = self.backbone(input_ids=input_ids, attention_mask=attention_mask, generator=generator,
                               with_logits=False)["hidden_states"]
        if self.freeze_backbone:
            hidden = hidden.detach()
        pooled = masked_mean_pool(hidden, attention_mask)
        return {
            "hidden_states": hidden,
            "pooled_output": pooled,
            "embeddings": self.projection(pooled, generator),
        }
