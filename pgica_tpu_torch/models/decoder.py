"""Vision-conditioned caption decoder, decode path (PyTorch).

Mirrors pgica_tpu/models/decoder.py:41-183. The projected vision embedding
(Dense + tanh) is the first position of the sequence and tokens extend it.

* ``decode_prefix`` adds ``wpe(0)`` to the vision token and primes the
  caches at position 0 (decoder.py:142-153).
* ``decode_step`` adds ``wpe(position)`` to the token embedding
  (decoder.py:169-176).
* ``cross_attention`` and ``cross_ln`` are kept so the parameter tree is
  complete, but — as in the JAX package and the reference it mirrors — they
  do NOT run at decode time (decoder.py:16-21). The teacher-forced training
  forward that uses them waits for the training slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from pgica_tpu_torch.models.layers import KVCaches, MultiHeadAttention
from pgica_tpu_torch.models.lm import TransformerLM
from pgica_tpu_torch.models.presets import LMConfig
from pgica_tpu_torch.ops.layernorm import LayerNorm


class CaptionDecoder(nn.Module):
    def __init__(self, config: LMConfig, projection_dim: int = 512, num_cross_heads: int = 8):
        super().__init__()
        self.config = config
        self.vision_projection = nn.Linear(projection_dim, config.hidden_size)
        self.cross_attention = MultiHeadAttention(config.hidden_size, num_cross_heads)
        self.cross_ln = LayerNorm(config.hidden_size, 1e-5)
        self.lm = TransformerLM(config)

    def project_vision(self, vision_embeddings: torch.Tensor) -> torch.Tensor:
        """(B, projection_dim) -> (B, 1, hidden) vision token."""
        weight = self.vision_projection.weight
        return torch.tanh(self.vision_projection(vision_embeddings.to(weight.dtype)))[:, None, :]

    def decode_prefix(
        self, vision_embeddings: torch.Tensor, caches: KVCaches, attention_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, KVCaches]:
        """Vision token at position 0 -> (logits for the first token (B, V), caches)."""
        vision_token = self.project_vision(vision_embeddings) + self.lm.wpe.weight[:1][None]
        out = self.lm(vision_token, attention_mask, caches, position=0)
        return out["logits"][:, -1, :], out["caches"]

    def decode_step(
        self, token_ids: torch.Tensor, position: int, caches: KVCaches, attention_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, KVCaches]:
        """One step: (B, 1) tokens written at cache slot ``position`` -> (B, V) next-token logits."""
        embeds = self.lm.wte(token_ids) + self.lm.wpe.weight[position][None, None]
        out = self.lm(embeds, attention_mask, caches, position=position)
        return out["logits"][:, -1, :], out["caches"]
