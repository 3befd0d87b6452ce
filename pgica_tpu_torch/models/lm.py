"""Decoder-only transformer LM, GPT-2 architecture (PyTorch).

Mirrors pgica_tpu/models/lm.py:27-209 for the decode path: token and learned
position embeddings, causal pre-norm blocks, ``ln_f`` and the weight-tied
head ``logits = h @ wte.T``. The head is one large matmul that the JAX
package leaves to XLA outside any kernel, so it stays ``F.linear`` here.
The Llama arch waits for its slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pgica_tpu_torch.models.layers import KVCaches, TransformerBlock, make_norm
from pgica_tpu_torch.models.presets import LMConfig
from pgica_tpu_torch.ops.attention import key_padding_bias


def init_kv_cache(
    cfg: LMConfig, batch: int, max_len: int, dtype: torch.dtype, device: torch.device
) -> KVCaches:
    """All-zeros per-layer (k, v) caches, each (B, H_kv, max_len, D).

    Slots past the current position stay zero; the decode key mask keeps
    them out of attention (JAX lm.py:185-192).
    """
    shape = (batch, cfg.kv_heads, max_len, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.num_layers)
    ]


class TransformerLM(nn.Module):
    """Causal transformer over input embeddings with the tied LM head."""

    def __init__(self, config: LMConfig):
        super().__init__()
        cfg = config
        if cfg.arch != "gpt2":
            raise NotImplementedError(f"arch {cfg.arch!r} is not ported yet (Llama slice)")
        self.config = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_heads, int(cfg.hidden_size * cfg.mlp_ratio),
                causal=True, norm_eps=cfg.norm_eps, mlp_kind="gelu",
            )
            for _ in range(cfg.num_layers)
        )
        self.ln_f = make_norm("layernorm", cfg.hidden_size, cfg.norm_eps)

    def forward(
        self,
        inputs_embeds: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        caches: Optional[KVCaches] = None,
        position: int = 0,
    ) -> dict:
        """inputs_embeds (B, S, hidden); attention_mask (B, S), or (B, max_len) with caches.

        Returns ``hidden_states``, ``logits`` (B, S, V) and ``caches`` (the
        same list, written in place, or None).
        """
        x = inputs_embeds.to(self.wte.weight.dtype)
        # one key bias for the whole forward, shared by every layer's attention
        key_bias = None if attention_mask is None else key_padding_bias(attention_mask)
        for i, block in enumerate(self.blocks):
            x = block(x, key_bias, None if caches is None else caches[i], position)
        x = self.ln_f(x)
        return {"hidden_states": x, "logits": F.linear(x, self.wte.weight), "caches": caches}
