"""Decoder-only transformer LM, GPT-2 and Llama architectures (PyTorch).

Mirrors pgica_tpu/models/lm.py:27-209: token embeddings (the ``input_ids``
path of the text tower; GPT-2 adds learned positions ``wpe``, Llama has none
and rotates q and k instead) or ``inputs_embeds`` (the decoder), causal
pre-norm blocks (GPT-2: LayerNorm, GELU, biases; Llama: RMSNorm, SwiGLU,
RoPE, grouped-query heads, no biases), ``ln_f`` and, with ``with_lm_head``,
the weight-tied head ``logits = h @ wte.T``. The head is one large matmul that
the JAX package leaves to XLA outside any kernel, so it stays ``F.linear``
here. ``with_logits=False`` skips it for one call: the stage-2 step takes
its log-probs from the hidden states through the fused linear-CE kernels,
where XLA drops the unused logits from the JAX graph (train_step.py:268-269);
eager PyTorch would compute and keep them.
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
    """Causal transformer over token ids or input embeddings, with an optional tied LM head."""

    def __init__(self, config: LMConfig, with_lm_head: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        if cfg.arch not in ("gpt2", "llama"):
            raise ValueError(f"unknown arch {cfg.arch!r}")
        llama = cfg.arch == "llama"
        self.config = cfg
        self.with_lm_head = with_lm_head
        self.dtype = dtype
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        if not llama:  # Llama's positions come from RoPE alone
            self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_heads, int(cfg.hidden_size * cfg.mlp_ratio),
                causal=True, norm_eps=cfg.norm_eps, mlp_kind="swiglu" if llama else "gelu",
                dropout=cfg.dropout, dtype=dtype, norm="rmsnorm" if llama else "layernorm",
                num_kv_heads=cfg.num_kv_heads, use_bias=not llama, use_rope=llama, rope_theta=cfg.rope_theta,
            )
            for _ in range(cfg.num_layers)
        )
        self.ln_f = make_norm("rmsnorm" if llama else "layernorm", cfg.hidden_size, cfg.norm_eps, dtype)

    @property
    def learned_positions(self) -> bool:
        """GPT-2 adds ``wpe``; Llama rotates q and k (RoPE) instead."""
        return self.config.arch == "gpt2"

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        caches: Optional[KVCaches] = None,
        position: int = 0,
        generator: Optional[torch.Generator] = None,
        with_logits: bool = True,
    ) -> dict:
        """input_ids (B, S) or inputs_embeds (B, S, hidden); attention_mask (B, S), or (B, max_len) with caches.

        Token ids get ``wte`` plus, for GPT-2, ``wpe`` of positions
        ``position .. position + S - 1`` (JAX lm.py:172-181); Llama's
        attention rotates q and k at those positions. Returns ``hidden_states``,
        ``logits`` (B, S, V) with the LM head unless ``with_logits`` is
        False, and ``caches`` (the same list, written in place, or None).
        ``generator`` drives dropout (None: off).
        """
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("Provide input_ids or inputs_embeds")
            x = self.wte(input_ids).to(self.dtype)
            if self.learned_positions:
                positions = torch.arange(position, position + input_ids.shape[1], device=input_ids.device)
                x = x + self.wpe(positions).to(self.dtype)[None]
        else:
            x = inputs_embeds.to(self.dtype)
        # one key bias for the whole forward, shared by every layer's attention
        key_bias = None if attention_mask is None else key_padding_bias(attention_mask)
        for i, block in enumerate(self.blocks):
            x = block(x, key_bias, None if caches is None else caches[i], position, generator)
        x = self.ln_f(x)
        out = {"hidden_states": x, "caches": caches}
        if self.with_lm_head and with_logits:
            out["logits"] = F.linear(x, self.wte.weight.to(self.dtype))
        return out
