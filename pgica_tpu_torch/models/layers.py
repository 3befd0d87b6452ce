"""Core transformer building blocks (PyTorch).

Mirrors pgica_tpu/models/layers.py:26-293 for the serving slice: the norm
factory, multi-head attention with a KV cache written at one scalar position,
the GELU MLPs, and the pre-norm block. Left out until their slices: RoPE,
GQA, SwiGLU/RMSNorm (Llama configs), ring attention, int8 and per-row cache
positions (continuous batching).

Computation runs in the dtype of the parameters: the model casts a copy of
its float32 masters once for bf16 inference, as the JAX package does
(model.py:370-387), and Flax's ``Dense(dtype=bf16)`` then computes exactly
what ``nn.Linear`` with bf16 weights computes. LayerNorm parameters stay
float32 (see ops/layernorm.py).

Parameter shapes follow PyTorch (``nn.Linear`` weight is (out, in));
models/convert.py maps the JAX tree onto them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pgica_tpu_torch.ops.flash_attention import flash_attention
from pgica_tpu_torch.ops.layernorm import LayerNorm

# (k, v), each (B, H, max_len, D). Caches are plain lists of these tuples,
# written IN PLACE at the decode position — unlike the JAX package, whose
# caches are functional values threaded through the loop (layers.py:141-158).
KVCache = Tuple[torch.Tensor, torch.Tensor]
KVCaches = List[KVCache]


def make_norm(kind: str, hidden: int, eps: float = 1e-5) -> nn.Module:
    """eps defaults to 1e-5 (HF GPT-2/CLIP convention)."""
    if kind != "layernorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet (Llama slice)")
    return LayerNorm(hidden, eps)


class MultiHeadAttention(nn.Module):
    """Self-attention with an optional KV cache (JAX layers.py:55-193)."""

    def __init__(self, hidden_size: int, num_heads: int, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        inner = num_heads * self.head_dim
        self.q_proj = nn.Linear(hidden_size, inner)
        self.k_proj = nn.Linear(hidden_size, inner)
        self.v_proj = nn.Linear(hidden_size, inner)
        self.out_proj = nn.Linear(inner, hidden_size)

    def forward(
        self,
        x: torch.Tensor,
        key_bias: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        position: int = 0,
    ) -> torch.Tensor:
        """x (B, S, hidden); key_bias (B, Sk) float32 from ``key_padding_bias``, or None.

        With ``cache``, the new k/v are written into it at ``position`` (in
        place) and attention runs over the whole cache.
        """
        b, s, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, S, H*D) -> (B, H, S, D)
            return t.view(b, s, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        if cache is not None:
            k_cache, v_cache = cache
            k_cache[:, :, position:position + s] = k
            v_cache[:, :, position:position + s] = v
            k, v = k_cache, v_cache
        causal = self.causal and cache is None  # decode masks through `key_bias`
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), key_bias, causal)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, kind: str = "gelu"):
        super().__init__()
        if kind not in ("gelu", "quick_gelu"):
            raise NotImplementedError(f"MLP kind {kind!r} is not ported yet")
        self.kind = kind
        self.fc_in = nn.Linear(hidden_size, intermediate_size)
        self.fc_out = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc_in(x)
        if self.kind == "quick_gelu":  # CLIP's activation: x * sigmoid(1.702x)
            h = h * torch.sigmoid(1.702 * h)
        else:  # GPT-2: flax nn.gelu(approximate=True)
            h = F.gelu(h, approximate="tanh")
        return self.fc_out(h)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block; ``ln_0``/``ln_1`` are the JAX ``LayerNorm_0``/``LayerNorm_1``."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        intermediate_size: int = 0,
        causal: bool = False,
        norm_eps: float = 1e-5,
        mlp_kind: str = "gelu",
    ):
        super().__init__()
        self.ln_0 = make_norm("layernorm", hidden_size, norm_eps)
        self.attn = MultiHeadAttention(hidden_size, num_heads, causal)
        self.ln_1 = make_norm("layernorm", hidden_size, norm_eps)
        self.mlp = MLP(hidden_size, intermediate_size or 4 * hidden_size, mlp_kind)

    def forward(
        self,
        x: torch.Tensor,
        key_bias: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        position: int = 0,
    ) -> torch.Tensor:
        x = x + self.attn(self.ln_0(x), key_bias, cache, position)
        return x + self.mlp(self.ln_1(x))
