"""Core transformer building blocks (PyTorch).

Mirrors pgica_tpu/models/layers.py:26-293: the norm factory (LayerNorm or
RMSNorm), rotary position embeddings, multi-head attention (self-attention
with a KV cache written at one scalar position, or cross-attention to a
``kv`` input; grouped-query heads; RoPE), the GELU and SwiGLU MLPs with
dropout, and the pre-norm block. Left out until their slices: ring
attention, int8 and per-row cache positions (continuous batching).

Every module takes the compute ``dtype`` at construction, as the Flax
modules do. :class:`Dense` is Flax's ``Dense(dtype, param_dtype=float32)``:
it casts its input and its float32 master weights to ``dtype`` in every
forward, inside the autograd graph, so training in bf16 sends gradients to
the float32 masters. For bf16 inference the model casts a copy of the masters
once instead (model.py), and the per-forward cast is then a no-op. LayerNorm
and RMSNorm parameters stay float32 (see ops/layernorm.py, ops/rmsnorm.py).

Dropout follows the JAX modules' ``deterministic`` flag through an optional
``generator`` argument: ``None`` is the deterministic call (eval, serving);
training passes the step's ``torch.Generator`` (see ops/dropout.py).

Parameter shapes follow PyTorch (``nn.Linear`` weight is (out, in));
models/convert.py maps the JAX tree onto them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pgica_tpu_torch.ops.attention import xla_attention
from pgica_tpu_torch.ops.dropout import FastDropout
from pgica_tpu_torch.ops.flash_attention import flash_attention
from pgica_tpu_torch.ops.layernorm import LayerNorm
from pgica_tpu_torch.ops.rmsnorm import RMSNorm

# (k, v), each (B, H, max_len, D). Caches are plain lists of these tuples,
# written IN PLACE at the decode position — unlike the JAX package, whose
# caches are functional values threaded through the loop (layers.py:141-158).
KVCache = Tuple[torch.Tensor, torch.Tensor]
KVCaches = List[KVCache]


def make_norm(kind: str, hidden: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> nn.Module:
    """``"rmsnorm"`` (Llama) or LayerNorm; eps defaults to 1e-5 (HF GPT-2/CLIP convention)."""
    if kind == "rmsnorm":
        return RMSNorm(hidden, eps, dtype)
    return LayerNorm(hidden, eps, dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on (B, H, S, D) at integer ``positions`` (S,), as JAX layers.py:41-52.

    Interleaved pairs (``x[..., 0::2]``, ``x[..., 1::2]``), not Hugging
    Face's ``rotate_half``; float32 angles ``positions / theta**(2i/d)``, cos
    and sin in float32, the result cast back to x's dtype.
    """
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions.to(torch.float32)[:, None] * freqs  # (S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` from float32 master weights (Flax ``Dense``); ``bias`` optional."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class MultiHeadAttention(nn.Module):
    """Self-attention with an optional KV cache, or cross-attention to ``kv`` (JAX layers.py:55-193).

    ``num_kv_heads`` below ``num_heads`` is grouped-query attention: the k and
    v projections give ``num_kv_heads`` heads, the cache keeps that many, and
    each is repeated for its ``num_heads // num_kv_heads`` query heads after
    the cache (``repeat_interleave``, ``jnp.repeat``'s order). ``use_rope``
    rotates q and k before the cache write, at positions ``position ..
    position + S - 1``.
    """

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        causal: bool = False,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        num_kv_heads: Optional[int] = None,
        use_bias: bool = True,
        use_rope: bool = False,
        rope_theta: float = 500000.0,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        inner = num_heads * self.head_dim
        kv_inner = self.num_kv_heads * self.head_dim
        self.q_proj = Dense(hidden_size, inner, dtype, use_bias)
        self.k_proj = Dense(hidden_size, kv_inner, dtype, use_bias)
        self.v_proj = Dense(hidden_size, kv_inner, dtype, use_bias)
        self.out_proj = Dense(inner, hidden_size, dtype, use_bias)
        self.dropout = FastDropout(dropout)

    def forward(
        self,
        x: torch.Tensor,
        key_bias: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        position: int = 0,
        generator: Optional[torch.Generator] = None,
        kv: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x (B, S, hidden); key_bias (B, Sk) float32 from ``key_padding_bias``, or None.

        With ``cache``, the new k/v are written into it at ``position`` (in
        place) and attention runs over the whole cache. With ``kv`` (B, Sk,
        hidden), keys and values come from it (cross-attention, unmasked):
        the decoder's single vision token, which the JAX package pins to the
        plain attention (decoder.py:78), so it runs ``xla_attention`` here
        too, outside any kernel.
        """
        b, s, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, S, n*D) -> (B, n, S, D)
            return t.view(b, t.shape[1], -1, self.head_dim).transpose(1, 2)

        src = x if kv is None else kv
        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(src)), heads(self.v_proj(src))
        if kv is not None:
            out = xla_attention(q, k, v, None, False)
            return self.dropout(self.out_proj(out.transpose(1, 2).reshape(b, s, -1)), generator)
        if self.use_rope:
            positions = torch.arange(position, position + s, device=x.device)
            q = rotary_embedding(q, positions, self.rope_theta)
            k = rotary_embedding(k, positions, self.rope_theta)
        if cache is not None:
            k_cache, v_cache = cache
            k_cache[:, :, position:position + s] = k
            v_cache[:, :, position:position + s] = v
            k, v = k_cache, v_cache
        if self.num_kv_heads != self.num_heads:
            rep = self.num_heads // self.num_kv_heads
            k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
        causal = self.causal and cache is None  # decode masks through `key_bias`
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), key_bias, causal)
        return self.dropout(self.out_proj(out.transpose(1, 2).reshape(b, s, -1)), generator)


class MLP(nn.Module):
    """``gelu`` (GPT-2, SigLIP) or ``quick_gelu`` (CLIP): fc_in, activation, fc_out; ``swiglu``
    (Llama): down_proj(silu(gate_proj(x)) * up_proj(x)). Dropout on the output (JAX layers.py:196-232)."""

    def __init__(
        self,
        hidden_size: int,
        intermediate_size: int,
        kind: str = "gelu",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        use_bias: bool = True,
    ):
        super().__init__()
        self.kind = kind
        if kind == "swiglu":
            self.gate_proj = Dense(hidden_size, intermediate_size, dtype, use_bias)
            self.up_proj = Dense(hidden_size, intermediate_size, dtype, use_bias)
            self.down_proj = Dense(intermediate_size, hidden_size, dtype, use_bias)
        elif kind in ("gelu", "quick_gelu"):
            self.fc_in = Dense(hidden_size, intermediate_size, dtype, use_bias)
            self.fc_out = Dense(intermediate_size, hidden_size, dtype, use_bias)
        else:
            raise ValueError(f"unknown MLP kind {kind!r}")
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.kind == "swiglu":
            return self.dropout(self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x)), generator)
        h = self.fc_in(x)
        if self.kind == "quick_gelu":  # CLIP's activation: x * sigmoid(1.702x)
            h = h * torch.sigmoid(1.702 * h)
        else:  # GPT-2: flax nn.gelu(approximate=True)
            h = F.gelu(h, approximate="tanh")
        return self.dropout(self.fc_out(h), generator)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block; ``ln_0``/``ln_1`` are the JAX ``LayerNorm_0``/``LayerNorm_1``
    (``RMSNorm_0``/``RMSNorm_1`` with ``norm="rmsnorm"``)."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        intermediate_size: int = 0,
        causal: bool = False,
        norm_eps: float = 1e-5,
        mlp_kind: str = "gelu",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        norm: str = "layernorm",
        num_kv_heads: Optional[int] = None,
        use_bias: bool = True,
        use_rope: bool = False,
        rope_theta: float = 500000.0,
    ):
        super().__init__()
        self.ln_0 = make_norm(norm, hidden_size, norm_eps, dtype)
        self.attn = MultiHeadAttention(hidden_size, num_heads, causal, dropout, dtype, num_kv_heads, use_bias,
                                       use_rope, rope_theta)
        self.ln_1 = make_norm(norm, hidden_size, norm_eps, dtype)
        self.mlp = MLP(hidden_size, intermediate_size or 4 * hidden_size, mlp_kind, dropout, dtype, use_bias)

    def forward(
        self,
        x: torch.Tensor,
        key_bias: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        position: int = 0,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = x + self.attn(self.ln_0(x), key_bias, cache, position, generator)
        return x + self.mlp(self.ln_1(x), generator)
