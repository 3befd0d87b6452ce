"""Architecture presets (port's copy of pgica_tpu/models/presets.py).

Model *names* resolve to built-in architecture presets, so the HF
identifiers in the configs keep working offline. tests/test_torch_ops.py
holds every preset equal, field for field, to the JAX package's. Left out:
``scan_layers`` (a JAX ``lax.scan`` layout with no counterpart in eager
PyTorch). Added: ``remat``, activation checkpointing of every block (a
module attribute in the JAX package, lm.py:50 and vit.py:32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """CLIP-style vision transformer configuration."""

    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    dropout: float = 0.0
    hidden_act: str = "quick_gelu"  # CLIP convention; "gelu" for SigLIP-style towers
    norm_eps: float = 1e-5
    remat: bool = False  # recompute each block's activations in the backward

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer configuration (GPT-2 or Llama family)."""

    vocab_size: int = 50257  # resized to tokenizer vocab at construction
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    num_kv_heads: Optional[int] = None  # != num_heads -> GQA (llama arch)
    max_position_embeddings: int = 1024
    mlp_ratio: float = 4.0
    dropout: float = 0.1
    arch: str = "gpt2"  # "gpt2": learned pos + LayerNorm + GELU; "llama": RoPE + RMSNorm + SwiGLU
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    remat: bool = False  # recompute each block's activations in the backward

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


VISION_PRESETS = {
    "openai/clip-vit-base-patch32": ViTConfig(224, 32, 768, 12, 12),
    "openai/clip-vit-base-patch16": ViTConfig(224, 16, 768, 12, 12),
    "openai/clip-vit-large-patch14": ViTConfig(224, 14, 1024, 24, 16),
    "google/siglip-so400m-patch14-384": ViTConfig(384, 14, 1152, 27, 16, mlp_ratio=4304 / 1152, hidden_act="gelu", norm_eps=1e-6),
    "tiny-vit": ViTConfig(32, 8, 32, 2, 2),
}

TEXT_PRESETS = {
    "gpt2": LMConfig(hidden_size=768, num_layers=12, num_heads=12),
    "gpt2-medium": LMConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "gpt2-large": LMConfig(hidden_size=1280, num_layers=36, num_heads=20),
    "gpt2-xl": LMConfig(hidden_size=1600, num_layers=48, num_heads=25),
    "microsoft/DialoGPT-medium": LMConfig(hidden_size=1024, num_layers=24, num_heads=16),
    "meta-llama/Meta-Llama-3-8B": LMConfig(
        hidden_size=4096,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        max_position_embeddings=8192,
        mlp_ratio=14336 / 4096,
        arch="llama",
        norm_eps=1e-5,
    ),
    "tiny-gpt2": LMConfig(hidden_size=32, num_layers=2, num_heads=2, max_position_embeddings=64),
    "tiny-llama": LMConfig(
        hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
        max_position_embeddings=64, arch="llama",
    ),
}


def get_vision_config(name: str, **overrides) -> ViTConfig:
    if name not in VISION_PRESETS:
        raise ValueError(f"Unknown vision model preset: {name!r} (known: {sorted(VISION_PRESETS)})")
    return dataclasses.replace(VISION_PRESETS[name], **overrides)


def get_text_config(name: str, **overrides) -> LMConfig:
    if name not in TEXT_PRESETS:
        raise ValueError(f"Unknown text model preset: {name!r} (known: {sorted(TEXT_PRESETS)})")
    return dataclasses.replace(TEXT_PRESETS[name], **overrides)
