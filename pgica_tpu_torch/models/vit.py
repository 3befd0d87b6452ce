"""CLIP-style vision transformer tower (PyTorch).

Mirrors pgica_tpu/models/vit.py:26-141: patch embedding, class token,
learned position embeddings, ``pre_ln``, pre-norm blocks, ``post_ln`` on the
CLS token, and the projection head (Dense-ReLU-Dropout-Dense-LN). Images
arrive normalized NHWC, as in the JAX package. A frozen backbone
(``freeze_backbone``) runs under ``torch.no_grad()``: the same numbers as the
JAX ``stop_gradient`` (vit.py:129-133), and no activations are kept for a
backward pass.

The patch embedding is a non-overlapping patchify by reshape plus one matmul,
flattening each patch in (h, w, c) order — exactly the JAX ``nn.Conv`` with
kernel = stride = patch and VALID padding (which drops the last ``size %
patch`` rows and columns of pixels: 6 of SigLIP's 384 at patch 14), and it
keeps cuDNN's default TF32 convolution out of float32 comparisons.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from pgica_tpu_torch.models.layers import Dense, TransformerBlock
from pgica_tpu_torch.models.presets import ViTConfig
from pgica_tpu_torch.ops.dropout import FastDropout
from pgica_tpu_torch.ops.layernorm import LayerNorm


class PatchEmbed(nn.Module):
    """(B, H, W, C) -> (B, N, width); ``weight`` is (width, P*P*C), no bias."""

    def __init__(self, patch_size: int, channels: int, width: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(width, patch_size * patch_size * channels))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, c = images.shape
        p = self.patch_size
        images = images[:, : h - h % p, : w - w % p]  # VALID: whole patches only
        x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class VisionTransformer(nn.Module):
    """ViT backbone; returns per-token features and the pooled CLS output."""

    def __init__(self, config: ViTConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        cfg = config
        self.config = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, cfg.hidden_size, dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, cfg.hidden_size))
        self.pre_ln = LayerNorm(cfg.hidden_size, cfg.norm_eps, dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_heads, int(cfg.hidden_size * cfg.mlp_ratio),
                causal=False, norm_eps=cfg.norm_eps, mlp_kind=cfg.hidden_act, dropout=cfg.dropout,
                dtype=dtype,
            )
            for _ in range(cfg.num_layers)
        )
        self.post_ln = LayerNorm(cfg.hidden_size, cfg.norm_eps, dtype)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        b, _, _, c = images.shape
        if c != 3:
            raise ValueError(f"Expected 3-channel NHWC images, got shape {tuple(images.shape)}")
        x = self.patch_embed(images)
        cls = self.cls_token.to(self.dtype).expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.pre_ln(x)
        for block in self.blocks:
            x = block(x, generator=generator)
        return {"features": x, "pooled_output": self.post_ln(x[:, 0])}


class ProjectionHead(nn.Module):
    """Dense-ReLU-Dropout-Dense-LayerNorm (JAX vit.py:83-101)."""

    def __init__(self, in_dim: int, projection_dim: int, dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_dim, projection_dim, dtype)
        self.dropout = FastDropout(dropout)
        self.fc2 = Dense(projection_dim, projection_dim, dtype)
        self.ln = LayerNorm(projection_dim, 1e-5, dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.ln(self.fc2(self.dropout(torch.relu(self.fc1(x)), generator)))


class VisionEncoder(nn.Module):
    """ViT backbone + projection head: ``features``, ``embeddings``, ``pooled_output``."""

    def __init__(
        self,
        config: ViTConfig,
        projection_dim: int = 512,
        dropout: float = 0.1,
        freeze_backbone: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.freeze_backbone = freeze_backbone
        self.backbone = VisionTransformer(config, dtype)
        self.projection = ProjectionHead(config.hidden_size, projection_dim, dropout, dtype)

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        if images.dim() != 4:
            raise ValueError(f"Expected 4D NHWC image batch, got {tuple(images.shape)}")
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            out = self.backbone(images, generator)
        out["embeddings"] = self.projection(out["pooled_output"], generator)
        return out
