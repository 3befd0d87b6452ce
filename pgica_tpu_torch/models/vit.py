"""CLIP-style vision transformer tower (PyTorch).

Mirrors pgica_tpu/models/vit.py:26-141: patch embedding, class token,
learned position embeddings, ``pre_ln``, pre-norm blocks, ``post_ln`` on the
CLS token, and the projection head (Dense-ReLU-Dense-LN). Images arrive
normalized NHWC, as in the JAX package.

The patch embedding is a non-overlapping patchify by reshape plus one matmul,
flattening each patch in (h, w, c) order — exactly the JAX ``nn.Conv`` with
kernel = stride = patch and VALID padding, and it keeps cuDNN's default TF32
convolution out of float32 comparisons.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from pgica_tpu_torch.models.layers import TransformerBlock
from pgica_tpu_torch.models.presets import ViTConfig
from pgica_tpu_torch.ops.layernorm import LayerNorm


class PatchEmbed(nn.Module):
    """(B, H, W, C) -> (B, N, width); ``weight`` is (width, P*P*C), no bias."""

    def __init__(self, patch_size: int, channels: int, width: int):
        super().__init__()
        self.patch_size = patch_size
        self.weight = nn.Parameter(torch.empty(width, patch_size * patch_size * channels))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, h, w, c = images.shape
        p = self.patch_size
        x = images.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, (h // p) * (w // p), p * p * c)
        return F.linear(x.to(self.weight.dtype), self.weight)


class VisionTransformer(nn.Module):
    """ViT backbone; returns per-token features and the pooled CLS output."""

    def __init__(self, config: ViTConfig):
        super().__init__()
        cfg = config
        self.config = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, 3, cfg.hidden_size)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches + 1, cfg.hidden_size))
        self.pre_ln = LayerNorm(cfg.hidden_size, cfg.norm_eps)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_heads, int(cfg.hidden_size * cfg.mlp_ratio),
                causal=False, norm_eps=cfg.norm_eps, mlp_kind=cfg.hidden_act,
            )
            for _ in range(cfg.num_layers)
        )
        self.post_ln = LayerNorm(cfg.hidden_size, cfg.norm_eps)

    def forward(self, images: torch.Tensor) -> dict:
        b, _, _, c = images.shape
        if c != 3:
            raise ValueError(f"Expected 3-channel NHWC images, got shape {tuple(images.shape)}")
        x = self.patch_embed(images)
        cls = self.cls_token.expand(b, 1, x.shape[-1])
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        x = self.pre_ln(x)
        for block in self.blocks:
            x = block(x)
        return {"features": x, "pooled_output": self.post_ln(x[:, 0])}


class ProjectionHead(nn.Module):
    """Dense-ReLU-Dense-LayerNorm (dropout is off at inference)."""

    def __init__(self, in_dim: int, projection_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, projection_dim)
        self.fc2 = nn.Linear(projection_dim, projection_dim)
        self.ln = LayerNorm(projection_dim, 1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ln(self.fc2(torch.relu(self.fc1(x))))


class VisionEncoder(nn.Module):
    """ViT backbone + projection head: ``features``, ``embeddings``, ``pooled_output``."""

    def __init__(self, config: ViTConfig, projection_dim: int = 512):
        super().__init__()
        self.backbone = VisionTransformer(config)
        self.projection = ProjectionHead(config.hidden_size, projection_dim)

    def forward(self, images: torch.Tensor) -> dict:
        if images.dim() != 4:
            raise ValueError(f"Expected 4D NHWC image batch, got {tuple(images.shape)}")
        out = self.backbone(images)
        out["embeddings"] = self.projection(out["pooled_output"])
        return out
