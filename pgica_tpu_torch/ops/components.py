"""Loss components (the port's copy of pgica_tpu/ops/components.py).

The reference ships loss building blocks that its trainer mostly does not
use; they are part of the public surface, so the port keeps them:

* :class:`TemperatureScaledSimilarity` — the (B_img, B_txt) cosine
  similarity over a fixed or learnable temperature, clamped to
  [``TEMP_MIN``, ``TEMP_MAX``]; its ``log_temperature`` parameter bridges
  from the JAX tree with ``models/convert.py:load_jax_params``.
* :class:`ContrastiveLossModule` — NT-Xent over it.
* :func:`nan_safe_gradients` — the global gradient norm, whether it is
  finite, and the gradients clipped to ``max_norm``, all on the device, with
  no host sync.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from pgica_tpu_torch.ops.losses import l2_normalize
from pgica_tpu_torch.training.optim import global_norm

TEMP_MIN, TEMP_MAX = 0.1, 2.0  # the reference's clamp bounds (components.py:78)

Grads = Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]


class TemperatureScaledSimilarity(nn.Module):
    """Cosine similarity matrix scaled by a (learnable) clamped temperature."""

    def __init__(self, initial_temperature: float = 0.5, learnable: bool = True):
        super().__init__()
        self.initial_temperature = initial_temperature
        self.learnable = learnable
        if learnable:
            self.log_temperature = nn.Parameter(torch.tensor(math.log(initial_temperature), dtype=torch.float32))

    def temperature(self) -> torch.Tensor:
        """The clamped temperature, a float32 0-d tensor on the parameter's device."""
        if self.learnable:
            return self.log_temperature.exp().clamp(TEMP_MIN, TEMP_MAX)
        return torch.tensor(self.initial_temperature, dtype=torch.float32).clamp(TEMP_MIN, TEMP_MAX)

    def forward(self, image_embeddings: torch.Tensor, text_embeddings: torch.Tensor) -> torch.Tensor:
        img = l2_normalize(image_embeddings.to(torch.float32))
        txt = l2_normalize(text_embeddings.to(torch.float32))
        return img @ txt.T / self.temperature().to(img.device)

    def current_temperature(self) -> float:
        return float(self.temperature().detach())


class ContrastiveLossModule(nn.Module):
    """NT-Xent over a :class:`TemperatureScaledSimilarity`: (loss, {loss_i2t, loss_t2i, accuracy})."""

    def __init__(self, initial_temperature: float = 0.5, learnable_temperature: bool = True):
        super().__init__()
        self.similarity = TemperatureScaledSimilarity(initial_temperature, learnable_temperature)

    def forward(
        self, image_embeddings: torch.Tensor, text_embeddings: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        sim = self.similarity(image_embeddings, text_embeddings)
        labels = torch.arange(sim.shape[0], device=sim.device)
        loss_i2t = F.cross_entropy(sim, labels)
        loss_t2i = F.cross_entropy(sim.T, labels)
        acc = (sim.argmax(dim=-1) == labels).to(torch.float32).mean()
        return 0.5 * (loss_i2t + loss_t2i), {"loss_i2t": loss_i2t, "loss_t2i": loss_t2i, "accuracy": acc}


def nan_safe_gradients(grads: Grads, max_norm: Optional[float] = None) -> Tuple[Grads, torch.Tensor, torch.Tensor]:
    """(grads, global norm, all finite), the last two 0-d device tensors: no host sync.

    With ``max_norm`` every gradient is scaled by ``min(1, max_norm / max(norm,
    1e-6))``; ``grads`` keeps its form (a mapping or a sequence). A caller
    zeroes the update where ``finite`` is False.
    """
    tensors = list(grads.values()) if isinstance(grads, Mapping) else list(grads)
    norm = global_norm(tensors)
    finite = torch.isfinite(norm)
    if max_norm is not None:
        scale = (max_norm / norm.clamp_min(1e-6)).clamp_max(1.0)
        scaled = [g * scale.to(g.dtype) for g in tensors]
        grads = dict(zip(grads.keys(), scaled)) if isinstance(grads, Mapping) else scaled
    return grads, norm, finite
