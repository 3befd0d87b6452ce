"""Stage-1 train and eval steps (port of pgica_tpu/training/train_step.py:63-103,163-248).

Stage 1 is contrastive: the frozen vision tower runs forward only, the text
tower forward and backward, and NT-Xent over the batch's local negatives
(``ops/losses.py``). The step keeps the JAX package's NaN-safe update: the
gradient norm is taken before clipping; a non-finite loss or gradient norm
applies no update, keeps the old optimizer and accumulator state, and adds
one to ``skipped``. The JAX step does that on the device; here one host
sync per step reads the loss and the norm (the loss is read anyway).

Not ported yet: device augmentation (``augment=True``, ROADMAP §1 item 7),
LoRA (item 12), and global negatives over a device axis (item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.ops.losses import ntxent_loss
from pgica_tpu_torch.training.optim import OptState, Optimizer, global_norm

Batch = Mapping[str, object]


@dataclasses.dataclass
class TrainState:
    """The module (its float32 masters are the params), the optimizer state and the counters.

    Steps update the module's parameters and ``opt_state`` in place and
    return the same object.
    """

    step: int
    module: nn.Module
    opt_state: OptState
    skipped: int = 0  # count of NaN-skipped updates

    @classmethod
    def create(cls, module: nn.Module, optimizer: Optimizer) -> "TrainState":
        return cls(step=0, module=module, opt_state=optimizer.init(module))


def _apply_update(
    state: TrainState, grads, optimizer: Optimizer, loss: torch.Tensor
) -> Tuple[TrainState, torch.Tensor]:
    """NaN-safe update: skip (no update, state kept) on a non-finite loss or gradient norm."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, state.opt_state.params)]
    grad_norm = global_norm(grads)
    norm = float(grad_norm)  # the step's one host sync (with the loss)
    if math.isfinite(float(loss)) and math.isfinite(norm):
        optimizer.update(grads, state.opt_state, norm)
    else:
        state.skipped += 1
    state.step += 1
    return state, grad_norm


def _on_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for key in ("image", "caption_ids", "caption_mask"):
        value = batch[key]
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = value.to(device, non_blocking=True)
    return out


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step: the JAX step's ``fold_in(rng, step)``."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def stage1_loss_fn(
    module: nn.Module,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    temperature: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Contrastive forward + NT-Xent. ``generator`` drives dropout (None: off)."""
    out = module(prepare_images(batch["image"]), batch["caption_ids"], batch["caption_mask"],
                 mode="contrastive", generator=generator)
    loss, metrics = ntxent_loss(out["image_embeddings"], out["text_embeddings"], temperature)
    metrics["loss"] = loss
    return loss, metrics


def _check_unported(augment: bool, lora) -> None:
    if augment:
        raise NotImplementedError("augment=True: device augmentation is not ported yet (ROADMAP §1 item 7)")
    if lora is not None:
        raise NotImplementedError("lora: LoRA is not ported yet (ROADMAP §1 item 12)")


def make_stage1_train_step(
    module: nn.Module,
    optimizer: Optimizer,
    temperature: float,
    augment: bool = False,
    lora: Optional[Tuple[float, int]] = None,
) -> Callable[[TrainState, Batch, int], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``step(state, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``image`` (uint8 NHWC or normalized float), ``caption_ids``
    and ``caption_mask`` as tensors or numpy arrays; they are moved to the
    module's device. ``seed`` and the state's step count seed the dropout
    generator. Metrics: ``loss``, ``loss_i2t``, ``loss_t2i``,
    ``contrastive_accuracy``, ``grad_norm`` (tensors) and ``skipped`` (int).
    """
    _check_unported(augment, lora)

    def step(state: TrainState, batch: Batch, seed: int = 0):
        params = state.opt_state.params
        device = params[0].device
        generator = step_generator(device, seed, state.step)
        with torch.enable_grad():
            loss, metrics = stage1_loss_fn(state.module, _on_device(batch, device), generator, temperature)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        state, grad_norm = _apply_update(state, grads, optimizer, loss.detach())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = grad_norm
        metrics["skipped"] = state.skipped
        return state, metrics

    return step


def make_stage1_eval_step(
    module: nn.Module, temperature: float, lora: Optional[Tuple[float, int]] = None
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> metrics``: the contrastive forward without dropout or gradients."""
    _check_unported(False, lora)

    @torch.no_grad()
    def step(batch: Batch):
        device = next(module.parameters()).device
        _, metrics = stage1_loss_fn(module, _on_device(batch, device), None, temperature)
        return metrics

    return step
