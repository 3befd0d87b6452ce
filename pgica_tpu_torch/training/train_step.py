"""Train and eval steps of stages 0, 1 and 2 (port of pgica_tpu/training/train_step.py:63-157,163-396).

* Stage 0: the optional caption cross-entropy warm-up of the decoder
  (generation-mode forward, ``caption_cross_entropy``).
* Stage 1 is contrastive: the frozen vision tower runs forward only, the
  text tower forward and backward, and NT-Xent over the batch's local
  negatives (``ops/losses.py``).
* Stage 2 is DPO: per model, one vision encode and ONE decoder pass over
  ``[chosen; rejected]`` (2B rows); the per-sequence log-probs come from the
  decoder's hidden states through the fused linear-CE kernels
  (``sequence_logprobs_from_hidden``), so the (2B, S, V) logits are never
  computed. The frozen reference (a :func:`~pgica_tpu_torch.models.model.
  frozen_copy` of the policy at stage-2 start, bf16 by default as the JAX
  trainer keeps it) runs the same path without dropout and without
  gradients. The text tower does not run in stage 0 or 2: its parameters get
  zero gradients and, if the optimizer holds them, AdamW still decays them,
  as the JAX step does.

Every step keeps the JAX package's NaN-safe update: the gradient norm is
taken before clipping; a non-finite loss or gradient norm applies no update,
keeps the old optimizer and accumulator state, and adds one to ``skipped``.
The JAX step does that on the device; here one host sync per step reads the
loss and the norm (the loss is read anyway).

Not ported yet: device augmentation (``augment=True``, ROADMAP §1 item 7),
LoRA (item 12), global negatives and the vocab-parallel log-probs over a
device mesh (item 13).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.ops.losses import dpo_loss, ntxent_loss, sequence_logprobs_from_hidden
from pgica_tpu_torch.training.optim import OptState, Optimizer, global_norm

Batch = Mapping[str, object]
CAPTION_KEYS = ("image", "caption_ids", "caption_mask")
PAIR_KEYS = ("image", "preferred_ids", "preferred_mask", "rejected_ids", "rejected_mask")


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


def _on_device(batch: Batch, device: torch.device, keys=CAPTION_KEYS) -> Dict[str, torch.Tensor]:
    out = {}
    for key in keys:
        value = batch[key]
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = value.to(device, non_blocking=True)
    return out


def step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The dropout generator of one step: the JAX step's ``fold_in(rng, step)``."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def _grad_step(
    state: TrainState,
    optimizer: Optimizer,
    seed: int,
    loss_fn: Callable[[torch.Generator], Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
) -> Tuple[TrainState, Dict[str, object]]:
    """Loss and gradients of the trained parameters, then the NaN-safe update."""
    params = state.opt_state.params
    generator = step_generator(params[0].device, seed, state.step)
    with torch.enable_grad():
        loss, metrics = loss_fn(generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    state, grad_norm = _apply_update(state, grads, optimizer, loss.detach())
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = grad_norm
    metrics["skipped"] = state.skipped
    return state, metrics


def _check_unported(augment: bool, lora) -> None:
    if augment:
        raise NotImplementedError("augment=True: device augmentation is not ported yet (ROADMAP §1 item 7)")
    if lora is not None:
        raise NotImplementedError("lora: LoRA is not ported yet (ROADMAP §1 item 12)")


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


# --------------------------------------------------------------------- stage 0


def stage0_loss_fn(
    module: nn.Module, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Teacher-forced caption cross-entropy (the optional LM warm-up)."""
    out = module(prepare_images(batch["image"]), batch["caption_ids"], batch["caption_mask"],
                 labels=batch["caption_ids"], mode="generation", generator=generator)
    return out["loss"], {"loss": out["loss"]}


def make_stage0_train_step(
    module: nn.Module, optimizer: Optimizer, augment: bool = False
) -> Callable[[TrainState, Batch, int], Tuple[TrainState, Dict[str, object]]]:
    """Returns ``step(state, batch, seed) -> (state, metrics)``: ``loss``, ``grad_norm``, ``skipped``.

    ``batch`` is a stage-1 batch (``image``, ``caption_ids``, ``caption_mask``).
    """
    _check_unported(augment, None)

    def step(state: TrainState, batch: Batch, seed: int = 0):
        batch = _on_device(batch, state.opt_state.params[0].device)
        return _grad_step(state, optimizer, seed, lambda gen: stage0_loss_fn(state.module, batch, gen))

    return step


# --------------------------------------------------------------------- stage 1


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


def make_stage1_train_step(
    module: nn.Module,
    optimizer: Optimizer,
    temperature: float,
    augment: bool = False,
    lora: Optional[Tuple[float, int]] = None,
) -> Callable[[TrainState, Batch, int], Tuple[TrainState, Dict[str, object]]]:
    """Returns ``step(state, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``image`` (uint8 NHWC or normalized float), ``caption_ids``
    and ``caption_mask`` as tensors or numpy arrays; they are moved to the
    module's device. ``seed`` and the state's step count seed the dropout
    generator. Metrics: ``loss``, ``loss_i2t``, ``loss_t2i``,
    ``contrastive_accuracy``, ``grad_norm`` (tensors) and ``skipped`` (int).
    """
    _check_unported(augment, lora)

    def step(state: TrainState, batch: Batch, seed: int = 0):
        batch = _on_device(batch, state.opt_state.params[0].device)
        return _grad_step(state, optimizer, seed, lambda gen: stage1_loss_fn(state.module, batch, gen, temperature))

    return step


def make_stage1_eval_step(
    module: nn.Module, temperature: float, lora: Optional[Tuple[float, int]] = None
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> metrics``: the contrastive forward without dropout or gradients."""
    _check_unported(False, lora)

    @torch.no_grad()
    def step(batch: Batch):
        _, metrics = stage1_loss_fn(module, _on_device(batch, _device(module)), None, temperature)
        return metrics

    return step


# --------------------------------------------------------------------- stage 2


def decoder_embedding(module: nn.Module) -> torch.Tensor:
    """The decoder LM's weight-tied embedding: the policy's f32 master, or a frozen copy's cast.

    A shared text tower (the JAX ``shared_lm``) is not ported yet.
    """
    return module.caption_decoder.lm.wte.weight


def _policy_pair_logprobs(
    module: nn.Module,
    images: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    length_normalized: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One vision encode + ONE decoder pass over [chosen; rejected] -> (chosen, rejected) log-probs (B,)."""
    b = images.shape[0]
    vision = module.encode_image(images, generator)
    ids = torch.cat([batch["preferred_ids"], batch["rejected_ids"]], dim=0)
    mask = torch.cat([batch["preferred_mask"], batch["rejected_mask"]], dim=0)
    vis2 = torch.cat([vision["embeddings"], vision["embeddings"]], dim=0)
    dec = module.decode_train(ids, mask, vis2, generator, with_logits=False)
    logps = sequence_logprobs_from_hidden(dec["hidden_states"], decoder_embedding(module), ids, mask,
                                          length_normalized)
    return logps[:b], logps[b:]


def stage2_loss_fn(
    module: nn.Module,
    ref_module: Optional[nn.Module],
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    beta: float,
    reference_free: bool,
    length_normalized: bool,
    label_smoothing: float,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DPO of the policy ``module`` (dropout from ``generator``) against ``ref_module`` (no dropout, no grad)."""
    images = prepare_images(batch["image"])
    pc, pr = _policy_pair_logprobs(module, images, batch, generator, length_normalized)
    rc = rr = None
    if not reference_free and ref_module is not None:
        with torch.no_grad():
            rc, rr = _policy_pair_logprobs(ref_module, images, batch, None, length_normalized)
    loss, metrics = dpo_loss(pc, pr, rc, rr, beta=beta, label_smoothing=label_smoothing,
                             reference_free=reference_free)
    metrics["loss"] = loss
    metrics["policy_chosen_logp"] = pc.mean()
    metrics["policy_rejected_logp"] = pr.mean()
    return loss, metrics


def make_stage2_train_step(
    module: nn.Module,
    optimizer: Optimizer,
    beta: float,
    reference_free: bool = False,
    length_normalized: bool = False,
    label_smoothing: float = 0.0,
    augment: bool = False,
    lora: Optional[Tuple[float, int]] = None,
) -> Callable[[TrainState, Optional[nn.Module], Batch, int], Tuple[TrainState, Dict[str, object]]]:
    """Returns ``step(state, ref_module, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``image`` and ``preferred_ids``/``preferred_mask``/
    ``rejected_ids``/``rejected_mask`` (tensors or numpy arrays; moved to the
    module's device). ``ref_module`` is the frozen reference (see
    :func:`~pgica_tpu_torch.models.model.frozen_copy`), or None with
    ``reference_free``. Metrics: ``loss``, ``reward_margin``,
    ``reward_accuracy``, ``chosen_reward``, ``rejected_reward``,
    ``policy_chosen_logp``, ``policy_rejected_logp``, ``grad_norm``
    (tensors) and ``skipped`` (int).
    """
    _check_unported(augment, lora)

    def step(state: TrainState, ref_module: Optional[nn.Module], batch: Batch, seed: int = 0):
        batch = _on_device(batch, state.opt_state.params[0].device, PAIR_KEYS)
        return _grad_step(state, optimizer, seed, lambda gen: stage2_loss_fn(
            state.module, ref_module, batch, gen, beta, reference_free, length_normalized, label_smoothing))

    return step


def make_stage2_eval_step(
    module: nn.Module,
    beta: float,
    reference_free: bool = False,
    length_normalized: bool = False,
    lora: Optional[Tuple[float, int]] = None,
) -> Callable[[Optional[nn.Module], Batch], Dict[str, torch.Tensor]]:
    """Returns ``step(ref_module, batch) -> metrics``: DPO loss and rewards without dropout or gradients."""
    _check_unported(False, lora)

    @torch.no_grad()
    def step(ref_module: Optional[nn.Module], batch: Batch):
        batch = _on_device(batch, _device(module), PAIR_KEYS)
        loss, metrics = stage2_loss_fn(module, ref_module, batch, None, beta, reference_free,
                                       length_normalized, 0.0)
        del metrics["policy_chosen_logp"], metrics["policy_rejected_logp"]  # as the JAX eval step
        return metrics

    return step
