"""The context-parallel (sequence-sharded) stage-2 step (port of pgica_tpu/training/cp_step.py:52-275).

The caption decoder's activations stay sharded over the ``seq`` axis through
the loss: each rank of the axis holds its block of every caption's columns.

* :func:`make_cp_module` (a context) switches the decoder to ring mode:
  self-attention runs :func:`~pgica_tpu_torch.ops.ring_attention.
  ring_attention`, positions are the shard's global ones (GPT-2's ``wpe``,
  Llama's RoPE). It adds no parameter: the module is the same one.
* Each rank computes the per-sequence DPO log-probs of its shard as partial
  sums (ops/losses.py:cp_sequence_logprob_partials[_from_hidden], the causal
  shift crossing to the next shard through ``ppermute``) and sums them over
  ``seq`` with ``collectives.reduce_from`` (psum forward, identity backward:
  each rank holds the same loss). Only (B,) partial sums cross the ranks:
  the (2B, S, V) logits and (2B, S, H) hidden states never exist whole.
* The gradients of one rank are those of its shard's terms; the step sums
  them over ``seq`` and averages them over the batch axes in one
  all-reduce, then takes the NaN-safe update of training/train_step.py.

The vision token and the dropout and augmentation streams are the same on
every shard of a batch block (the streams fold in the batch-axis index
only): dropout inside the decoder therefore repeats its mask every
S_local tokens along the sequence, the JAX package's documented deviation.
``data_axis`` composition is the mesh's batch axes (each rank's rows come
from ``mesh.shard_batch``); ``tp_axis`` composition is a module cut over
``model`` by parallel/sharding.py, whose fused CE is then vocab-parallel on
the shard's rows (JAX falls back to materialised logits there because GSPMD
cannot partition its custom call, cp_step.py:127-132; the numbers are the
same). LoRA does not compose with context parallelism (the trainer refuses).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.ops.losses import cp_sequence_logprob_partials, cp_sequence_logprob_partials_from_hidden, dpo_loss
from pgica_tpu_torch.parallel import collectives
from pgica_tpu_torch.parallel.mesh import BATCH_AXES, MeshContext
from pgica_tpu_torch.training.optim import Optimizer
from pgica_tpu_torch.training.train_step import (
    PAIR_KEYS,
    TrainState,
    _apply_update,
    _augmented,
    _on_device,
    decoder_embedding,
    decoder_vocab,
    reduce_metrics,
    step_generator,
    stream_offset,
    vocab_mesh,
)


@contextlib.contextmanager
def make_cp_module(module: nn.Module, axis_name: str):
    """``module`` with its decoder in ring mode over ``axis_name`` for the duration (the JAX
    ``module.clone(ring_axis=...)``); nests, and restores what it found."""
    dec = module.caption_decoder
    targets = [dec, dec.lm] + [block.attn for block in dec.lm.blocks]
    held = [m.__dict__.get("ring_axis") for m in targets]
    for m in targets:
        m.ring_axis = axis_name
    try:
        yield module
    finally:
        for m, old in zip(targets, held):
            if old is None:
                m.__dict__.pop("ring_axis", None)
            else:
                m.ring_axis = old


def sequence_shard(batch: Dict[str, torch.Tensor], axis_name: str) -> Dict[str, torch.Tensor]:
    """This rank's block of the caption columns of a pair batch; raises if the axis does not divide them."""
    n, i = collectives.axis_size(axis_name), collectives.axis_index(axis_name)
    length = batch["preferred_ids"].shape[1]
    if length % n:
        raise ValueError(f"sequence length {length} not divisible by CP degree {n}")
    out = dict(batch)
    for key in PAIR_KEYS[1:]:
        out[key] = batch[key][:, i * length // n:(i + 1) * length // n]
    return out


def _pair_partials(module: nn.Module, images: torch.Tensor, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator], axis_name: str, use_fused_ce: bool,
                   mesh: Optional[MeshContext]) -> Tuple[torch.Tensor, ...]:
    """One vision encode and one decoder pass over this shard's [chosen; rejected] columns -> the
    (B,) log-prob sums and token counts of each side, summed over the sequence shards."""
    b = images.shape[0]
    vision = module.encode_image(images, generator)
    ids = torch.cat([batch["preferred_ids"], batch["rejected_ids"]], dim=0)
    mask = torch.cat([batch["preferred_mask"], batch["rejected_mask"]], dim=0)
    vis2 = torch.cat([vision["embeddings"], vision["embeddings"]], dim=0)
    dec = module.decode_train(ids, mask, vis2, generator, with_logits=not use_fused_ce)
    if use_fused_ce:
        part, cnt = cp_sequence_logprob_partials_from_hidden(
            dec["hidden_states"], decoder_embedding(module), ids, mask, axis_name, mesh=vocab_mesh(module, mesh),
            vocab_size=decoder_vocab(module))
    else:
        part, cnt = cp_sequence_logprob_partials(dec["logits"], ids, mask, axis_name)
    part = collectives.reduce_from(part, axis_name)
    cnt = collectives.psum(cnt, axis_name)
    return part[:b], cnt[:b], part[b:], cnt[b:]


def make_stage2_cp_loss_fn(
    module: nn.Module,
    mesh: MeshContext,
    axis_name: str = "seq",
    beta: float = 0.1,
    reference_free: bool = False,
    length_normalized: bool = False,
    label_smoothing: float = 0.0,
    use_fused_ce: bool = False,
) -> Callable:
    """``loss_fn(ref_module, batch, generator) -> (loss, metrics)`` on this rank's rows (``batch``: whole
    captions, tensors on the device; images prepared or raw), the decoder sequence-sharded over
    ``axis_name``; ``generator`` drives the policy's dropout (None: deterministic, the eval pass)."""

    def totals(parts, cnts):
        return parts / cnts.clamp_min(1.0) if length_normalized else parts

    def loss_fn(ref_module: Optional[nn.Module], batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator]):
        images = prepare_images(batch["image"])
        with mesh:
            shard = sequence_shard(batch, axis_name)
            with make_cp_module(module, axis_name):
                pp, pcnt, rp, rcnt = _pair_partials(module, images, shard, generator, axis_name, use_fused_ce,
                                                    mesh)
            pc, pr = totals(pp, pcnt), totals(rp, rcnt)
            rc = rr = None
            if not reference_free and ref_module is not None:
                with torch.no_grad(), make_cp_module(ref_module, axis_name):
                    rcp, rcc, rrp, rrc = _pair_partials(ref_module, images, shard, None, axis_name, use_fused_ce,
                                                        mesh)
                rc, rr = totals(rcp, rcc), totals(rrp, rrc)
        loss, metrics = dpo_loss(pc, pr, rc, rr, beta=beta, label_smoothing=label_smoothing,
                                 reference_free=reference_free)
        metrics["loss"] = loss
        metrics["policy_chosen_logp"] = pc.mean()
        metrics["policy_rejected_logp"] = pr.mean()
        return loss, metrics

    return loss_fn


def make_stage2_cp_train_step(
    module: nn.Module,
    optimizer: Optimizer,
    mesh: MeshContext,
    axis_name: str = "seq",
    beta: float = 0.1,
    reference_free: bool = False,
    length_normalized: bool = False,
    label_smoothing: float = 0.0,
    augment: bool = False,
    use_fused_ce: bool = False,
) -> Callable:
    """``step(state, ref_module, batch, seed) -> (state, metrics)``, context-parallel: ``batch`` is this
    rank's rows (``mesh.shard_batch``) with whole captions; metrics and the NaN-safe update as
    :func:`~pgica_tpu_torch.training.train_step.make_stage2_train_step`."""
    loss_fn = make_stage2_cp_loss_fn(module, mesh, axis_name, beta, reference_free, length_normalized,
                                     label_smoothing, use_fused_ce)

    def step(state: TrainState, ref_module: Optional[nn.Module], batch, seed: int = 0):
        params = state.opt_state.params
        device, offset = params[0].device, stream_offset(mesh)
        batch = _augmented(_on_device(batch, device, PAIR_KEYS), augment, seed, state.step, offset)
        generator = step_generator(device, seed, state.step, offset)
        with torch.enable_grad(), mesh, make_cp_module(module, axis_name):  # remat recomputes in ring mode
            loss, metrics = loss_fn(ref_module, batch, generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        metrics = reduce_metrics({k: v.detach() for k, v in metrics.items()}, mesh)
        with mesh:  # the shards' terms summed over the sequence, averaged over the batch ranks
            state, grad_norm = _apply_update(state, grads, optimizer, metrics["loss"], mesh,
                                             BATCH_AXES + (axis_name,))
        metrics["grad_norm"] = grad_norm
        metrics["skipped"] = state.skipped
        return state, metrics

    return step


def make_stage2_cp_eval_step(
    module: nn.Module,
    mesh: MeshContext,
    axis_name: str = "seq",
    beta: float = 0.1,
    reference_free: bool = False,
    length_normalized: bool = False,
    use_fused_ce: bool = False,
) -> Callable:
    """``step(ref_module, batch) -> metrics``: the deterministic context-parallel DPO metrics of the global
    batch from this rank's rows (the JAX ``make_stage2_cp_eval_step``)."""
    loss_fn = make_stage2_cp_loss_fn(module, mesh, axis_name, beta, reference_free, length_normalized,
                                     use_fused_ce=use_fused_ce)

    @torch.no_grad()
    def step(ref_module: Optional[nn.Module], batch):
        batch = _on_device(batch, next(module.parameters()).device, PAIR_KEYS)
        _, metrics = loss_fn(ref_module, batch, None)
        return reduce_metrics(metrics, mesh, batch["image"].shape[0])

    return step
