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

With ``augment=True`` (the trainer's setting, as in every stage of the JAX
trainer) the step augments the normalized images before the forward
(``data/augment.py``: crop, flip, colour jitter, rotation), with
parameters drawn from :func:`augment_generator`, a CPU generator of the
step's seed and count as :func:`step_generator` is for dropout; the stage-2
reference sees the same augmented images as the policy.

Every step keeps the JAX package's NaN-safe update: the gradient norm is
taken before clipping; a non-finite loss or gradient norm applies no update,
keeps the old optimizer and accumulator state, and adds one to ``skipped``.
As in the JAX step, that happens on the device (``where(ok, new, old)``,
training/optim.py), so a step ends in no host sync; ``skipped`` is a device
counter that :attr:`TrainState.skipped` reads.

A step is a :class:`TrainStep`, split where a CUDA graph needs it: a host
part (the batch to the device, the augmentation's draws, the generators'
seeds, and whether this micro-step applies the accumulated update) and a
body that does everything else on the device. Called, it runs both: the
eager step, on any device and mesh. Without a mesh, training/graphs.py
captures the body as one CUDA graph per batch shape (the trainer's route on
the card); the eager step is the plain version the graphs are held to.

LoRA (JAX train_step.py:39-60): with ``lora=(alpha, rank[, dropout])`` the
stage-1 and stage-2 steps train the state's adapter factors only
(``TrainState.create(module, optimizer, lora=adapters)``). The step merges
``W + (alpha / rank) * A @ B`` into the targeted weights and runs the
module on them (models/lora.py:swapped) for the forward and the backward;
the float32 masters take no gradient and are never written, and gradient
clipping and AdamW see the factors only. The train step draws the adapter
DropConnect (``dropout``) from a generator of its own, one mask a step; the
eval steps merge without it. The tied embedding is no target, so a LoRA
stage-2 step runs the fused-CE dh kernel and never dW.

Data parallelism (``mesh``, a :class:`~pgica_tpu_torch.parallel.mesh.
MeshContext`): each rank takes its rows of the global batch; the stage-1
loss scores them against negatives gathered over the batch axes
(``axis_name``); the step all-reduces every gradient and divides by the
number of batch ranks, which gives the gradient of the global-batch mean
loss (JAX zero1.py:24-29), before the update, so every rank applies the
same update. The NaN skip reads the pmean'ed loss and the norm of the
reduced gradients, so all ranks skip together; the metrics are pmean'ed.
The dropout, augmentation and LoRA streams fold in the rank's batch-axis
index (``stream_offset``; rank 0's streams are the one-device streams).

Tensor parallelism (a module cut over ``model`` by parallel/sharding.py:
shard_module; JAX's ``mesh=tp_mesh`` route, trainer.py:818-821,880-902):
the ranks of one batch block along ``model`` take the same rows and the
same dropout and augmentation streams (the streams fold in the batch-axis
index only), so their replicated activations are bit-equal; the layers
make the Megatron collectives; stage 2's log-probs go through the
vocab-parallel fused CE on this rank's block of ``wte``; the gradients are
averaged over the batch axes only, never over ``model``, and the gradient
norm sums the blocks' squares over ``model`` (training/optim.py). A
``seq`` axis of more than one rank repeats a step on each of its ranks
(stage 1, as the JAX package's GSPMD step does); stage 2 is then
training/cp_step.py's.

FSDP at rest (a module cut over ``fsdp`` by parallel/sharding.py:shard_fsdp,
the JAX package's GSPMD parameter shardings): the towers gather the cut
weights where they run (parallel/fsdp.py), and a cut leaf's gradient comes
out of the gathers' backward summed over ``fsdp`` and this rank's block; it
is then summed over the other batch axes only and divided by the batch
ranks (:func:`reduce_gradients`), while a replicated leaf's is averaged
over all of them as above. The moments and the update are the shards', and
the norm sums each cut leaf's squares over the axes that cut it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from pgica_tpu_torch.core.prng import stream_generator, stream_seed
from pgica_tpu_torch.data.augment import AugmentParams, augment_batch, prepare_images, sample_augment_params
from pgica_tpu_torch.models.lora import Adapters, merged_targets, swapped
from pgica_tpu_torch.ops.losses import dpo_loss, ntxent_loss, sequence_logprobs_from_hidden
from pgica_tpu_torch.parallel import collectives, fsdp
from pgica_tpu_torch.parallel.mesh import BATCH_AXES, AxisName, MeshContext, axis_names
from pgica_tpu_torch.parallel.sharding import param_axes, tp_axis
from pgica_tpu_torch.training.optim import OptState, Optimizer, global_norm

Batch = Mapping[str, object]
CAPTION_KEYS = ("image", "caption_ids", "caption_mask")
PAIR_KEYS = ("image", "preferred_ids", "preferred_mask", "rejected_ids", "rejected_mask")


LoraSpec = Tuple[float, ...]  # (alpha, rank) or (alpha, rank, dropout), as the JAX steps take it


@dataclasses.dataclass
class TrainState:
    """The module (its float32 masters are the params), the optimizer state and the counters.

    Steps update the module's parameters (or, with ``lora``, the adapter
    factors) and ``opt_state`` in place and return the same object. ``step``
    counts the calls on the host (it seeds the generators); ``skipped_t``,
    the NaN-skipped updates, is an int32 tensor on the parameters' device.
    """

    step: int
    module: nn.Module
    opt_state: OptState
    skipped_t: Optional[torch.Tensor] = None
    lora: Optional[Adapters] = None  # the trained factors in LoRA mode (the masters then stay frozen)

    def __post_init__(self):
        if self.skipped_t is None:
            device = self.opt_state.params[0].device if self.opt_state.params else torch.device("cpu")
            self.skipped_t = torch.zeros((), dtype=torch.int32, device=device)

    @property
    def skipped(self) -> int:
        """The count of NaN-skipped updates (a host sync)."""
        return int(self.skipped_t)

    @classmethod
    def create(cls, module: nn.Module, optimizer: Optimizer, lora: Optional[Adapters] = None) -> "TrainState":
        opt_state = optimizer.init(module) if lora is None else optimizer.init_adapters(module, lora)
        return cls(step=0, module=module, opt_state=opt_state, lora=lora)


def all_reduce_mean(grads: List[torch.Tensor], mesh: MeshContext, axis: AxisName = BATCH_AXES,
                    count: Optional[int] = None) -> List[torch.Tensor]:
    """The sum over ``axis`` of each gradient divided by ``count`` (default: the axis's ranks, the mean):
    one all-reduce of the flat f32 buffer."""
    n = mesh.axis_size(axis)
    count = n if count is None else count
    if n == 1 and count == 1:
        return grads
    flat = collectives.psum(torch.cat([g.reshape(-1).to(torch.float32) for g in grads]), axis, mesh)
    flat /= count
    return [part.view_as(g).to(g.dtype) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def tree_norm(state: TrainState, mesh: Optional[MeshContext]) -> Callable[[List[torch.Tensor]], torch.Tensor]:
    """The gradient tree's global norm for ``state``'s trained leaves: the blocks' squares of a sharded
    module summed over the axes that cut them (a LoRA state's factors are whole)."""
    axes = param_axes(state.module) if state.lora is None and mesh is not None else {}
    if not axes:
        return global_norm
    per_leaf = [axes.get(name, ()) for name in state.opt_state.names]
    return lambda grads: global_norm(grads, per_leaf, mesh)


def reduce_gradients(grads: List[torch.Tensor], state: TrainState, mesh: MeshContext,
                     axis: AxisName = BATCH_AXES) -> List[torch.Tensor]:
    """The gradients summed over ``axis`` and divided by the batch ranks: a leaf cut over ``fsdp`` came out of
    its gathers' backward summed over ``fsdp`` already, so it is summed over the rest of ``axis`` only."""
    cut = set(fsdp.leaves(state.module)) if state.lora is None else set()
    count = mesh.data_parallel_size
    if not cut:
        return all_reduce_mean(grads, mesh, axis, count)
    rest = tuple(a for a in axis_names(axis) if a != "fsdp")
    sharded = [name in cut for name in state.opt_state.names]
    out = list(grads)
    for keep, over in ((False, axis), (True, rest)):
        idx = [i for i, s in enumerate(sharded) if s == keep]
        if idx:
            for i, g in zip(idx, all_reduce_mean([grads[i] for i in idx], mesh, over, count)):
                out[i] = g
    return out


def _update(state: TrainState, grads, optimizer: Optimizer, loss: torch.Tensor, due: bool,
            mesh: Optional[MeshContext] = None, axis: AxisName = BATCH_AXES) -> torch.Tensor:
    """NaN-safe update on the device: nothing changes on a non-finite loss or gradient norm, and ``skipped``
    adds one; returns the gradient norm. ``due``: whether this micro-step applies the accumulated update
    (:meth:`Optimizer.due`).

    On a mesh the gradients are first summed over ``axis`` and divided by
    the batch ranks (with the default axis, averaged over them;
    :func:`reduce_gradients`), and ``loss`` is the pmean'ed loss.
    """
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, state.opt_state.params)]
    if mesh is not None:
        grads = reduce_gradients(grads, state, mesh, axis)
    norm_fn = tree_norm(state, mesh)
    grad_norm = norm_fn(grads)
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    optimizer.step(grads, state.opt_state, ok, grad_norm, due, norm_fn)
    state.skipped_t.add_((~ok).to(torch.int32))
    return grad_norm


def _on_device(batch: Batch, device: torch.device, keys=CAPTION_KEYS) -> Dict[str, torch.Tensor]:
    out = {}
    for key in keys:
        value = batch[key]
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = value.to(device, non_blocking=True)
    return out


RANK_STREAM = 1 << 44  # a batch rank's streams: offset by its batch-axis index times this


def stream_offset(mesh: Optional[MeshContext]) -> int:
    """The streams' offset of this rank: JAX's ``fold_in(rng, axis_index)`` (0 without a mesh, and on rank 0)."""
    return 0 if mesh is None else mesh.batch_index * RANK_STREAM


def step_generator(device: torch.device, seed: int, step: int, offset: int = 0) -> torch.Generator:
    """The dropout generator of one step: the JAX step's ``fold_in(rng, step)``."""
    return stream_generator(seed, step, device, offset=offset)


AUGMENT_STREAM = 1 << 40  # keeps the augmentation seeds apart from the dropout seeds


def augment_generator(seed: int, step: int, offset: int = 0) -> torch.Generator:
    """The augmentation generator of one step, on the CPU (the JAX step's ``aug_rng`` split).

    Its draws are a few scalars per image, copied to the device in one
    transfer, so one seed augments alike on the card and on the CPU.
    """
    return stream_generator(seed, step, offset=AUGMENT_STREAM + offset)


LORA_STREAM = 2 << 40  # the adapter DropConnect's seeds (the JAX step's fold_in(rng, 7))


def _adapted(module: nn.Module, adapters: Optional[Adapters], lora: Optional[LoraSpec],
             generator: Optional[torch.Generator] = None):
    """A context running ``module`` on its LoRA-merged weights (no-op without ``lora``); with a
    ``generator``, the spec's dropout masks the factors."""
    if lora is None:
        return contextlib.nullcontext(module)
    if adapters is None:
        raise ValueError("a LoRA step needs the adapter factors (TrainState.create(..., lora=adapters))")
    dropout = lora[2] if len(lora) > 2 else 0.0
    return swapped(module, merged_targets(module, adapters, lora[0], int(lora[1]), dropout, generator))


def _augmented(batch: Dict[str, torch.Tensor], augment: bool, seed: int, step: int,
               offset: int = 0) -> Dict[str, torch.Tensor]:
    if augment:
        batch["image"] = augment_batch(prepare_images(batch["image"]), augment_generator(seed, step, offset))
    return batch


def _bound(mesh: Optional[MeshContext]):
    """The mesh's axis names bound for the collectives (a no-op without a mesh)."""
    return contextlib.nullcontext() if mesh is None else mesh


def reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[MeshContext],
                   rows: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Each metric's mean over the batch ranks (weighted by ``rows``, this rank's batch rows, if given)."""
    if mesh is None or mesh.data_parallel_size == 1:
        return metrics
    names = sorted(metrics)
    local = torch.stack([metrics[k].detach().to(torch.float32) for k in names])
    if rows is None:
        reduced = collectives.pmean(local, BATCH_AXES, mesh)
    else:
        weighted = collectives.psum(torch.cat([local * rows, local.new_tensor([rows])]), BATCH_AXES, mesh)
        reduced = weighted[:-1] / weighted[-1]
    return dict(zip(names, reduced.unbind()))


LossFn = Callable[[nn.Module, Optional[nn.Module], Dict[str, torch.Tensor], Optional[torch.Generator]],
                  Tuple[torch.Tensor, Dict[str, torch.Tensor]]]


class TrainStep:
    """One stage's train step: ``step(state, batch, seed)`` (``step(state, ref, batch, seed)`` for a stage
    that takes a reference) -> ``(state, metrics)``, eager.

    :meth:`host_inputs` is the part that needs the host (the batch moved to
    the device, the augmentation's draws from their CPU generator, the seeds
    of the dropout and LoRA generators) and :meth:`body` the rest: the
    forward, the gradients, the norm, the NaN skip, the accumulation and the
    update, every operation on the device with no host sync, so that without
    a mesh one CUDA graph can hold it (training/graphs.py). The merged LoRA
    weights stay in place through the backward, where activation
    checkpointing recomputes the blocks. On a mesh the gradients and the
    metrics are reduced over the batch ranks.
    """

    def __init__(self, optimizer: Optimizer, loss_fn: LossFn, keys: Tuple[str, ...], augment: bool,
                 lora: Optional[LoraSpec], mesh: Optional[MeshContext], takes_ref: bool):
        self.optimizer, self.loss_fn, self.keys = optimizer, loss_fn, keys
        self.augment, self.lora, self.mesh, self.takes_ref = augment, lora, mesh, takes_ref

    def split_args(self, args) -> Tuple[Optional[nn.Module], Batch, int]:
        """(ref, batch, seed) of a call's arguments after the state."""
        if self.takes_ref:
            ref, batch, *rest = args
        else:
            ref, (batch, *rest) = None, args
        return ref, batch, int(rest[0]) if rest else 0

    def seeds(self, seed: int, step: int) -> Tuple[int, Optional[int]]:
        """The step's dropout and LoRA DropConnect seeds (None: no LoRA)."""
        offset = stream_offset(self.mesh)
        lora = None if self.lora is None else stream_seed(seed, step, LORA_STREAM + offset)
        return stream_seed(seed, step, offset), lora

    def augment_draws(self, rows: int, seed: int, step: int) -> Optional[AugmentParams]:
        """The augmentation's parameters for ``rows`` images, on the CPU (None without augmentation)."""
        if not self.augment:
            return None
        return sample_augment_params(rows, augment_generator(seed, step, stream_offset(self.mesh)))

    def host_inputs(self, state: TrainState, batch: Batch, seed: int):
        """(batch on the device, augmentation draws there or None, dropout generator, LoRA generator or None)."""
        device = state.opt_state.params[0].device
        batch = _on_device(batch, device, self.keys)
        draws = self.augment_draws(batch["image"].shape[0], seed, state.step)
        dropout_seed, lora_seed = self.seeds(seed, state.step)
        generator = torch.Generator(device).manual_seed(dropout_seed)
        lora_gen = None if lora_seed is None else torch.Generator(device).manual_seed(lora_seed)
        return batch, None if draws is None else draws.to(device), generator, lora_gen

    def body(self, state: TrainState, ref: Optional[nn.Module], batch: Dict[str, torch.Tensor],
             draws: Optional[AugmentParams], generator: Optional[torch.Generator],
             lora_gen: Optional[torch.Generator], due: bool) -> Dict[str, torch.Tensor]:
        """The step's device work on its inputs; the metrics as 0-dim tensors (``skipped`` the counter's value)."""
        if draws is not None:
            batch = dict(batch, image=augment_batch(prepare_images(batch["image"]), params=draws))
        params = state.opt_state.params
        with torch.enable_grad(), _bound(self.mesh), _adapted(state.module, state.lora, self.lora, lora_gen):
            loss, metrics = self.loss_fn(state.module, ref, batch, generator)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        metrics = reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)
        metrics["grad_norm"] = _update(state, grads, self.optimizer, metrics["loss"], due, self.mesh)
        metrics["skipped"] = state.skipped_t.clone()
        return metrics

    def __call__(self, state: TrainState, *args) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        ref, batch, seed = self.split_args(args)
        batch, draws, generator, lora_gen = self.host_inputs(state, batch, seed)
        metrics = self.body(state, ref, batch, draws, generator, lora_gen, self.optimizer.due(state.opt_state))
        state.step += 1
        return state, metrics


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
    module: nn.Module, optimizer: Optimizer, augment: bool = False, mesh: Optional[MeshContext] = None,
) -> TrainStep:
    """Returns ``step(state, batch, seed) -> (state, metrics)``: ``loss``, ``grad_norm``, ``skipped``.

    ``batch`` is a stage-1 batch (``image``, ``caption_ids``, ``caption_mask``);
    on a ``mesh``, this rank's rows of it.
    """

    return TrainStep(optimizer, lambda module, _, batch, gen: stage0_loss_fn(module, batch, gen), CAPTION_KEYS,
                     augment, None, mesh, takes_ref=False)


# --------------------------------------------------------------------- stage 1


def stage1_loss_fn(
    module: nn.Module,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    temperature: float,
    axis_name: Optional[AxisName] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Contrastive forward + NT-Xent. ``generator`` drives dropout (None: off); ``axis_name``
    gathers the negatives over those mesh axes."""
    out = module(prepare_images(batch["image"]), batch["caption_ids"], batch["caption_mask"],
                 mode="contrastive", generator=generator)
    loss, metrics = ntxent_loss(out["image_embeddings"], out["text_embeddings"], temperature, axis_name)
    metrics["loss"] = loss
    return loss, metrics


def make_stage1_train_step(
    module: nn.Module,
    optimizer: Optimizer,
    temperature: float,
    augment: bool = False,
    lora: Optional[LoraSpec] = None,
    mesh: Optional[MeshContext] = None,
) -> TrainStep:
    """Returns ``step(state, batch, seed) -> (state, metrics)``.

    ``batch`` (on a ``mesh``: this rank's rows, the negatives gathered over
    the batch axes) holds ``image`` (uint8 NHWC or normalized float), ``caption_ids``
    and ``caption_mask`` as tensors or numpy arrays; they are moved to the
    module's device. ``seed`` and the state's step count seed the dropout
    generator. Metrics: ``loss``, ``loss_i2t``, ``loss_t2i``,
    ``contrastive_accuracy``, ``grad_norm`` and ``skipped`` (0-dim tensors on the device).
    ``augment`` augments the images first (see the module docstring).
    ``lora`` trains the state's adapters (see the module docstring).
    """

    axis = None if mesh is None else BATCH_AXES
    return TrainStep(optimizer, lambda module, _, batch, gen: stage1_loss_fn(module, batch, gen, temperature, axis),
                     CAPTION_KEYS, augment, lora, mesh, takes_ref=False)


def make_stage1_loss(module: nn.Module, temperature: float, augment: bool = False,
                     mesh: Optional[MeshContext] = None, axis_name: AxisName = BATCH_AXES):
    """``loss_fn(batch, seed, step) -> (loss, metrics)`` of the ZeRO steps (parallel/zero1.py): this rank's
    rows moved to the device and augmented, dropout from the step's stream, the negatives gathered over
    ``axis_name`` (the JAX package's ``stage1_loss_fn`` with ``axis_name``)."""

    def loss_fn(batch: Batch, seed: int, step: int):
        device, offset = _device(module), stream_offset(mesh)
        batch = _augmented(_on_device(batch, device), augment, seed, step, offset)
        return stage1_loss_fn(module, batch, step_generator(device, seed, step, offset), temperature, axis_name)

    return loss_fn


def make_stage1_eval_step(
    module: nn.Module, temperature: float, lora: Optional[LoraSpec] = None, adapters: Optional[Adapters] = None,
    mesh: Optional[MeshContext] = None,
) -> Callable[[Batch], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> metrics``: the contrastive forward without dropout or gradients.

    With ``lora`` it runs on the base merged with ``adapters`` (read at each
    call, so the train steps' in-place updates show), without DropConnect.
    On a ``mesh`` it scores this rank's rows against the global negatives and
    returns the metrics of the global batch (the ranks' means weighted by rows).
    """
    axis = None if mesh is None else BATCH_AXES

    @torch.no_grad()
    def step(batch: Batch):
        batch = _on_device(batch, _device(module))
        with _bound(mesh), _adapted(module, adapters, lora):
            _, metrics = stage1_loss_fn(module, batch, None, temperature, axis)
        return reduce_metrics(metrics, mesh, batch["image"].shape[0])

    return step


# --------------------------------------------------------------------- stage 2


def decoder_embedding(module: nn.Module) -> torch.Tensor:
    """The decoder LM's weight-tied embedding: the policy's f32 master, or a frozen copy's cast; gathered
    where it is cut over ``fsdp``.

    With a shared text tower it is the shared LM's (JAX ``shared_lm``): the
    decoder's ``lm`` is that LM.
    """
    return fsdp.full(module.caption_decoder.lm.wte, "weight")


def decoder_vocab(module: nn.Module) -> int:
    """The decoder's whole vocab (its ``wte`` may hold one rank's block of it)."""
    return module.caption_decoder.lm.config.vocab_size


def vocab_mesh(module: nn.Module, mesh: Optional[MeshContext]) -> Optional[MeshContext]:
    """``mesh`` where the log-probs take the vocab-parallel route: a module cut over its ``model`` axis."""
    return mesh if mesh is not None and tp_axis(module) is not None else None


def _policy_pair_logprobs(
    module: nn.Module,
    images: torch.Tensor,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator],
    length_normalized: bool,
    mesh: Optional[MeshContext] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One vision encode + ONE decoder pass over [chosen; rejected] -> (chosen, rejected) log-probs (B,)."""
    b = images.shape[0]
    vision = module.encode_image(images, generator)
    ids = torch.cat([batch["preferred_ids"], batch["rejected_ids"]], dim=0)
    mask = torch.cat([batch["preferred_mask"], batch["rejected_mask"]], dim=0)
    vis2 = torch.cat([vision["embeddings"], vision["embeddings"]], dim=0)
    dec = module.decode_train(ids, mask, vis2, generator, with_logits=False)
    logps = sequence_logprobs_from_hidden(dec["hidden_states"], decoder_embedding(module), ids, mask,
                                          length_normalized, mesh=vocab_mesh(module, mesh),
                                          vocab_size=decoder_vocab(module))
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
    mesh: Optional[MeshContext] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """DPO of the policy ``module`` (dropout from ``generator``) against ``ref_module`` (no dropout, no grad);
    ``mesh`` for the vocab-parallel log-probs of a tensor-parallel module."""
    images = prepare_images(batch["image"])
    pc, pr = _policy_pair_logprobs(module, images, batch, generator, length_normalized, mesh)
    rc = rr = None
    if not reference_free and ref_module is not None:
        with torch.no_grad():
            rc, rr = _policy_pair_logprobs(ref_module, images, batch, None, length_normalized, mesh)
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
    lora: Optional[LoraSpec] = None,
    mesh: Optional[MeshContext] = None,
) -> TrainStep:
    """Returns ``step(state, ref_module, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``image`` and ``preferred_ids``/``preferred_mask``/
    ``rejected_ids``/``rejected_mask`` (tensors or numpy arrays; moved to the
    module's device). ``ref_module`` is the frozen reference (see
    :func:`~pgica_tpu_torch.models.model.frozen_copy`), or None with
    ``reference_free``. Metrics: ``loss``, ``reward_margin``,
    ``reward_accuracy``, ``chosen_reward``, ``rejected_reward``,
    ``policy_chosen_logp``, ``policy_rejected_logp``, ``grad_norm`` and
    ``skipped`` (0-dim tensors on the device). ``augment`` augments the images first.
    ``lora`` trains the state's adapters; the reference is then the frozen
    merged policy at stage-2 start (the trainer's). On a ``mesh``, ``batch``
    is this rank's rows.
    """

    def loss_fn(module, ref_module, batch, gen):
        return stage2_loss_fn(module, ref_module, batch, gen, beta, reference_free, length_normalized,
                              label_smoothing, mesh)

    return TrainStep(optimizer, loss_fn, PAIR_KEYS, augment, lora, mesh, takes_ref=True)


def make_stage2_loss(module: nn.Module, ref_module: Optional[nn.Module], beta: float, reference_free: bool = False,
                     length_normalized: bool = False, label_smoothing: float = 0.0, augment: bool = False,
                     mesh: Optional[MeshContext] = None):
    """``loss_fn(batch, seed, step) -> (loss, metrics)`` of the ZeRO steps: DPO on this rank's rows, as
    :func:`make_stage1_loss` (the reference without dropout or gradients)."""

    def loss_fn(batch: Batch, seed: int, step: int):
        device, offset = _device(module), stream_offset(mesh)
        batch = _augmented(_on_device(batch, device, PAIR_KEYS), augment, seed, step, offset)
        return stage2_loss_fn(module, ref_module, batch, step_generator(device, seed, step, offset), beta,
                              reference_free, length_normalized, label_smoothing, mesh)

    return loss_fn


def make_stage2_eval_step(
    module: nn.Module,
    beta: float,
    reference_free: bool = False,
    length_normalized: bool = False,
    lora: Optional[LoraSpec] = None,
    adapters: Optional[Adapters] = None,
    mesh: Optional[MeshContext] = None,
) -> Callable[[Optional[nn.Module], Batch], Dict[str, torch.Tensor]]:
    """Returns ``step(ref_module, batch) -> metrics``: DPO loss and rewards without dropout or gradients
    (with ``lora``, the policy merged with ``adapters``, as :func:`make_stage1_eval_step`; on a ``mesh``,
    the global batch's metrics from this rank's rows)."""

    @torch.no_grad()
    def step(ref_module: Optional[nn.Module], batch: Batch):
        batch = _on_device(batch, _device(module), PAIR_KEYS)
        with _bound(mesh), _adapted(module, adapters, lora):
            loss, metrics = stage2_loss_fn(module, ref_module, batch, None, beta, reference_free,
                                           length_normalized, 0.0, mesh)
        del metrics["policy_chosen_logp"], metrics["policy_rejected_logp"]  # as the JAX eval step
        return reduce_metrics(metrics, mesh, batch["image"].shape[0])

    return step
