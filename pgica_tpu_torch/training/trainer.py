"""Two-stage trainer, on one device or data-parallel over ranks (port of pgica_tpu/training/trainer.py:60-1296).

``PreferenceGuidedTrainer`` runs the optional stage 0 (caption
cross-entropy warm-up), stage 1 (contrastive) and stage 2 (DPO against a
frozen reference), with the JAX trainer's partitions, gradient
accumulation (``MultiSteps``), augmentation, validation, early stopping,
per-epoch, best and mid-epoch autosave checkpoints, resume, and the
``results.json`` artifacts. The train steps update the model's float32
masters in place, so the model wrapper always holds the trained weights
(its bf16 serving copy follows them, ``models/model.py``).

Differences from the JAX trainer:

* A device mesh (``mesh``, a :class:`~pgica_tpu_torch.parallel.mesh.
  MeshContext` over ``torch.distributed`` ranks, one process a rank) runs
  data parallelism over its batch axes ``dcn``/``data``/``fsdp``: each
  rank's loaders yield its rows of every global batch (the length bucket is
  the global batch's), and the steps reduce gradients and metrics over the
  ranks (training/train_step.py), with the standard optimizer replicated.
  ``mesh.zero1`` routes the stages through parallel/zero1.py and
  ``mesh.zero3`` through parallel/zero3.py, with the JAX trainer's checks
  (trainer.py:256-437) and its ZeRO partitions: the Adam state (and under
  ZeRO-3 the LM blocks) sharded, freezing by the backbone flags only, no
  gradient accumulation, no LoRA. Validation reduces over the ranks,
  weighted by rows. Only rank 0 writes checkpoints (gathered parameters;
  the ZeRO Adam state gathered too: a resume takes this rank's slices of
  it wherever the saved buffers' sizes are this run's, whatever the rank
  count, and otherwise starts the optimizer fresh, as JAX's
  ``_maybe_resume_opt_state``), ``results.json`` and the logged metrics.
* FSDP at rest (``mesh.fsdp`` > 1 without a ZeRO flag; JAX trainer.py:
  256-261): the trainer cuts the model over ``fsdp`` at construction, after
  the ``model`` cut (parallel/sharding.py:shard_fsdp: JAX's shard of every
  leaf the rules cut, whole layers of the ``scan_layers`` stacks where the
  axis divides them), so the Adam moments and the stage-2 reference are cut
  alike; the towers gather a block's weights at its entry
  (parallel/fsdp.py). Stages 0-2, validation and the CP step run on the cut
  model; checkpoints hold the gathered parameters and moments, which a
  resume cuts onto its own mesh; after training the model is gathered back
  (cut over ``model`` only, if it was). Off under ZeRO (whose steps own the
  layout) and LoRA (JAX trains the adapters and leaves the base as it is).
* Tensor parallelism (``mesh.model`` > 1; JAX trainer.py:815-821): the
  trainer cuts the model over ``model`` at construction
  (parallel/sharding.py:shard_module, the layers' Megatron collectives),
  and stage 2's log-probs take the vocab-parallel fused CE. It is off under
  LoRA, as in JAX (the ranks of ``model`` then repeat the step). A
  tensor-parallel checkpoint holds the gathered parameters and Adam
  moments, laid out as one process's, so a resume cuts them onto any
  ``model`` degree, one process included.
* Context parallelism (``mesh.seq`` > 1; JAX trainer.py:822-876): stage 2
  runs training/cp_step.py's step, the caption columns sharded over
  ``seq``; stage 0 and 1 repeat on each rank of ``seq``, as JAX's GSPMD
  step does; the length buckets stay multiples of ``mesh.seq``. It refuses
  LoRA and a ``data.max_caption_length`` that ``mesh.seq`` does not divide.
  ZeRO refuses ``model`` or ``seq`` > 1.
* LoRA (``model.lora_config``; JAX trainer.py:201-260,494-507,612-625,
  686-725,1131-1162,1232-1237): stages 1 and 2 train the model's adapter
  factors only (the optimizer holds nothing else, so no partition
  freezes anything); the float32 masters stay as they are until the end of
  training, when the adapters are folded into them (or the best checkpoint,
  merged, is loaded), after which ``generate_captions`` and the CLIs see
  the adapted model. The stage-2 reference is a frozen copy, in
  ``reference_dtype``, of the merged policy at stage-2 start. Checkpoints
  hold the base, the factors and the config.
* On the card without a mesh every train step of stages 0-2 (LoRA too) runs
  as CUDA graphs (training/graphs.py:GraphedTrainStep: one per batch shape,
  captured after the shape's first, eager step), as the JAX trainer jits
  them; the mesh routes run eagerly. A step ends in no host sync: the NaN
  skip happens on the device, and the trainer reads the skip counter at
  logging boundaries and at the end of each epoch. The steps' walls come
  from CUDA events around each step, read at the epoch's end.
* The stage-2 reference never holds the text tower, which stage 2 does not
  run; ``drop_unused_tower`` moves the policy's text tower to host memory
  for the stage and back at its end (checkpoints hold it throughout).
* ``profile_dir`` traces the 3rd to 8th step that this trainer runs in each
  stage with ``torch.profiler`` (host and, on the card, CUDA activity), one
  trace per stage, and keeps each window's kernel and copy time, its host
  operators' time, the steps' walls and the window's wall (synchronized at
  both ends, the autosaves' time taken out) in ``profiles``.
* Checkpoints are ``torch.save`` payloads (``training/checkpoint.py``).
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from pgica_tpu_torch.core.precision import compute_dtype
from pgica_tpu_torch.core.prng import purpose_seed
from pgica_tpu_torch.models.lora import fold_lora, lora_from_tree, lora_to_tree, merged_targets
from pgica_tpu_torch.models.model import frozen_copy
from pgica_tpu_torch.parallel import collectives, fsdp
from pgica_tpu_torch.parallel.mesh import BATCH_AXES
from pgica_tpu_torch.parallel.sharding import (
    gathered_state_dict,
    is_sharded,
    local_state,
    shard_fsdp,
    shard_module,
    sharded_bytes,
)
from pgica_tpu_torch.parallel.zero1 import ZeroState, make_zero1_train_step
from pgica_tpu_torch.parallel.zero3 import make_zero3_train_step
from pgica_tpu_torch.training.checkpoint import CheckpointManager, effective_params, load_opt_state, opt_state_dict
from pgica_tpu_torch.training.cp_step import make_stage2_cp_eval_step, make_stage2_cp_train_step
from pgica_tpu_torch.training.graphs import GraphedTrainStep
from pgica_tpu_torch.training.optim import create_optimizer, warmup_cosine_schedule
from pgica_tpu_torch.training.packing import bucket_batch, default_buckets
from pgica_tpu_torch.training.train_step import (
    TrainState,
    make_stage0_train_step,
    make_stage1_eval_step,
    make_stage1_loss,
    make_stage1_train_step,
    make_stage2_eval_step,
    make_stage2_loss,
    make_stage2_train_step,
)
from pgica_tpu_torch.utils import trace

logger = logging.getLogger(__name__)

try:  # optional experiment tracking, as in the JAX trainer
    import mlflow  # type: ignore
except Exception:  # pragma: no cover
    mlflow = None
try:
    import wandb  # type: ignore
except Exception:  # pragma: no cover
    wandb = None
try:
    from tqdm import tqdm  # type: ignore
except Exception:  # pragma: no cover
    tqdm = None

PROFILE_STEPS = (2, 8)  # [first, last) step of a stage that profile_dir traces
STEP_RANGE = "train_step"  # the profiler range around each train step


def stage_seed(seed: int, stage: int) -> int:
    """The seed of one stage's step generators (the JAX trainer's ``purpose_key``)."""
    return purpose_seed(seed, f"train_stage{stage}")


@contextmanager
def _without(module: nn.Module, child: str):
    """``module`` with one child taken out for the duration (a copy made inside lacks it)."""
    held = module._modules[child]
    module._modules[child] = None
    try:
        yield module
    finally:
        module._modules[child] = held


class _StepWalls:
    """Each train step's wall: on the card the device time between CUDA events recorded on the stream
    around the step (the steps end in no host sync), read once they are done; on the CPU the host clock."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: List[Any] = []

    def start(self) -> None:
        self.marks.append([self._mark(), None])

    def end(self) -> None:
        self.marks[-1][1] = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(self) -> List[float]:
        """The walls so far (on the card this waits for the steps recorded)."""
        if not self.cuda:
            return [b - a for a, b in self.marks]
        if self.marks:
            self.marks[-1][1].synchronize()
        return [a.elapsed_time(b) / 1e3 for a, b in self.marks]


class PreferenceGuidedTrainer:
    """Orchestrates stage 0 (optional), stage 1 (contrastive) and stage 2 (DPO) on one device or a mesh."""

    def __init__(
        self,
        model,
        config,
        train_loader=None,
        val_loader=None,
        preference_train_loader=None,
        preference_val_loader=None,
        mesh=None,
        output_dir: Optional[str] = None,
        profile_dir: Optional[str] = None,
        max_steps_per_epoch: Optional[int] = None,
    ):
        self.model = model
        self.config = config
        self.mesh = mesh
        self.is_writer = mesh is None or mesh.rank == 0  # only rank 0 writes checkpoints, results and logs
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.preference_train_loader = preference_train_loader
        self.preference_val_loader = preference_val_loader
        if mesh is not None:
            for loader in (train_loader, val_loader, preference_train_loader, preference_val_loader):
                if loader is None:
                    continue
                if not hasattr(loader, "set_shard"):
                    raise ValueError("on a device mesh the loaders must yield each rank's rows "
                                     "(data/loader.py:DataLoader.set_shard)")
                loader.set_shard(mesh)
        if mesh is not None and self._lora_static is None:  # TP and FSDP are off under LoRA
            shard_module(model.module, mesh)
            if not (config.get("mesh.zero1", False) or config.get("mesh.zero3", False)):
                shard_fsdp(model.module, mesh, scanned=bool(config.get("model.scan_layers", False)))
            if is_sharded(model.module):
                local, whole = sharded_bytes(model.module)
                logger.info("Sharded over fsdp %d x model %d: this rank holds %d of %d bytes of the cut parameters",
                            mesh.shape["fsdp"], mesh.shape["model"], local, whole)

        self.output_dir = Path(output_dir or config.get("paths.output_dir", "./outputs"))
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.checkpoints = CheckpointManager(config.get("paths.checkpoint_dir", self.output_dir / "checkpoints"),
                                             writer=self.is_writer)

        self.profile_dir = profile_dir
        self.profiles: Dict[int, Dict[str, float]] = {}
        self._profiler = None
        self._profile_excluded_s = 0.0  # autosave time inside the profiled window, left out of its wall
        self.graphs: Dict[int, Dict[str, Any]] = {}  # per stage: what its graphed train step captured and replayed
        self.max_steps_per_epoch = max_steps_per_epoch  # debug cap (--max-steps)
        self.global_step = 0
        self.current_epoch = 0
        self._dropped_tower: Optional[nn.Module] = None  # text tower held in host memory by drop_unused_tower
        self.best_val_loss: Dict[int, float] = {1: float("inf"), 2: float("inf")}
        self.early_stopping_patience = config.get("training.early_stopping_patience", 3)
        self.logging_steps = config.get("training.logging_steps", 100)
        strategy = str(config.get("training.save_strategy", "steps")).lower()
        self.save_steps = int(config.get("training.save_steps", 0) or 0) if strategy == "steps" else 0
        self.keep_checkpoints = config.get("training.keep_checkpoints")
        self.save_epoch_checkpoints = bool(config.get("training.save_epoch_checkpoints", True))
        self.save_best_checkpoints = bool(config.get("training.save_best_checkpoints", True))
        self._resume: Optional[Dict[str, int]] = None  # stage / epoch / step_in_epoch
        self._restored_opt_state = None
        self.seed = config.get("training.seed", 42)
        if bool(config.get("training.length_bucketing", True)):
            max_len = int(config.get("data.max_caption_length", 128))
            self._buckets = tuple(config.get("training.length_buckets") or default_buckets(max_len))
        else:
            self._buckets = None
        self._seq_multiple = mesh.shape["seq"] if mesh is not None else 1  # buckets the seq axis divides
        self.history: Dict[str, List] = {"stage0": [], "stage1": [], "stage2": []}
        self._setup_tracking()

    @property
    def device(self) -> torch.device:
        return self.model.device

    # ------------------------------------------------------------- tracking

    def _setup_tracking(self):
        self._mlflow_run = None
        self._wandb_run = None
        if not self.is_writer:
            return
        if mlflow is not None:
            try:
                mlflow.set_experiment(self.config.get("logging.mlflow_experiment", "image-captioning-alignment"))
                self._mlflow_run = mlflow.start_run()
                mlflow.log_params({
                    "stage1_lr": self.config.get("training.stage1.learning_rate"),
                    "stage2_lr": self.config.get("training.stage2.learning_rate"),
                    "projection_dim": self.config.get("model.projection_dim"),
                    "temperature": self.config.get("model.temperature"),
                })
            except Exception as e:  # pragma: no cover
                logger.warning("MLflow unavailable: %s", e)
        if wandb is not None:
            try:  # WANDB_MODE (offline unless set) is honoured: "disabled" starts nothing
                self._wandb_run = wandb.init(
                    project=self.config.get("logging.wandb_project", "preference-guided-captioning"),
                    mode=os.environ.get("WANDB_MODE", "offline"),
                    config=self.config.to_dict(),
                )
            except Exception as e:  # pragma: no cover
                logger.warning("wandb unavailable: %s", e)

    def _log_metrics(self, metrics: Dict[str, Any], step: int, prefix: str = "train"):
        if not self.is_writer:
            return
        scalars = {f"{prefix}/{k}": float(v) for k, v in metrics.items()}
        logger.info("step %d | %s", step, " ".join(f"{k}={v:.4f}" for k, v in scalars.items()))
        if self._mlflow_run is not None:
            try:
                mlflow.log_metrics(scalars, step=step)
            except Exception:  # pragma: no cover
                pass
        if self._wandb_run is not None and wandb is not None and wandb.run:
            wandb.log(scalars, step=step)

    def _finish_tracking(self):
        if self._mlflow_run is not None:
            try:
                mlflow.end_run()
            except Exception:  # pragma: no cover
                pass
        if self._wandb_run is not None and wandb is not None and wandb.run:
            wandb.finish()

    # ------------------------------------------------------------- helpers

    def _stage_cfg(self, stage: int) -> Dict[str, Any]:
        return self.config.get(f"training.stage{stage}", {})

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """The batch's arrays, length-bucketed; the train steps move them to the device.

        On a mesh the batch is this rank's rows, and the bucket is the global
        batch's (the largest length over the batch ranks), so every rank runs
        one shape, as the JAX package's one sharded global batch does.
        """
        arrays = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        arrays.pop("preference_score", None)
        if self._buckets is not None:
            arrays = bucket_batch(arrays, self._buckets, self._seq_multiple, global_len=self._global_len)
        return arrays

    def _global_len(self, length: int) -> int:
        if self.mesh is None or self.mesh.data_parallel_size == 1:
            return length
        local = torch.tensor([length], device=self.device)
        return int(collectives.pmax(local, BATCH_AXES, self.mesh))

    @property
    def _lora_static(self):
        """(alpha, rank, dropout) while the model carries LoRA adapters, else None (JAX trainer.py:201-211)."""
        cfg = self.model.lora_config
        if cfg and self.model.lora is not None:
            return (float(cfg["alpha"]), int(cfg["rank"]), float(cfg.get("dropout", 0.0)))
        return None

    def _make_optimizer(self, stage: int, steps_per_epoch: int):
        """The stage's chain: modules outside its gradient graph are frozen (JAX trainer.py:213-255).

        With LoRA the state holds the adapters alone, so nothing is frozen.
        """
        cfg = self._stage_cfg(stage)
        accum = int(cfg.get("gradient_accumulation_steps", 1))
        if self.max_steps_per_epoch is not None:
            steps_per_epoch = min(steps_per_epoch, self.max_steps_per_epoch)
        total_updates = max(1, steps_per_epoch * int(cfg.get("num_epochs", 1)) // max(accum, 1))
        lora = self._lora_static is not None
        frozen_prefixes = ("caption_decoder",) if stage == 1 else ("text_encoder",)
        if self.model.freeze_text_backbone:
            frozen_prefixes += ("text_encoder.backbone",)
        return create_optimizer(
            learning_rate=float(cfg.get("learning_rate", 5e-5)),
            total_steps=total_updates,
            warmup_steps=int(cfg.get("warmup_steps", 500)),
            weight_decay=float(cfg.get("weight_decay", 0.01)),
            max_grad_norm=float(cfg.get("max_grad_norm", 1.0)),
            gradient_accumulation_steps=accum,
            freeze_vision_backbone=False if lora else self.model.freeze_vision_backbone,
            frozen_prefixes=() if lora else frozen_prefixes,
        )

    # ------------------------------------------------------------- ZeRO (JAX trainer.py:256-437)

    def _zero1_active(self, lora) -> bool:
        """``mesh.zero1`` routes training through parallel/zero1.py: the flat Adam state sharded over ``data``."""
        if not bool(self.config.get("mesh.zero1", False)):
            return False
        if self.mesh is None or self.mesh.shape.get("data", 1) <= 1:
            raise ValueError("mesh.zero1 requires a device mesh with data > 1")
        if lora is not None:
            raise ValueError("mesh.zero1 does not compose with LoRA (the adapter optimizer state is tiny; "
                             "use the default path)")
        bad = {a: self.mesh.shape[a] for a in ("dcn", "fsdp", "model", "seq") if self.mesh.shape[a] > 1}
        if bad:
            raise ValueError(f"mesh.zero1 shards the optimizer state over the data axis only; set {sorted(bad)} "
                             f"to 1 (got {bad})")
        if bool(self.config.get("mesh.zero3", False)):
            raise ValueError("mesh.zero1 and mesh.zero3 are mutually exclusive")
        return True

    def _zero3_axis(self):
        """The shard axis (a name or a tuple): every axis > 1 among data/fsdp."""
        names = tuple(a for a in ("data", "fsdp") if self.mesh.shape[a] > 1)
        return names if len(names) != 1 else names[0]

    def _zero3_active(self, lora) -> bool:
        """``mesh.zero3`` routes training through parallel/zero3.py: the LM blocks sharded at rest."""
        if not bool(self.config.get("mesh.zero3", False)):
            return False
        if self.mesh is None or self.mesh.shape["data"] * self.mesh.shape["fsdp"] <= 1:
            raise ValueError("mesh.zero3 requires a device mesh with data*fsdp > 1")
        if not bool(self.config.get("model.scan_layers", False)):
            raise ValueError("mesh.zero3 requires model.scan_layers: true (stacked-block lax.scan layout — the "
                             "per-layer gather hook lives in the scan body)")
        if lora is not None:
            raise ValueError("mesh.zero3 does not compose with LoRA")
        bad = {a: self.mesh.shape[a] for a in ("dcn", "model", "seq") if self.mesh.shape[a] > 1}
        if bad:
            raise ValueError(f"mesh.zero3 runs manual over data/fsdp only; set {sorted(bad)} to 1 (got {bad})")
        return True

    def _init_zero(self, zero: int, stage: int, steps_per_epoch: int, loss_fn, ref: Optional[nn.Module] = None):
        """(state, step, sharded reference) of the ZeRO-``zero`` path of ``stage`` (JAX trainer.py:316-431)."""
        cfg = self._stage_cfg(stage)
        name = f"mesh.zero{zero}"
        if int(cfg.get("gradient_accumulation_steps", 1)) > 1:
            raise ValueError(f"{name} does not support gradient_accumulation_steps > 1 (accumulate via a larger "
                             "data axis instead)")
        axis = self._zero3_axis() if zero == 3 else "data"
        n = self.mesh.axis_size(axis)
        loader = self.train_loader if stage == 1 else self.preference_train_loader
        batch_size = int(getattr(loader, "batch_size", 0) or cfg.get("batch_size", 0) or 0)
        if batch_size and batch_size % n:
            raise ValueError(f"{name}: global batch_size {batch_size} must be divisible by the {axis} world ({n})")
        if self.max_steps_per_epoch is not None:
            steps_per_epoch = min(steps_per_epoch, self.max_steps_per_epoch)
        schedule = warmup_cosine_schedule(float(cfg.get("learning_rate", 5e-5)), int(cfg.get("warmup_steps", 500)),
                                          max(1, steps_per_epoch * int(cfg.get("num_epochs", 1))))
        frozen = []
        if self.model.freeze_vision_backbone:
            frozen.append("vision_encoder.backbone.")
        if self.model.freeze_text_backbone:
            frozen.append("text_encoder.backbone.")
        mask = (lambda k: not k.startswith(tuple(frozen))) if frozen else None
        make = make_zero3_train_step if zero == 3 else make_zero1_train_step
        kw = {"with_ref": ref is not None} if zero == 3 else {}
        init_fn, step_fn = make(loss_fn, self.mesh, axis, learning_rate=schedule,
                                weight_decay=float(cfg.get("weight_decay", 0.01)),
                                max_grad_norm=float(cfg.get("max_grad_norm", 1.0)), trainable_mask=mask, **kw)
        state = init_fn(self.model.module)
        restored, self._restored_opt_state = self._restored_opt_state, None  # consume once
        if restored is not None:
            try:
                if "zero" not in restored:
                    raise ValueError("not a ZeRO state")
                state.load_state_dict(restored)
                state.step = self.global_step
                logger.info("Resumed the ZeRO optimizer state from checkpoint")
            except (ValueError, KeyError) as e:
                logger.warning("Could not resume optimizer state (%s); starting fresh", e)
        ref_shards = init_fn.shard_ref(ref) if zero == 3 and ref is not None else None
        logger.info("Stage %d under ZeRO-%d over %s (world %d): %s bytes a rank", stage, zero, axis, n,
                    state.nbytes())
        return state, step_fn, ref_shards

    def _end_zero(self, state) -> None:
        """Back to a plain module with the trained parameters (the JAX trainer's ``_sync_model``)."""
        if isinstance(state, ZeroState) and state.params.shards:
            state.params.release()

    def _check_early_stopping(self, stage: int, val_loss: float, counter: int) -> int:
        """The updated patience counter; the caller stops once it reaches the patience."""
        if val_loss < self.best_val_loss[stage]:
            return 0
        return counter + 1

    def _resume_window(self, stage: int, num_epochs: int):
        """(start_epoch, skip_steps) of this stage given a restored checkpoint.

        A mid-epoch autosave resumes inside its epoch, skipping the batches
        already consumed (the loader's order is pinned per epoch); an
        end-of-epoch checkpoint resumes at the next epoch.
        """
        if not self._resume or self._resume.get("stage") != stage:
            return 0, 0
        info, self._resume = self._resume, None  # consume once
        epoch = int(info.get("epoch", 0))
        step_in_epoch = int(info.get("step_in_epoch", 0))
        if step_in_epoch > 0:
            return min(epoch, num_epochs), step_in_epoch
        return min(epoch + 1, num_epochs), 0

    def _ckpt_payload(self, state=None) -> Dict[str, Any]:
        """Checkpoint content: every parameter by name (a dropped tower from host memory; under ZeRO and
        tensor parallelism gathered, on every rank); with LoRA the masters are the frozen base, beside the
        factors and their config."""
        if isinstance(state, ZeroState):
            return {"params": state.params.state_dict()}
        payload = {"params": self._whole(self.model.module)}
        if self._lora_static is not None:
            payload.update(lora=lora_to_tree(self.model.lora), lora_config=dict(self.model.lora_config))
        return payload

    def _whole(self, module: nn.Module, tensors=None) -> Dict[str, torch.Tensor]:
        """``module``'s state (or ``tensors`` by its parameter names) whole: gathered over ``fsdp`` and
        ``model`` where the module is cut (every rank calls it)."""
        if is_sharded(module):
            return gathered_state_dict(module, self.mesh, tensors)
        return module.state_dict() if tensors is None else dict(tensors)

    def _opt_payload(self, state):
        """The state's optimizer state as a checkpoint holds it (under ZeRO, FSDP and tensor parallelism
        gathered: every rank calls it)."""
        if isinstance(state, ZeroState):
            return state.state_dict()
        if is_sharded(self.model.module):
            return opt_state_dict(state.opt_state, lambda named: self._whole(self.model.module, named))
        return state.opt_state

    def _maybe_autosave(self, stage: int, epoch: int, step_idx: int, state: TrainState):
        if not self.save_steps or self.global_step % self.save_steps != 0 or stage == 0:
            return  # stage 0 is checkpoint-free, as in the JAX trainer
        self.checkpoints.save_autosave(
            stage, epoch=epoch, opt_state=self._opt_payload(state), global_step=self.global_step,
            step_in_epoch=step_idx + 1, config=self.config.to_dict(), **self._ckpt_payload(state),
        )

    def _graphed(self, step):
        """The stage's train step as CUDA graphs on the card without a mesh (the JAX trainer jits every
        step), else the eager step."""
        return GraphedTrainStep(step) if self.mesh is None and self.device.type == "cuda" else step

    def _end_graphs(self, stage: int, step) -> None:
        """Keep what the stage's graphed step did in ``graphs`` and drop its graphs and their pool."""
        if not isinstance(step, GraphedTrainStep):
            return
        keys = list(step.graphs.values())
        self.graphs[stage] = {
            "keys": len(keys), "eager_steps": step.eager_steps, "replays": step.replays,
            "capture_s": [g.captured.capture_s for g in keys], "pool_bytes": sum(g.captured.pool_bytes for g in keys),
            "kernels": [g.captured.kernels for g in keys], "replays_by_key": [g.replays for g in keys],
        }
        logger.info("Stage %d: %d graphed keys (%d eager first steps), %d replays, pool %.2f GiB", stage, len(keys),
                    step.eager_steps, step.replays, self.graphs[stage]["pool_bytes"] / 2**30)
        step.close()

    def _sync_model(self) -> None:
        """Put a tower held out by ``drop_unused_tower`` back on the device.

        The JAX trainer pushes its train state back onto the model here; the
        port's steps update the model's masters in place, so only the tower
        needs moving.
        """
        if self._dropped_tower is not None:
            self._dropped_tower.to(self.device)
            self._dropped_tower = None

    def _end_of_epoch(self, stage: int, epoch: int, state: TrainState, val_loss: Optional[float],
                      patience_counter: int) -> tuple:
        """Epoch checkpoint, pruning, early stopping and the best checkpoint; (counter, stop)."""
        if self.save_epoch_checkpoints:
            self.checkpoints.save_epoch(stage, epoch, opt_state=self._opt_payload(state),
                                        global_step=self.global_step, val_loss=val_loss,
                                        config=self.config.to_dict(), **self._ckpt_payload(state))
            if self.keep_checkpoints:
                self.checkpoints.prune_epochs(stage, int(self.keep_checkpoints))
        if val_loss is None:
            return patience_counter, False
        patience_counter = self._check_early_stopping(stage, val_loss, patience_counter)
        if val_loss < self.best_val_loss[stage]:
            self.best_val_loss[stage] = val_loss
            if self.save_best_checkpoints:
                self.checkpoints.save_best(stage, epoch=epoch, global_step=self.global_step, val_loss=val_loss,
                                           config=self.config.to_dict(), **self._ckpt_payload(state))
        if patience_counter >= self.early_stopping_patience:
            logger.info("Stage %d early stopping at epoch %d", stage, epoch)
            return patience_counter, True
        return patience_counter, False

    # ------------------------------------------------------------- stage 0

    def train_stage0(self) -> Dict[str, Any]:
        """OPTIONAL caption cross-entropy warm-up; inert unless ``training.stage0.num_epochs`` > 0.

        Full model, teacher forcing on the stage-1 corpus; no checkpoints or
        early stopping.
        """
        cfg = self._stage_cfg(0)
        num_epochs = int(cfg.get("num_epochs", 0))
        if num_epochs <= 0:
            return {"skipped": True}
        if self.train_loader is None:
            raise ValueError("Stage 0 requires a contrastive train_loader")
        if self._lora_static is not None:
            raise ValueError("stage0 warmup is full-parameter; disable it for LoRA runs")
        module = self.model.module
        optimizer = self._make_optimizer(0, len(self.train_loader))
        state = self._maybe_resume_opt_state(TrainState.create(module, optimizer))
        step = self._graphed(make_stage0_train_step(module, optimizer, augment=True, mesh=self.mesh))
        seed = stage_seed(self.seed, 0)
        logger.info("Stage 0 (caption-CE warmup): %d epochs x %d steps", num_epochs, len(self.train_loader))
        start_epoch, skip_steps = self._resume_window(0, num_epochs)
        try:
            for epoch in range(start_epoch, num_epochs):
                state, m = self._run_epoch(state, self.train_loader, lambda st, b: step(st, b, seed), 0, epoch,
                                           skip_steps if epoch == start_epoch else 0)
                self.history["stage0"].append(
                    {"epoch": epoch, "train_loss": m["loss"], "input_wait_fraction": m["input_wait_fraction"]})
        finally:
            self._end_graphs(0, step)
        return {"history": self.history["stage0"]}

    # ------------------------------------------------------------- stage 1

    def train_stage1(self) -> Dict[str, Any]:
        if self.train_loader is None:
            raise ValueError("Stage 1 requires a contrastive train_loader")
        cfg = self._stage_cfg(1)
        num_epochs = int(cfg.get("num_epochs", 1))
        temperature = float(self.config.get("model.temperature", 0.5))
        module = self.model.module
        lora = self._lora_static
        seed = stage_seed(self.seed, 1)
        eval_step = make_stage1_eval_step(module, temperature, lora=lora and lora[:2], adapters=self.model.lora,
                                          mesh=self.mesh)
        zero = 3 if self._zero3_active(lora) else 1 if self._zero1_active(lora) else 0
        if zero:
            axis = self._zero3_axis() if zero == 3 else "data"
            loss_fn = make_stage1_loss(module, temperature, augment=True, mesh=self.mesh, axis_name=axis)
            state, z_step, _ = self._init_zero(zero, 1, len(self.train_loader), loss_fn)

            def train_step(st, b):
                return z_step(st, b, seed)
        else:
            optimizer = self._make_optimizer(1, len(self.train_loader))
            state = self._maybe_resume_opt_state(
                TrainState.create(module, optimizer, self.model.lora if lora else None))
            step = self._graphed(make_stage1_train_step(module, optimizer, temperature, augment=True, lora=lora,
                                                        mesh=self.mesh))

            def train_step(st, b):
                return step(st, b, seed)

        logger.info("Stage 1: %d epochs x %d steps", num_epochs, len(self.train_loader))
        patience_counter = 0
        start_epoch, skip_steps = self._resume_window(1, num_epochs)
        try:
            for epoch in range(start_epoch, num_epochs):
                self.current_epoch = epoch
                state, m = self._run_epoch(state, self.train_loader, train_step, 1, epoch,
                                           skip_steps if epoch == start_epoch else 0)
                val_loss = self._validate(self.val_loader, eval_step, 1, state)
                self.history["stage1"].append({"epoch": epoch, "train_loss": m["loss"], "val_loss": val_loss,
                                               "input_wait_fraction": m["input_wait_fraction"],
                                               "step_seconds": m["step_seconds"], "peak_mem_gib": m["peak_mem_gib"]})
                patience_counter, stop = self._end_of_epoch(1, epoch, state, val_loss, patience_counter)
                if stop:
                    break
        finally:
            self._end_zero(state)
            self._end_graphs(1, None if zero else step)
        return {"best_val_loss": self.best_val_loss[1], "history": self.history["stage1"]}

    # ------------------------------------------------------------- stage 2

    def _stage2_reference(self, ref_dtype: torch.dtype) -> nn.Module:
        """Frozen DPO reference = the policy at STAGE-2 START, persisted (JAX trainer.py:954-975).

        Rebuilding it from a restored policy after an interruption would move
        the KL anchor; so it is written once at stage-2 start and restored
        whenever a stage-2 checkpoint is resumed. It leaves out the text
        tower, which stage 2 never runs. With LoRA the policy is the base
        merged with the adapters, without DropConnect (JAX trainer.py:714-723).
        """
        name = "stage2_reference"
        path = self.checkpoints._path(name)
        with _without(self.model.module, "text_encoder") as policy:
            ref = frozen_copy(policy, ref_dtype)
            lora = self._lora_static
            if lora is not None:
                with torch.no_grad():
                    for n, w in merged_targets(policy, self.model.lora, lora[0], lora[1]).items():
                        ref.get_parameter(n).copy_(w)
        if self._resume is not None and self._resume.get("stage") == 2 and path.exists():
            ref.load_state_dict(local_state(ref, self.mesh, self.checkpoints.restore(name)["params"]))
            logger.info("Restored stage-2 DPO reference (stage-2 start policy) from %s", path)
        elif self.save_steps or self.save_epoch_checkpoints or self.save_best_checkpoints:
            self.checkpoints.save(name, self._whole(ref), stage=2)
        return ref

    def train_stage2(self) -> Dict[str, Any]:
        cfg = self._stage_cfg(2)
        num_epochs = int(cfg.get("num_epochs", 1))
        if num_epochs <= 0:
            logger.info("Stage 2 disabled (num_epochs=%d)", num_epochs)
            return {"skipped": True}
        if self.preference_train_loader is None:
            raise ValueError("Stage 2 requires a preference_train_loader")
        reference_free = bool(cfg.get("reference_free", False))
        module = self.model.module
        lora = self._lora_static
        zero = 1 if self._zero1_active(lora) else 3 if self._zero3_active(lora) else 0
        if lora is not None and bool(cfg.get("drop_unused_tower", False)):
            raise ValueError("training.stage2.drop_unused_tower composes with full fine-tuning only")
        if zero and bool(cfg.get("drop_unused_tower", False)):
            raise ValueError("training.stage2.drop_unused_tower composes with the plain and data-parallel paths "
                             "only (ZeRO-1/3 manage their own parameter layouts)")
        ref = None
        if not reference_free:
            ref = self._stage2_reference(compute_dtype(cfg.get("reference_dtype", "bf16")))
        if bool(cfg.get("drop_unused_tower", False)):
            # stage 2 never runs the text tower: its masters wait in host memory
            self._dropped_tower = module.text_encoder.to("cpu")
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        dpo = dict(beta=float(cfg.get("dpo_beta", 0.1)), reference_free=reference_free,
                   length_normalized=bool(cfg.get("length_normalized", False)))
        label_smoothing = float(cfg.get("label_smoothing", 0.0))
        seed = stage_seed(self.seed, 2)
        ref_shards = None
        cp = self.mesh is not None and self.mesh.shape["seq"] > 1
        if cp and not zero:
            if lora is not None:
                raise ValueError("mesh.seq context parallelism composes with dcn/data/fsdp and model axes but not "
                                 "with LoRA")
            seq_len = int(self.config.get("data.max_caption_length", 128))
            if seq_len % self.mesh.shape["seq"]:
                raise ValueError(f"max_caption_length {seq_len} not divisible by mesh.seq {self.mesh.shape['seq']}")
        if cp and not zero:
            use_fused = bool(self.config.get("pallas.fused_cross_entropy", True))
            eval_step = make_stage2_cp_eval_step(module, self.mesh, "seq", use_fused_ce=use_fused, **dpo)
        else:
            eval_step = make_stage2_eval_step(module, lora=lora and lora[:2], adapters=self.model.lora,
                                              mesh=self.mesh, **dpo)
        if zero:
            loss_fn = make_stage2_loss(module, ref, label_smoothing=label_smoothing, augment=True, mesh=self.mesh,
                                       **dpo)
            state, z_step, ref_shards = self._init_zero(zero, 2, len(self.preference_train_loader), loss_fn,
                                                        ref if zero == 3 else None)

            def train_step(st, b):
                return z_step(st, b, seed) if ref_shards is None else z_step(st, b, seed, ref=ref_shards)
        else:
            optimizer = self._make_optimizer(2, len(self.preference_train_loader))
            state = self._maybe_resume_opt_state(
                TrainState.create(module, optimizer, self.model.lora if lora else None))
            if cp:
                step = make_stage2_cp_train_step(module, optimizer, self.mesh, "seq", label_smoothing=label_smoothing,
                                                 augment=True, use_fused_ce=use_fused, **dpo)
            else:
                step = self._graphed(make_stage2_train_step(module, optimizer, label_smoothing=label_smoothing,
                                                            augment=True, lora=lora, mesh=self.mesh, **dpo))

            def train_step(st, b):
                return step(st, ref, b, seed)

        logger.info("Stage 2: %d epochs x %d steps", num_epochs, len(self.preference_train_loader))
        patience_counter = 0
        start_epoch, skip_steps = self._resume_window(2, num_epochs)
        try:
            for epoch in range(start_epoch, num_epochs):
                self.current_epoch = epoch
                state, m = self._run_epoch(state, self.preference_train_loader, train_step, 2, epoch,
                                           skip_steps if epoch == start_epoch else 0)
                val_loss = self._validate(self.preference_val_loader, lambda b: eval_step(ref, b), 2, state,
                                          ref_shards)
                self.history["stage2"].append({"epoch": epoch, "train_loss": m["loss"], "val_loss": val_loss,
                                               "input_wait_fraction": m["input_wait_fraction"],
                                               "step_seconds": m["step_seconds"], "peak_mem_gib": m["peak_mem_gib"]})
                patience_counter, stop = self._end_of_epoch(2, epoch, state, val_loss, patience_counter)
                if stop:
                    break
        finally:
            self._end_zero(state)
            self._end_graphs(2, None if zero else step)
            self._sync_model()
        return {"best_val_loss": self.best_val_loss[2], "history": self.history["stage2"]}

    # ------------------------------------------------------------- loops

    def _maybe_profile(self, stage: int, stage_step: int, walls: "_StepWalls") -> None:
        """torch.profiler over this stage's steps PROFILE_STEPS[0] .. PROFILE_STEPS[1] - 1."""
        if self.profile_dir is None:
            return
        if stage_step == PROFILE_STEPS[0] and self._profiler is None:
            from torch.profiler import ProfilerActivity, profile

            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize()
            self._profiler = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
            self._profiler.__enter__()
            self._profile_excluded_s = 0.0
            self._profile_t0 = (stage, stage_step, time.perf_counter())
            logger.info("Started torch.profiler trace of stage %d -> %s", stage, self.profile_dir)
        elif stage_step >= PROFILE_STEPS[1]:
            self._stop_profile(stage_step, walls)

    def _stop_profile(self, stage_step: int, walls: "_StepWalls") -> None:
        """Close the trace; keep the window's kernel time (memory copies apart), host time and walls.

        ``wall_ms`` spans the window, synchronized at both ends, with its data
        loading and without its autosaves (synchronized around them and left
        out: ``autosave_ms``); the device's busy share ``busy`` is
        ``device_ms / wall_ms``. ``step_ms`` sums the train steps' own walls
        (CUDA events around each step on the card). ``host_ms`` is the self
        time of the host events (operators, autograd nodes, CUDA runtime
        calls; on any thread) inside the steps' ranges, ``host_top`` the ten
        largest by name as (name, ms, calls).
        """
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        stage, first, t0 = self._profile_t0
        wall_ms = (time.perf_counter() - t0 - self._profile_excluded_s) * 1e3
        self._profiler.__exit__(None, None, None)
        prof, self._profiler = self._profiler, None
        events = trace.raw_events(prof)
        # on the card the step ranges also show as annotations spanning each step's kernels: not kernels
        device = {k: v for k, v in trace.device_totals(events).items() if k != STEP_RANGE}
        copies = {k for k in device if k.startswith(("Memcpy", "Memset"))}
        host = trace.host_self_times(events, within=STEP_RANGE)
        device_ms = sum(us for k, (us, _) in device.items() if k not in copies) / 1e3
        self.profiles[stage] = {
            "steps": stage_step - first,
            "step_ms": sum(walls.seconds()[first:stage_step]) * 1e3,
            "wall_ms": wall_ms,
            "autosave_ms": self._profile_excluded_s * 1e3,
            "device_ms": device_ms,
            "busy": device_ms / wall_ms if wall_ms > 0 else None,
            "memcpy_ms": sum(us for k, (us, _) in device.items() if k in copies) / 1e3,
            "launches": sum(n for k, (_, n) in device.items() if k not in copies),
            "host_ms": sum(us for us, _ in host.values()) / 1e3,
            "host_top": [(name, us / 1e3, n) for name, us, n in trace.largest(host, 10)],
        }
        Path(self.profile_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(self.profile_dir) / f"stage{stage}.json"))
        logger.info("Stopped torch.profiler trace of stage %d: %s", stage, self.profiles[stage])

    def _autosave_outside_profile(self, stage: int, epoch: int, step_idx: int, state) -> None:
        """``_maybe_autosave``; inside a profiled window, synchronized around and its time left out of the
        window's wall (its copies are memory copies, not kernels)."""
        if self._profiler is None or not self.save_steps or self.global_step % self.save_steps:
            self._maybe_autosave(stage, epoch, step_idx, state)
            return
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self._maybe_autosave(stage, epoch, step_idx, state)
        if cuda:
            torch.cuda.synchronize()
        self._profile_excluded_s += time.perf_counter() - t

    def _run_epoch(self, state, loader, train_step, stage: int, epoch: int, skip_steps: int = 0):
        """One epoch of ``train_step(state, batch) -> (state, metrics)``."""
        losses = []
        cuda = self.device.type == "cuda"
        walls = _StepWalls(cuda)
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        n_items = 0
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)  # deterministic per-epoch order for resume
        start_idx = 0
        if skip_steps and hasattr(loader, "iter_batches"):
            base_iter = loader.iter_batches(skip_steps)  # consumed batches are never fetched
            start_idx, skip_steps = skip_steps, 0
        else:
            base_iter = loader
        iterator = base_iter
        if tqdm is not None:
            iterator = tqdm(base_iter, total=len(loader), initial=start_idx, desc=f"stage{stage} epoch {epoch}",
                            leave=False)
        input_wait_s = 0.0

        def _timed(it):
            nonlocal input_wait_s
            it = iter(it)
            while True:
                t_wait = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    return
                input_wait_s += time.perf_counter() - t_wait
                yield batch

        run = 0  # steps this trainer ran in this epoch
        for step_idx, batch in enumerate(_timed(iterator), start=start_idx):
            if self.max_steps_per_epoch is not None and step_idx >= self.max_steps_per_epoch:
                break
            if step_idx < skip_steps:
                continue  # consumed before the mid-epoch checkpoint
            self._maybe_profile(stage, run, walls)
            arrays = self._device_batch(batch)
            n_items += arrays["image"].shape[0]
            walls.start()
            with torch.profiler.record_function(STEP_RANGE):
                state, metrics = train_step(state, arrays)
            walls.end()
            run += 1
            self.global_step += 1
            self._autosave_outside_profile(stage, epoch, step_idx, state)
            if self.global_step % self.logging_steps == 0:
                self._log_metrics(metrics, self.global_step, prefix=f"stage{stage}/train")
            losses.append(metrics["loss"])
        self._stop_profile(run, walls)  # close the trace even for short epochs
        if losses:
            stacked = torch.stack([torch.as_tensor(x, dtype=torch.float32) for x in losses])
            finite = torch.isfinite(stacked)
            mean_loss = float(torch.where(finite, stacked, 0.0).sum() / finite.sum().clamp(min=1))
        else:
            mean_loss = float("nan")
        dt = time.perf_counter() - t0
        skipped = int(state.skipped)
        input_wait_fraction = input_wait_s / max(dt, 1e-6)
        logger.info("stage %d epoch %d: train_loss=%.4f (%d steps, %.1f pairs/s, %d NaN-skipped, input wait %.0f%%)",
                    stage, epoch, mean_loss, len(losses), n_items / max(dt, 1e-6), skipped,
                    100.0 * input_wait_fraction)
        if input_wait_fraction > 0.25 and len(losses) > 1:
            logger.warning("stage %d epoch %d is INPUT-BOUND: %.0f%% of epoch wall time was spent waiting on the "
                           "data loader (%.1fs of %.1fs). Raise data.num_workers.",
                           stage, epoch, 100.0 * input_wait_fraction, input_wait_s, dt)
        return state, {
            "loss": mean_loss,
            "pairs_per_sec": n_items / max(dt, 1e-6),
            "skipped": skipped,
            "input_wait_fraction": round(input_wait_fraction, 4),
            "step_seconds": walls.seconds(),
            "peak_mem_gib": torch.cuda.max_memory_allocated(self.device) / 2**30 if cuda else None,
        }

    def _validate(self, loader, eval_step, stage: int, state=None, ref_shards=None) -> Optional[float]:
        """The mean over the loader's batches of the eval loss (on a mesh each batch's over the ranks);
        ZeRO's sharded parameters (and reference) are gathered for it."""
        if loader is None or len(loader) == 0:
            return None
        with contextlib.ExitStack() as gathered:
            if isinstance(state, ZeroState):
                gathered.enter_context(state.params.materialized())
            if ref_shards is not None:
                gathered.enter_context(ref_shards.materialized())
            losses = [eval_step(self._device_batch(batch))["loss"] for batch in loader]
        val_loss = float(torch.stack(losses).mean())
        self._log_metrics({"loss": val_loss}, self.global_step, prefix=f"stage{stage}/val")
        return val_loss

    # ------------------------------------------------------------- pipeline

    def train(self) -> Dict[str, Any]:
        """Run the full pipeline: stage 0 (if configured), stage 1, stage 2."""
        results: Dict[str, Any] = {}
        t0 = time.perf_counter()
        resume_stage = (self._resume or {}).get("stage")
        try:
            if resume_stage in (None, 0) and int(self._stage_cfg(0).get("num_epochs", 0)) > 0:
                results["stage0"] = self.train_stage0()
            if int(self._stage_cfg(1).get("num_epochs", 0)) > 0:
                if resume_stage == 2:
                    logger.info("Skipping stage 1: resuming a stage-2 checkpoint")
                else:
                    results["stage1"] = self.train_stage1()
            results["stage2"] = self.train_stage2()
        finally:
            self._finish_tracking()
            self.checkpoints.wait()
            for ld in (self.train_loader, self.val_loader, self.preference_train_loader, self.preference_val_loader):
                if hasattr(ld, "close"):
                    ld.close()
        if self.mesh is not None:
            fsdp.uninstall(self.model.module, self.mesh)  # the trained model whole over fsdp again
            self.mesh.barrier()  # rank 0's last checkpoint is on disk before any rank reads it
        loaded = bool(self.config.get("training.load_best_model_at_end", False)) and self._load_best_at_end()
        if not loaded and self._lora_static is not None:
            self._fold_lora()  # also when no best checkpoint was there to load (JAX: the adapters stay apart)
        self._write_results(results, wall_clock_s=time.perf_counter() - t0)
        return results

    def _fold_lora(self) -> None:
        """Merge the final adapters into the masters (in place), so that generate_captions and the CLIs
        see the adapted model; ``model.lora`` is cleared so nothing merges them twice."""
        alpha, rank, _ = self._lora_static
        fold_lora(self.model.module, self.model.lora, alpha, rank)
        self.model.lora = None
        logger.info("Folded LoRA adapters into model params for inference")

    def _load_params(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy a checkpoint's parameters into the model's masters, in place (cut to this rank's blocks
        under tensor parallelism and FSDP)."""
        self.model.module.load_state_dict(local_state(self.model.module, self.mesh, params))

    def _load_best_at_end(self) -> bool:
        """Leave the best-val-loss checkpoint on the model (HF Trainer semantics): stage 2's, else 1's.
        Whether one was loaded."""
        for stage in (2, 1):
            if self.best_val_loss[stage] == float("inf"):
                continue
            path = self.checkpoints._path(f"best_model_stage{stage}")
            if not path.exists():
                continue
            payload = self.checkpoints.restore(path)
            self._load_params(effective_params(payload))
            if payload.get("lora"):
                self.model.lora = None  # merged: nothing may merge the adapters again
            logger.info("load_best_model_at_end: restored best stage-%d params (val_loss %.4f)",
                        stage, self.best_val_loss[stage])
            return True
        logger.info("load_best_model_at_end: no best checkpoint recorded; keeping final params")
        return False

    def _write_results(self, results: Dict[str, Any], wall_clock_s: float):
        """results.json and results_summary.json in the output directory (rank 0's)."""
        if not self.is_writer:
            return
        counts = self.model.num_parameters()
        device = self.device
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"

        def best(stage):
            return None if self.best_val_loss[stage] == float("inf") else self.best_val_loss[stage]

        def last_loss(stage):
            return self.history[stage][-1]["train_loss"] if self.history[stage] else None

        payload = {
            "framework": "pgica_tpu_torch",
            "hardware": f"{name} x{1 if self.mesh is None else self.mesh.num_devices}",
            "total_parameters": counts.get("total"),
            "trainable_parameters": counts.get("trainable"),
            "total_steps": self.global_step,
            "wall_clock_minutes": round(wall_clock_s / 60.0, 2),
            "stage0": {"history": self.history.get("stage0", [])},
            "stage1": {"best_val_loss": best(1), "history": self.history["stage1"]},
            "stage2": {"best_val_loss": best(2), "history": self.history["stage2"]},
            "nan_skipped_note": "per-stage skip counts are logged per epoch",
            "input_wait_fraction": max((rec["input_wait_fraction"] for recs in self.history.values() for rec in recs
                                        if rec.get("input_wait_fraction") is not None), default=None),
        }
        (self.output_dir / "results.json").write_text(json.dumps(payload, indent=2))
        summary = {
            "hardware": payload["hardware"],
            "wall_clock_minutes": payload["wall_clock_minutes"],
            "stage1_final_train_loss": last_loss("stage1"),
            "stage1_best_val_loss": best(1),
            "stage2_final_train_loss": last_loss("stage2"),
            "stage2_best_val_loss": best(2),
            "total_steps": self.global_step,
        }
        (self.output_dir / "results_summary.json").write_text(json.dumps(summary, indent=2))
        logger.info("Wrote results artifacts to %s", self.output_dir)

    def load_checkpoint(self, path) -> Dict[str, Any]:
        """Restore parameters, the optimizer state (taken by the next stage start) and the resume point."""
        payload = self.checkpoints.restore(path)
        if payload.get("lora") and self.model.lora_config:
            # resume LoRA training: the base and the factors are restored apart
            self._load_params(payload["params"])
            self.model.lora = {p: tuple(t.to(self.device, copy=True) for t in ab)
                               for p, ab in lora_from_tree(payload["lora"]).items()}
        else:
            self._load_params(effective_params(payload))
        self._restored_opt_state = payload.get("opt_state")
        meta = payload.get("meta", {})
        self.global_step = int(meta.get("global_step", 0) or 0)
        self.current_epoch = int(meta.get("epoch", 0) or 0)
        meta_stage = meta.get("stage")  # a missing stage means 1; a stage 0 stays 0
        self._resume = {
            "stage": 1 if meta_stage is None else int(meta_stage),
            "epoch": self.current_epoch,
            "step_in_epoch": int(meta.get("step_in_epoch", 0) or 0),
        }
        logger.info("Restored checkpoint from %s (stage %s, epoch %d, step %d, step_in_epoch %d)", path,
                    self._resume["stage"], self.current_epoch, self.global_step, self._resume["step_in_epoch"])
        return meta

    def _maybe_resume_opt_state(self, state: TrainState) -> TrainState:
        restored, self._restored_opt_state = self._restored_opt_state, None  # consume once
        if restored is None:
            return state
        try:
            load_opt_state(state.opt_state, restored, lambda named: local_state(self.model.module, self.mesh, named))
        except (ValueError, KeyError) as e:
            logger.warning("Could not resume optimizer state (%s); starting fresh", e)
            return state
        state.step = self.global_step
        logger.info("Resumed optimizer state from checkpoint")
        return state
