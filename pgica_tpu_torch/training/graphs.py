"""Train and eval steps captured as CUDA graphs, as the JAX package jits them.

The JAX trainer compiles every train step (``jax.jit(..., donate_argnums=(0,))``,
pgica_tpu/training/trainer.py:535-537,619-623,868-890) and every eval step
(:625, :829, :892); the eager port pays a host launch for every kernel and
every optimizer op of a step, which left the card idle for most of a
bucketed step. :class:`GraphedTrainStep` runs a
:class:`~pgica_tpu_torch.training.train_step.TrainStep` built without a mesh
(stages 0, 1 and 2, full fine-tuning and LoRA) as CUDA graphs:

* **Keys.** One graph per batch shape and dtype (the length buckets give a
  few widths, an epoch's last partial batch another number of rows) and,
  with gradient accumulation, per variant: the micro-steps that only
  accumulate and the one that updates (:meth:`Optimizer.due`, the host's
  one decision; the card's torch has no conditional graph nodes).
* **Capture.** A key's first step runs eagerly on the capture stream: a real
  step, which updates, and which loads the kernel libraries and makes
  cuBLAS's workspace. Its capture follows, and every later step of the key
  replays. A failed capture raises: there is no eager fall-back on the card.
* **Inputs.** The batch arrays and the augmentation's draws (made on the
  host from their CPU generator, as the eager step makes them) are copied
  into the key's static device buffers from pinned memory before each
  replay; the copy of one step waits for the previous step's to leave the
  pinned buffers, so the host runs at most one step ahead of the copies.
* **Generators.** The dropout and LoRA DropConnect generators are the
  graph's registered generators, re-seeded before each replay with the
  seeds the eager step's fresh generators take (``core/prng.py``), so a
  replay draws what the eager step draws. Activation checkpointing's
  recompute draws from one more registered generator a block
  (:class:`~pgica_tpu_torch.models.layers.ReplayStreams`).
* **Pool.** The keys of one step share one memory pool: their graphs replay
  one after another on one stream. :meth:`close` drops the graphs and the
  pool (the trainer does at each stage's end).
* **Outputs.** A replay's metrics are packed into one float32 tensor inside
  the graph and cloned after the replay, so a later replay does not
  overwrite them.
* **Versions.** A replay writes the trained leaves without the dispatcher
  seeing it, so their version counters are bumped after each replay: the
  bf16 serving copy, keyed on the masters' versions (models/model.py), is
  then rebuilt from the trained weights.

On the CPU there is nothing to capture: the step runs its body over the same
static buffers on every call, which the CPU tests hold to the eager step bit
for bit. Every arithmetic operation is the eager step's, so on the card a
replay equals the eager step bit for bit too (chip_smoke.py phases 6-9).

:class:`GraphedEvalStep` does the same for an
:class:`~pgica_tpu_torch.training.train_step.EvalStep` built without a mesh
(stage 1 and stage 2, LoRA included), forward only: one graph per batch
shape and dtype, the key's first call eager on the capture stream, the batch
copied into static buffers from pinned memory, the metrics packed into one
float32 tensor and cloned after the replay. It draws nothing, so it has no
generators. Under LoRA the merge of the adapters into the targeted weights
is inside the graph, which reads the factors the graphed train step updates
in place: each replay evaluates the current adapters. Given another graphed
step (``pool_of``, the stage's train step), its graphs take that step's
memory pool, since they replay one after another on one stream.
:class:`GraphedCalls` captures any such function of static inputs per key:
the model wrapper's entry points run through it (models/model.py).
"""

from __future__ import annotations

import gc
import itertools
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from pgica_tpu_torch.data.augment import AugmentParams
from pgica_tpu_torch.generation.slots import CapturedSteps
from pgica_tpu_torch.models.layers import ReplayStreams
from pgica_tpu_torch.training.train_step import EvalStep, TrainState, TrainStep

AUG = "augment."  # prefix of the augmentation draws among a key's static inputs


def _as_tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(value))


def _packed(metrics: Dict[str, torch.Tensor]) -> Tuple[List[str], torch.Tensor]:
    """The metrics' names and their values stacked into one float32 tensor (one clone copies them all)."""
    names = sorted(metrics)
    return names, torch.stack([metrics[k].to(torch.float32) for k in names])


def _unpacked(names: List[str], packed: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(zip(names, packed.unbind()))


class _Graph:
    """One key's static inputs, its capture (None until captured, always None on the CPU) and its replays."""

    def __init__(self, inputs: Dict[str, torch.Tensor], device: torch.device):
        self.static = {k: torch.empty(v.shape, dtype=v.dtype, device=device) for k, v in inputs.items()}
        pin = device.type == "cuda"
        self.staging = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pin) if pin else None
                        for k, v in inputs.items()}
        self.streams = ReplayStreams()
        self.captured: Optional[CapturedSteps] = None
        self.replays = 0

    def batch(self, keys: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
        return {k: self.static[k] for k in keys}

    def draws(self) -> Optional[AugmentParams]:
        fields = {k[len(AUG):]: v for k, v in self.static.items() if k.startswith(AUG)}
        return AugmentParams(**fields) if fields else None


class _Captures:
    """What the graphed steps share: their keys' graphs, the keys' memory pool (``pool_of``'s, if that
    step has one when the first key is captured), the capture stream and the staging of the inputs.

    ``graphs`` maps each key to its :class:`_Graph` (``captured``, its
    :class:`~pgica_tpu_torch.generation.slots.CapturedSteps`: ``kernels``, the
    port's kernels the graph holds, ``capture_s`` and ``pool_bytes``, what
    its capture added to the pool; ``replays``); ``eager_steps`` counts the
    keys' first, eager calls.
    """

    def __init__(self, pool_of: Optional["_Captures"] = None):
        self.graphs: Dict[Tuple, _Graph] = {}
        self.eager_steps = 0
        self.pool_of = pool_of
        self.shares_pool = False
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._copied: Optional[torch.cuda.Event] = None
        self._bound: Optional[Tuple[Any, ...]] = None  # what the graphs hold by address

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values())

    @property
    def pool_bytes(self) -> int:
        return sum(g.captured.pool_bytes for g in self.graphs.values() if g.captured is not None)

    def close(self) -> None:
        """Drop the graphs and their pool (a shared pool lives on with its other owner)."""
        cuda = self._stream is not None
        self.graphs.clear()
        self._pool = self._stream = self._copied = self._bound = None
        if cuda:
            gc.collect()
            torch.cuda.empty_cache()

    def _check_bound(self, bound: Tuple[Any, ...], what: str) -> None:
        if self._bound is None:
            self._bound = bound
        elif len(bound) != len(self._bound) or any(a is not b for a, b in zip(bound, self._bound)):
            raise ValueError(f"a graphed step takes the {what} it was captured on")

    def _entry(self, key: Tuple, inputs: Dict[str, torch.Tensor], device: torch.device) -> "_Graph":
        entry = self.graphs.get(key)
        if entry is None:
            entry = self.graphs[key] = _Graph(inputs, device)
        return entry

    def _stage(self, entry: _Graph, inputs: Dict[str, torch.Tensor]) -> None:
        """Copy the step's inputs into the key's static buffers (from pinned memory, on the card)."""
        if self._copied is not None:
            self._copied.synchronize()  # the previous step's copies have left the pinned buffers
        for name, value in inputs.items():
            dst, pinned = entry.static[name], entry.staging[name]
            if pinned is None or value.device.type == "cuda":
                dst.copy_(value)
            else:
                pinned.copy_(value)
                dst.copy_(pinned, non_blocking=True)
        if any(p is not None for p in entry.staging.values()):
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _capture(self, entry: _Graph, fn: Callable[[], Any], device: torch.device,
                 generators: Iterable[Optional[torch.Generator]] = (), warmup: Optional[Callable[[], Any]] = None):
        """The key's first call, eager on the capture stream (its output: the call's), then its capture,
        which runs nothing; a failed capture raises."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        if self._pool is None and self.pool_of is not None and self.pool_of._pool is not None:
            self._pool, self.shares_pool = self.pool_of._pool, True
        entry.captured = CapturedSteps(fn, device, self._stream, generators, self._pool, warmup=warmup)
        self.eager_steps += 1
        if self._pool is None:
            self._pool = entry.captured.graph.pool()
        first, entry.captured.first = entry.captured.first, None  # the graph keeps its own outputs, not these
        return first

    def _run(self, entry: _Graph, fn: Callable[[], Any], device: torch.device):
        """``fn``'s output: on the CPU its own over the static buffers, at a key's first call its eager
        run's, else the replay's (the graph's static output, which the next replay overwrites)."""
        if device.type != "cuda":
            return fn()
        if entry.captured is None:
            return self._capture(entry, fn, device)
        entry.captured.replay()
        entry.replays += 1
        return entry.captured.out


class GraphedTrainStep(_Captures):
    """``step(state, batch, seed)`` (or ``step(state, ref, batch, seed)``) of ``train_step``, captured as one
    CUDA graph per key; the same call and results as the eager step (see the module docstring).

    ``graphs`` and ``eager_steps`` as :class:`_Captures` has them. A stage-2
    step is captured on one reference: another one raises.
    """

    def __init__(self, train_step: TrainStep):
        if train_step.mesh is not None:
            raise ValueError("a graphed train step runs on one device: its step must be built without a mesh")
        super().__init__()
        self.train_step = train_step
        self._generators: Optional[Tuple[torch.Generator, Optional[torch.Generator]]] = None

    def __call__(self, state: TrainState, *args) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        step = self.train_step
        ref, batch, seed = step.split_args(args)
        self._check_bound((state.opt_state, ref), "state (and reference)")
        device = state.opt_state.params[0].device
        due = step.optimizer.due(state.opt_state)
        inputs = {k: _as_tensor(batch[k]) for k in step.keys}
        draws = step.augment_draws(inputs["image"].shape[0], seed, state.step)
        if draws is not None:
            inputs.update({AUG + k: v for k, v in vars(draws).items()})
        key = (due,) + tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())
        entry = self._entry(key, inputs, device)
        self._stage(entry, inputs)
        dropout_seed, lora_seed = step.seeds(seed, state.step)
        generator, lora_gen = self._seeded(device, dropout_seed, lora_seed)

        def body():
            return step.body(state, ref, entry.batch(step.keys), entry.draws(), generator, lora_gen, due)

        def run(streams):
            with streams():
                return _packed(body())

        if device.type != "cuda":
            metrics = _unpacked(*_packed(body()))
        elif entry.captured is None:
            metrics = _unpacked(*self._capture(entry, lambda: run(entry.streams.capturing), device,
                                               itertools.chain((generator, lora_gen), entry.streams.generators),
                                               warmup=lambda: run(entry.streams.recording)))
        else:
            entry.streams.seed(dropout_seed)
            entry.captured.replay()
            entry.replays += 1
            names, out = entry.captured.out
            metrics = _unpacked(names, out.clone())
            torch.autograd.graph.increment_version(state.opt_state.params)
        state.step += 1
        return state, metrics

    def close(self) -> None:
        """Drop the graphs and their pool."""
        self._generators = None
        super().close()

    def _seeded(self, device: torch.device, dropout_seed: int, lora_seed: Optional[int]):
        """The step's generators, re-seeded: the graphs' registered generators on the card."""
        if self._generators is None:
            lora = None if lora_seed is None else torch.Generator(device)
            self._generators = (torch.Generator(device), lora)
        generator, lora_gen = self._generators
        generator.manual_seed(dropout_seed)
        if lora_gen is not None:
            lora_gen.manual_seed(lora_seed)
        return generator, lora_gen


class GraphedEvalStep(_Captures):
    """``step(batch)`` (or ``step(ref, batch)``) of ``eval_step``, captured as one CUDA graph per batch shape
    and dtype; the same call and metrics as the eager eval step (see the module docstring).

    ``pool_of``: the stage's graphed train step, whose pool the eval graphs
    share once it has one. The step is captured on one reference and one set
    of adapters: others raise.
    """

    def __init__(self, eval_step: EvalStep, pool_of: Optional[_Captures] = None):
        if eval_step.mesh is not None:
            raise ValueError("a graphed eval step runs on one device: its step must be built without a mesh")
        super().__init__(pool_of)
        self.eval_step = eval_step

    def __call__(self, *args) -> Dict[str, torch.Tensor]:
        step = self.eval_step
        ref, batch = step.split_args(args)
        self._check_bound((ref, step.adapters), "reference and adapters")
        device = step.device
        inputs = {k: _as_tensor(batch[k]) for k in step.keys}
        entry = self._entry(tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()), inputs, device)
        self._stage(entry, inputs)
        names, out = self._run(entry, lambda: _packed(step.body(ref, entry.batch(step.keys))), device)
        return _unpacked(names, out.clone() if device.type == "cuda" else out)


class GraphedCalls(_Captures):
    """``fn(static inputs)``, a function of tensors that moves no data to the host, captured as one CUDA
    graph per key on ``device`` (run over the static buffers on the CPU).

    :meth:`__call__` takes the key (which must name everything ``fn``
    depends on besides its inputs' shapes and dtypes), the inputs and ``fn``,
    and returns ``finish(out)``, where ``out`` is ``fn``'s output: after a
    replay the graph's own tensors, so ``finish`` copies what it keeps
    (clones, or host arrays). Call it under the grad mode of its first call.
    """

    def __init__(self, device: torch.device):
        super().__init__()
        self.device = device

    def __call__(self, key: Hashable, inputs: Dict[str, torch.Tensor],
                 fn: Callable[[Dict[str, torch.Tensor]], Any], finish: Callable[[Any], Any]):
        shapes = tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())
        entry = self._entry((key,) + shapes, inputs, self.device)
        self._stage(entry, inputs)
        return finish(self._run(entry, lambda: fn(entry.static), self.device))
