"""ZeRO-1: reduce-scattered gradients and a flat, sharded optimizer state (port of pgica_tpu/parallel/zero1.py).

The module's parameters live as ONE flat f32 buffer, sharded over the data
axis: each rank keeps ``padded_size / n`` contiguous elements of the masters
and of each Adam moment, and never a full-size moment. A step

1. all-gathers the flat shard into a full buffer, which the module's
   parameters view for the step (and drop after it);
2. runs the local loss and its gradients on this rank's rows (the loss may
   use the axis' collectives, e.g. NT-Xent's gathered negatives, whose
   backward sums the cotangents back to their rank);
3. reduce-scatters the flat gradient and divides by n: the gradient of the
   global-batch mean loss;
4. zeroes the frozen elements (the mask) before the norm, clips by
   ``sqrt(psum(square sums))``, and takes optax's AdamW step on the shard
   (``training/optim.py:adamw_updates``), NaN-safe: a non-finite pmean'ed
   loss or norm updates nothing and adds one to ``skipped``, on every rank
   alike; the mask zeroes the updates of frozen elements.

The flat buffer holds the parameters in the JAX tree's leaf order
(:func:`jax_path`), each leaf's elements in the port's layout, padded to a
multiple of n. Freezing is the mask of the JAX trainer's ZeRO path: the
frozen vision and text backbones only (a stage's untouched tower gets zero
gradients and AdamW's decay, as there). Gradient accumulation and LoRA do
not compose, as in the JAX package.

:class:`ShardedParams` is the machinery that ZeRO-3 (parallel/zero3.py)
shares: with ``blocks=True`` every transformer block of the module's LMs is
a flat buffer of its own, gathered at the block's entry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Callable, Dict, Iterator, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from pgica_tpu_torch.parallel import collectives
from pgica_tpu_torch.parallel.mesh import AxisName, MeshContext
from pgica_tpu_torch.training.optim import EPS, adamw_updates

LossFn = Callable[[Mapping[str, object], int, int], Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
Trainable = Callable[[str], bool]


def jax_path(module: nn.Module, name: str) -> Tuple[str, ...]:
    """The JAX package's tree path of the port's parameter ``name`` (the inverse of the weight bridge's
    naming, models/convert.py): ``blocks.i`` -> ``block_i``, a block's ``ln_0``/``ln_1`` ->
    ``LayerNorm_0``/``RMSNorm_0``..., ``vision_projection`` -> ``vision_projection/layers_0``, a
    ``weight`` -> ``embedding`` / ``scale`` / ``kernel``."""
    parts = name.split(".")
    out: List[str] = []
    node = module
    i = 0
    while i < len(parts) - 1:
        part = parts[i]
        if part == "blocks":
            out.append(f"block_{parts[i + 1]}")
            node = node.blocks[int(parts[i + 1])]
            i += 2
            continue
        child = getattr(node, part)
        if re.fullmatch(r"ln_[01]", part) and hasattr(node, "mlp"):
            out.append(f"{type(child).__name__}_{part[-1]}")
        else:
            out.append(part)
        if part == "vision_projection":
            out.append("layers_0")
        node = child
        i += 1
    leaf = parts[-1]
    if leaf == "weight":
        if isinstance(node, nn.Embedding):
            leaf = "embedding"
        elif type(node).__name__ in ("LayerNorm", "RMSNorm"):
            leaf = "scale"
        else:
            leaf = "kernel"
    return tuple(out + [leaf])


class FlatSpec(NamedTuple):
    """Static recipe for parameters <-> one flat buffer."""

    names: Tuple[str, ...]
    shapes: Tuple[torch.Size, ...]
    sizes: Tuple[int, ...]
    dtypes: Tuple[torch.dtype, ...]
    padded_size: int  # total elements, padded to a multiple of the axis size


def make_flat_spec(params: Mapping[str, torch.Tensor], n_shards: int) -> FlatSpec:
    """The spec of ``params`` (name -> tensor, in the buffer's order), padded to a multiple of ``n_shards``."""
    shapes = tuple(p.shape for p in params.values())
    sizes = tuple(math.prod(s) for s in shapes)
    padded = -(-sum(sizes) // n_shards) * n_shards
    return FlatSpec(tuple(params), shapes, sizes, tuple(p.dtype for p in params.values()), padded)


def flatten_tree(tensors: Sequence[torch.Tensor], spec: FlatSpec) -> torch.Tensor:
    """The tensors (``spec``'s order) as one padded flat float32 buffer."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    return torch.nn.functional.pad(flat, (0, spec.padded_size - flat.numel()))


def unflatten_tree(flat: torch.Tensor, spec: FlatSpec) -> Dict[str, torch.Tensor]:
    """A full flat buffer as the spec's named tensors, each in its dtype (views where that is float32)."""
    parts = flat[:sum(spec.sizes)].split(spec.sizes)
    return {name: part.view(shape).to(dtype)
            for name, part, shape, dtype in zip(spec.names, parts, spec.shapes, spec.dtypes)}


def _lms(module: nn.Module) -> List[Tuple[str, nn.Module]]:
    """The module's transformer LMs (the JAX package's ``scan_layers`` towers), each once."""
    seen, out = set(), []
    for name, child in module.named_modules():
        if type(child).__name__ == "TransformerLM" and id(child) not in seen:
            seen.add(id(child))
            out.append((name, child))
    return out


class ShardedParams:
    """The parameters of ``module`` as flat buffers sharded over ``axis``; the module keeps empty ones.

    Buffer 0 holds every parameter outside the LM blocks, in the JAX leaf
    order; with ``blocks`` each LM block is a buffer of its own (ZeRO-3),
    which the LM gathers at the block's entry (``TransformerLM.sharded``).
    The buffers are float32, as the JAX package's; a parameter of another
    dtype (a frozen bf16 reference's) is cast back as it is gathered.
    ``trainable`` (name -> bool) makes the masks; None trains every element.
    """

    def __init__(self, module: nn.Module, mesh: MeshContext, axis: AxisName, blocks: bool = False,
                 trainable: Optional[Trainable] = None):
        self.module, self.mesh, self.axis = module, mesh, axis
        self.n, self.index = mesh.axis_size(axis), mesh.axis_index(axis)
        named = dict(module.named_parameters())
        self.device = next(iter(named.values())).device
        groups: List[Dict[str, nn.Parameter]] = []
        self.lms: List[Tuple[nn.Module, List[int]]] = []  # (LM, the buffers of its blocks)
        self.block_keys: Dict[int, List[str]] = {}  # buffer -> its parameters' names within the block
        in_block = set()
        if blocks:
            for prefix, lm in _lms(module):
                ids = []
                for j, block in enumerate(lm.blocks):
                    keys = [k for k, _ in block.named_parameters()]
                    names = {f"{prefix}.blocks.{j}.{k}": p for k, p in block.named_parameters()}
                    in_block.update(names)
                    ids.append(len(groups) + 1)
                    self.block_keys[len(groups) + 1] = keys
                    groups.append(names)
                self.lms.append((lm, ids))
        rest = sorted((k for k in named if k not in in_block), key=lambda k: jax_path(module, k))
        groups.insert(0, {k: named[k] for k in rest})
        self.params: List[Dict[str, nn.Parameter]] = groups
        self.specs = [make_flat_spec(g, self.n) for g in groups]
        self.shards: List[torch.Tensor] = []
        self.masks: Optional[List[torch.Tensor]] = None if trainable is None else []
        for spec, group in zip(self.specs, groups):
            self.shards.append(self._mine(flatten_tree(list(group.values()), spec)))
            if trainable is not None:
                mask = [torch.full(p.shape, float(trainable(k)), device=self.device) for k, p in group.items()]
                self.masks.append(self._mine(flatten_tree(mask, spec)))
        for k, p in named.items():
            p.requires_grad_(trainable is None or trainable(k))
        for i, shard in enumerate(self.shards):  # a block's shard takes its gradient through the gather
            shard.requires_grad_(i > 0 and any(p.requires_grad for p in groups[i].values()))
        self._release_storage()
        for lm, ids in self.lms:
            lm.sharded = _BlockGather(self, ids)

    def _mine(self, flat: torch.Tensor) -> torch.Tensor:
        size = flat.numel() // self.n
        return flat[self.index * size:(self.index + 1) * size].clone()

    def _release_storage(self, groups: Optional[Sequence[int]] = None) -> None:
        for i in range(len(self.params)) if groups is None else groups:
            for p in self.params[i].values():
                p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    def gather(self, i: int) -> torch.Tensor:
        """The full flat buffer ``i`` (differentiable: its backward reduce-scatters the sum)."""
        return collectives.all_gather(self.shards[i], self.axis, self.mesh)

    @contextlib.contextmanager
    def materialized(self) -> Iterator[None]:
        """The rest's parameters gathered into the module for the duration (the blocks gather themselves)."""
        with torch.no_grad():
            full = unflatten_tree(self.gather(0), self.specs[0])
        for name, p in self.params[0].items():
            p.data = full[name]
        try:
            yield
        finally:
            self._release_storage([0])

    @property
    def rest_params(self) -> List[nn.Parameter]:
        return list(self.params[0].values())

    @torch.no_grad()
    def gather_params(self) -> Dict[str, torch.Tensor]:
        """Every parameter, gathered (a fresh tensor each), by name (every rank must call it)."""
        out: Dict[str, torch.Tensor] = {}
        for i, spec in enumerate(self.specs):
            out.update({k: v.clone() for k, v in unflatten_tree(self.gather(i), spec).items()})
        return out

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """``module.state_dict()`` with the gathered parameters (every rank must call it)."""
        full = self.gather_params()
        return {k: full.get(k, v) for k, v in self.module.state_dict(keep_vars=False).items()}

    @torch.no_grad()
    def release(self) -> None:
        """Put the gathered parameters back into the module and drop the block gathers: a plain module again."""
        full = self.gather_params()
        for group in self.params:
            for name, p in group.items():
                p.data = full[name]
        for lm, _ in self.lms:
            lm.sharded = None
        self.shards = []

    def nbytes(self) -> int:
        """Bytes of this rank's parameter shards."""
        return sum(s.numel() * s.element_size() for s in self.shards)


class _BlockGather:
    """An LM's hook: block ``j`` runs on its weights gathered at its entry, dropped after it.

    Under activation checkpointing the LM calls it inside the checkpointed
    function, so the backward pass gathers the weights again (JAX's remat
    over the gather) and keeps only the block's input.
    """

    def __init__(self, owner: ShardedParams, buffers: List[int]):
        self.owner, self.buffers = owner, buffers

    def block(self, lm: nn.Module, j: int) -> Callable:
        i = self.buffers[j]

        def run(*args, **kwargs):
            weights = unflatten_tree(self.owner.gather(i), self.owner.specs[i]).values()
            params = dict(zip(self.owner.block_keys[i], weights))
            return torch.func.functional_call(lm.blocks[j], params, args, kwargs)

        return run


@dataclasses.dataclass
class ZeroState:
    """A ZeRO train state: the sharded parameters, the shards' Adam moments and the counters."""

    step: int
    params: ShardedParams
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    count: int = 0  # updates applied (the schedule's step and Adam's bias-correction count)
    skipped: int = 0

    def nbytes(self) -> Dict[str, int]:
        """This rank's bytes of parameter shards and of optimizer state."""
        return {"params": self.params.nbytes(),
                "optimizer": sum(t.numel() * t.element_size() for t in self.mu + self.nu)}

    @torch.no_grad()
    def state_dict(self) -> Dict[str, object]:
        """The optimizer state with its moments gathered (every rank must call it; rank 0 writes it)."""
        p = self.params
        return {"zero": {"n": p.n, "padded_sizes": [s.padded_size for s in p.specs], "count": self.count,
                         "skipped": self.skipped,
                         "mu": [collectives.all_gather(m, p.axis, p.mesh).cpu() for m in self.mu],
                         "nu": [collectives.all_gather(v, p.axis, p.mesh).cpu() for v in self.nu]}}

    @torch.no_grad()
    def load_state_dict(self, saved: Mapping[str, object]) -> None:
        """Take this rank's slices of a saved state, saved on any number of ranks; raises where the buffers'
        padded sizes differ from this run's (JAX's resume compares the global shapes: a buffer is padded to a
        multiple of the rank count, so another count may pad it otherwise)."""
        z = saved["zero"]
        p = self.params
        mine = [s.padded_size for s in p.specs]
        if list(z["padded_sizes"]) != mine:
            raise ValueError(f"the checkpoint's ZeRO buffers of {list(z['padded_sizes'])} elements ({z['n']} ranks) "
                             f"are not this run's {mine} ({p.n} ranks)")
        for mine, full in zip(self.mu + self.nu, list(z["mu"]) + list(z["nu"])):
            mine.copy_(p._mine(full.to(mine.device)))
        self.count, self.skipped = int(z["count"]), int(z["skipped"])


Zero1State = ZeroState  # one buffer: shards[0] holds every parameter


def _sharded_update(state: ZeroState, grads: List[torch.Tensor], loss: torch.Tensor, schedule: Callable[[int], float],
                    weight_decay: float, max_grad_norm: float, eps: float) -> torch.Tensor:
    """Mask, global-norm clip and NaN-safe AdamW on the shards (grads: the shards' gradients, already / n)."""
    p = state.params
    if p.masks is not None:
        grads = [g * m for g, m in zip(grads, p.masks)]
    sq = torch.stack([torch.sum(g * g) for g in grads]).sum()
    gnorm = torch.sqrt(collectives.psum(sq, p.axis, p.mesh))
    scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    if math.isfinite(float(loss)) and math.isfinite(float(gnorm)):  # the step's host sync
        with torch.no_grad():
            grads = [g * scale for g in grads]
            updates = adamw_updates(grads, p.shards, state.mu, state.nu, state.count, schedule(state.count),
                                    weight_decay, eps)
            if p.masks is not None:
                updates = [u * m for u, m in zip(updates, p.masks)]
            for shard, u in zip(p.shards, updates):
                shard.add_(u.to(shard.dtype))
        state.count += 1
    else:
        state.skipped += 1
    state.step += 1
    return gnorm


def _schedule(learning_rate) -> Callable[[int], float]:
    return learning_rate if callable(learning_rate) else (lambda _: float(learning_rate))


def _reduced_metrics(loss: torch.Tensor, metrics: Dict[str, torch.Tensor], mesh: MeshContext,
                     axis: AxisName) -> Dict[str, torch.Tensor]:
    metrics = {k: collectives.pmean(v.detach().to(torch.float32), axis, mesh) for k, v in metrics.items()}
    metrics["loss"] = collectives.pmean(loss.detach().to(torch.float32), axis, mesh)
    return metrics


def make_zero1_train_step(
    loss_fn: LossFn,
    mesh: MeshContext,
    axis_name: AxisName = "data",
    learning_rate=1e-4,  # float or schedule(count) -> float
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    trainable_mask: Optional[Trainable] = None,
    eps: float = EPS,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)``.

    ``init_fn(module) -> ZeroState`` shards the module's parameters and
    allocates the Adam moments of this rank's shard only; the module keeps
    empty parameters until ``state.params.release()``.

    ``step_fn(state, batch, seed) -> (state, metrics)``: one step on this
    rank's rows ``batch``. ``loss_fn(batch, seed, step) -> (loss, metrics)``
    runs the module (its own generators for dropout and augmentation, the
    rank folded in) and may use ``axis_name``'s collectives: the mesh is
    bound while it runs. Metrics are pmean'ed, with ``loss``, ``grad_norm``
    and ``skipped``. ``step_fn.gather_params(state)`` gives every parameter
    by name. ``trainable_mask`` (name -> bool): False freezes a parameter (no
    update, no decay).
    """
    schedule = _schedule(learning_rate)

    def init_fn(module: nn.Module) -> ZeroState:
        params = ShardedParams(module, mesh, axis_name, blocks=False, trainable=trainable_mask)
        return ZeroState(0, params, [torch.zeros_like(s) for s in params.shards],
                         [torch.zeros_like(s) for s in params.shards])

    def step_fn(state: ZeroState, batch, seed: int = 0):
        p = state.params
        n = p.n
        with mesh, torch.enable_grad(), p.materialized():
            loss, metrics = loss_fn(batch, seed, state.step)
            wrt = [q for q in p.rest_params if q.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
            grads = [next(got) if q.requires_grad else None for q in p.rest_params]
            grads = [torch.zeros_like(q) if g is None else g for g, q in zip(grads, p.rest_params)]
            gflat = collectives.psum_scatter(flatten_tree(grads, p.specs[0]), axis_name, mesh) / n
        metrics = _reduced_metrics(loss, metrics, mesh, axis_name)
        with mesh:
            metrics["grad_norm"] = _sharded_update(state, [gflat], metrics["loss"], schedule, weight_decay,
                                                   max_grad_norm, eps)
        metrics["skipped"] = state.skipped
        return state, metrics

    step_fn.gather_params = lambda state: state.params.gather_params()  # type: ignore[attr-defined]
    return init_fn, step_fn
