"""AdamW with warmup-cosine, global-norm clipping, freezing and gradient accumulation.

Port of pgica_tpu/training/optim.py. The JAX package builds
``MultiSteps(multi_transform({"train": chain(clip_by_global_norm, adamw),
"frozen": set_to_zero}))`` with optax; this module reproduces that chain with
plain functions on tensors, in the same arithmetic order:

* ``clip_by_global_norm``: optax's rule, ``g / norm * max_norm`` once the
  norm reaches ``max_norm`` (not ``clip_grad_norm_``'s ``+ 1e-6``), the norm
  taken over the trained leaves;
* AdamW: bias-corrected moments, eps outside the square root, decoupled
  weight decay ``+ wd * param`` on every trained leaf, then ``-lr``;
* ``warmup_cosine_schedule``: linear from 0 (so the first update has lr 0)
  to the peak, cosine down to ``lr * 1e-5``, evaluated in float32 as optax
  does, at the count of updates applied so far;
* LoRA (``init_adapters``): the factors are the only trained leaves;
* freezing: frozen leaves get no update and no decay (they are left out of
  the optimizer, and their ``requires_grad`` is turned off so no gradient is
  computed for them; ``init`` turns it on for every trained leaf, so one
  module can pass from a stage's optimizer to the next's);
* ``MultiSteps``: the running mean ``acc + (g - acc) / (n + 1)`` over k
  micro-steps, and one inner update on the k-th.

``torch.optim.AdamW`` would not do: the train step's NaN skip must leave the
moments and the accumulator exactly as they were. Updates happen in place on
the parameters and the state (the JAX chain is functional), with
multi-tensor ``torch._foreach_*`` calls so that a step costs a few launches.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, as the JAX package uses them


def warmup_cosine_schedule(learning_rate: float, warmup_steps: int, total_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1), lr * 1e-5), in float32."""
    warmup = max(1, min(warmup_steps, max(total_steps - 1, 1)))
    decay_steps = max(total_steps, warmup + 1) - warmup
    f32 = np.float32
    peak, end = f32(learning_rate), learning_rate * 1e-5
    alpha = 0.0 if learning_rate == 0.0 else end / learning_rate

    def schedule(count: int) -> float:
        if count < warmup:  # optax.linear_schedule(0, peak, warmup)
            frac = f32(1) - f32(count) / f32(warmup)
            return float(f32(-learning_rate) * frac + peak)
        t = f32(min(count - warmup, decay_steps))  # optax.cosine_decay_schedule
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps)))
        return float(peak * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


def global_norm(tensors: Sequence[torch.Tensor], axes: Optional[Sequence[Tuple[str, ...]]] = None,
                mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element of every tensor (f32, on their device).

    On the CPU each tensor's norm is accumulated in float64: PyTorch's float32 CPU norm can lose
    ~2% on a large, mostly zero gradient (the 525 M-element Llama-3-8B embedding, 128 rows of it
    touched), where the card's reduction and optax's do not.

    On a mesh whose ranks hold blocks of leaves (``axes``: the mesh axes each tensor is cut over, ``()``
    for a whole one; ``fsdp``, ``model`` or both) the blocks' sum of squares is summed over their axes
    and a replicated tensor counts once, so every rank gets the whole tree's norm (JAX optim.py:63-80).
    """
    if not tensors:
        return torch.zeros((), dtype=torch.float32)
    cpu = tensors[0].device.type == "cpu"
    if cpu:
        norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float64) for t in tensors])
    else:
        norms = torch.stack(torch._foreach_norm([t.to(torch.float32) for t in tensors]))
    if axes is None or mesh is None or not any(axes):
        return torch.linalg.vector_norm(norms).to(torch.float32)
    from pgica_tpu_torch.parallel import collectives

    squares = norms.square()
    total = squares.new_zeros(())
    for group in sorted(set(axes)):  # one order on every rank
        part = squares[torch.tensor([a == group for a in axes], device=norms.device)].sum()
        total = total + (collectives.psum(part, group, mesh) if group else part)
    return total.sqrt().to(torch.float32)


def clip_by_global_norm(grads: List[torch.Tensor], norm: float, max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm given the grads' norm: unchanged below ``max_norm``, else g / norm * max_norm."""
    if norm < max_norm:
        return grads
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    return clipped


@dataclasses.dataclass
class OptState:
    """Trained parameters (references into the module) and the AdamW/MultiSteps state."""

    names: List[str]
    params: List[torch.Tensor]  # the module's Parameters, or the LoRA factors
    count: int  # updates applied: the schedule's step and Adam's bias-correction count
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    mini_step: int = 0  # micro-steps accumulated toward the next update
    acc: Optional[List[torch.Tensor]] = None  # running mean of the micro-steps' grads


@dataclasses.dataclass
class Optimizer:
    """The port of ``create_optimizer``'s chain; ``init`` picks the trained leaves."""

    schedule: Schedule
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    every_k: int = 1
    freeze_vision_backbone: bool = False
    frozen_prefixes: Tuple[str, ...] = ()

    def is_frozen(self, name: str) -> bool:
        """JAX ``freeze_labels``: the frozen vision backbone and any listed prefix."""
        prefixes = list(self.frozen_prefixes)
        if self.freeze_vision_backbone:
            prefixes.append("vision_encoder.backbone")
        return any(name == p or name.startswith(p + ".") for p in prefixes)

    def init(self, module: nn.Module) -> OptState:
        names, params = [], []
        for name, p in module.named_parameters():
            frozen = self.is_frozen(name)
            p.requires_grad_(not frozen)
            if not frozen:
                names.append(name)
                params.append(p)
        return self._state(names, params)

    def init_adapters(self, module: nn.Module, lora) -> OptState:
        """The state of LoRA training: the factors ({path: (A, B)}) are the trained leaves, every
        parameter of ``module`` frozen (no gradient, no update, no decay), as the JAX optimizer that
        only ever sees the adapter tree."""
        module.requires_grad_(False)
        names, params = [], []
        for path in sorted(lora):
            for part, t in zip("ab", lora[path]):
                names.append(f"{path}/{part}")
                params.append(t.requires_grad_(True))
        return self._state(names, params)

    @staticmethod
    def _state(names: List[str], params: List[torch.Tensor]) -> OptState:
        return OptState(names, params, 0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState, grad_norm: Optional[float] = None,
               norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm) -> None:
        """One micro-step with ``grads`` (aligned with ``state.params``), in place.

        ``grad_norm`` is ``norm_fn(grads)`` if the caller has it already (``norm_fn``: the tree's norm,
        :func:`global_norm` over the blocks of a sharded module).
        """
        if self.every_k > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            delta = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(delta, float(state.mini_step + 1))
            torch._foreach_add_(state.acc, delta)
            if state.mini_step < self.every_k - 1:
                state.mini_step += 1
                return
            grads, state.acc, state.mini_step = state.acc, None, 0
            grad_norm = None  # the clip's norm is the mean's
        if grad_norm is None:
            grad_norm = float(norm_fn(grads))
        self._adamw(clip_by_global_norm(grads, grad_norm, self.max_grad_norm), state)

    def _adamw(self, grads: List[torch.Tensor], state: OptState) -> None:
        upd = adamw_updates(grads, state.params, state.mu, state.nu, state.count, self.schedule(state.count),
                            self.weight_decay)
        torch._foreach_add_(state.params, upd)
        state.count += 1


def adamw_updates(grads: List[torch.Tensor], params: List[torch.Tensor], mu: List[torch.Tensor],
                  nu: List[torch.Tensor], count: int, lr: float, weight_decay: float,
                  eps: float = EPS) -> List[torch.Tensor]:
    """optax.adamw's updates for ``params`` after ``count`` updates, at learning rate ``lr``.

    The moments ``mu``/``nu`` are updated in place; the returned updates are
    added to the parameters by the caller (ZeRO masks them first).
    """
    torch._foreach_mul_(mu, B1)
    torch._foreach_add_(mu, grads, alpha=1 - B1)
    torch._foreach_mul_(nu, B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - B2)
    n = count + 1
    bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(n))
    bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(n))
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu, bc1)
    torch._foreach_div_(upd, denom)
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_mul_(upd, -lr)
    return upd


def create_optimizer(
    learning_rate: float,
    total_steps: int,
    warmup_steps: int = 500,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    gradient_accumulation_steps: int = 1,
    freeze_vision_backbone: bool = False,
    frozen_prefixes: Tuple[str, ...] = (),
) -> Optimizer:
    """The JAX ``create_optimizer``; frozen prefixes are dotted module names (``"caption_decoder"``)."""
    if gradient_accumulation_steps < 1 or not math.isfinite(learning_rate):
        raise ValueError("gradient_accumulation_steps must be >= 1 and learning_rate finite")
    return Optimizer(
        schedule=warmup_cosine_schedule(learning_rate, warmup_steps, total_steps),
        weight_decay=weight_decay,
        max_grad_norm=max_grad_norm,
        every_k=gradient_accumulation_steps,
        freeze_vision_backbone=freeze_vision_backbone,
        frozen_prefixes=tuple(frozen_prefixes),
    )
