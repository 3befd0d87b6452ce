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

Everything runs on the parameters' device without a host sync, so that a
CUDA graph can hold the whole micro-step (training/graphs.py): the counters
(``count``, ``mini_step``) are int32 tensors there, the learning rate and
Adam's bias corrections are computed there from ``count`` in float32, as
optax computes them, and the clip is optax's select. The NaN skip is JAX's
``where(ok, new, old)``: every new value is computed and then selected
against the old one (never multiplied by a 0/1 mask: NaN times 0 is NaN),
so a skipped micro-step keeps the bits of the parameters, the moments, the
accumulator and both counters. Which micro-step applies the update
(MultiSteps' ``lax.cond`` on ``mini_step == k - 1``) is the one decision
taken on the host: a skip keeps ``mini_step`` where it was, so the host
keeps an upper bound of it and reads the 4 bytes from the device only when
the bound cannot rule the update out (:meth:`Optimizer.due`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Count = Union[int, torch.Tensor]
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, as the JAX package uses them
GROUP_ELEMENTS = 1 << 26  # the update takes the leaves in groups of about this many elements (its temporaries')


Schedule = Callable[[Count], Union[float, torch.Tensor]]


def warmup_cosine_schedule(learning_rate: float, warmup_steps: int, total_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1), lr * 1e-5), in float32.

    Called with a count tensor (any integer dtype and device) the schedule
    returns the rate as a float32 tensor there, with no host sync; with an
    int, as a float (computed the same way on the CPU).
    """
    warmup = max(1, min(warmup_steps, max(total_steps - 1, 1)))
    decay_steps = max(total_steps, warmup + 1) - warmup
    alpha = 0.0 if learning_rate == 0.0 else learning_rate * 1e-5 / learning_rate

    def schedule(count: Count):
        if not isinstance(count, torch.Tensor):
            return float(schedule(torch.tensor(int(count), dtype=torch.int32)))
        c = count.to(torch.float32)
        warm = (1.0 - c / warmup) * -learning_rate + learning_rate  # optax.linear_schedule(0, peak, warmup)
        t = torch.clamp(c - warmup, max=decay_steps)  # optax.cosine_decay_schedule
        cosine = 0.5 * (1.0 + torch.cos(t * math.pi / decay_steps))
        decayed = ((1 - alpha) * cosine + alpha) * learning_rate
        return torch.where(c < warmup, warm, decayed)

    return schedule


def bias_corrections(count: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adam's ``1 - b ** (count + 1)`` for b1 and b2, float32 on ``count``'s device (optax's bias_correction)."""
    n = (count + 1).to(torch.float32)
    return 1.0 - torch.pow(B1, n), 1.0 - torch.pow(B2, n)


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


def clip_by_global_norm(grads: List[torch.Tensor], norm: torch.Tensor, max_norm: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm given the grads' norm: ``where(norm < max_norm, g, g / norm * max_norm)``."""
    keep = norm < max_norm
    clipped = torch._foreach_div(grads, norm)
    torch._foreach_mul_(clipped, max_norm)
    for c, g in zip(clipped, grads):
        torch.where(keep, g, c, out=c)
    return clipped


def select_(old: List[torch.Tensor], ok: torch.Tensor, new: List[torch.Tensor]) -> None:
    """``old = where(ok, new, old)``, in place: where ``ok`` is False every bit of ``old`` stays."""
    for o, n in zip(old, new):
        torch.where(ok, n, o, out=o)


def _groups(tensors: Sequence[torch.Tensor]):
    """Runs of consecutive indices of ``tensors`` of at most GROUP_ELEMENTS elements (a larger tensor alone)."""
    group, size = [], 0
    for i, t in enumerate(tensors):
        if group and size + t.numel() > GROUP_ELEMENTS:
            yield group
            group, size = [], 0
        group.append(i)
        size += t.numel()
    if group:
        yield group


class OptState:
    """Trained parameters (references into the module) and the AdamW/MultiSteps state.

    ``count`` (updates applied: the schedule's step and Adam's bias-correction
    count) and ``mini_step`` (micro-steps accumulated toward the next update)
    live on the parameters' device as int32 tensors ``count_t`` and
    ``mini_step_t``; the properties read them as ints (a host sync).
    ``acc``, the running mean of the micro-steps' grads, is allocated with
    the state when the optimizer accumulates, and is zero at ``mini_step``
    0. ``mini_step_bound`` is the host's upper bound of ``mini_step`` (None:
    unknown; :meth:`Optimizer.due`).
    """

    def __init__(self, names: List[str], params: List[torch.Tensor], count: Count, mu: List[torch.Tensor],
                 nu: List[torch.Tensor], mini_step: Count = 0, acc: Optional[List[torch.Tensor]] = None):
        device = params[0].device if params else torch.device("cpu")
        self.names, self.params, self.mu, self.nu, self.acc = names, params, mu, nu, acc
        self.count_t = torch.as_tensor(count, dtype=torch.int32).to(device).clone()
        self.mini_step_t = torch.as_tensor(mini_step, dtype=torch.int32).to(device).clone()
        self.mini_step_bound: Optional[int] = None

    @property
    def count(self) -> int:
        return int(self.count_t)

    @count.setter
    def count(self, value: int) -> None:
        self.count_t.fill_(int(value))

    @property
    def mini_step(self) -> int:
        return int(self.mini_step_t)

    @mini_step.setter
    def mini_step(self, value: int) -> None:
        self.mini_step_t.fill_(int(value))
        self.mini_step_bound = None


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

    def _state(self, names: List[str], params: List[torch.Tensor]) -> OptState:
        acc = [torch.zeros_like(p) for p in params] if self.every_k > 1 else None
        return OptState(names, params, 0, [torch.zeros_like(p) for p in params], [torch.zeros_like(p) for p in params],
                        acc=acc)

    def due(self, state: OptState) -> bool:
        """Whether the next micro-step applies the update (``mini_step == every_k - 1``), then advance the
        host's bound of ``mini_step`` past it.

        A skipped micro-step keeps ``mini_step``, so the host knows an upper
        bound of it only: the bound grows by one a micro-step, and only where
        it reaches ``every_k - 1`` is the device's value read (4 bytes, a
        sync). After an update it is 0, or ``every_k - 1`` again if that
        micro-step was skipped: the bound says the latter, so the next
        micro-step reads too.
        """
        k = self.every_k
        if k == 1:
            return True
        if state.mini_step_bound is None or state.mini_step_bound >= k - 1:
            state.mini_step_bound = int(state.mini_step_t)
        due = state.mini_step_bound == k - 1
        state.mini_step_bound = k - 1 if due else state.mini_step_bound + 1
        return due

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], state: OptState, ok: torch.Tensor, grad_norm: torch.Tensor, due: bool,
             norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm) -> None:
        """One micro-step with ``grads`` (aligned with ``state.params``), in place and without a host sync.

        ``ok`` (a bool tensor) is False on a non-finite loss or gradient norm:
        then nothing changes. ``grad_norm`` is ``norm_fn(grads)`` (the tree's
        norm, :func:`global_norm` over the blocks of a sharded module); ``due``
        is :meth:`due`'s answer for this micro-step. Accumulating, the k-th
        micro-step clips the mean by the mean's norm and updates; the others
        only accumulate.
        """
        if self.every_k > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            mean = torch._foreach_sub(grads, state.acc)
            torch._foreach_div_(mean, (state.mini_step_t + 1).to(torch.float32))
            torch._foreach_add_(mean, state.acc)
            if not due:
                select_(state.acc, ok, mean)
                state.mini_step_t.add_(ok.to(torch.int32))
                return
            grads, grad_norm = mean, norm_fn(mean)  # the clip's norm is the mean's
        self._adamw(grads, grad_norm, state, ok)
        if self.every_k > 1:
            for a in state.acc:
                a.masked_fill_(ok, 0.0)
            state.mini_step_t.masked_fill_(ok, 0)

    def update(self, grads: List[torch.Tensor], state: OptState, grad_norm: Optional[Count] = None,
               norm_fn: Callable[[List[torch.Tensor]], torch.Tensor] = global_norm) -> None:
        """One micro-step that is never skipped (the plain chain, as ``optax.update``)."""
        norm = norm_fn(grads) if grad_norm is None else torch.as_tensor(grad_norm, dtype=torch.float32)
        norm = norm.to(grads[0].device)
        self.step(grads, state, torch.ones((), dtype=torch.bool, device=norm.device), norm, self.due(state), norm_fn)

    def _adamw(self, grads: List[torch.Tensor], grad_norm: torch.Tensor, state: OptState, ok: torch.Tensor) -> None:
        """Clip and AdamW a group of leaves at a time (their temporaries bounded by GROUP_ELEMENTS), then
        select against the old values; ``count`` advances where ``ok``."""
        lr = self.schedule(state.count_t)
        bc1, bc2 = bias_corrections(state.count_t)
        for idx in _groups(state.params):
            params = [state.params[i] for i in idx]
            mu, nu = [state.mu[i] for i in idx], [state.nu[i] for i in idx]
            clipped = clip_by_global_norm([grads[i] for i in idx], grad_norm, self.max_grad_norm)
            mu_new, nu_new, new = _adam_parts(clipped, params, mu, nu, bc1, bc2, lr, self.weight_decay)
            del clipped
            torch._foreach_add_(new, params)
            select_(params, ok, new)
            select_(mu, ok, mu_new)
            select_(nu, ok, nu_new)
        state.count_t.add_(ok.to(torch.int32))


def _adam_parts(grads: List[torch.Tensor], params: List[torch.Tensor], mu: List[torch.Tensor], nu: List[torch.Tensor],
                bc1: torch.Tensor, bc2: torch.Tensor, lr: Union[float, torch.Tensor], weight_decay: float,
                eps: float = EPS) -> Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]:
    """optax.adamw's new moments and updates (``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``), out of place."""
    mu_new = torch._foreach_mul(mu, B1)
    torch._foreach_add_(mu_new, grads, alpha=1 - B1)
    nu_new = torch._foreach_mul(nu, B2)
    torch._foreach_addcmul_(nu_new, grads, grads, value=1 - B2)
    denom = torch._foreach_div(nu_new, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    upd = torch._foreach_div(mu_new, bc1)
    torch._foreach_div_(upd, denom)
    if weight_decay:
        torch._foreach_add_(upd, params, alpha=weight_decay)
    torch._foreach_mul_(upd, -lr)
    return mu_new, nu_new, upd


def adamw_updates(grads: List[torch.Tensor], params: List[torch.Tensor], mu: List[torch.Tensor],
                  nu: List[torch.Tensor], count: Count, lr: Union[float, torch.Tensor], weight_decay: float,
                  eps: float = EPS) -> List[torch.Tensor]:
    """optax.adamw's updates for ``params`` after ``count`` updates, at learning rate ``lr``.

    The moments ``mu``/``nu`` are updated in place; the returned updates are
    added to the parameters by the caller (ZeRO masks them first).
    """
    count = torch.as_tensor(count, dtype=torch.int32).to(mu[0].device)
    bc1, bc2 = bias_corrections(count)
    mu_new, nu_new, upd = _adam_parts(grads, params, mu, nu, bc1, bc2, lr, weight_decay, eps)
    torch._foreach_copy_(mu, mu_new)
    torch._foreach_copy_(nu, nu_new)
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
