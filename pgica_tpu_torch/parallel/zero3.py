"""ZeRO-3: the LM blocks' parameters sharded at rest and gathered one block at a time (port of
pgica_tpu/parallel/zero3.py).

ZeRO-1 (parallel/zero1.py) shards the optimizer state but gathers every
parameter for the step. Here each transformer block of the LMs (the text
tower's and the decoder's: the JAX package's ``scan_layers`` stacks) is a
flat float32 buffer of its own, of which each rank keeps ``1/n``; the LM
gathers a block's weights at the block's entry and drops them after it
(models/lm.py, ``TransformerLM.sharded``). The gather's backward
reduce-scatters the SUM of the weights' gradients, so a block's gradient
leaves the backward pass summed over the ranks and already sharded (divided
by n after, for the mean loss). Under activation checkpointing the gather
sits inside the checkpointed function: the backward pass gathers again and
saves only the block's input, so a rank holds the parameters / n plus one
block. Everything outside the blocks (the vision tower, embeddings, heads)
goes through zero1's flat buffer; the Adam moments mirror the shards.
``zero1.ShardedParams(..., blocks=True)`` holds that split (JAX's
``ParamLayout``).

The frozen DPO reference (``with_ref``) is sharded the same way
(``init_fn.shard_ref``) and gathered inside the step.

The port refuses what the JAX package refuses: a block leaf whose JAX last
dim (head_dim for q/k/v, else the output width) n does not divide
(JAX zero3.py:126-134); the trainer refuses ``mesh.zero3`` without
``model.scan_layers: true``. The axis may be one name or a tuple (e.g.
``("data", "fsdp")``).
"""

from __future__ import annotations

import contextlib
import re
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from pgica_tpu_torch.parallel import collectives
from pgica_tpu_torch.parallel.mesh import AxisName, MeshContext
from pgica_tpu_torch.parallel.zero1 import (
    EPS,
    LossFn,
    ShardedParams,
    Trainable,
    ZeroState,
    _lms,
    _reduced_metrics,
    _schedule,
    _sharded_update,
    flatten_tree,
    jax_path,
)

Zero3State = ZeroState  # shards[0]: the rest; shards[1:]: one per LM block


def jax_last_dim(lm: nn.Module, key: str, param: torch.Tensor) -> int:
    """The last dim of the JAX package's leaf for a block parameter (``key`` within the block): q/k/v
    kernels (hidden, H, D) and biases (H, D) end in head_dim; every other leaf in its output width."""
    if re.search(r"attn\.[qkv]_proj\.", key):
        return lm.config.head_dim
    return param.shape[0]


def check_divisible(module: nn.Module, n: int) -> None:
    """Raise as JAX's ParamLayout does when n does not divide a block leaf's last dim."""
    for prefix, lm in _lms(module):
        for j, block in enumerate(lm.blocks):
            for key, p in block.named_parameters():
                last = jax_last_dim(lm, key, p)
                if last % n:
                    path = "/".join(jax_path(module, f"{prefix}.blocks.{j}.{key}"))
                    raise ValueError(
                        f"zero3: stacked block leaf {path} (last dim {last}) — last dim must be divisible by "
                        f"the axis size {n}; pick head_dim/hidden/intermediate sizes divisible by the fsdp world")


def make_zero3_train_step(
    loss_fn: LossFn,
    mesh: MeshContext,
    axis_name: AxisName = "fsdp",
    learning_rate=1e-4,  # float or schedule(count) -> float
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
    trainable_mask: Optional[Trainable] = None,
    eps: float = EPS,
    with_ref: bool = False,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn, step_fn)`` for ZeRO-3 training.

    ``init_fn(module) -> ZeroState`` shards the module's parameters (the
    blocks' and the rest's) and the Adam moments of this rank's shards;
    ``init_fn.shard_ref(ref_module) -> ShardedParams`` shards a frozen
    reference alike.

    ``step_fn(state, batch, seed, ref=None) -> (state, metrics)``:
    ``loss_fn(batch, seed, step)`` runs the module (and, with ``with_ref``,
    the reference, which ``step_fn`` materializes for it) on this rank's
    rows, as in :func:`~pgica_tpu_torch.parallel.zero1.make_zero1_train_step`.
    ``step_fn.gather_params(state)``: every parameter by name.
    """
    schedule = _schedule(learning_rate)
    n = mesh.axis_size(axis_name)

    def init_fn(module: nn.Module) -> ZeroState:
        check_divisible(module, n)
        params = ShardedParams(module, mesh, axis_name, blocks=True, trainable=trainable_mask)
        return ZeroState(0, params, [torch.zeros_like(s) for s in params.shards],
                         [torch.zeros_like(s) for s in params.shards])

    def shard_ref(ref_module: nn.Module) -> ShardedParams:
        check_divisible(ref_module, n)
        return ShardedParams(ref_module, mesh, axis_name, blocks=True, trainable=lambda _: False)

    init_fn.shard_ref = shard_ref  # type: ignore[attr-defined]

    def step_fn(state: ZeroState, batch, seed: int = 0, ref: Optional[ShardedParams] = None):
        if with_ref and ref is None:
            raise ValueError("step_fn built with with_ref=True needs ref=init_fn.shard_ref(ref_module)")
        p = state.params
        ref_ctx = ref.materialized() if ref is not None else contextlib.nullcontext()
        with mesh, torch.enable_grad(), p.materialized(), ref_ctx:
            loss, metrics = loss_fn(batch, seed, state.step)
            rest = p.rest_params
            blocks = p.shards[1:]
            wrt = [q for q in rest + blocks if q.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
            grads = [next(got) if q.requires_grad else None for q in rest + blocks]
            grads = [torch.zeros_like(q) if g is None else g for g, q in zip(grads, rest + blocks)]
            g_rest = collectives.psum_scatter(flatten_tree(grads[:len(rest)], p.specs[0]), axis_name, mesh) / n
            g_blocks = [g.to(torch.float32) / n for g in grads[len(rest):]]
        metrics = _reduced_metrics(loss, metrics, mesh, axis_name)
        with mesh:
            metrics["grad_norm"] = _sharded_update(state, [g_rest] + g_blocks, metrics["loss"], schedule,
                                                   weight_decay, max_grad_norm, eps)
        metrics["skipped"] = state.skipped
        return state, metrics

    step_fn.gather_params = lambda state: state.params.gather_params()  # type: ignore[attr-defined]
    return init_fn, step_fn
