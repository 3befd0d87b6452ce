"""Functional LoRA adapters (port of pgica_tpu/models/lora.py).

The factors live outside the module, in a dict from the JAX package's
parameter path (``caption_decoder/lm/block_0/attn/q_proj/kernel``) to an
(A, B) pair of float32 tensors with the JAX shapes: A is (fan_in, r) and B
(r, fan_out), fan_in the first dim of the JAX kernel and fan_out the product
of the rest. The JAX layout is kept exactly, so the factors of the two
packages are the same tensors; :func:`apply_lora` maps each product onto the
port's (out, in) weight. For the attention ``out_proj``, whose JAX kernel is
(H, D, hidden), A is (H, r) and B (r, D * hidden): the JAX package's shapes,
not peft's (see ROADMAP).

A train step runs the module on ``W + (alpha / r) * A @ B`` without changing
it: :func:`swapped` puts the merged tensors in place of the float32 masters
for the forward and the backward (activation checkpointing recomputes
blocks there), then puts the masters back. The masters take no gradient
(the optimizer holds the factors only) and are never written.

Target selection is by path, as peft's ``target_modules``: a kernel whose
last module name is a target, inside ``scope`` (the text towers, never the
vision tower).
"""

from __future__ import annotations

import math
import re
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

Adapters = Dict[str, Tuple[torch.Tensor, torch.Tensor]]

DEFAULT_TARGETS = ("q_proj", "v_proj")  # peft's c_attn ~ the port's q/k/v split
# The reference's scope: peft wraps the text encoder and the caption decoder, never the vision
# tower, whose blocks use the same q_proj/out_proj names.
DEFAULT_SCOPE = ("text_encoder/backbone", "caption_decoder/lm", "shared_lm")


def jax_path(name: str) -> str:
    """The JAX path of a port Dense weight: ``a.blocks.3.attn.q_proj.weight`` -> ``a/block_3/attn/q_proj/kernel``."""
    parts = re.sub(r"(^|\.)blocks\.(\d+)(?=\.)", r"\1block_\2", name).split(".")
    return "/".join(parts[:-1] + ["kernel" if parts[-1] == "weight" else parts[-1]])


def port_name(path: str) -> str:
    """Inverse of :func:`jax_path`."""
    parts = [re.sub(r"^block_(\d+)$", r"blocks.\1", p) for p in path.split("/")]
    return ".".join(parts[:-1] + ["weight" if parts[-1] == "kernel" else parts[-1]])


def _is_target(path: str, targets: Sequence[str], scope: Sequence[str]) -> bool:
    if scope and not any(path.startswith(s) for s in scope):
        return False
    return path.endswith("/kernel") and any(re.search(rf"(^|/){re.escape(t)}/kernel$", path) for t in targets)


def target_shapes(module: nn.Module, targets: Sequence[str] = DEFAULT_TARGETS,
                  scope: Sequence[str] = DEFAULT_SCOPE) -> Dict[str, Tuple[int, int]]:
    """{JAX path: (fan_in, fan_out)} of every targeted Dense weight of ``module``, by path."""
    from pgica_tpu_torch.models.layers import Dense, MultiHeadAttention

    shapes = {}
    for name, p in module.named_parameters():
        owner_name = name.rsplit(".", 1)[0]
        if not name.endswith(".weight") or not isinstance(module.get_submodule(owner_name), Dense):
            continue
        path = jax_path(name)
        if not _is_target(path, targets, scope):
            continue
        parent = module.get_submodule(owner_name.rsplit(".", 1)[0])
        if owner_name.endswith("out_proj") and isinstance(parent, MultiHeadAttention):
            fan_in = parent.num_heads  # JAX kernel (H, D, hidden)
        else:
            fan_in = p.shape[1]  # JAX kernel (in, out...) of an (out, in) weight
        shapes[path] = (fan_in, p.numel() // fan_in)
    return dict(sorted(shapes.items()))


def init_lora(module: nn.Module, generator: torch.Generator, rank: int = 16,
              targets: Sequence[str] = DEFAULT_TARGETS, scope: Sequence[str] = DEFAULT_SCOPE) -> Adapters:
    """{path: (A, B)} for every targeted kernel, on ``module``'s device, in path order.

    A ~ N(0, 1/rank) drawn from ``generator`` (a CPU generator, so one seed
    gives the same factors on every device), B zeros: the adapter starts as
    a no-op, as in the JAX package (whose draws differ: tests bridge its
    factors with :func:`from_numpy`).
    """
    device = next(module.parameters()).device
    factors: Adapters = {}
    for path, (fan_in, fan_out) in target_shapes(module, targets, scope).items():
        a = torch.randn((fan_in, rank), generator=generator, dtype=torch.float32) / math.sqrt(rank)
        factors[path] = (a.to(device), torch.zeros((rank, fan_out), dtype=torch.float32, device=device))
    return factors


def dropout_masks(lora: Adapters, dropout: float, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """One DropConnect mask per adapter, (fan_in, 1): Bernoulli(1 - dropout) / (1 - dropout), in path order.

    The JAX package's ``lora_dropout`` (lora.py:97-115): rows of A, the
    adapter's input features, are dropped once per step for the whole batch,
    where peft drops per token; the expectation is the same.
    """
    keep = 1.0 - dropout
    masks = {}
    for path in sorted(lora):
        a = lora[path][0]
        draw = torch.rand((a.shape[0], 1), generator=generator, device=generator.device, dtype=torch.float32)
        masks[path] = ((draw < keep).to(torch.float32) / keep).to(a.device)
    return masks


def lora_delta(weight: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """(alpha / r) * A @ B in the JAX kernel's layout, laid out as the port's (out, in) ``weight``, in its dtype."""
    return ((a @ b).reshape(-1, weight.shape[0]).T * scale).to(weight.dtype)


def apply_lora(params: Mapping[str, torch.Tensor], lora: Adapters, alpha: float = 32.0, rank: int = 16,
               dropout: float = 0.0, generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """``params`` (port names, as ``named_parameters``/``state_dict``) with the LoRA deltas merged.

    ``dropout`` with a ``generator`` (train steps only) masks rows of A
    first (:func:`dropout_masks`); without a generator it is off, as in eval.
    Differentiable in the factors.
    """
    if not lora:
        return dict(params)
    scale = alpha / rank
    masks = dropout_masks(lora, dropout, generator) if dropout > 0.0 and generator is not None else {}
    merged = dict(params)
    for path, (a, b) in lora.items():
        name = port_name(path)
        if path in masks:
            a = a * masks[path]
        merged[name] = params[name] + lora_delta(params[name], a, b, scale)
    return merged


@contextmanager
def swapped(module: nn.Module, weights: Mapping[str, torch.Tensor]) -> Iterator[nn.Module]:
    """``module`` running on ``weights`` (port name -> tensor) in place of those parameters, for the duration."""
    held: List[Tuple[nn.Module, str, Any]] = []
    try:
        for name, t in weights.items():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            held.append((owner, leaf, owner._parameters[leaf]))
            owner._parameters[leaf] = t
        yield module
    finally:
        for owner, leaf, p in reversed(held):
            owner._parameters[leaf] = p


def merged_targets(module: nn.Module, lora: Adapters, alpha: float, rank: int, dropout: float = 0.0,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """The merged tensors of the targeted parameters only (what :func:`swapped` takes).

    Adapters of a tower that ``module`` lacks (the stage-2 reference leaves
    the text tower out) are skipped.
    """
    names = {port_name(p) for p in lora}
    params = {n: p for n, p in module.named_parameters() if n in names}
    present = {p: ab for p, ab in lora.items() if port_name(p) in params}
    merged = apply_lora(params, present, alpha, rank, dropout, generator)
    return {n: merged[n] for n in params}


@torch.no_grad()
def fold_lora(module: nn.Module, lora: Adapters, alpha: float, rank: int) -> None:
    """Add the adapters' deltas into ``module``'s parameters in place (the trainer's final fold)."""
    for name, w in merged_targets(module, lora, alpha, rank).items():
        module.get_parameter(name).copy_(w)


def count_lora_params(lora: Adapters) -> int:
    return sum(a.numel() + b.numel() for a, b in lora.values())


def from_numpy(lora: Mapping[str, Tuple[Any, Any]], device: torch.device) -> Adapters:
    """A JAX factor dict ({path: (A, B)} of arrays) as the port's, float32 on ``device``."""
    import numpy as np

    return {p: tuple(torch.from_numpy(np.array(t, np.float32)).to(device) for t in ab) for p, ab in lora.items()}


# -- checkpoint (de)serialization ------------------------------------------------

_SEP = "--"  # the JAX package's checkpoint-safe path separator


def lora_to_tree(lora: Adapters) -> Dict[str, Dict[str, torch.Tensor]]:
    """Factors dict -> checkpoint-safe nested dict (the JAX ``lora_to_tree``)."""
    return {p.replace("/", _SEP): {"a": a, "b": b} for p, (a, b) in lora.items()}


def lora_from_tree(tree: Mapping[str, Mapping[str, torch.Tensor]]) -> Adapters:
    return {p.replace(_SEP, "/"): (v["a"], v["b"]) for p, v in tree.items()}


# -- peft-name translation -------------------------------------------------------

# peft targets GPT-2's fused Conv1D module names; this framework splits them into per-projection kernels.
PEFT_NAME_MAP = {
    "c_attn": ("q_proj", "k_proj", "v_proj"),
    "c_proj": ("out_proj", "fc_out"),
    "c_fc": ("fc_in",),
}


def normalize_lora_config(raw: Any) -> Optional[Dict[str, Any]]:
    """``model.lora_config`` (peft schema: r / lora_alpha / target_modules / lora_dropout) -> {rank, alpha,
    targets, dropout}; None when LoRA is off. ``lora_dropout`` is the train-step DropConnect above."""
    if not raw:
        return None
    targets: List[str] = []
    for t in raw.get("target_modules", ["c_attn"]):
        targets.extend(PEFT_NAME_MAP.get(t, (t,)))
    return {
        "rank": int(raw.get("r", raw.get("rank", 16))),
        "alpha": float(raw.get("lora_alpha", raw.get("alpha", 32))),
        "targets": tuple(dict.fromkeys(targets)),
        "dropout": float(raw.get("lora_dropout", raw.get("dropout", 0.0))),
    }
