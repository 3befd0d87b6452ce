"""Weight bridge: the JAX package's parameter tree -> the port's modules.

``load_jax_params(module, params)`` takes the JAX tree as nested dicts of
numpy arrays, as ``jax.tree.map(np.asarray, model.params)`` gives it (the
port never imports JAX, so it takes numpy only), and copies every leaf under
``vision_encoder/...`` and ``caption_decoder/...`` into the port's module:

* Dense ``kernel`` (in, out) -> ``nn.Linear`` weight (out, in).
* ``q_proj``/``k_proj``/``v_proj`` kernel (hidden, H, D) -> weight (H*D, hidden),
  bias (H, D) -> (H*D,).
* ``out_proj`` kernel (H, D, hidden) -> weight (hidden, H*D).
* ``patch_embed/kernel`` (P, P, 3, width), HWIO -> weight (width, P*P*3) in
  (h, w, c) order, matching the port's patchify (models/vit.py).
* LayerNorm and RMSNorm ``scale`` (and LayerNorm ``bias``) -> ``weight``
  (``bias``); ``embedding`` -> ``weight``; ``cls_token`` and ``pos_embed`` as
  they are.
* ``block_i`` -> ``blocks.i``, ``LayerNorm_0/1`` and ``RMSNorm_0/1`` ->
  ``ln_0/1``, ``vision_projection/layers_0`` -> ``vision_projection``.
* Llama blocks: q/k/v/o without biases, k and v of ``num_kv_heads * D``
  columns, and the SwiGLU ``gate_proj``/``up_proj``/``down_proj`` kernels.

Every subtree is filled: ``vision_encoder``, ``text_encoder`` and
``caption_decoder``, and ``shared_lm`` for a model built with
``share_text_tower``. An unknown key, a parameter left unfilled, or a shape
mismatch raises. A JAX LoRA factor dict needs no conversion: the port keys
its factors by the same paths, in the same layout (models/lora.py;
``PreferenceGuidedCaptioningModel.load_jax_params(params, lora=...)``).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _port_name(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path[:-1]:
        m = re.fullmatch(r"block_(\d+)", p)
        if m:
            parts += ["blocks", m.group(1)]
        elif re.fullmatch(r"(LayerNorm|RMSNorm)_(\d+)", p):
            parts.append("ln_" + p.rsplit("_", 1)[1])
        elif p != "layers_0":  # nn.Sequential([Dense, tanh]) -> the Linear itself
            parts.append(p)
    leaf = {"scale": "weight", "kernel": "weight", "embedding": "weight"}.get(path[-1], path[-1])
    return ".".join(parts + [leaf])


def _port_value(path: Tuple[str, ...], x: np.ndarray) -> np.ndarray:
    owner, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    if leaf == "kernel":
        if x.ndim == 4:  # patch conv (P, P, C, width)
            return x.reshape(-1, x.shape[-1]).T
        if x.ndim == 3 and owner == "out_proj":  # (H, D, hidden)
            return x.reshape(-1, x.shape[-1]).T
        if x.ndim == 3:  # q/k/v (hidden, H, D)
            return x.reshape(x.shape[0], -1).T
        return x.T
    if leaf == "bias" and x.ndim == 2:  # q/k/v (H, D)
        return x.reshape(-1)
    return x


def load_jax_params(module: nn.Module, params: Mapping) -> None:
    """Fill ``module``'s parameters in place from the JAX tree ``params``."""
    targets: Dict[str, nn.Parameter] = dict(module.named_parameters())
    filled = set()
    for path, value in _flatten(params):
        name = _port_name(path)
        if name not in targets:
            raise KeyError(f"JAX parameter {'/'.join(path)} has no counterpart ({name}) in the port")
        target = targets[name]
        value = _port_value(path, value)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"shape mismatch for {'/'.join(path)}: JAX {tuple(value.shape)} -> "
                f"port {name} {tuple(target.shape)}"
            )
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(value)))  # np.array: a writable copy
        filled.add(name)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"port parameters missing from the JAX tree: {missing}")
