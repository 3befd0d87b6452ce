"""Precision policy: params fp32, compute bf16, losses/reductions fp32.

Mirrors pgica_tpu/core/precision.py:22-51. Parameters stay float32 masters;
inference runs on a copy cast once to the compute dtype (as
``PreferenceGuidedCaptioningModel._inference_params`` does in the JAX
package, model.py:370-387); LayerNorm and attention softmax statistics stay
float32 inside the kernels.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

POLICIES = {
    "no": torch.float32,
    "fp32": torch.float32,
    "float32": torch.float32,
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    # fp16 maps to bf16, as in the JAX package (its documented deviation
    # from GPU AMP), so both packages run the same numerics for one config.
    "fp16": torch.bfloat16,
    "float16": torch.bfloat16,
}


def compute_dtype(mixed_precision: str) -> torch.dtype:
    try:
        return POLICIES[str(mixed_precision).lower()]
    except KeyError:
        raise ValueError(
            f"Unknown mixed_precision {mixed_precision!r}; expected one of {sorted(POLICIES)}"
        )


def cast_floating(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` with its floating parameters and buffers cast.

    The copy is deep, so the float32 masters stay untouched; integer buffers
    keep their dtype (``nn.Module.to(dtype)`` casts floating tensors only).
    """
    return copy.deepcopy(module).to(dtype)
