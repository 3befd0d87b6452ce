"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``. A missing
card is an error, never a silent fall back to the CPU: the CPU runs only when
the caller asks for it (the tests do). A rank of a distributed run takes the
card of its ``LOCAL_RANK`` (``torchrun`` sets it; ranks that share one card
set it alike).
"""

from __future__ import annotations

import os
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {device}; expected 'cuda' or 'cpu'")
    return device


def rank_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` resolved for this rank: a bare ``cuda`` becomes ``cuda:LOCAL_RANK`` (0 without it).

    A card index past the cards present raises, as a missing card does.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if device.type == "cuda" and device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} requested, but {torch.cuda.device_count()} card(s) are present")
    return device
