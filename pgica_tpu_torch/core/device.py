"""Device resolution for the port's entry points.

Entry points take an explicit ``device`` and default to ``"cuda"``. A missing
card is an error, never a silent fall back to the CPU: the CPU runs only when
the caller asks for it (the tests do).
"""

from __future__ import annotations

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
