"""Seeds by purpose: one run seed, a reproducible stream per purpose and step.

The port's copy of pgica_tpu/core/prng.py. The JAX package derives every
stochastic site's key as ``fold_in(fold_in(root, purpose), step)``; the port
does the same with explicit ``torch.Generator``s: a purpose's seed is a hash
of the run seed and the purpose's name, and a step's generator is seeded
from that and the step count. So a stream depends on (seed, purpose, step)
alone, not on the order of the calls, and a run resumed at a checkpointed
step replays it. The streams are not JAX's threefry streams, and cannot be.

``purpose_seed(seed, f"train_stage{s}")`` is the seed of stage ``s``'s step
generators (training/trainer.py:stage_seed). ``stream_generator`` is the one
formula of a step's stream: the train steps' dropout, augmentation and LoRA
generators (training/train_step.py) are streams of the stage seed at offsets
of their own, and ``step_generator`` is the stream of a purpose's seed.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Union

import torch

# Stable purpose ids (never renumber — checkpoint reproducibility); the JAX package's
PURPOSES: Dict[str, int] = {
    "params": 0,
    "dropout": 1,
    "augment": 2,
    "sampling": 3,
    "data": 4,
    "train_stage1": 5,
    "train_stage2": 6,
    "train_stage0": 7,
}

STEP_STRIDE = 1_000_003  # a purpose seed's steps: seed * STEP_STRIDE + step


def purpose_seed(seed: int, purpose: str) -> int:
    """A 32-bit seed for ``purpose`` (one of ``PURPOSES``) under the run seed ``seed``."""
    if purpose not in PURPOSES:
        raise KeyError(f"unknown purpose {purpose!r}; one of {sorted(PURPOSES)}")
    return int.from_bytes(hashlib.sha1(f"{seed}/{purpose}".encode()).digest()[:4], "little")


def stream_generator(seed: int, step: int, device: Union[str, torch.device] = "cpu",
                     offset: int = 0) -> torch.Generator:
    """A generator on ``device`` for step ``step`` of the stream of ``seed`` (``offset`` parts streams)."""
    return torch.Generator(device=device).manual_seed(seed * STEP_STRIDE + int(step) + offset)


def step_generator(seed: int, purpose: str, step: int, device: Union[str, torch.device] = "cpu") -> torch.Generator:
    """A generator on ``device`` for ``purpose`` at ``step``, seeded from nothing else."""
    return stream_generator(purpose_seed(seed, purpose), step, device)
