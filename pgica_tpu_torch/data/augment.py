"""Device-side uint8 -> normalized float image path.

Mirrors ``prepare_images`` of pgica_tpu/data/augment.py:221-231 with the
ImageNet mean and std of pgica_tpu/data/preprocessing.py:30-31. The training
augmentations of that module wait for the training slice.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> /255 -> ImageNet-normalized float32, on ``images``' device.

    Hosts ship raw uint8 (4x less host->device traffic than float32). Float
    inputs are assumed already normalized and pass through.
    """
    if images.is_floating_point():
        return images
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std
