"""Device-side image preparation and training augmentation (port of pgica_tpu/data/augment.py).

``prepare_images`` turns uint8 NHWC into ImageNet-normalized float32 on the
images' device (augment.py:221-231, with the mean and std of
preprocessing.py:30-31). ``augment_batch`` is the JAX package's train-time
augmentation (augment.py:38-242): per image a random resized crop
(0.8-1.0 of the area) and a horizontal flip, colour jitter (brightness,
contrast, saturation 0.2, hue 0.1, in that fixed order), then one rotation
angle of 0-5 degrees for the batch with a random sign per image, by the
exact Paeth three-shear decomposition, vacated pixels black.

Each random function is split in two: ``sample_augment_params`` draws every
parameter from a ``torch.Generator`` on the CPU (a few scalars per image,
copied to the device in one transfer, so the card and the CPU draw the same
values from one seed), and the other functions apply given parameters, so
that tests can feed them the values ``jax.random`` drew. The streams of the
two packages differ; the operations are the same.

The JAX package expresses the crop, the flip and the shears as one-hot
matrix products (einsums) because the TPU's gather unit serializes; on the
card a gather is an ordinary memory-bound kernel, so each of them is a
gather here (advanced indexing with the matrix's index, and the shear's
out-of-range sources masked to 0). A one-hot product with float32
accumulation is exact, so the two agree bit for bit. ``torch.round``, like
``jnp.round``, rounds half to even, which the rotation's mirror trick needs
(``_rotate_batch``). All functions take and return normalized NHWC float32;
the jitter works in de-normalized [0, 1] space.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LUMA = (0.299, 0.587, 0.114)  # ITU-R BT.601
MIN_AXIS_SCALE = 0.8 ** 0.5  # sqrt: the crop's area scale is 0.8-1.0, as the reference's
JITTER = (0.2, 0.2, 0.2, 0.1)  # brightness, contrast, saturation, hue
ROTATION_DEGREES = 5.0


@functools.lru_cache(maxsize=None)
def _constants(device: torch.device):
    """ImageNet's (mean, std) and the BT.601 luma weights on ``device``, made once a device: the copy
    from the host that makes them would be refused inside a CUDA-graph capture (the engine's admission
    graphs, the captured train steps), and a caller's eager run before the capture fills this cache.
    Normal tensors, never written."""
    with torch.inference_mode(False):
        return tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (IMAGENET_MEAN, IMAGENET_STD, LUMA))


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> /255 -> ImageNet-normalized float32, on ``images``' device.

    Hosts ship raw uint8 (4x less host->device traffic than float32). Float
    inputs are assumed already normalized and pass through.
    """
    if images.is_floating_point():
        return images
    mean, std = _constants(images.device)[:2]
    return (images.to(torch.float32) / 255.0 - mean) / std


@dataclasses.dataclass
class AugmentParams:
    """The random draws of one batch of N images (float32 / bool tensors on one device).

    ``row_*``/``col_*``: crop scale in [sqrt(0.8), 1) and placement in [0, 1)
    per axis (JAX ``_resample_matrix``); ``col_flip``: the horizontal flip;
    ``jitter`` (N, 4): brightness, contrast and saturation factors and the
    hue shift (``_color_jitter``); ``theta``: the batch's rotation angle in
    radians; ``positive`` (N,): True where an image turns by +theta, False by
    -theta (JAX ``_rotate_batch``'s Bernoulli draw).
    """

    row_scale: torch.Tensor
    row_offset: torch.Tensor
    col_scale: torch.Tensor
    col_offset: torch.Tensor
    col_flip: torch.Tensor
    jitter: torch.Tensor
    theta: torch.Tensor
    positive: torch.Tensor

    def to(self, device: torch.device) -> "AugmentParams":
        return AugmentParams(**{f.name: getattr(self, f.name).to(device, non_blocking=True)
                                for f in dataclasses.fields(self)})


def sample_augment_params(n: int, generator: torch.Generator) -> AugmentParams:
    """Draw one batch's parameters from a CPU ``generator``, with the JAX package's distributions."""

    def uniform(shape, low: float, high: float) -> torch.Tensor:
        return low + (high - low) * torch.rand(shape, generator=generator, dtype=torch.float32)

    def bernoulli(shape) -> torch.Tensor:
        return torch.rand(shape, generator=generator) < 0.5

    b, c, s, h = JITTER
    jitter = torch.stack([uniform((n,), 1 - b, 1 + b), uniform((n,), 1 - c, 1 + c),
                          uniform((n,), 1 - s, 1 + s), uniform((n,), -h, h)], dim=1)
    return AugmentParams(
        row_scale=uniform((n,), MIN_AXIS_SCALE, 1.0), row_offset=uniform((n,), 0.0, 1.0),
        col_scale=uniform((n,), MIN_AXIS_SCALE, 1.0), col_offset=uniform((n,), 0.0, 1.0),
        col_flip=bernoulli((n,)), jitter=jitter,
        theta=uniform((), 0.0, ROTATION_DEGREES) * (math.pi / 180.0), positive=bernoulli((n,)),
    )


def _resample_index(size: int, scale: torch.Tensor, offset: torch.Tensor,
                    flip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, size) nearest-neighbour source index of a crop + resize (+ flip) along one axis.

    The index of JAX ``_resample_matrix``'s one-hot rows: crop length
    ``size * scale`` placed at ``offset * (size - crop_len)``, output pixel i
    reads round(offset + (i + 0.5) * crop_len / size - 0.5), clipped.
    """
    crop_len = size * scale
    start = offset * (size - crop_len)
    grid = torch.arange(size, dtype=torch.float32, device=scale.device) + 0.5
    positions = start[:, None] + grid * (crop_len / size)[:, None] - 0.5
    idx = torch.round(positions).to(torch.int64).clamp(0, size - 1)
    if flip is not None:
        idx = torch.where(flip[:, None], size - 1 - idx, idx)
    return idx


def _shear_index(slope: torch.Tensor, n_ortho: int, n_shift: int):
    """Source index (n_ortho, n_shift), clipped, and its validity, of a shear (JAX ``_shear_matrix``).

    Line i shifts by round(slope * (i - center)): out[i, j] = in[i, j - shift_i],
    0 where that source lies outside the line (black fill).
    """
    center = (n_ortho - 1) / 2.0
    lines = torch.arange(n_ortho, dtype=torch.float32, device=slope.device)
    shifts = torch.round(slope * (lines - center)).to(torch.int64)
    src = torch.arange(n_shift, device=slope.device)[None, :] - shifts[:, None]
    valid = (src >= 0) & (src < n_shift)
    return src.clamp(0, n_shift - 1), valid


def _rot3_batch(images: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """Rotate (N, H, W, C) by one shared ``theta``: column shear, row shear, column shear.

    R(theta) = Sx(tan theta/2) Sy(-sin theta) Sx(tan theta/2); vacated pixels
    come out 0 (append a ones channel to recover the validity mask).
    """
    _, h, w, _ = images.shape
    src1, valid1 = _shear_index(torch.tan(theta / 2.0), h, w)  # per image row i
    src2, valid2 = _shear_index(-torch.sin(theta), w, h)  # per image column j
    rows = torch.arange(h, device=images.device)[:, None]
    cols = torch.arange(w, device=images.device)[None, :]
    x = torch.where(valid1[..., None], images[:, rows, src1], 0.0)
    x = torch.where(valid2.T[..., None], x[:, src2.T, cols], 0.0)
    return torch.where(valid1[..., None], x[:, rows, src1], 0.0)


def rotate_3shear(img: torch.Tensor, theta: torch.Tensor, max_degrees: float = 5.0,
                  fill: float = 0.0) -> torch.Tensor:
    """Rotate one (H, W, C) image by ``theta`` radians counterclockwise (torchvision's convention).

    ``max_degrees`` is accepted for the JAX signature and unused.
    """
    del max_degrees
    ones = torch.ones(img.shape[:2] + (1,), dtype=img.dtype, device=img.device)
    out = _rot3_batch(torch.cat([img, ones], dim=-1)[None], theta)[0]
    return torch.where(out[..., -1:] > 0.5, out[..., : img.shape[-1]], fill)


def _rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Elementwise RGB [0, 1] -> HSV [0, 1] (torchvision/colorsys convention)."""
    r, g, b = rgb.unbind(-1)
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    rng = maxc - minc
    s = torch.where(maxc > 0, rng / torch.clamp(maxc, min=1e-12), 0.0)
    safe = torch.clamp(rng, min=1e-12)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(rng > 0, torch.remainder(h / 6.0, 1.0), 0.0)  # floor-mod, as jnp's %
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Elementwise HSV [0, 1] -> RGB [0, 1]; ``jnp.select`` becomes a chain of ``torch.where``."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sector = torch.remainder(i.to(torch.int32), 6)

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):  # the first matching sector wins, as in jnp.select
            out = torch.where(sector == k, choices[k], out)
        return out

    r = select((v, q, p, p, t), v)
    g = select((t, v, v, q, p), p)
    b = select((p, p, t, v, v), q)
    return torch.stack([r, g, b], dim=-1)


def _color_jitter(img01: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """torchvision ColorJitter(0.2, 0.2, 0.2, 0.1) on (N, H, W, 3) in [0, 1] with given factors.

    ``jitter`` (N, 4): brightness, contrast, saturation factors and the hue
    shift. Brightness, contrast and saturation blend against the BT.601 luma
    (contrast against its mean over the image), hue rotates h by the shift
    mod 1. The order is fixed b -> c -> s -> h, as in the JAX package (its
    documented deviation from torchvision's random order per image).
    """
    fb, fc, fs, shift = (jitter[:, i].reshape(-1, 1, 1, 1) for i in range(4))
    luma = _constants(img01.device)[2].to(img01.dtype)
    img01 = torch.clamp(img01 * fb, 0.0, 1.0)
    gray_mean = (img01 @ luma).mean(dim=(1, 2)).reshape(-1, 1, 1, 1)
    img01 = torch.clamp(img01 * fc + gray_mean * (1 - fc), 0.0, 1.0)
    gray = (img01 @ luma)[..., None]
    img01 = torch.clamp(img01 * fs + gray * (1 - fs), 0.0, 1.0)
    hsv = _rgb_to_hsv(img01)
    hue = torch.remainder(hsv[..., :1] + shift, 1.0)
    return torch.clamp(_hsv_to_rgb(torch.cat([hue, hsv[..., 1:]], dim=-1)), 0.0, 1.0)


def _augment_images(images: torch.Tensor, p: AugmentParams) -> torch.Tensor:
    """Per image: crop + resize, flip, colour jitter (JAX ``vmap(_augment_one)``, batched)."""
    n, h, w, _ = images.shape
    rows = _resample_index(h, p.row_scale, p.row_offset)
    cols = _resample_index(w, p.col_scale, p.col_offset, p.col_flip)
    batch = torch.arange(n, device=images.device)[:, None, None]
    img = images[batch, rows[:, :, None], cols[:, None, :]]
    mean, std = _constants(images.device)[:2]
    img01 = torch.clamp(img * std + mean, 0.0, 1.0)
    return (_color_jitter(img01, p.jitter) - mean) / std


def _rotate_batch(images: torch.Tensor, theta: torch.Tensor, positive: torch.Tensor) -> torch.Tensor:
    """The rotation stage on a normalized batch: +theta where ``positive``, else -theta.

    R(-theta) = Flip_W R(theta) Flip_W about the centre, exactly, since the
    width flip negates both shear slopes and rounding half to even is odd-
    symmetric; so the images that turn by -theta are mirrored, the whole
    batch takes one +theta pass, and they are mirrored back. Vacated pixels
    become black (normalized: -mean/std).
    """
    ones = torch.ones(images.shape[:3] + (1,), dtype=images.dtype, device=images.device)
    stacked = torch.cat([images, ones], dim=-1)
    sign = positive[:, None, None, None]
    rot = _rot3_batch(torch.where(sign, stacked, stacked.flip(2)), theta)
    out = torch.where(sign, rot, rot.flip(2))
    mean, std = _constants(images.device)[:2]
    return torch.where(out[..., -1:] > 0.5, out[..., :-1], (0.0 - mean) / std)


def augment_batch(images: torch.Tensor, generator: Optional[torch.Generator] = None, enabled: bool = True,
                  params: Optional[AugmentParams] = None) -> torch.Tensor:
    """Augment a normalized NHWC float32 batch on its device; the identity when not ``enabled``.

    The parameters are ``params`` if given, else drawn from ``generator``
    (a CPU generator) by :func:`sample_augment_params`. Given ``params`` on
    the images' device, every operation is a kernel there: no host copy, no
    sync, so a CUDA graph can hold the call (training/graphs.py draws on the
    host and copies the draws into the graph's static ``params``).
    """
    if not enabled:
        return images
    if params is None:
        if generator is None:
            raise ValueError("augment_batch needs a generator or params")
        params = sample_augment_params(images.shape[0], generator)
    params = params.to(images.device)
    return _rotate_batch(_augment_images(images, params), params.theta, params.positive)
