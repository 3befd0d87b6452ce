"""The port's device augmentation against the JAX package's, op by op, on the CPU.

The two packages draw from different generators, so each op of the port is
fed the parameters that ``jax.random`` drew; the test recomputes JAX's key
splits itself (augment.py:48-52, 136-147, 164-167, 194-202, 240-242).
Tolerances: the crop/flip index, the shears and the rotation are gathers in
the port and one-hot products in JAX, exact on both sides, so they must be
bit-equal; the HSV conversions and the colour jitter are float32 arithmetic
in another order (the luma dot products), held to 1e-6 in [0, 1]; the whole
batch to 1e-6 / min(std) after normalization.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data import augment as jaug
from pgica_tpu_torch.data import augment as aug

JITTER_ATOL = 1e-6
BATCH_ATOL = JITTER_ATOL / min(aug.IMAGENET_STD)


def _t(x):
    return torch.from_numpy(np.array(x))


def _resample_draws(key, min_scale):
    """(scale, offset, flip) as JAX ``_resample_matrix`` draws them."""
    k_scale, k_off, k_flip = jax.random.split(key, 3)
    scale = jax.random.uniform(k_scale, (), minval=min_scale, maxval=1.0)
    offset = jax.random.uniform(k_off, (), minval=0.0, maxval=1.0)
    return scale, offset, jax.random.bernoulli(k_flip)


def _jitter_draws(key):
    kb, kc, ks, kh = jax.random.split(key, 4)
    return jnp.stack([jax.random.uniform(kb, (), minval=0.8, maxval=1.2),
                      jax.random.uniform(kc, (), minval=0.8, maxval=1.2),
                      jax.random.uniform(ks, (), minval=0.8, maxval=1.2),
                      jax.random.uniform(kh, (), minval=-0.1, maxval=0.1)])


def _batch_draws(key, n):
    """Every parameter ``augment_batch(key, images)`` draws, as the port's AugmentParams."""
    k_imgs, k_rot = jax.random.split(key)
    rows, cols, jit = [], [], []
    for k in jax.random.split(k_imgs, n):
        k_h, k_w, k_col = jax.random.split(k, 3)
        rows.append(_resample_draws(k_h, 0.8 ** 0.5))
        cols.append(_resample_draws(k_w, 0.8 ** 0.5))
        jit.append(_jitter_draws(k_col))
    k_theta, k_sign = jax.random.split(k_rot)
    theta = jax.random.uniform(k_theta, (), minval=0.0, maxval=5.0) * (jnp.pi / 180.0)
    positive = jax.random.bernoulli(k_sign, 0.5, (n,))
    return aug.AugmentParams(
        row_scale=_t([r[0] for r in rows]), row_offset=_t([r[1] for r in rows]),
        col_scale=_t([c[0] for c in cols]), col_offset=_t([c[1] for c in cols]),
        col_flip=_t([bool(c[2]) for c in cols]), jitter=_t(jnp.stack(jit)), theta=_t(theta),
        positive=_t(np.asarray(positive)),
    )


def _normalized(rng, n, h, w):
    u8 = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    return np.asarray(jaug.prepare_images(jnp.asarray(u8)))


@pytest.mark.parametrize("size", [32, 57, 224])
@pytest.mark.parametrize("flip", [False, True])
def test_resample_index_is_jax_resample_matrix(size, flip):
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        m = np.asarray(jaug._resample_matrix(key, size, 0.8 ** 0.5, flip=flip))
        scale, offset, do_flip = _resample_draws(key, 0.8 ** 0.5)
        idx = aug._resample_index(size, _t([scale]), _t([offset]), _t([bool(do_flip)]) if flip else None)
        np.testing.assert_array_equal(idx[0].numpy(), m.argmax(axis=1))
        assert (m.sum(axis=1) == 1).all()


@pytest.mark.parametrize("n_ortho, n_shift", [(32, 32), (224, 224), (20, 33)])
def test_shear_index_is_jax_shear_matrix(n_ortho, n_shift):
    for slope in (0.0, 0.0437, -0.0872, 0.5, -1.3):
        m = np.asarray(jaug._shear_matrix(jnp.float32(slope), n_ortho, n_shift))
        src, valid = aug._shear_index(torch.tensor(slope, dtype=torch.float32), n_ortho, n_shift)
        np.testing.assert_array_equal(valid.numpy(), m.sum(axis=2) == 1)
        np.testing.assert_array_equal(np.where(valid.numpy(), src.numpy(), 0),
                                      np.where(valid.numpy(), m.argmax(axis=2), 0))


@pytest.mark.parametrize("degrees", [0.7, 3.0, -4.9, 30.0])
def test_rotation_is_bit_equal_to_jax(degrees):
    rng = np.random.default_rng(int(abs(degrees) * 10))
    images = _normalized(rng, 3, 32, 40)
    theta = np.float32(degrees * math.pi / 180.0)
    want = np.asarray(jaug._rot3_batch(jnp.asarray(images), jnp.float32(theta)))
    np.testing.assert_array_equal(aug._rot3_batch(_t(images), _t(theta)).numpy(), want)
    one = np.asarray(jaug.rotate_3shear(jnp.asarray(images[1]), jnp.float32(theta), fill=-1.5))
    np.testing.assert_array_equal(aug.rotate_3shear(_t(images[1]), _t(theta), fill=-1.5).numpy(), one)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rotate_batch_with_jax_draws_is_bit_equal(seed):
    images = _normalized(np.random.default_rng(seed), 5, 32, 32)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug._rotate_batch(key, jnp.asarray(images)))
    k_theta, k_sign = jax.random.split(key)
    theta = jax.random.uniform(k_theta, (), minval=0.0, maxval=5.0) * (jnp.pi / 180.0)
    positive = jax.random.bernoulli(k_sign, 0.5, (5,))
    got = aug._rotate_batch(_t(images), _t(theta), _t(np.asarray(positive))).numpy()
    np.testing.assert_array_equal(got, want)


def test_hsv_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    rgb = rng.random((4, 16, 16, 3), dtype=np.float32)
    rgb[0, 0, :4] = [[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0]]  # grey and pure hues
    hsv = np.asarray(jaug._rgb_to_hsv(jnp.asarray(rgb)))
    np.testing.assert_allclose(aug._rgb_to_hsv(_t(rgb)).numpy(), hsv, atol=JITTER_ATOL, rtol=0)
    back = np.asarray(jaug._hsv_to_rgb(jnp.asarray(hsv)))
    np.testing.assert_allclose(aug._hsv_to_rgb(_t(hsv)).numpy(), back, atol=JITTER_ATOL, rtol=0)


def test_color_jitter_with_jax_draws_matches_jax():
    rng = np.random.default_rng(1)
    img01 = rng.random((4, 24, 24, 3), dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = np.stack([np.asarray(jaug._color_jitter(k, jnp.asarray(x))) for k, x in zip(keys, img01)])
    jitter = _t(jnp.stack([_jitter_draws(k) for k in keys]))
    np.testing.assert_allclose(aug._color_jitter(_t(img01), jitter).numpy(), want, atol=JITTER_ATOL, rtol=0)


@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 48, 40)])
def test_augment_batch_with_jax_draws_matches_jax(shape):
    images = _normalized(np.random.default_rng(shape[1]), *shape)
    key = jax.random.PRNGKey(shape[1])
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(images)))
    got = aug.augment_batch(_t(images), params=_batch_draws(key, shape[0])).numpy()
    np.testing.assert_allclose(got, want, atol=BATCH_ATOL, rtol=0)
    assert not np.allclose(got, images)


def test_augment_batch_disabled_is_the_identity():
    images = _t(_normalized(np.random.default_rng(2), 2, 32, 32))
    assert aug.augment_batch(images, torch.Generator().manual_seed(0), enabled=False) is images


def test_sampled_params_are_deterministic_and_in_range():
    a = aug.sample_augment_params(64, torch.Generator().manual_seed(3))
    b = aug.sample_augment_params(64, torch.Generator().manual_seed(3))
    for f in ("row_scale", "col_offset", "jitter", "theta", "positive", "col_flip"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert ((a.row_scale >= 0.8 ** 0.5) & (a.row_scale < 1)).all()
    assert ((a.jitter[:, :3] >= 0.8) & (a.jitter[:, :3] < 1.2)).all() and (a.jitter[:, 3].abs() <= 0.1).all()
    assert 0 <= float(a.theta) < 5 * math.pi / 180 and a.positive.dtype == torch.bool
    assert 0 < int(a.positive.sum()) < 64 and 0 < int(a.col_flip.sum()) < 64
    images = _t(_normalized(np.random.default_rng(4), 3, 32, 32))
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert torch.equal(aug.augment_batch(images, g1), aug.augment_batch(images, g2))
