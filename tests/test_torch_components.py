"""The port's loss components, fused NT-Xent, cross-attention at decode and purpose seeds
against the JAX package's, on the CPU.

* ``ntxent_loss_fused``: loss within 1e-6 and both gradients within 1e-5 of
  JAX's ``ntxent_loss_fused`` and of the port's ``ntxent_loss`` (float32;
  the fused path's plain version on the CPU computes the same logits).
* ``ops/components.py``: ``TemperatureScaledSimilarity`` and
  ``ContrastiveLossModule`` with their ``log_temperature`` bridged from the
  JAX parameters (1e-6; the temperature's gradient 1e-5), and
  ``nan_safe_gradients``.
* ``cross_attend_at_decode``: the decoder's prefix and three step logits
  with the vision embeddings fused in, within 1e-5 of JAX's decoder built
  with the flag.
* ``core/prng.py``: the purpose ids are JAX's; seeds are reproducible and do
  not depend on the order of the calls; the trainer's stage seeds and
  step generators are these.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.core.prng import PURPOSES as JAX_PURPOSES
from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.models.decoder import CaptionDecoder as JaxCaptionDecoder
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu.ops import components as jcomponents
from pgica_tpu.ops.losses import ntxent_loss_fused as jax_ntxent_loss_fused
from pgica_tpu_torch.core import prng
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.convert import load_jax_params
from pgica_tpu_torch.models.lm import init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
from pgica_tpu_torch.ops import components
from pgica_tpu_torch.ops.losses import ntxent_loss, ntxent_loss_fused
from pgica_tpu_torch.training import train_step, trainer

LOSS_TOL = 1e-6
GRAD_TOL = 1e-5
LOGIT_TOL = 1e-5


def _embeddings(b: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    img, txt = (rng.normal(size=(b, d)).astype(np.float32) for _ in range(2))
    return img / np.linalg.norm(img, axis=1, keepdims=True), txt / np.linalg.norm(txt, axis=1, keepdims=True)


# ------------------------------------------------------------------ fused NT-Xent


@pytest.mark.parametrize("b, d, temperature", [(8, 16, 0.5), (37, 32, 0.07), (100, 8, 1.0)])
def test_ntxent_loss_fused_matches_jax_and_the_plain_loss(b, d, temperature):
    img, txt = _embeddings(b, d, seed=b)

    def jax_loss(i, t):
        loss, metrics = jax_ntxent_loss_fused(i, t, temperature)
        return loss, metrics

    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(img), jnp.asarray(txt))
    timg, ttxt = (torch.from_numpy(x).requires_grad_() for x in (img, txt))
    loss, metrics = ntxent_loss_fused(timg, ttxt, temperature)
    grads = torch.autograd.grad(loss, (timg, ttxt))
    assert set(metrics) == set(jmetrics) == {"loss_i2t", "loss_t2i"}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=LOSS_TOL, err_msg=key)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=GRAD_TOL)

    plain, plain_metrics = ntxent_loss(timg, ttxt, temperature)
    plain_grads = torch.autograd.grad(plain, (timg, ttxt))
    np.testing.assert_allclose(loss.item(), plain.item(), rtol=LOSS_TOL)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), plain_metrics[key].item(), rtol=LOSS_TOL, err_msg=key)
    for g, pg in zip(grads, plain_grads):
        np.testing.assert_allclose(g.numpy(), pg.numpy(), atol=GRAD_TOL)


def test_ntxent_loss_fused_sums_both_gradients_of_one_tensor():
    """One tensor as both modalities: h in one direction, W in the other; autograd sums the two."""
    img, _ = _embeddings(6, 16, seed=1)
    x = torch.from_numpy(img).requires_grad_()
    y = torch.from_numpy(img.copy()).requires_grad_()
    loss, _ = ntxent_loss_fused(x, x, 0.5)
    (gx,) = torch.autograd.grad(loss, (x,))
    loss2, _ = ntxent_loss_fused(x, y, 0.5)
    gx2, gy2 = torch.autograd.grad(loss2, (x, y))
    np.testing.assert_allclose(gx.numpy(), (gx2 + gy2).numpy(), atol=GRAD_TOL)


def test_ntxent_loss_fused_raises_on_a_device_axis():
    """An axis name with no active mesh raises, as JAX's unbound axis name (global negatives:
    tests/test_torch_parallel.py)."""
    img, txt = (torch.from_numpy(x) for x in _embeddings(4, 8, seed=2))
    with pytest.raises(ValueError, match="unbound axis name"):
        ntxent_loss_fused(img, txt, 0.5, axis_name="data")


# ------------------------------------------------------------------ components


def _jax_similarity(initial: float, learnable: bool, img, txt):
    mod = jcomponents.TemperatureScaledSimilarity(initial_temperature=initial, learnable=learnable)
    variables = mod.init(jax.random.PRNGKey(0), img, txt)
    return mod, variables


@pytest.mark.parametrize("initial, learnable", [(0.5, True), (0.05, True), (3.0, True), (0.01, False), (0.7, False)])
def test_temperature_scaled_similarity_matches_jax(initial, learnable):
    img, txt = _embeddings(5, 8, seed=3)
    img, txt = img * 3.0, txt * 0.5  # unnormalized: the module normalizes
    jmod, variables = _jax_similarity(initial, learnable, jnp.asarray(img), jnp.asarray(txt))
    mod = components.TemperatureScaledSimilarity(initial, learnable)
    if learnable:
        load_jax_params(mod, jax.tree.map(np.asarray, variables["params"]))
        assert mod.log_temperature.item() == float(variables["params"]["log_temperature"])
        assert mod.current_temperature() == pytest.approx(jmod.current_temperature(variables["params"]), rel=1e-7)
    else:
        assert not list(mod.parameters())
        assert mod.current_temperature() == pytest.approx(jmod.current_temperature({}), rel=1e-7)
    sim = mod(torch.from_numpy(img), torch.from_numpy(txt))
    np.testing.assert_allclose(sim.detach().numpy(), np.asarray(jmod.apply(variables, img, txt)), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    if learnable:
        def jloss(params):
            return jnp.sum(jmod.apply({"params": params}, img, txt) ** 2)

        jg = jax.grad(jloss)(variables["params"])["log_temperature"]
        (g,) = torch.autograd.grad((sim ** 2).sum(), (mod.log_temperature,))
        np.testing.assert_allclose(g.item(), float(jg), rtol=GRAD_TOL, atol=GRAD_TOL)
        # clamped temperatures pass no gradient, in both packages
        assert (g.item() == 0.0) == (float(jg) == 0.0) == (not 0.1 <= initial <= 2.0)


def test_contrastive_loss_module_matches_jax():
    img, txt = _embeddings(7, 16, seed=4)
    jmod = jcomponents.ContrastiveLossModule(initial_temperature=0.3)
    variables = jmod.init(jax.random.PRNGKey(0), img, txt)
    jloss, jmetrics = jmod.apply(variables, img, txt)
    mod = components.ContrastiveLossModule(initial_temperature=0.3)
    load_jax_params(mod, jax.tree.map(np.asarray, variables["params"]))
    loss, metrics = mod(torch.from_numpy(img), torch.from_numpy(txt))
    assert set(metrics) == set(jmetrics)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=LOSS_TOL, err_msg=key)
    assert 0 <= metrics["accuracy"].item() <= 1


@pytest.mark.parametrize("max_norm", [None, 1.0, 100.0])
def test_nan_safe_gradients_match_jax(max_norm):
    rng = np.random.default_rng(5)
    grads = {"w": rng.normal(size=(4, 3)).astype(np.float32) * 10, "b": rng.normal(size=(3,)).astype(np.float32)}
    jclipped, jnorm, jfinite = jcomponents.nan_safe_gradients(jax.tree.map(jnp.asarray, grads), max_norm)
    for form in ("dict", "list"):
        tgrads = {k: torch.from_numpy(v) for k, v in grads.items()}
        given = tgrads if form == "dict" else list(tgrads.values())
        clipped, norm, finite = components.nan_safe_gradients(given, max_norm)
        assert isinstance(norm, torch.Tensor) and isinstance(finite, torch.Tensor) and bool(finite) == bool(jfinite)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=LOSS_TOL)
        out = clipped if form == "dict" else dict(zip(grads, clipped))
        for k in grads:
            np.testing.assert_allclose(out[k].numpy(), np.asarray(jclipped[k]), rtol=GRAD_TOL, atol=GRAD_TOL)
    bad = {"w": torch.tensor([1.0, float("nan"), 1.0])}
    _, _, finite = components.nan_safe_gradients(bad)
    _, _, jfinite = jcomponents.nan_safe_gradients({"w": jnp.asarray([1.0, jnp.nan, 1.0])})
    assert not bool(finite) and not bool(jfinite)


# ------------------------------------------------------------------ cross-attention at decode


def test_cross_attend_at_decode_matches_jax(tiny_model):
    jm = tiny_model
    port = PreferenceGuidedCaptioningModel(
        vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, tokenizer=CaptionTokenizer(),
        max_caption_length=8, image_size=32, device="cpu")
    port.load_jax_params(jax.tree.map(np.asarray, jm.params))
    cfg = port.module.decoder_config
    jdec = JaxCaptionDecoder(jm.module.decoder_config, 16, cross_attend_at_decode=True)
    jparams = {"params": jm.params["caption_decoder"]}
    b, cache_len = 2, 9
    images = np.random.default_rng(6).integers(0, 256, size=(b, 32, 32, 3), dtype=np.uint8)
    emb_j = jm.module.apply({"params": jm.params}, jax_prepare_images(jnp.asarray(images)),
                            method=jm.module.encode_image)["embeddings"]
    emb_p = port.encode_image(images)["embeddings"]
    dec = port.module.caption_decoder
    assert dec.cross_attend_at_decode is False  # off by default, as in JAX

    def mask_at(pos):
        return (np.arange(cache_len)[None, :] <= pos).astype(np.int32).repeat(b, 0)

    caches_j = jax_init_kv_cache(jm.module.decoder_config, b, cache_len, jnp.float32)
    caches_p = init_kv_cache(cfg, b, cache_len, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        logits_j, caches_j = jdec.apply(jparams, emb_j, caches_j, jnp.asarray(mask_at(0)), method=jdec.decode_prefix)
        logits_p, caches_p = port.module.decode_prefix(emb_p, caches_p, torch.from_numpy(mask_at(0)))
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=LOGIT_TOL)
        for t in (1, 2, 3):
            tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)[:, None]
            logits_j, caches_j = jdec.apply(jparams, jnp.asarray(tok), t, caches_j, jnp.asarray(mask_at(t)), emb_j,
                                            method=jdec.decode_step)
            dec.cross_attend_at_decode = True
            plain_caches = [tuple(x.clone() for x in kv) for kv in caches_p]
            without, _ = port.module.decode_step(torch.from_numpy(tok).long(), t, plain_caches,
                                                 torch.from_numpy(mask_at(t)))  # no embeddings: no fusion
            logits_p, caches_p = port.module.decode_step(torch.from_numpy(tok).long(), t, caches_p,
                                                         torch.from_numpy(mask_at(t)), emb_p)
            dec.cross_attend_at_decode = False
            np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=LOGIT_TOL, err_msg=f"step {t}")
            assert not torch.allclose(without, logits_p, atol=1e-3)


# ------------------------------------------------------------------ purpose seeds


def test_purposes_are_jax_and_seeds_are_reproducible_and_order_free():
    assert prng.PURPOSES == JAX_PURPOSES
    seeds = {p: prng.purpose_seed(42, p) for p in prng.PURPOSES}
    assert len(set(seeds.values())) == len(seeds) and all(0 <= s < 2 ** 32 for s in seeds.values())
    assert seeds == {p: prng.purpose_seed(42, p) for p in reversed(list(prng.PURPOSES))}
    assert prng.purpose_seed(43, "dropout") != seeds["dropout"]
    with pytest.raises(KeyError, match="unknown purpose"):
        prng.purpose_seed(42, "nonsense")

    def draws(order):
        return {(p, s): torch.rand(4, generator=prng.step_generator(42, p, s)) for p, s in order}

    keys = [(p, s) for p in ("dropout", "sampling", "train_stage1") for s in (0, 1, 7)]
    forward, backward = draws(keys), draws(reversed(keys))
    assert all(torch.equal(forward[k], backward[k]) for k in keys)
    assert len({tuple(v.tolist()) for v in forward.values()}) == len(keys)


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_stage_seeds_and_step_generators_are_the_purpose_streams(stage):
    seed = trainer.stage_seed(42, stage)
    assert seed == prng.purpose_seed(42, f"train_stage{stage}")
    for step in (0, 3):
        want = torch.rand(5, generator=train_step.step_generator(torch.device("cpu"), seed, step))
        got = torch.rand(5, generator=prng.step_generator(42, f"train_stage{stage}", step))
        assert torch.equal(got, want)
