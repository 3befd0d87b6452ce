"""The port's tiny model against the JAX package's, with bridged weights (CPU, float32).

The JAX model is the shared ``tiny_model`` (tiny-vit + tiny-gpt2, conftest);
its parameters go through ``load_jax_params`` into the port. Compared:
``encode_image``, ``decode_prefix`` logits, three ``decode_step`` logits and
every layer's KV cache after each call. Tolerance atol 1e-4: float32 through
a few layers, sums taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.lm import init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

ATOL = 1e-4
B = 2


@pytest.fixture(scope="module")
def pair(tiny_model):
    port = PreferenceGuidedCaptioningModel(
        vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16,
        tokenizer=CaptionTokenizer(), max_caption_length=8, image_size=32, device="cpu",
    )
    port.load_jax_params(jax.tree.map(np.asarray, tiny_model.params))
    return tiny_model, port


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)


def _jax_apply(jm, method, *args):
    return jm.module.apply({"params": jm.params}, *args, method=method)


def test_encode_image_matches_jax(pair, images):
    jm, port = pair
    ref = _jax_apply(jm, jm.module.encode_image, jax_prepare_images(jnp.asarray(images)))
    out = port.encode_image(images)
    for key in ("features", "pooled_output", "embeddings"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)


def test_decode_prefix_and_steps_match_jax(pair, images):
    jm, port = pair
    cfg = port.module.decoder_config
    cache_len = 9
    emb_j = _jax_apply(jm, jm.module.encode_image, jax_prepare_images(jnp.asarray(images)))["embeddings"]
    emb_p = port.encode_image(images)["embeddings"]

    def mask_at(pos):
        return (np.arange(cache_len)[None, :] <= pos).astype(np.int32).repeat(B, 0)

    def check(name, logits_j, logits_p, caches_j, caches_p):
        assert logits_p.shape == (B, cfg.vocab_size)
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=ATOL, err_msg=name)
        # the port writes its caches in place: check them before the next call
        for layer, ((kj, vj), (kp, vp)) in enumerate(zip(caches_j, caches_p)):
            np.testing.assert_allclose(kp.numpy(), np.asarray(kj), atol=ATOL, err_msg=f"{name} k{layer}")
            np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, err_msg=f"{name} v{layer}")

    caches_j = jax_init_kv_cache(jm.module.decoder_config, B, cache_len, jnp.float32)
    caches_p = init_kv_cache(cfg, B, cache_len, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        logits_j, caches_j = _jax_apply(jm, "decode_prefix", emb_j, caches_j, jnp.asarray(mask_at(0)))
        logits_p, caches_p = port.module.decode_prefix(emb_p, caches_p, torch.from_numpy(mask_at(0)))
        check("prefix", logits_j, logits_p, caches_j, caches_p)
        for t in (1, 2, 3):
            tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)[:, None]
            logits_j, caches_j = _jax_apply(
                jm, "decode_step", jnp.asarray(tok), t, caches_j, jnp.asarray(mask_at(t)))
            logits_p, caches_p = port.module.decode_step(
                torch.from_numpy(tok).long(), t, caches_p, torch.from_numpy(mask_at(t)))
            check(f"step {t}", logits_j, logits_p, caches_j, caches_p)
