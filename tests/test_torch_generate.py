"""Greedy and sampled ``generate_captions`` of the port against the JAX package (CPU, float32).

Greedy decoding must be token-identical to the JAX package's, with
``early_stop`` off and on, including when EOS ends every row early. Sampling
is checked for shape and for determinism under a fixed seed only: the port
draws from a ``torch.Generator``, whose stream differs from ``jax.random``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.generation.decode import generate as jax_generate
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import generate
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

MAX_LENGTH = 8


def _port(params):
    port = PreferenceGuidedCaptioningModel(
        vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16,
        tokenizer=CaptionTokenizer(), max_caption_length=8, image_size=32, device="cpu",
    )
    port.load_jax_params(params)
    return port


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def params(tiny_model):
    return jax.tree.map(np.array, tiny_model.params)


@pytest.fixture(scope="module")
def eos_params(params, tiny_model, images):
    """Weights under which every row emits EOS before ``MAX_LENGTH``.

    EOS's tied embedding becomes a scaled copy of the embedding of a token
    that both rows' greedy captions contain, so EOS outscores that token.
    """
    tied = jax.tree.map(np.array, params)
    greedy = _jax_ids(tiny_model, jax.tree.map(jnp.asarray, params), images, early_stop=False)
    common = sorted(set(greedy[0]) & set(greedy[1]))
    assert common, "the two greedy captions share no token; pick other images"
    wte = tied["caption_decoder"]["lm"]["wte"]["embedding"]
    wte[tiny_model.tokenizer.eos_token_id] = 1.2 * wte[common[0]]
    return tied


def _jax_ids(jm, jparams, images, early_stop):
    emb = jm.module.apply(
        {"params": jparams}, jax_prepare_images(jnp.asarray(images)), method=jm.module.encode_image
    )["embeddings"]
    return np.asarray(jax_generate(
        jm.module, jparams, emb, bos_token_id=jm.tokenizer.bos_token_id,
        eos_token_id=jm.tokenizer.eos_token_id, pad_token_id=jm.tokenizer.pad_token_id,
        max_length=MAX_LENGTH, early_stop=early_stop,
    ))


@pytest.mark.parametrize("weights", ["random", "eos"])
@pytest.mark.parametrize("early_stop", [False, True])
def test_greedy_is_token_identical_to_jax(tiny_model, params, eos_params, images, weights, early_stop):
    p = params if weights == "random" else eos_params
    port = _port(p)
    steps = []
    decode_step = port.module.decode_step
    port.module.decode_step = lambda *a: steps.append(1) or decode_step(*a)

    want = _jax_ids(tiny_model, jax.tree.map(jnp.asarray, p), images, early_stop)
    emb = port.encode_image(images)["embeddings"]
    got = generate(
        port.module, emb, eos_token_id=port.tokenizer.eos_token_id,
        pad_token_id=port.tokenizer.pad_token_id, max_length=MAX_LENGTH, early_stop=early_stop,
    ).numpy()
    np.testing.assert_array_equal(got, want)

    eos = port.tokenizer.eos_token_id
    if weights == "eos":
        assert (want == eos).any(axis=1).all()
    if early_stop and weights == "eos":  # the loop ended once every row had emitted EOS
        last_eos = max(int(np.argmax(row == eos)) for row in want)
        assert len(steps) == last_eos
    else:
        assert len(steps) == MAX_LENGTH - 1

    jm_params, tiny_model.params = tiny_model.params, jax.tree.map(jnp.asarray, p)
    try:
        want_text = tiny_model.generate_captions(images, max_length=MAX_LENGTH, early_stop=early_stop)
    finally:
        tiny_model.params = jm_params
    assert port.generate_captions(images, max_length=MAX_LENGTH, early_stop=early_stop) == want_text


def test_sampling_is_deterministic_under_a_seed(params, images):
    port = _port(params)
    kwargs = dict(max_length=MAX_LENGTH, do_sample=True, temperature=0.8, top_p=0.9,
                  repetition_penalty=1.2, seed=7)
    first = port.generate_captions(images, **kwargs)
    assert len(first) == len(images) and all(isinstance(c, str) for c in first)
    assert port.generate_captions(images, **kwargs) == first
    emb = port.encode_image(images)["embeddings"]
    ids = [
        generate(port.module, emb, eos_token_id=port.tokenizer.eos_token_id,
                 pad_token_id=port.tokenizer.pad_token_id, max_length=MAX_LENGTH, do_sample=True,
                 generator=torch.Generator().manual_seed(7))
        for _ in range(2)
    ]
    assert ids[0].shape == (len(images), MAX_LENGTH)
    assert torch.equal(ids[0], ids[1])
    assert ((ids[0] >= 0) & (ids[0] < port.module.decoder_config.vocab_size)).all()


def test_beam_search_is_not_ported_yet(params, images):
    with pytest.raises(NotImplementedError, match="beam"):
        _port(params).generate_captions(images, max_length=MAX_LENGTH, num_beams=2)
