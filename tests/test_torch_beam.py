"""Beam search of the port against the JAX package's (CPU, float32): token ids identical.

The same weights (bridged with ``load_jax_params``) and the same vision
embeddings go through JAX ``generate(num_beams=k)`` and the port's, for k = 2,
3 and 4, ``early_stop`` off and on, length penalties -0.5, 0 and 1, and
repetition penalties 1 and 1.1; under three sets of weights: random, EOS the
first token of some rows (so first-token hypotheses enter the finished pool
at length 1 and their beams may continue with PAD only), and EOS a copy of a
common token (so many candidates finish and the live set fills with
``NEG_INF`` ties). Tolerance: none, the ids must be equal. Mirrors
tests/test_generation.py:95-160, including beam 1 through the forced
``_beam_search`` equal to greedy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.generation.decode import _beam_search as jax_beam_search
from pgica_tpu.generation.decode import generate as jax_generate
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import _beam_search, _top_k, generate
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

MAX_LENGTH = 10
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, max_caption_length=8,
            image_size=32)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)


def _embeddings(jm, params, images):
    return jm.module.apply({"params": jax.tree.map(jnp.asarray, params)},
                           jax_prepare_images(jnp.asarray(images)), method=jm.module.encode_image)["embeddings"]


def _jax_ids(jm, params, emb, **kw):
    tok = jm.tokenizer
    return np.asarray(jax_generate(
        jm.module, jax.tree.map(jnp.asarray, params), emb, bos_token_id=tok.bos_token_id,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, max_length=MAX_LENGTH, **kw))


def _port(params):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY)
    port.load_jax_params(params)
    return port


def _port_ids(port, emb, **kw):
    tok = port.tokenizer
    return generate(port.module, torch.from_numpy(np.array(emb)), eos_token_id=tok.eos_token_id,
                    pad_token_id=tok.pad_token_id, max_length=MAX_LENGTH, **kw).numpy()


@pytest.fixture(scope="module")
def weights(tiny_model, images):
    """name -> (JAX parameter tree as numpy, its port model)."""
    base = jax.tree.map(np.array, tiny_model.params)
    eos = tiny_model.tokenizer.eos_token_id
    emb = _embeddings(tiny_model, base, images)
    greedy = _jax_ids(tiny_model, base, emb)
    out = {"random": base}
    first = jax.tree.map(np.array, base)  # EOS outscores row 0's greedy first token
    wte = first["caption_decoder"]["lm"]["wte"]["embedding"]
    wte[eos] = 1.5 * wte[greedy[0, 0]]
    out["eos_first"] = first
    common = jax.tree.map(np.array, base)  # EOS outscores the token the greedy captions use most
    wte = common["caption_decoder"]["lm"]["wte"]["embedding"]
    wte[eos] = 1.2 * wte[np.bincount(greedy.ravel()).argmax()]
    out["eos_common"] = common
    return {name: (p, _port(p)) for name, p in out.items()}


@pytest.mark.parametrize("length_penalty", [-0.5, 0.0, 1.0])
@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("num_beams", [2, 3, 4])
@pytest.mark.parametrize("which", ["random", "eos_first", "eos_common"])
def test_beam_search_is_token_identical_to_jax(tiny_model, weights, images, which, num_beams, early_stop,
                                               length_penalty):
    params, port = weights[which]
    emb = _embeddings(tiny_model, params, images)
    eos = tiny_model.tokenizer.eos_token_id
    for repetition_penalty in (1.0, 1.1):
        kw = dict(num_beams=num_beams, early_stop=early_stop, length_penalty=length_penalty,
                  repetition_penalty=repetition_penalty)
        want = _jax_ids(tiny_model, params, emb, **kw)
        np.testing.assert_array_equal(_port_ids(port, emb, **kw), want, err_msg=str(kw))
        if which != "random":
            assert (want == eos).any(), "no caption ended on EOS; the weights do not force it"


def test_first_token_eos_enters_the_pool_at_length_one(tiny_model, weights, images):
    """Under ``eos_first`` with length penalty 1 the length-1 hypothesis [EOS] wins row 0: its
    normalized score beats every longer one. Both packages pick it."""
    params, port = weights["eos_first"]
    emb = _embeddings(tiny_model, params, images)
    kw = dict(num_beams=4, length_penalty=1.0)
    want = _jax_ids(tiny_model, params, emb, **kw)
    got = _port_ids(port, emb, **kw)
    np.testing.assert_array_equal(got, want)
    pad, eos = tiny_model.tokenizer.pad_token_id, tiny_model.tokenizer.eos_token_id
    assert got[0, 0] == eos and (got[0, 1:] == pad).all()


def test_beam_one_is_greedy(tiny_model, weights, images):
    params, port = weights["random"]
    emb = _embeddings(tiny_model, params, images)
    tok = port.tokenizer
    greedy = _port_ids(port, emb)
    np.testing.assert_array_equal(greedy, _jax_ids(tiny_model, params, emb))
    np.testing.assert_array_equal(_port_ids(port, emb, num_beams=1), greedy)
    forced = _beam_search(port.module, torch.from_numpy(np.array(emb)), 1.0, max_length=MAX_LENGTH,
                          num_beams=1, length_penalty=1.0, eos_token_id=tok.eos_token_id,
                          pad_token_id=tok.pad_token_id).numpy()
    np.testing.assert_array_equal(forced, greedy)
    jax_forced = np.asarray(jax_beam_search(
        tiny_model.module, jax.tree.map(jnp.asarray, params), emb, 1.0, max_length=MAX_LENGTH, num_beams=1,
        length_penalty=1.0, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id))
    np.testing.assert_array_equal(forced, jax_forced)


def test_beam_search_ignores_the_sampling_flags(tiny_model, weights, images):
    params, port = weights["random"]
    emb = _embeddings(tiny_model, params, images)
    plain = _port_ids(port, emb, num_beams=3)
    sampled = _port_ids(port, emb, num_beams=3, do_sample=True, temperature=0.5, top_p=0.5,
                        generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(sampled, plain)


@pytest.mark.parametrize("early_stop", [False, True])
def test_generate_captions_with_beams_matches_jax(tiny_model, weights, images, early_stop):
    params, port = weights["eos_common"]
    kw = dict(max_length=MAX_LENGTH, num_beams=4, repetition_penalty=1.1, length_penalty=1.0,
              early_stop=early_stop)
    saved, tiny_model.params = tiny_model.params, jax.tree.map(jnp.asarray, params)
    try:
        want = tiny_model.generate_captions(images, **kw)
    finally:
        tiny_model.params = saved
    assert port.generate_captions(images, **kw) == want


@pytest.mark.parametrize("shape, k", [((2, 40), 8), ((3, 7), 7), ((1, 600), 6)])
def test_top_k_breaks_ties_toward_the_lower_index_as_jax(shape, k):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(0, 3, size=shape).astype(np.float32)  # few distinct values: ties everywhere
    x[:, ::5] = -1e9
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = _top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_early_stop_ends_the_loop_early_with_the_same_ids(tiny_model, weights, images):
    """With EOS common the pool soon holds hypotheses no live beam can beat: fewer decoder steps."""
    params, port = weights["eos_common"]
    emb = _embeddings(tiny_model, params, images)
    steps = []
    decode_step = port.module.decode_step
    port.module.decode_step = lambda *a: steps.append(1) or decode_step(*a)
    try:
        full = _port_ids(port, emb, num_beams=2, length_penalty=0.0)
        n_full = len(steps)
        early = _port_ids(port, emb, num_beams=2, length_penalty=0.0, early_stop=True)
    finally:
        port.module.decode_step = decode_step
    np.testing.assert_array_equal(early, full)
    assert n_full == MAX_LENGTH - 1 and len(steps) - n_full < n_full
