"""Greedy and sampled ``generate_captions`` of the port against the JAX package (CPU, float32).

Greedy decoding must be token-identical to the JAX package's, with
``early_stop`` off and on, including when EOS ends every row early. Sampling
is checked for shape and for determinism under a fixed seed only: the port
draws from a ``torch.Generator``, whose stream differs from ``jax.random``'s.
A bf16 model serves a cast copy of its float32 masters; after training
updates the masters in place it must serve the trained weights (exactly
the JAX package's ``_inference_params`` cast of the same masters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.generation.decode import generate as jax_generate
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import make_stage0_train_step as jax_make_stage0_train_step
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import generate
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.training.optim import create_optimizer
from pgica_tpu_torch.training.train_step import TrainState, make_stage0_train_step

MAX_LENGTH = 8
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, max_caption_length=8,
            image_size=32)


def _port(params, dtype=torch.float32):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), dtype=dtype, device="cpu", **TINY)
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


# ---- the bf16 serving copy after training (stage 0 trains the decoder, the weights serving reads)

STAGE0_LR, STAGE0_UPDATES = 1e-2, 4  # the schedule's first update has lr 0 (warmup 2 of 10)


def _captions(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, MAX_LENGTH + 1, size=3)
    return {"image": rng.integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8),
            "caption_ids": rng.integers(0, 261, size=(3, MAX_LENGTH)).astype(np.int32),
            "caption_mask": (np.arange(MAX_LENGTH)[None, :] < lengths[:, None]).astype(np.int32)}


def _greedy_ids(port, module, images):
    emb = module.encode_image(prepare_images(torch.from_numpy(images)))["embeddings"]
    return generate(module, emb, eos_token_id=port.tokenizer.eos_token_id,
                    pad_token_id=port.tokenizer.pad_token_id, max_length=MAX_LENGTH)


def test_bf16_serving_copy_follows_in_place_training(params, images):
    """Generate (the bf16 copy is cast and cached), train the masters in place, generate again:
    the ids are those of a fresh cast of the trained masters."""
    port = _port(params, torch.bfloat16)
    before = port.generate_captions(images, max_length=MAX_LENGTH)
    with torch.no_grad():
        ids_before = _greedy_ids(port, port._inference_module(), images)
    opt = create_optimizer(STAGE0_LR, 10, 2, freeze_vision_backbone=True)
    state = TrainState.create(port.module, opt)
    step = make_stage0_train_step(port.module, opt)
    for i in range(STAGE0_UPDATES):
        state, _ = step(state, _captions(60 + i), 0)
    with torch.no_grad():
        got = _greedy_ids(port, port._inference_module(), images)
        want = _greedy_ids(port, frozen_copy(port.module, torch.bfloat16), images)
    assert torch.equal(got, want)
    assert not torch.equal(got, ids_before), "training left the greedy ids as they were; train harder"
    fresh = _port(params, torch.bfloat16)
    fresh.module.load_state_dict(port.module.state_dict())
    after = port.generate_captions(images, max_length=MAX_LENGTH)
    assert after == fresh.generate_captions(images, max_length=MAX_LENGTH) and after != before


def test_bf16_serving_copy_is_jax_inference_params_after_training(params, images):
    """The JAX model takes stage-0 updates from the same weights and replaces its params (as its
    trainer does); the port's masters take the same values in place, as an optimizer writes them.
    Then both serve the same bf16 weights, bit for bit."""
    jm = JaxModel(tokenizer=JaxTokenizer(), seed=0, dtype=jnp.bfloat16, **TINY)
    jm.params = jax.tree.map(jnp.asarray, params)
    port = _port(params, torch.bfloat16)
    port.generate_captions(images, max_length=MAX_LENGTH)  # the copy of the untrained masters is cached
    jax_served_before = jm._inference_params()
    jopt = jax_create_optimizer(STAGE0_LR, total_steps=10, warmup_steps=2, params_for_freezing=jm.params,
                                freeze_vision_backbone=True)
    jstate = JaxTrainState.create(jm.params, jopt)
    jstep = jax.jit(jax_make_stage0_train_step(jm.module, jopt, augment=False))
    for i in range(STAGE0_UPDATES):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in _captions(60 + i).items()}, jax.random.PRNGKey(0))
    jm.params = jstate.params
    assert jm._inference_params() is not jax_served_before  # JAX re-casts for the new params
    trained = _port(jax.tree.map(np.asarray, jstate.params)).module.state_dict()
    with torch.no_grad():
        for name, p in port.module.named_parameters():
            p.copy_(trained[name])
    want = _port(jax.tree.map(lambda x: np.asarray(x, dtype=np.float32), jm._inference_params()))
    want = dict(want.module.named_parameters())
    for name, p in port._inference_module().named_parameters():
        assert torch.equal(p.float(), want[name]), name
    untrained = torch.from_numpy(params["caption_decoder"]["lm"]["wte"]["embedding"]).to(torch.bfloat16)
    assert not torch.equal(port._inference_module().caption_decoder.lm.wte.weight, untrained)
