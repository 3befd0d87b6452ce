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
``_beam_search`` equal to greedy. The port's step swaps its cache and
presence buffers each step (A to B at odd t, B to A at even t): searches of
6 and 7 steps end in either buffer, and equal JAX's too. The beam step
reads nothing back to the host (the card replays it as a CUDA graph): it
runs under ``FakeTensorMode``, where a data-dependent read raises, and a
step with such a read put back fails there. The beam keys of one shape
share its buffers, each with its own scoring, and each key's search on them
still equals JAX's; shapes past ``DecodeGraphs.beam_shapes`` are dropped,
the least recently used first, and their buffers freed.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import DataDependentOutputException, FakeTensorMode

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.generation.decode import _beam_search as jax_beam_search
from pgica_tpu.generation.decode import generate as jax_generate
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import (
    _beam_finalize,
    _beam_init,
    _beam_search,
    _top_k,
    beam_graphs,
    beam_step,
    generate,
    init_beam_state,
)
from pgica_tpu_torch.generation.slots import DecodeGraphs
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


def _jax_ids(jm, params, emb, max_length=MAX_LENGTH, **kw):
    tok = jm.tokenizer
    return np.asarray(jax_generate(
        jm.module, jax.tree.map(jnp.asarray, params), emb, bos_token_id=tok.bos_token_id,
        eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, max_length=max_length, **kw))


def _port(params):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY)
    port.load_jax_params(params)
    return port


def _port_ids(port, emb, max_length=MAX_LENGTH, **kw):
    tok = port.tokenizer
    return generate(port.module, torch.from_numpy(np.array(emb)), eos_token_id=tok.eos_token_id,
                    pad_token_id=tok.pad_token_id, max_length=max_length, **kw).numpy()


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


@pytest.mark.parametrize("max_length", [7, 8], ids=["6 steps, ends in A", "7 steps, ends in B"])
@pytest.mark.parametrize("which", ["random", "eos_common"])
def test_beam_search_ends_in_either_buffer_as_jax(tiny_model, weights, images, which, max_length):
    """The last step writes buffer A (an even count of steps) or B (odd): ids equal JAX's either way."""
    params, port = weights[which]
    emb = _embeddings(tiny_model, params, images)
    kw = dict(num_beams=3, length_penalty=1.0, repetition_penalty=1.1, max_length=max_length)
    np.testing.assert_array_equal(_port_ids(port, emb, **kw), _jax_ids(tiny_model, params, emb, **kw), err_msg=str(kw))


def _fake_beam_steps(module, tok, steps: int = 2) -> None:
    """The prefix, then ``steps`` beam steps (both buffer directions) under FakeTensorMode: every tensor
    made inside is fake, and reading one's value on the host raises DataDependentOutputException."""
    with torch.inference_mode(), FakeTensorMode(allow_non_fake_inputs=True):
        state = init_beam_state(module.decoder_config, 2, 3, MAX_LENGTH, torch.float32, torch.device("cpu"),
                                length_penalty=1.0, repetition_penalty=1.1, eos_token_id=tok.eos_token_id,
                                pad_token_id=tok.pad_token_id)
        _beam_init(module, state, torch.zeros(2, 16))
        for t in range(1, steps + 1):
            beam_step(module, state, t % 2 == 1)


def test_beam_step_reads_nothing_back_to_the_host(weights):
    _, port = weights["random"]
    _fake_beam_steps(port.module, port.tokenizer)


def test_a_host_read_in_the_beam_step_fails_the_check(weights, monkeypatch):
    """The check catches a read: the step's position turned back into a host int (``int(t)``)."""
    _, port = weights["random"]
    module = port.module
    decode_step = module.decode_step
    monkeypatch.setattr(module, "decode_step",
                        lambda tokens, position, *rest: decode_step(tokens, int(position[0]), *rest))
    with pytest.raises(DataDependentOutputException):
        _fake_beam_steps(module, port.tokenizer)


def _search_on(module, state, emb) -> np.ndarray:
    """A whole eager search on a given state (a key's of ``DecodeGraphs.beams``)."""
    with torch.inference_mode():
        _beam_init(module, state, torch.from_numpy(np.array(emb)))
        for t in range(1, state.live_seqs.shape[2]):
            beam_step(module, state, t % 2 == 1)
        return _beam_finalize(state).numpy()


def test_beam_keys_of_one_shape_share_its_buffers(tiny_model, weights, images):
    """Two scorings of one beam shape: one set of buffers (caches, presence, beams), each key its own
    length-penalty table and penalties; a search on either key's state equals JAX's, the second
    running after the first on the same buffers."""
    params, port = weights["eos_common"]
    emb = _embeddings(tiny_model, params, images)
    tok = port.tokenizer
    graphs = DecodeGraphs(port.module, torch.device("cpu"))
    scorings = [(1.0, 1.0), (-0.5, 1.1)]
    keys = [beam_graphs(graphs, 3, MAX_LENGTH, 3, lp, rp, tok.eos_token_id, tok.pad_token_id) for lp, rp in scorings]
    a, b = (k.state for k in keys)
    assert len(graphs.beams) == 2
    for name in ("cache_buffers", "presence"):
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert x is y, name
    assert a.live_seqs is b.live_seqs and a.t is b.t
    assert not torch.equal(a.lp_table, b.lp_table) and (a.repetition_penalty, b.repetition_penalty) == (1.0, 1.1)
    for (lp, rp), key in zip(scorings * 2, keys * 2):
        want = _jax_ids(tiny_model, params, emb, num_beams=3, length_penalty=lp, repetition_penalty=rp)
        np.testing.assert_array_equal(_search_on(port.module, key.state, emb), want, err_msg=str((lp, rp)))


def test_beam_shapes_past_the_bound_are_dropped(weights):
    """``beam_shapes`` 2: a third shape drops the least recently used one, every key of it, and frees
    its buffers; a key used again counts as recent."""
    _, port = weights["random"]
    tok = port.tokenizer
    graphs = DecodeGraphs(port.module, torch.device("cpu"), beam_shapes=2)

    def key(batch: int, lp: float = 1.0) -> object:
        return beam_graphs(graphs, batch, MAX_LENGTH, 2, lp, 1.0, tok.eos_token_id, tok.pad_token_id)

    key(1)
    dropped = weakref.ref(key(2).state.cache_buffers[0])
    key(2, 0.5)
    key(1)  # shape 1 is now the most recent
    key(3)
    gc.collect()
    assert sorted(k[0] for k in graphs.beams) == [1, 3]
    assert dropped() is None, "the dropped shape's caches are still held"
    key(1, 0.5)
    key(2)
    assert sorted({k[0] for k in graphs.beams}) == [1, 2]


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
