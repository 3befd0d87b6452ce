"""The port wrapper's entry points against the JAX wrapper's, on the CPU (float32).

``__call__`` (the reference-parity API, JAX model.py:352-364) in
contrastive, generation (with labels and the loss, and without labels) and
dual modes at batch 1 and 3, as tests/test_model.py:117-171 drives the JAX
wrapper, with the caption mask given and left out; ``compute_similarity``
and ``encode_image``. The JAX tiny model's weights are bridged into the port
(``load_jax_params``); every output within 1e-5 of JAX's (float32 through a
few layers, sums in another order: the largest difference seen is ~1.2e-6).
A bad mode and missing caption ids raise ``ValueError`` in both.

On the CPU the entries run their functions over the static buffers of
their graph keys (training/graphs.py:GraphedCalls), one key per entry, mode,
input shapes and dtypes, and labels or not. After an in-place update of the
masters the same keys must give the new weights' results: against JAX on
the new weights in float32, and in bf16 against the rebuilt serving copy run
eagerly, bit for bit (the entries' graphs dropped with the old copy).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

SEQ, IMG, PROJ, VOCAB = 8, 32, 16, 261
ATOL = 1e-5
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, max_caption_length=SEQ,
            image_size=IMG)
MODES = {"contrastive": ("image_embeddings", "text_embeddings", "vision_embeddings"),
         "generation": ("logits", "loss", "vision_embeddings"),
         "dual": ("image_embeddings", "text_embeddings", "logits", "loss", "vision_embeddings")}


@pytest.fixture(scope="module")
def pair():
    jm = JaxModel(tokenizer=JaxTokenizer(), seed=0, dropout=0.0, **TINY)
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=1, dropout=0.1, **TINY)
    port.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, port


def _inputs(batch: int, seed: int = 0):
    rng = np.random.default_rng(seed + batch)
    images = rng.integers(0, 256, size=(batch, IMG, IMG, 3), dtype=np.uint8)
    ids = rng.integers(0, VOCAB, size=(batch, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None, :] < rng.integers(2, SEQ + 1, size=batch)[:, None]).astype(np.int32)
    return images, ids, mask


def _close(got: dict, want: dict, where: str) -> None:
    assert sorted(got) == sorted(want), where
    for k in want:
        w = np.asarray(want[k])
        assert isinstance(got[k], np.ndarray) and got[k].shape == w.shape, f"{where}: {k}"
        np.testing.assert_allclose(got[k], w, atol=ATOL, rtol=0, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_call_matches_the_jax_wrapper(pair, mode, batch):
    jm, port = pair
    images, ids, mask = _inputs(batch)
    labels = ids if mode != "contrastive" else None
    want = jm(images, ids, mask, labels=labels, mode=mode)
    got = port(images, ids, mask, labels=labels, mode=mode)
    assert sorted(got) == sorted(MODES[mode])
    _close(got, want, f"{mode} at batch {batch}")
    if mode != "contrastive":
        assert float(got["loss"]) > 0
        _close(port(images, ids, mask, mode=mode), jm(images, ids, mask, mode=mode), f"{mode} without labels")
    _close(port(images, ids, mode=mode), jm(images, ids, mode=mode), f"{mode} without a mask")
    np.testing.assert_allclose(np.linalg.norm(got["vision_embeddings"], axis=-1) > 0, True)


def test_call_raises_as_the_jax_wrapper_does(pair):
    jm, port = pair
    images, ids, mask = _inputs(1)
    for model in (jm, port):
        with pytest.raises(ValueError, match="mode"):
            model(images, ids, mask, mode="inference")
        with pytest.raises(ValueError, match="caption_ids"):
            model(images, mode="generation")


def test_similarity_and_encode_image_match_the_jax_wrapper(pair):
    jm, port = pair
    images, ids, mask = _inputs(3)
    want = jm.compute_similarity(images, ids, mask)
    got = port.compute_similarity(images, ids, mask)
    assert isinstance(got, np.ndarray) and got.shape == (3, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(port.compute_similarity(images, ids), np.asarray(jm.compute_similarity(images, ids)),
                               atol=ATOL, rtol=0)
    ref = jm.module.apply({"params": jm.params}, jax_prepare_images(jnp.asarray(images)),
                          method=jm.module.encode_image)
    out = port.encode_image(images)
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].device.type == "cpu"
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, rtol=0, err_msg=key)
    # the first image alone is another key, with the same rows
    np.testing.assert_allclose(port.encode_image(images[:1])["embeddings"].numpy(), out["embeddings"][:1].numpy(),
                               atol=ATOL, rtol=0)


def test_entries_keep_one_graph_key_each(pair):
    _, port = pair
    port._entry_graphs = None
    images, ids, mask = _inputs(2)
    for _ in range(2):
        port(images, ids, mask, mode="dual")
        port(images, ids, mask, labels=ids, mode="dual")
        port(images, ids, mask, mode="contrastive")
        port.encode_image(images)
        port.compute_similarity(images, ids, mask)
    keys = port._entry_graphs.graphs
    assert len(keys) == 5, list(keys)
    assert {key[0][0] for key in keys} == {"call", "encode_image", "compute_similarity"}  # ((entry, ...), inputs)


def test_entries_follow_an_in_place_update_of_the_masters(pair):
    jm, _ = pair
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=1, **TINY)
    port.load_jax_params(jax.tree.map(np.asarray, jm.params))
    images, ids, mask = _inputs(3, seed=7)
    before = port(images, ids, mask, labels=ids, mode="dual")
    port.encode_image(images)
    port.compute_similarity(images, ids, mask)
    graphs = port._entry_graphs
    moved = jax.tree.map(lambda x: np.asarray(x) * 1.05 + 0.001, jm.params)
    port.load_jax_params(moved)  # in place: the masters keep their storage
    jm2 = JaxModel(tokenizer=JaxTokenizer(), seed=0, dropout=0.0, **TINY)
    jm2.params = jax.tree.map(jnp.asarray, moved)
    after = port(images, ids, mask, labels=ids, mode="dual")
    assert port._entry_graphs is graphs  # float32: the same keys, on the same masters
    assert not np.allclose(after["logits"], before["logits"])
    _close(after, jm2(images, ids, mask, labels=ids, mode="dual"), "dual after the update")
    np.testing.assert_allclose(port.compute_similarity(images, ids, mask),
                               np.asarray(jm2.compute_similarity(images, ids, mask)), atol=ATOL, rtol=0)
    ref = jm2.module.apply({"params": jm2.params}, jax_prepare_images(jnp.asarray(images)),
                           method=jm2.module.encode_image)
    np.testing.assert_allclose(port.encode_image(images)["embeddings"].numpy(), np.asarray(ref["embeddings"]),
                               atol=ATOL, rtol=0)


def test_bf16_entries_follow_the_rebuilt_serving_copy():
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=2, dtype=torch.bfloat16,
                                           **TINY)
    images, ids, mask = _inputs(2, seed=9)
    first = port.encode_image(images)["embeddings"]
    port.compute_similarity(images, ids, mask)
    graphs, copy = port._entry_graphs, port._inference_module()
    with torch.no_grad():
        for p in port.module.parameters():
            p.mul_(1.5)
    with torch.inference_mode():
        module = port._inference_module()
        assert module is not copy and port._entry_graphs is None  # the new copy dropped the old graphs
        pixels = prepare_images(torch.from_numpy(images))
        want = module.encode_image(pixels)["embeddings"]
        want_sim = module.compute_similarity(pixels, torch.from_numpy(ids), torch.from_numpy(mask))
        want_call = port.module(pixels, torch.from_numpy(ids), torch.from_numpy(mask), mode="contrastive")
    got = port.encode_image(images)["embeddings"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, want) and not torch.equal(got, first)
    assert np.array_equal(port.compute_similarity(images, ids, mask), want_sim.numpy())
    assert port._entry_graphs is not graphs
    out = port(images, ids, mask, mode="contrastive")  # on the masters, in the compute dtype
    assert out["image_embeddings"].dtype == np.float32
    assert np.array_equal(out["image_embeddings"], want_call["image_embeddings"].float().numpy())
