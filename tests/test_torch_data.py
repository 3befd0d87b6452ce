"""The port's host data path against the JAX package's, on the CPU: config, processors,
datasets, loaders, the native decoder and the factories' dummy data.

Everything here is numpy on both sides, so the comparisons are exact
(``assert_array_equal``): the same config dicts, the same processed images
(PIL, and the native libjpeg path where ``g++`` and libjpeg build it), the
same tokens, the same items from synthetic CSV/JSON/sidecar datasets of
PNG and JPEG files written to ``tmp_path``, and the same batches per epoch,
after ``set_epoch`` and from ``iter_batches(k)``.
"""

import io
import json

import numpy as np
import pytest
from PIL import Image

from pgica_tpu.data import loader as jloader
from pgica_tpu.data import native_image as jnative
from pgica_tpu.data import preprocessing as jpre
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.utils import config as jconfig
from pgica_tpu.utils import factories as jfactories
from pgica_tpu_torch.data import loader, native_image, preprocessing
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.utils import config, factories, logging_config

from conftest import make_config_dict

CONFIGS = sorted(p.name for p in __import__("pathlib").Path("configs").glob("*.yaml") if p.name != "logging.yaml"
                 and p.name != "environment.yaml")


def _processors(port: bool, **kw):
    pre, tok = (preprocessing, CaptionTokenizer) if port else (jpre, JaxTokenizer)
    return pre.ImageProcessor(image_size=32, **kw), pre.TextProcessor(tok(), max_length=16)


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray) or isinstance(a[k], np.generic):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        else:
            assert a[k] == b[k], k


def _assert_batches_equal(got, want, nonempty=True):
    got, want = list(got), list(want)
    assert len(got) == len(want) and (len(got) > 0 or not nonempty)
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


# ------------------------------------------------------------------ config and logging


@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_every_config_as_jax(name, monkeypatch):
    monkeypatch.setenv("CAPTION_ALIGNMENT_BATCH_SIZE", "12")
    monkeypatch.setenv("CAPTION_ALIGNMENT_PIN_MEMORY", "off")
    port, ref = config.Config(f"configs/{name}"), jconfig.Config(f"configs/{name}")
    assert port.to_dict() == ref.to_dict()
    assert port.get("training.stage1.batch_size") == 12 and port.get("data.pin_memory") is False
    assert port.get_stage2_config() == ref.get_stage2_config() and port.get_targets() == ref.get_targets()


def test_config_validation_set_save_and_coercion(tmp_path):
    for broken in ({"data": {}}, {k: v for k, v in make_config_dict().items() if k != "targets"}):
        with pytest.raises(ValueError):
            config.Config(config_dict=broken)
        with pytest.raises(ValueError):
            jconfig.Config(config_dict=broken)
    cfg = config.Config(config_dict=make_config_dict())
    cfg.set("training.stage3.new", 5)
    cfg.save(tmp_path / "c.yaml")
    assert config.Config(tmp_path / "c.yaml").get("training.stage3.new") == 5
    for raw in ("true", "0", "12", "1e-4", "3.5", "abc", "OFF"):
        assert config.coerce_env_value(raw) == jconfig.coerce_env_value(raw)
    assert config.ENV_OVERRIDES == jconfig.ENV_OVERRIDES


def test_logging_config_applies_the_repo_logging_yaml(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert logging_config.configure_logging(tmp_path / "absent.yaml") == {}
    src = (__import__("pathlib").Path(__file__).resolve().parents[1] / "configs" / "logging.yaml")
    from pgica_tpu.utils import logging_config as jlogging

    assert logging_config.configure_logging(src) == jlogging.configure_logging(src)


# ------------------------------------------------------------------ processors and native decode


def _write_images(root, rng, n=6):
    paths = []
    for i in range(n):
        arr = rng.integers(0, 255, size=(40 + 7 * i, 50 - 2 * i, 3), dtype=np.uint8)
        path = root / (f"img_{i}.png" if i % 2 else f"img_{i}.jpg")
        Image.fromarray(arr).save(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("device_side", [False, True])
@pytest.mark.parametrize("native", ["off", "fast"])
def test_image_processor_matches_jax(tmp_path, device_side, native):
    if native == "fast" and (native_image.get_library() is None or jnative.get_library() is None):
        pytest.skip("native image library unavailable (no g++ or libjpeg)")
    paths = _write_images(tmp_path, np.random.default_rng(0))
    kw = dict(device_side_normalization=device_side, native_decode=native)
    port, ref = _processors(True, **kw)[0], _processors(False, **kw)[0]
    for path in paths:
        got, want = port.process_image(path), ref.process_image(path)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype == (np.uint8 if device_side else np.float32)
        data = path.read_bytes()
        np.testing.assert_array_equal(port.process_image(data), ref.process_image(data))
    arr = np.random.default_rng(1).integers(0, 255, size=(64, 48, 4), dtype=np.uint8)
    np.testing.assert_array_equal(port.process_image(arr), ref.process_image(arr))
    np.testing.assert_array_equal(port.process_batch(paths), ref.process_batch(paths))
    if not device_side:
        img = port.process_image(paths[0])
        np.testing.assert_array_equal(port.denormalize(img), ref.denormalize(img))
    np.testing.assert_array_equal(port.zero_image(), ref.zero_image())
    with pytest.raises(ValueError):
        port.process_image(12345)


def test_native_decode_matches_jax_and_rejects_what_jax_rejects(tmp_path):
    if native_image.get_library() is None or jnative.get_library() is None:
        pytest.skip("native image library unavailable (no g++ or libjpeg)")
    rng = np.random.default_rng(2)
    for h, w in ((480, 640), (100, 150), (224, 224)):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)).save(buf, format="JPEG", quality=90)
        for prescale in (False, True):
            got = native_image.decode_resize_jpeg(buf.getvalue(), 224, prescale=prescale)
            np.testing.assert_array_equal(got, jnative.decode_resize_jpeg(buf.getvalue(), 224, prescale=prescale))
    assert native_image.decode_resize_jpeg(b"\xff\xd8\xff not a jpeg", 32) is None
    assert native_image._library_path().parent.name == "native"  # the port's build directory


def test_text_processor_and_tokenizer_match_jax():
    port, ref = _processors(True)[1], _processors(False)[1]
    captions = ["a dog in the park", "", "x" * 40, "café — 2 birds!"]
    for c in captions:
        _assert_items_equal(port.encode_caption(c), ref.encode_caption(c))
    _assert_items_equal(port.encode_batch(captions), ref.encode_batch(captions))
    ids = port.encode_batch(captions)["input_ids"]
    assert port.decode_batch(ids) == ref.decode_batch(ids)
    _assert_items_equal(port.prepare_for_generation("a"), ref.prepare_for_generation("a"))
    assert (port.vocab_size, port.pad_token_id, port.bos_token_id, port.eos_token_id) == (
        ref.vocab_size, ref.pad_token_id, ref.bos_token_id, ref.eos_token_id)
    with pytest.raises(ValueError):
        port.encode_caption(42)


def test_tokenizer_load_matches_jax(tmp_path):
    d = tmp_path / "t"
    d.mkdir()
    (d / "vocab.json").write_text(json.dumps({"a": 0, "b": 1, "ab": 2}))
    (d / "merges.txt").write_text("#version: pgica_tpu\na b\n")
    tok, ref = CaptionTokenizer.load(d), JaxTokenizer.load(d)
    assert tok.vocab == ref.vocab and tok.encode("abab") == ref.encode("abab") == [2, 2]


# ------------------------------------------------------------------ datasets


def _caption_sets(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "caps"
    root.mkdir()
    paths = _write_images(root, rng, 12)
    records = [{"image_path": p.name, "caption": f"caption number {i}"} for i, p in enumerate(paths)]
    records.append({"image_path": "missing.jpg", "caption": "a file that is not there"})
    records.append({"image_path": paths[0].name, "caption": "   "})  # filtered: empty
    (root / "data.json").write_text(json.dumps({"data": records}))
    (root / "data.csv").write_text("Image,Text\n" + "\n".join(f"{r['image_path']},{r['caption']}" for r in records))
    side = tmp_path / "side"
    side.mkdir()
    for i, p in enumerate(_write_images(side, rng, 4)):
        p.with_suffix(".txt" if i % 2 else ".caption").write_text(f"sidecar {i}")
    return [root / "data.json", root / "data.csv", side]


def test_caption_datasets_match_jax(tmp_path):
    for path in _caption_sets(tmp_path):
        kw = dict(device_side_normalization=True)
        port = loader.ConceptualCaptionsDataset(path, *_processors(True, **kw), max_samples=7)
        ref = jloader.ConceptualCaptionsDataset(path, *_processors(False, **kw), max_samples=7)
        assert len(port) == len(ref) > 0
        for i in range(len(ref)):
            _assert_items_equal(port[i], ref[i])
        assert port.get_sample_by_path(ref.data[0]["image_path"])["raw_caption"] == ref.data[0]["caption"]


def test_preference_datasets_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    paths = _write_images(tmp_path, rng, 3)
    items = [
        {"image_path": paths[0].name, "preferred_caption": "good one", "rejected_caption": "bad",
         "preference_score": 0.9},
        {"image_path": paths[1].name, "conversations": [{"response": f"r{i}", "score": s}
                                                         for i, s in enumerate((1.0, 3.0, 2.2, 0.5))]},
        {"image_path": paths[2].name, "captions": ["c0", "c1", "c2"], "scores": [0.1, 0.9, 0.2]},
        {"image_path": paths[2].name, "captions": ["c0"], "scores": [0.1, 0.9]},
    ]
    path = tmp_path / "prefs.json"
    path.write_text(json.dumps(items))
    port = loader.UltraFeedbackDataset(path, *_processors(True))
    ref = jloader.UltraFeedbackDataset(path, *_processors(False))
    assert len(port) == len(ref) > 2
    for i in range(len(ref)):
        _assert_items_equal(port[i], ref[i])


# ------------------------------------------------------------------ loaders


@pytest.mark.parametrize("workers", [(0, "thread"), (3, "thread")])
def test_dataloaders_give_jax_batches_every_epoch_and_from_any_start(tmp_path, workers):
    path = _caption_sets(tmp_path)[0]
    kw = dict(batch_size=2, seed=5, num_workers=workers[0], workers_mode=workers[1])
    port = loader.create_dataloaders(loader.ConceptualCaptionsDataset, path, *_processors(True), **kw)
    ref = jloader.create_dataloaders(jloader.ConceptualCaptionsDataset, path, *_processors(False), **kw)
    for p, r in zip(port, ref):
        assert len(p) == len(r)
        _assert_batches_equal(p, r)  # epoch 0
        _assert_batches_equal(p, r)  # epoch 1 (each iteration advances the epoch)
        for epoch, start in ((7, 0), (3, 1), (0, 2)):
            p.set_epoch(epoch)
            r.set_epoch(epoch)
            _assert_batches_equal(p.iter_batches(start), r.iter_batches(start), nonempty=start < len(r))
        p.close()
        r.close()


def test_process_workers_give_the_inline_batches():
    """Spawned workers (a copy of the dataset each) give the batches of the inline fetch."""
    ds = factories.DummyConceptualDataset(*_processors(True), 12, seed=1)
    inline = loader.DataLoader(ds, 4, shuffle=True, seed=2)
    spawned = loader.DataLoader(ds, 4, shuffle=True, seed=2, num_workers=2, workers_mode="process")
    try:
        _assert_batches_equal(spawned, inline)
        _assert_batches_equal(spawned, inline)  # the pool serves the next epoch too
    finally:
        spawned.close()
    assert not hasattr(spawned, "_ppool")


def test_pinned_order_is_jax_and_grain_raises():
    """The pinned order is JAX's; grain mode is ported (tests/test_torch_grain.py), an unknown mode raises."""
    for args in ((10, 3, True, True, 4, 0), (10, 3, True, False, 4, 9), (7, 2, False, False, 0, 1)):
        assert loader._pinned_batch_order(*args) == jloader._pinned_batch_order(*args)
    assert loader.DataLoader([], 2, workers_mode="grain").workers_mode == "grain"
    with pytest.raises(ValueError, match="unknown workers_mode"):
        loader.DataLoader([], 2, workers_mode="grains")


# ------------------------------------------------------------------ factories


def test_dummy_loaders_give_jax_batches():
    cfg = make_config_dict(**{"data.dummy_samples": 24, "training.stage1.batch_size": 4,
                              "training.stage2.batch_size": 4})
    port_cfg, ref_cfg = config.Config(config_dict=cfg), jconfig.Config(config_dict=cfg)
    port_proc = factories.create_processors(port_cfg, factories.create_tokenizer(port_cfg))
    ref_proc = jfactories.create_processors(ref_cfg, jfactories.create_tokenizer(ref_cfg))
    for kind in ("conceptual", "ultrafeedback"):
        port = factories.create_loaders_with_fallback(port_cfg, *port_proc, kind=kind)
        ref = jfactories.create_loaders_with_fallback(ref_cfg, *ref_proc, kind=kind)
        for p, r in zip(port, ref):
            p.set_epoch(2)
            r.set_epoch(2)
            _assert_batches_equal(p, r)


def test_factories_raise_on_what_is_not_ported(tmp_path):
    def cfg(**kw):
        return config.Config(config_dict=make_config_dict(**kw))

    corpus = tmp_path / "caps.json"
    corpus.write_text(json.dumps([{"image_path": "a.jpg", "caption": "a cat"}] * 4))
    # the dataset-trained BPE is ported (tests/test_torch_native_bpe.py): the factory trains and caches it
    bpe = cfg(**{"data.bpe_vocab_size": 300, "data.conceptual_captions_path": str(corpus),
                 "paths.cache_dir": str(tmp_path / "cache")})
    assert factories.create_tokenizer(bpe)._merges and any((tmp_path / "cache").iterdir())
    # LoRA, a shared text tower and int8 decode are ported (tests/test_torch_lora.py, test_torch_tower_options.py,
    # test_torch_quant.py): the factory builds them
    assert factories.create_model(cfg(**{"model.lora_config": {"r": 4}}), device="cpu").lora_config["rank"] == 4
    assert hasattr(factories.create_model(cfg(**{"model.share_text_tower": True}), device="cpu").module, "shared_lm")
    assert factories.create_model(cfg(**{"inference.quantization": "int8"}), device="cpu").quantization == "int8"
    model = factories.create_model(cfg(**{"hardware.gradient_checkpointing": True}), device="cpu")
    assert model.module.text_encoder.backbone.config.remat and model.module.vision_encoder.backbone.config.remat
    assert model.num_parameters()["trainable"] < model.num_parameters()["total"]
