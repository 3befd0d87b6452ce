"""The port's native BPE encoder, ``train_bpe``, ``save``/``load`` and the dataset-trained BPE of
``create_tokenizer`` against the JAX package's, on the CPU (mirrors tests/test_native_bpe.py and
tests/test_data.py:67-85).

Everything is exact: ids, merges and vocabularies are equal lists and
dicts, and the files ``save`` writes are byte-identical. The native cases
skip where ``g++`` does not build ``native/bpe.cpp`` (decided inside each
test).
"""

import json
import pickle

import numpy as np
import pytest

from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.utils import config as jconfig
from pgica_tpu.utils import factories as jfactories
from pgica_tpu_torch.data import native_bpe
from pgica_tpu_torch.data.native_bpe import NativeBPE
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.utils import config, factories

from conftest import make_config_dict

ASCII_TEXTS = [
    "a red bird sitting on a branch",
    "Hello, World! 123 test-case",
    "  leading spaces and   multiple   gaps",
    "punctuation... everywhere!!! (really?)",
    "x",
    "",
    "the quick brown fox jumps over the lazy dog 42 times",
    "don't stop; it's we'll I'm you're we've he'd",
    " 's odd '' apostrophes'",
    "mixed \t whitespace\truns  \t end ",
]

UNICODE_TEXTS = [
    "café ☕ naïve",
    "日本語 caption",
    "x² + y³",
    "a → b — c",
    "١٢٣ digits",
    "mixed中文and123",
    "non‑breaking space",
    "emoji \U0001f600\U0001f680 run",
]

CORPORA = {
    280: ["hello world"] * 10,
    300: ["the cat sat on the mat"] * 20 + ["the dog ran in the park"] * 20,
    350: ["the cat sat on the mat"] * 30 + ["dogs playing in the park"] * 30 + ["café naïve 日本"] * 3,
}


def _require_native():
    if native_bpe.get_library() is None:
        pytest.skip(f"native BPE library unavailable ({native_bpe.build_error})")


def _tokenizers():
    trained = CaptionTokenizer.train_bpe(CORPORA[350], vocab_size=350)
    return {"bytes": CaptionTokenizer(), "trained": trained}


@pytest.mark.parametrize("kind", ["bytes", "trained"])
def test_native_ids_equal_python_ids(kind):
    _require_native()
    tok = _tokenizers()[kind]
    native = NativeBPE(tok.vocab, tok._merges, tok.unk_token_id)
    assert native.available
    jtok = JaxTokenizer(tok._base_vocab, tok._merges)
    for text in ASCII_TEXTS + UNICODE_TEXTS + ["the cat playing in the mat park"]:
        assert native.encode(text) == tok._python_encode(text), repr(text)
        assert tok.encode(text, add_bos=True, add_eos=True) == jtok.encode(text, add_bos=True, add_eos=True)
    assert tok._native is not None  # encode went through the native encoder
    assert native.encode("a" * 50, max_tokens=8) is None  # too many ids: the caller encodes in Python
    assert tok.encode("ab " * 3000) == tok._python_encode("ab " * 3000)


def test_library_builds_into_the_port_build_directory():
    _require_native()
    path = native_bpe._library_path()
    assert path.exists() and path.parent.parts[-3:] == ("build", "pgica_tpu_torch", "native")
    assert path.name.startswith("libbpe-") and path.suffix == ".so"


@pytest.mark.parametrize("vocab_size", sorted(CORPORA))
def test_train_bpe_merges_and_vocab_equal_jax(vocab_size):
    corpus = CORPORA[vocab_size]
    tok = CaptionTokenizer.train_bpe(corpus, vocab_size=vocab_size)
    ref = JaxTokenizer.train_bpe(corpus, vocab_size=vocab_size)
    assert tok._merges == ref._merges and len(tok._merges) > 0
    assert tok.vocab == ref.vocab and tok.vocab_size == ref.vocab_size <= vocab_size
    for text in corpus[:1] + ["the cat ran in the park", "hello wor"] + UNICODE_TEXTS[:2]:
        assert tok.encode(text) == ref.encode(text)
        assert tok.decode(tok.encode(text)) == text
    assert len(tok.encode(corpus[0])) < len(corpus[0].encode())


def test_save_load_roundtrip_and_files_equal_jax(tmp_path):
    tok = CaptionTokenizer.train_bpe(CORPORA[350], vocab_size=350)
    tok.save(tmp_path / "port")
    JaxTokenizer.train_bpe(CORPORA[350], vocab_size=350).save(tmp_path / "jax")
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    back = CaptionTokenizer.load(tmp_path / "port")
    jback = JaxTokenizer.load(tmp_path / "port")
    assert back.vocab == tok.vocab == jback.vocab and back._merges == tok._merges
    for text in ASCII_TEXTS + UNICODE_TEXTS:
        assert back.encode(text) == tok.encode(text) == jback.encode(text)


def test_pickled_tokenizer_leaves_the_native_handle_and_encodes_the_same():
    tok = CaptionTokenizer.train_bpe(CORPORA[300], vocab_size=300)
    want = [tok.encode(t) for t in ASCII_TEXTS]
    copy = pickle.loads(pickle.dumps(tok))
    assert copy._native is None and not copy._native_tried and copy._cache == {}
    assert [copy.encode(t) for t in ASCII_TEXTS] == want
    if native_bpe.get_library() is not None:
        assert copy._native is not None and copy._native is not tok._native  # built its own


def _corpus_files(tmp_path):
    captions = ["a small dog on the beach", "two cats on a red sofa", "a dog and a cat", "the red car",
                "a café on the street", "dogs on the beach at night"] * 4
    table = tmp_path / "caps.csv"
    table.write_text("image_path,caption\n" + "\n".join(f"img_{i}.jpg,{c}" for i, c in enumerate(captions)))
    records = tmp_path / "caps.json"
    records.write_text(json.dumps([{"image": f"img_{i}.jpg", "text": c} for i, c in enumerate(captions)]))
    return [table, records]


def test_read_caption_corpus_equals_jax(tmp_path):
    for path in _corpus_files(tmp_path) + [tmp_path / "missing.json"]:
        assert factories.read_caption_corpus(path) == jfactories.read_caption_corpus(path)
    assert len(factories.read_caption_corpus(tmp_path / "caps.csv")) == 24
    (tmp_path / "caps.parquet").write_text("x")
    assert factories.read_caption_corpus(tmp_path / "caps.parquet") == []


def test_create_tokenizer_trains_caches_and_equals_jax(tmp_path, monkeypatch):
    for i, corpus in enumerate(_corpus_files(tmp_path)):
        overrides = {"data.bpe_vocab_size": 290, "data.conceptual_captions_path": str(corpus),
                     "paths.cache_dir": str(tmp_path / f"cache{i}")}
        port_cfg = config.Config(config_dict=make_config_dict(**overrides))
        jax_cfg = jconfig.Config(config_dict=make_config_dict(**{**overrides,
                                                                 "paths.cache_dir": str(tmp_path / f"jcache{i}")}))
        tok, ref = factories.create_tokenizer(port_cfg), jfactories.create_tokenizer(jax_cfg)
        assert tok.vocab == ref.vocab and tok._merges == ref._merges and len(tok._merges) > 0
        cached = list((tmp_path / f"cache{i}").iterdir())
        assert [p.name for p in cached] == [p.name for p in (tmp_path / f"jcache{i}").iterdir()]
        assert cached[0].name.startswith("bpe_290_")
        texts = factories.read_caption_corpus(corpus) + UNICODE_TEXTS
        ids = [tok.encode(t) for t in texts]
        assert ids == [ref.encode(t) for t in texts]

        def no_training(*a, **k):
            raise AssertionError("the second call trained again")

        with monkeypatch.context() as m:  # the second call loads the cache
            m.setattr(CaptionTokenizer, "train_bpe", classmethod(no_training))
            again = factories.create_tokenizer(port_cfg)
        assert again.vocab == tok.vocab and [again.encode(t) for t in texts] == ids
    # no corpus: the byte fallback, as JAX
    cfg = make_config_dict(**{"data.bpe_vocab_size": 290, "data.conceptual_captions_path": str(tmp_path / "none")})
    assert factories.create_tokenizer(config.Config(config_dict=cfg)).vocab == jfactories.create_tokenizer(
        jconfig.Config(config_dict=cfg)).vocab == CaptionTokenizer().vocab


def test_encode_padded_and_batch_through_the_native_encoder_equal_jax():
    tok = CaptionTokenizer.train_bpe(CORPORA[300], vocab_size=300)
    ref = JaxTokenizer.train_bpe(CORPORA[300], vocab_size=300)
    for text in ("the cat ran", "a" * 500, ""):
        for got, want in zip(tok.encode_padded(text, 8), ref.encode_padded(text, 8)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tok.encode_batch(ASCII_TEXTS, 16), ref.encode_batch(ASCII_TEXTS, 16)):
        np.testing.assert_array_equal(got, want)
