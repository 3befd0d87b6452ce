"""The port's caption metrics against the JAX package's (CPU).

Mirrors tests/test_metrics.py: each case runs through JAX
``CaptioningMetrics`` and the port's on the same fixed caption lists, must
give the same keys and values within 1e-12 (the same Python/NumPy code),
and keeps the JAX test's own assertions. The routes without ``nltk`` and
``rouge_score`` (the built-in METEOR and ROUGE) are forced by hiding those
packages. The two metrics that run the model are held on the tiny JAX model
bridged into the port with ``load_jax_params`` (float32): BERTScore's
text-tower route within 1e-5 (the towers' sums run in another order) and
CLIP-Score within 1e-4 (its similarity is scaled by 100 / temperature), with
equal flags. With ``transformers`` installed, the local-HF BERTScore route
runs a tiny ``BertModel`` written to a temporary directory in both packages.
"""

import copy
import json
import sys

import jax
import numpy as np
import pytest
import torch

from pgica_tpu.evaluation.metrics import CaptioningMetrics as JaxMetrics
from pgica_tpu.evaluation.metrics import word_tokenize as jax_word_tokenize
from pgica_tpu.evaluation.runner import EvaluationRunner as JaxRunner
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.evaluation.metrics import CaptioningMetrics, word_tokenize
from pgica_tpu_torch.evaluation.runner import EvaluationRunner
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

EXACT = 1e-12
BERT_ATOL = 1e-5
CLIP_ATOL = 1e-4
PREDS = ["a red bird on a branch", "two dogs in a park"]
REFS = [["a red bird sitting on a branch"], ["two dogs playing in the park"]]
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, image_size=32)


def same(got: dict, want: dict, atol: float = EXACT) -> dict:
    """The port's result ``got`` has ``want``'s keys and values within ``atol``; returns ``got``."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=atol, rel=0), k
    return got


def both(call, jax_metrics=None, port_metrics=None, atol: float = EXACT):
    """``call`` on JAX's and the port's ``CaptioningMetrics``; the port's result after holding it to JAX's."""
    want = call(jax_metrics or JaxMetrics())
    got = call(port_metrics or CaptioningMetrics())
    if isinstance(want, dict):
        return same(got, want, atol)
    assert got == pytest.approx(want, abs=atol, rel=0)
    return got


def hide(monkeypatch, *packages):
    """Make ``import`` of ``packages`` and their submodules fail, as if they were not installed."""
    for name in [m for m in sys.modules if m.split(".")[0] in packages] + list(packages):
        monkeypatch.setitem(sys.modules, name, None)


def port_model(params, max_caption_length: int):
    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), max_caption_length=max_caption_length,
                                            device="cpu", **TINY)
    model.load_jax_params(params)
    return model


@pytest.fixture(scope="module")
def params(tiny_model):
    return jax.tree.map(np.array, tiny_model.params)


@pytest.fixture(scope="module")
def bridged(tiny_model, params):
    """(JAX model, port model) with the same weights and the tiny model's captions of 8 tokens."""
    return tiny_model, port_model(params, tiny_model.max_caption_length)


@pytest.fixture(scope="module")
def bridged_long(tiny_model, params):
    """The same weights with captions of 24 tokens, so BERTScore's texts differ past their first words."""
    jm = copy.copy(tiny_model)  # shares the module and params; the session fixture keeps its length
    jm.max_caption_length = 24
    return jm, port_model(params, 24)


class TestTokenizer:
    def test_lowercase_and_punct(self):
        assert word_tokenize("Hello, World!") == jax_word_tokenize("Hello, World!") == ["hello", ",", "world", "!"]


class TestBleu:
    def test_perfect_match(self):
        out = both(lambda m: m.compute_bleu_scores(REFS[0], [REFS[0]]))
        assert out["bleu_4"] == pytest.approx(1.0)

    def test_partial_match_ordering(self):
        out = both(lambda m: m.compute_bleu_scores(PREDS, REFS))
        assert out["bleu_1"] > out["bleu_2"] > out["bleu_4"]
        assert 0 < out["bleu_1"] <= 1

    def test_no_match(self):
        out = both(lambda m: m.compute_bleu_scores(["zzz qqq"], [["aaa bbb"]]))
        assert out["bleu_1"] == pytest.approx(0.0, abs=1e-6)


class TestRouge:
    def test_scores_in_range(self):
        out = both(lambda m: m.compute_rouge_scores(PREDS, REFS))
        for k in ("rouge_1", "rouge_2", "rouge_l"):
            assert 0 <= out[k] <= 1
        assert out["rouge_1"] >= out["rouge_2"]

    def test_builtin_close_to_package(self):
        pkg = both(lambda m: m.compute_rouge_scores(PREDS, REFS))
        builtin = both(lambda m: m._rouge_builtin(PREDS, REFS))
        assert abs(pkg["rouge_1"] - builtin["rouge_1"]) < 0.15

    def test_builtin_route_without_rouge_score(self, monkeypatch):
        want = JaxMetrics()._rouge_builtin(PREDS, REFS)
        hide(monkeypatch, "rouge_score")
        got = both(lambda m: m.compute_rouge_scores(PREDS, REFS))
        same(got, want)


class TestMeteor:
    def test_perfect(self):
        out = both(lambda m: m.compute_meteor_score(REFS[0], [REFS[0]]))
        assert out["meteor"] > 0.95

    def test_partial_between_zero_and_one(self):
        out = both(lambda m: m.compute_meteor_score(PREDS, REFS))
        assert 0 < out["meteor"] < 1

    def test_stem_matching(self):
        exact = both(lambda m: m._meteor_pair("dogs playing", "dogs playing"))
        stemmed = both(lambda m: m._meteor_pair("dog plays", "dogs playing"))
        assert 0 < stemmed <= exact

    def test_builtin_route_without_nltk(self, monkeypatch):
        hide(monkeypatch, "nltk")
        out = both(lambda m: m.compute_meteor_score(PREDS + ["the cats sitting"], REFS + [["the cat sat"]]))
        assert out["meteor_nltk"] == 0.0 and out["meteor_synonym_stage"] == 0.0
        assert 0 < out["meteor"] < 1


class TestCider:
    def test_perfect_is_ten(self):
        preds = ["a cat on a mat", "a dog in a yard"]
        refs = [["a cat on a mat"], ["a dog in a yard"]]
        assert both(lambda m: m.compute_cider_score(preds, refs)) == pytest.approx(10.0, rel=1e-3)

    def test_length_penalty(self):
        refs = [["a cat sat on the mat today"], ["dogs run fast in the park"]]
        short = both(lambda m: m.compute_cider_score(["a cat", "dogs run"], refs))
        close = both(lambda m: m.compute_cider_score(["a cat sat on the mat", "dogs run fast in the park"], refs))
        assert close > short

    def test_empty_prediction(self):
        assert both(lambda m: m.compute_cider_score([""], [["a cat"]])) == pytest.approx(0.0, abs=1e-6)


class TestBertScore:
    def test_chargram_proxy(self):
        out = both(lambda m: m.compute_bert_score(PREDS, REFS))
        assert out["bert_score_proxy"] == 1.0
        assert 0 < out["bert_score_f1"] <= 1
        perfect = both(lambda m: m.compute_bert_score(REFS[0], [REFS[0]]))
        assert perfect["bert_score_f1"] == pytest.approx(1.0)

    @pytest.mark.parametrize("batch", [32, 3], ids=["one-forward", "forwards-of-3"])
    def test_text_tower_route_matches_jax(self, bridged_long, batch):
        """Each distinct text is embedded once, ``batch`` texts a forward (JAX: one text a forward, twice
        per pair); the greedy-matching P/R/F1 agree within 1e-5."""
        jm, pm = bridged_long
        preds = PREDS + ["a red bird", "two dogs in a park"]
        refs = REFS + [["a red bird sitting on a branch", "a bird"], ["two small dogs playing in a park"]]
        port = CaptioningMetrics(model=pm)
        port.BERT_SCORE_BATCH = batch
        out = both(lambda m: m.compute_bert_score(preds, refs), JaxMetrics(model=jm), port, atol=BERT_ATOL)
        assert out["bert_score_proxy"] == 1.0
        assert 0 < out["bert_score_f1"] < 1

    def test_local_hf_model_route(self, tmp_path):
        """``bert_model_path``: a tiny BertModel and its vocab written here, read by both packages."""
        transformers = pytest.importorskip("transformers")
        words = sorted({w for t in PREDS + [r for refs in REFS for r in refs] for w in word_tokenize(t)})
        (tmp_path / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *words]) + "\n")
        torch.manual_seed(0)
        cfg = transformers.BertConfig(vocab_size=5 + len(words), hidden_size=16, num_hidden_layers=1,
                                      num_attention_heads=2, intermediate_size=32, max_position_embeddings=64)
        transformers.BertModel(cfg).save_pretrained(tmp_path)
        transformers.BertTokenizer(str(tmp_path / "vocab.txt")).save_pretrained(tmp_path)
        path = str(tmp_path)
        out = both(lambda m: m.compute_bert_score(PREDS, REFS), JaxMetrics(bert_model_path=path),
                   CaptioningMetrics(bert_model_path=path))
        assert out["bert_score_proxy"] == 0.0
        assert 0 < out["bert_score_f1"] < 1


class TestPreference:
    def test_win_rate(self):
        out = both(lambda m: m.compute_preference_metrics(
            model_outputs=["a red bird on a branch"], preferred_captions=["a red bird sitting on the branch"],
            rejected_captions=["some unrelated words entirely"], preference_scores=[0.9]))
        assert out["preference_win_rate"] == 1.0
        assert out["preference_margin"] > 0

    def test_correlation(self):
        out = both(lambda m: m.compute_preference_metrics(
            model_outputs=["a b c", "x y z", "a b"], preferred_captions=["a b c", "q w e", "a b"],
            rejected_captions=["m n", "x y z", "m n"], preference_scores=[0.9, 0.2, 0.8]))
        assert -1 <= out["human_preference_correlation"] <= 1


class TestDiversity:
    def test_identical_captions(self):
        out = both(lambda m: m.compute_diversity_metrics(["same words here"] * 4))
        assert out["unique_captions"] == pytest.approx(0.25)

    def test_all_unique(self):
        out = both(lambda m: m.compute_diversity_metrics(["aa bb", "cc dd", "ee ff"]))
        assert out["unique_captions"] == 1.0
        assert out["distinct_1"] == 1.0


class TestAggregate:
    def test_all_metrics_keys(self):
        out = both(lambda m: m.compute_all_metrics(PREDS, REFS))
        for key in ("bleu_4", "rouge_l", "meteor", "cider_score", "bert_score_f1", "distinct_1"):
            assert key in out

    def test_string_references_listified(self):
        flat = both(lambda m: m.compute_all_metrics(PREDS, [r[0] for r in REFS]))
        nested = both(lambda m: m.compute_all_metrics(PREDS, REFS))
        assert flat["bleu_4"] == pytest.approx(nested["bleu_4"])

    def test_with_the_model(self, bridged_long):
        """The whole suite with a model (BERTScore's text-tower route, self-judged CLIP-Score) and
        preference pairs."""
        jm, pm = bridged_long
        images = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), np.uint8)
        call = lambda m: m.compute_all_metrics(  # noqa: E731
            PREDS, REFS, images=images, preferred_captions=[r[0] for r in REFS], rejected_captions=["a", "b"],
            preference_scores=[0.9, 0.4])
        want, got = call(JaxMetrics(model=jm)), call(CaptioningMetrics(model=pm))
        assert sorted(got) == sorted(want)
        for k in want:
            atol = CLIP_ATOL if k.startswith("clip_score") else BERT_ATOL if k.startswith("bert_score") else EXACT
            assert got[k] == pytest.approx(want[k], abs=atol, rel=0), k
        assert all(isinstance(v, float) for v in got.values())


class TestRunner:
    def test_run_evaluation_end_to_end(self, tmp_path, config_dict, bridged):
        """EvaluationRunner over a dummy loader writes artifacts and latencies (greedy, 2 requests)."""
        from pgica_tpu_torch.data.loader import DataLoader
        from pgica_tpu_torch.utils.config import Config
        from pgica_tpu_torch.utils.factories import DummyConceptualDataset, create_processors

        config = Config(config_dict=config_dict)
        config.set("evaluation.generate_config.max_length", 8)
        config.set("evaluation.generate_config.num_beams", 1)
        config.set("evaluation.generate_config.do_sample", False)
        model = bridged[1]
        ip, tp = create_processors(config, model.tokenizer)
        loader = DataLoader(DummyConceptualDataset(ip, tp, 8), 4, prefetch=0)
        result = EvaluationRunner(model, config, output_dir=tmp_path).run_evaluation(loader)
        assert result["num_samples"] == 8
        assert "cider_score" in result["metrics"]
        assert "latency_ms_p95" not in result["metrics"]
        assert result["metrics"]["latency_percentiles_omitted"] == 1.0
        assert result["metrics"]["latency_n_requests"] == 2
        assert result["metrics"]["latency_ms_per_caption_mean"] > 0
        assert result["metrics"]["decode_warmup_ms"] > 0
        assert (tmp_path / "predictions.json").exists()
        saved = json.loads((tmp_path / "metrics.json").read_text())
        assert "bleu_4" in saved and saved.keys() == result["metrics"].keys()

    def test_decode_warmup_excluded_from_latencies(self, tmp_path):
        """Warm-up = ONE extra untimed generate call on the first batch only."""
        calls = []

        class _FakeModel:
            tokenizer = None

            def generate_captions(self, images, **kw):
                calls.append(len(images))
                return ["a cat sits"] * len(images)

        class _Loader:
            batch_size = 2

            def __iter__(self):
                for _ in range(3):
                    yield {"image": np.zeros((2, 4, 4, 3), np.float32), "raw_caption": ["a cat sits", "a dog runs"]}

        data = EvaluationRunner(_FakeModel(), None, output_dir=tmp_path)._generate_predictions(_Loader())
        assert len(calls) == 4  # 3 timed batches + 1 untimed warm-up
        assert len(data["latencies_ms"]) == 3
        assert data["warmup_ms"] is not None and data["warmup_ms"] >= 0

    def test_latency_percentiles_need_twenty_requests(self):
        few = same(EvaluationRunner._latency_stats([100.0] * 19, [4] * 19),
                   JaxRunner._latency_stats([100.0] * 19, [4] * 19))
        assert "latency_ms_p95" not in few and few["latency_percentiles_omitted"] == 1.0
        lat = list(np.linspace(80.0, 120.0, 25))
        stats = same(EvaluationRunner._latency_stats(lat, [4] * 25), JaxRunner._latency_stats(lat, [4] * 25))
        assert stats["latency_n_requests"] == 25
        assert stats["latency_ms_p95"] == pytest.approx(np.percentile(lat, 95))
        assert stats["latency_ms_per_caption_mean"] == pytest.approx(np.mean(lat) / 4)
        assert "latency_percentiles_omitted" not in stats

    def test_human_eval_aggregation(self, tmp_path):
        records = [{"helpfulness": 4, "accuracy": 5}, {"helpfulness": 5, "accuracy": 3}]
        out = same(EvaluationRunner(None, None, output_dir=tmp_path / "port").aggregate_human_eval(records),
                   JaxRunner(None, None, output_dir=tmp_path / "jax").aggregate_human_eval(records))
        assert out["human_eval_helpfulness_mean"] == pytest.approx(4.5)
        assert out["human_eval_count"] == 2


class TestMeteorNltkGolden:
    """Golden values of nltk.single_meteor_score semantics (exact + Porter-stem stages, alpha .9, beta 3,
    gamma .5), from tests/test_metrics.py."""

    def test_exact_match_identity(self):
        out = both(lambda m: m.compute_meteor_score(["the cat sat on the mat"], [["the cat sat on the mat"]]))
        assert out["meteor"] == pytest.approx(0.9977, abs=1e-3)
        assert out["meteor_nltk"] == 1.0

    def test_partial_match_golden(self):
        out = both(lambda m: m.compute_meteor_score(["a cat sat on a mat"], [["the cat sat on the mat"]]))
        assert out["meteor"] == pytest.approx(0.625, abs=1e-3)

    def test_stem_stage_matches(self):
        out = both(lambda m: m.compute_meteor_score(["the cats sitting on the mats"], [["the cat sat on the mat"]]))
        assert out["meteor"] == pytest.approx(0.8067, abs=1e-3)

    def test_no_match_zero(self):
        assert both(lambda m: m.compute_meteor_score(["xyz"], [["abc def"]]))["meteor"] == 0.0


class TestMeteorSynonymStage:
    """``evaluation.wordnet_path`` as a JSON synonym table, through nltk's aligner."""

    HYP = ["a feline sat on the mat"]
    REF = [["a cat sat on the mat"]]

    @pytest.fixture()
    def table_path(self, tmp_path):
        p = tmp_path / "synonyms.json"
        p.write_text(json.dumps({"cat": ["feline"], "quick": ["fast", "speedy"]}))
        return str(p)

    def test_synonym_stage_raises_score_and_flag(self, table_path):
        base = both(lambda m: m.compute_meteor_score(self.HYP, self.REF))
        syn = both(lambda m: m.compute_meteor_score(self.HYP, self.REF), JaxMetrics(wordnet_path=table_path),
                   CaptioningMetrics(wordnet_path=table_path))
        assert base["meteor_synonym_stage"] == 0.0
        assert syn["meteor_synonym_stage"] == 1.0
        assert syn["meteor"] > base["meteor"] + 0.1
        exact = both(lambda m: m.compute_meteor_score(self.REF[0], [self.REF[0]]))
        assert syn["meteor"] == pytest.approx(exact["meteor"], abs=1e-6)

    def test_table_is_symmetric(self, table_path):
        fwd = both(lambda m: m.compute_meteor_score(["a feline sat"], [["a cat sat"]]),
                   JaxMetrics(wordnet_path=table_path), CaptioningMetrics(wordnet_path=table_path))
        bwd = both(lambda m: m.compute_meteor_score(["a cat sat"], [["a feline sat"]]),
                   JaxMetrics(wordnet_path=table_path), CaptioningMetrics(wordnet_path=table_path))
        assert fwd["meteor"] == pytest.approx(bwd["meteor"], abs=1e-6)
        assert fwd["meteor"] > 0.9

    def test_missing_or_bad_path_flags_off(self, tmp_path):
        bad = tmp_path / "notjson.json"
        bad.write_text("[1, 2, 3]")
        out = both(lambda m: m.compute_meteor_score(self.HYP, self.REF), JaxMetrics(wordnet_path=str(bad)),
                   CaptioningMetrics(wordnet_path=str(bad)))
        assert out["meteor_synonym_stage"] == 0.0

    def test_factory_wires_wordnet_path(self, table_path):
        from pgica_tpu.utils.config import Config as JaxConfig
        from pgica_tpu.utils.factories import create_metrics as jax_create_metrics
        from pgica_tpu_torch.utils.config import Config
        from pgica_tpu_torch.utils.factories import create_metrics

        configs = [JaxConfig("configs/default.yaml"), Config("configs/default.yaml")]
        for c in configs:
            c.set("evaluation.wordnet_path", table_path)
        m = create_metrics(configs[1])
        assert m.wordnet_path == table_path
        out = both(lambda m: m.compute_meteor_score(self.HYP, self.REF), jax_create_metrics(configs[0]), m)
        assert out["meteor_synonym_stage"] == 1.0

    def test_table_route_without_nltk_stemmer(self, table_path, monkeypatch):
        """Without nltk the table keeps its surface forms and METEOR takes the built-in route."""
        hide(monkeypatch, "nltk")
        assert CaptioningMetrics(wordnet_path=table_path)._resolve_wordnet().synsets("cat")[0].lemmas()[1].name() \
            == "feline"
        out = both(lambda m: m.compute_meteor_score(self.HYP, self.REF), JaxMetrics(wordnet_path=table_path),
                   CaptioningMetrics(wordnet_path=table_path))
        assert out["meteor_nltk"] == 0.0


class TestMetricProvenanceFlags:
    def test_bert_score_chargram_flagged_proxy(self):
        assert both(lambda m: m.compute_bert_score(["a cat"], [["a cat"]]))["bert_score_proxy"] == 1.0

    def test_clip_score_self_judged_flag(self, bridged):
        jm, pm = bridged
        images = np.zeros((2, 32, 32, 3), np.float32)
        out = both(lambda m: m.compute_clip_score(images, ["a", "b"]), JaxMetrics(model=jm),
                   CaptioningMetrics(model=pm), atol=CLIP_ATOL)
        assert out["clip_score_self_judged"] == 1.0

    def test_clip_score_independent_judge_flag(self, bridged, params):
        """The judge has other weights than the model: the score is the judge's."""
        jm, pm = bridged
        half = jax.tree.map(lambda x: 0.5 * x, params)
        jax_judge = copy.copy(jm)
        jax_judge.params = jax.tree.map(jax.numpy.asarray, half)
        images = np.random.default_rng(4).integers(0, 256, (3, 32, 32, 3), np.uint8)
        captions = ["a red bird", "two dogs", "a cat on a mat"]
        out = both(lambda m: m.compute_clip_score(images, captions), JaxMetrics(model=jm, clip_judge=jax_judge),
                   CaptioningMetrics(model=pm, clip_judge=port_model(half, jm.max_caption_length)), atol=CLIP_ATOL)
        assert out["clip_score_self_judged"] == 0.0
        self_judged = CaptioningMetrics(model=pm).compute_clip_score(images, captions)
        assert abs(out["clip_score_mean"] - self_judged["clip_score_mean"]) > 1e-3
