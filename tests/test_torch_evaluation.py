"""The port's evaluation runner, ``create_metrics`` and evaluation CLIs against the JAX package's (CPU).

``EvaluationRunner`` runs the tiny JAX model and the same weights bridged
into the port (``load_jax_params``, float32) over the same dummy loaders:
the predictions must be token-identical, greedy and with the config's 4
beams; every metric but the latencies must agree (BERTScore within 1e-5,
CLIP-Score within 1e-4, the rest within 1e-12); ``metrics.json`` must hold
the same keys. ``compare_with_targets`` and ``generate_evaluation_report``
must equal the JAX script's. ``create_metrics`` restores a CLIP judge saved
by the port's ``CheckpointManager``. The three CLIs run on
configs/smoke.yaml with ``--device cpu`` and dummy data; without
``--device`` they ask for the card.
"""

import copy
import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from pgica_tpu.data.loader import DataLoader as JaxDataLoader
from pgica_tpu.evaluation.runner import EvaluationRunner as JaxRunner
from pgica_tpu.utils.config import Config as JaxConfig
from pgica_tpu.utils.factories import DummyConceptualDataset as JaxDummyConceptual
from pgica_tpu.utils.factories import DummyPreferenceDataset as JaxDummyPreference
from pgica_tpu.utils.factories import create_processors as jax_create_processors
from pgica_tpu_torch.data.loader import DataLoader
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.evaluation.runner import EvaluationRunner
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
from pgica_tpu_torch.scripts import evaluate, predict, run_evaluation
from pgica_tpu_torch.training.checkpoint import CheckpointManager
from pgica_tpu_torch.utils.config import Config
from pgica_tpu_torch.utils.factories import (
    DummyConceptualDataset,
    DummyPreferenceDataset,
    create_metrics,
    create_model,
    create_processors,
)

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "configs" / "smoke.yaml")
ATOL = {"bert_score": 1e-5, "clip_score": 1e-4}
LATENCY = ("latency", "decode_warmup_ms")


def _load_jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def port_model(tiny_model):
    model = PreferenceGuidedCaptioningModel(
        vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, tokenizer=CaptionTokenizer(),
        max_caption_length=tiny_model.max_caption_length, image_size=32, device="cpu")
    model.load_jax_params(jax.tree.map(np.array, tiny_model.params))
    return model


def _configs(config_dict, num_beams: int):
    cfg = copy.deepcopy(config_dict)
    gen = cfg["evaluation"]["generate_config"]
    gen.update(max_length=8, num_beams=num_beams, do_sample=num_beams > 1)  # beams ignore the sampling flags
    return JaxConfig(config_dict=cfg), Config(config_dict=cfg)


def _loader(kind: str, jax_side: bool, config):
    processors = (jax_create_processors if jax_side else create_processors)(config)
    dummy = {(True, "conceptual"): JaxDummyConceptual, (True, "preference"): JaxDummyPreference,
             (False, "conceptual"): DummyConceptualDataset, (False, "preference"): DummyPreferenceDataset}
    return (JaxDataLoader if jax_side else DataLoader)(dummy[jax_side, kind](*processors, 8, seed=3), 4, prefetch=0)


@pytest.mark.parametrize("kind", ["conceptual", "preference"])
@pytest.mark.parametrize("num_beams", [1, 4], ids=["greedy", "4-beams"])
def test_runner_matches_jax(tiny_model, port_model, config_dict, tmp_path, kind, num_beams):
    jax_config, config = _configs(config_dict, num_beams)
    want = JaxRunner(tiny_model, jax_config, output_dir=tmp_path / "jax").run_evaluation(
        _loader(kind, True, jax_config))
    got = EvaluationRunner(port_model, config, output_dir=tmp_path / "port").run_evaluation(
        _loader(kind, False, config))
    predictions = [json.loads((tmp_path / side / "predictions.json").read_text()) for side in ("jax", "port")]
    assert predictions[1] == predictions[0] and len(predictions[1]) == got["num_samples"] == 8
    saved = [json.loads((tmp_path / side / "metrics.json").read_text()) for side in ("jax", "port")]
    assert saved[1].keys() == saved[0].keys() == got["metrics"].keys()
    assert all(isinstance(v, float) for v in saved[1].values())
    for k, v in want["metrics"].items():
        if not k.startswith(LATENCY):
            atol = next((a for prefix, a in ATOL.items() if k.startswith(prefix)), 1e-12)
            assert got["metrics"][k] == pytest.approx(v, abs=atol, rel=0), k
    assert ("preference_win_rate" in got["metrics"]) == (kind == "preference")


def test_report_helpers_match_the_jax_script():
    jax_script = _load_jax_script("run_evaluation")
    metrics = {"bleu_4": 0.3, "rouge_l": 0.5, "cider_score": 0.8, "preference_win_rate": 0.6, "distinct_1": 0.9,
               "latency_ms_p95": 42.0, "latency_ms_mean": 180.0, "bert_score_f1": 0.7, "clip_score_mean": 21.5,
               "avg_preferred_similarity": 0.4, "unique_captions": 1.0, "meteor": 0.2}
    targets = {"cider_score": 1.15, "preference_win_rate": 0.5, "latency_ms_p95": 150, "latency_ms_mean": 150,
               "human_eval_helpfulness": 4.2}
    results = {"num_samples": 4, "metrics": metrics}
    assert run_evaluation.compare_with_targets(metrics, targets) == jax_script.compare_with_targets(metrics, targets)
    report = run_evaluation.generate_evaluation_report(results, targets)
    assert report == jax_script.generate_evaluation_report(results, targets)
    assert report["target_comparison"]["latency_ms_mean"]["met"] is False
    assert set(report) == {"num_samples", "caption_quality", "preference_alignment", "diversity", "efficiency",
                           "target_comparison"}


def _save_judge(port_model, directory: Path, scale: float = 0.5) -> Path:
    params = {k: v * scale if v.is_floating_point() else v for k, v in port_model.module.state_dict().items()}
    return CheckpointManager(directory).save_best(1, params=params)


def _smoke_config(**sets) -> Config:
    config = Config(SMOKE)
    for key, value in sets.items():
        config.set(key, value)
    return config


def test_create_metrics_restores_the_clip_judge(tmp_path):
    """A judge saved by the port's CheckpointManager scores CLIP-Score (not self-judged); a missing
    judge, or one of another architecture, falls back to self-scoring, flagged."""
    config = _smoke_config()
    model = create_model(config, device="cpu")
    judge_path = _save_judge(model, tmp_path / "judge")
    config.set("evaluation.clip_judge_checkpoint", str(judge_path))
    metrics = create_metrics(config, model)
    saved = torch.load(judge_path / "state.pt", weights_only=True)["params"]
    assert all(torch.equal(metrics.clip_judge.module.state_dict()[k], v) for k, v in saved.items())
    images = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), np.uint8)
    judged = metrics.compute_clip_score(images, ["a red bird", "two dogs"])
    assert judged["clip_score_self_judged"] == 0.0
    self_scored = create_metrics(_smoke_config(), model).compute_clip_score(images, ["a red bird", "two dogs"])
    assert self_scored["clip_score_self_judged"] == 1.0
    assert judged["clip_score_mean"] != self_scored["clip_score_mean"]

    config.set("evaluation.clip_judge_checkpoint", str(tmp_path / "absent"))
    assert create_metrics(config, model).clip_judge is None
    other = _smoke_config(**{"model.projection_dim": 16})
    other.set("evaluation.clip_judge_checkpoint", str(judge_path))
    assert create_metrics(other, create_model(other, device="cpu")).clip_judge is None  # shapes differ: warned


def test_run_evaluation_cli(tmp_path):
    out = tmp_path / "eval"
    assert run_evaluation.main(["--config", SMOKE, "--device", "cpu", "--dataset", "both", "--output-dir",
                                str(out), "--max-samples", "8"]) == 0
    report = json.loads((out / "evaluation_report.json").read_text())
    assert set(report["datasets"]) == {"conceptual", "ultrafeedback"} and "summary" in report
    for name in ("conceptual", "ultrafeedback"):
        assert report["datasets"][name]["num_samples"] == 8
        assert (out / name / "predictions.json").exists() and (out / name / "metrics.json").exists()
        assert report["datasets"][name]["caption_quality"]["clip_score_self_judged"] == 1.0


def test_evaluate_cli_with_a_checkpoint(tmp_path):
    checkpoint = _save_judge(create_model(Config(SMOKE), device="cpu"), tmp_path / "ckpt", scale=0.9)
    output = tmp_path / "metrics.json"
    assert evaluate.main(["--config", SMOKE, "--device", "cpu", "--model-path", str(checkpoint), "--split", "val",
                          "--output", str(output), "--output-dir", str(tmp_path / "eval")]) == 0
    result = json.loads(output.read_text())
    assert result["num_samples"] == 8 and "cider_score" in result["metrics"]
    assert (tmp_path / "eval" / "predictions.json").exists()


def test_predict_cli(tmp_path):
    from PIL import Image

    output = tmp_path / "demo.json"
    assert predict.main(["--config", SMOKE, "--device", "cpu", "--demo", "--output", str(output)]) == 0
    demo = json.loads(output.read_text())
    assert demo["text_model"] == "tiny-gpt2" and isinstance(demo["demo_caption"], str)
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(6)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (40, 48, 3), np.uint8)).save(images / f"{i}.jpg")
    assert predict.main(["--config", SMOKE, "--device", "cpu", "--image", str(images / "0.jpg"),
                         "--output", str(tmp_path / "one.json")]) == 0
    one = json.loads((tmp_path / "one.json").read_text())
    assert predict.main(["--config", SMOKE, "--device", "cpu", "--image-dir", str(images),
                         "--output", str(tmp_path / "dir.json")]) == 0
    many = json.loads((tmp_path / "dir.json").read_text())
    assert one["image_path"] == str(images / "0.jpg") and isinstance(one["caption"], str) and one["latency_ms"] > 0
    assert [r["image_path"] for r in many] == [str(images / f"{i}.jpg") for i in range(3)]
    assert all(isinstance(r["caption"], str) for r in many)


def test_entry_points_ask_for_the_card(tmp_path, monkeypatch):
    """Without ``--device cpu`` the CLIs run on the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((run_evaluation.main, ["--output-dir", str(tmp_path)]), (evaluate.main, []),
                       (predict.main, ["--demo"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--config", SMOKE, *argv])
