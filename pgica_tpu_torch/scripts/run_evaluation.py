"""Comprehensive evaluation CLI of the port (the counterpart of scripts/run_evaluation.py).

Runs the EvaluationRunner over conceptual and/or preference test data (the
in-memory dummy data where the config's paths are missing), compares
metrics against config targets (lower-is-better for ``*_ms``), writes a
structured ``evaluation_report.json`` with caption-quality / preference /
diversity / efficiency sections, and logs to MLflow where it is installed.

    python -m pgica_tpu_torch.scripts.run_evaluation --checkpoint checkpoints/best_model_stage2 --dataset both
    python -m pgica_tpu_torch.scripts.run_evaluation --config configs/smoke.yaml --device cpu

The flags are the JAX CLI's, with ``--platform`` replaced by ``--device``
(``cuda``, the default, or ``cpu``). ``main(argv)`` returns the exit code;
``run(argv)`` returns the report and the model, for callers in the same
process.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional

logger = logging.getLogger(__name__)


def compare_with_targets(metrics: dict, targets: dict) -> dict:
    """Target comparison with lower-is-better for latency (reference 284-314)."""
    comparison = {}
    for name, target in targets.items():
        actual = metrics.get(name)
        if actual is None:
            comparison[name] = {"target": target, "actual": None, "met": None}
            continue
        lower_is_better = name.endswith("_ms") or "_ms_" in name or "latency" in name
        met = actual <= target if lower_is_better else actual >= target
        comparison[name] = {"target": float(target), "actual": float(actual), "met": bool(met)}
    return comparison


def generate_evaluation_report(results: dict, targets: dict) -> dict:
    """Structured report (reference run_evaluation.py:317-402)."""
    metrics = results["metrics"]

    def section(prefixes):
        return {k: float(v) for k, v in metrics.items() if any(k.startswith(p) or k == p for p in prefixes)}

    return {
        "num_samples": results["num_samples"],
        "caption_quality": section(("bleu", "rouge", "meteor", "cider_score", "bert_score", "clip_score")),
        "preference_alignment": section(("preference", "avg_preferred", "avg_rejected", "human_preference")),
        "diversity": section(("distinct", "unique")),
        "efficiency": section(("latency",)),
        "target_comparison": compare_with_targets(metrics, targets),
    }


def _log_to_mlflow(name: str, metrics: dict) -> None:
    """One MLflow run of ``metrics``, where mlflow is installed (reference run_evaluation.py:532-535)."""
    try:
        import mlflow
    except ImportError:
        return
    try:
        with mlflow.start_run(run_name=f"eval_{name}"):
            mlflow.log_metrics({k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))})
    except Exception as e:  # an optional tracker: its failure must not lose the report
        logger.warning("MLflow logging of eval_%s failed: %r", name, e)


def run_comprehensive_evaluation(config, model, dataset: str, output_dir: Path, max_samples=None) -> dict:
    from pgica_tpu_torch.evaluation.runner import EvaluationRunner
    from pgica_tpu_torch.utils.factories import create_loaders_with_fallback, create_metrics, create_processors

    image_processor, text_processor = create_processors(config, model.tokenizer)
    metrics = create_metrics(config, model)  # one CLIP judge for every dataset
    datasets = ["conceptual", "ultrafeedback"] if dataset == "both" else [dataset]
    reports = {}
    for name in datasets:
        _, _, test_loader = create_loaders_with_fallback(config, image_processor, text_processor, kind=name)
        runner = EvaluationRunner(model, config, metrics, output_dir / name)
        max_batches = max(1, max_samples // test_loader.batch_size) if max_samples else None
        results = runner.run_evaluation(test_loader, max_batches=max_batches)
        reports[name] = generate_evaluation_report(results, config.get_targets())
        _log_to_mlflow(name, results["metrics"])

    combined = {"datasets": reports}
    if len(reports) > 1:  # combined multi-dataset summary (reference 537-550)
        met_flags = [c["met"] for r in reports.values() for c in r["target_comparison"].values()
                     if c["met"] is not None]
        combined["summary"] = {"targets_met": sum(met_flags), "targets_total": len(met_flags)}
    return combined


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Comprehensive caption evaluation (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--dataset", type=str, default="conceptual", choices=["conceptual", "ultrafeedback", "both"])
    p.add_argument("--output-dir", type=str, default="./eval_outputs")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cuda needs a card)")
    return p.parse_args(argv)


def run(argv: Optional[List[str]] = None):
    """Parse ``argv``, build the model (and restore ``--checkpoint``), evaluate, write the report:
    (report, model)."""
    args = parse_args(argv)
    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import create_model, create_tokenizer, restore_params, setup_logging

    config = Config(args.config)
    setup_logging(None, config.get("logging.level", "INFO"))
    model = create_model(config, create_tokenizer(config), device=args.device)
    if args.checkpoint:
        restore_params(model, args.checkpoint)

    output_dir = Path(args.output_dir)
    report = run_comprehensive_evaluation(config, model, args.dataset, output_dir, args.max_samples)
    output_dir.mkdir(parents=True, exist_ok=True)
    report_path = output_dir / "evaluation_report.json"
    report_path.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    print(f"\nReport written to {report_path}", file=sys.stderr)
    return report, model


def main(argv: Optional[List[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
