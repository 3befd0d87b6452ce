"""Evaluation runner (the port's copy of pgica_tpu/evaluation/runner.py).

Generates captions over a test loader (per-request latency capture: one
sample per generate_captions call; tail percentiles only from >= 20 request
samples; the first batch's call is an untimed warm-up, reported separately
as ``decode_warmup_ms``: on the card it loads the kernels and cuBLAS and
captures the greedy/sampled decode graphs of that shape), computes the full metric
suite + latency stats, writes
``predictions.json`` / ``metrics.json``, renders a 2x2 matplotlib summary
figure with actual-vs-target bars (targets: CIDEr 1.15, win rate 0.72,
p95 150 ms — reference metrics.py:1006-1010), and aggregates human-eval
records.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from pgica_tpu_torch.evaluation.metrics import CaptioningMetrics

logger = logging.getLogger(__name__)


def generate_kwargs(config) -> Dict[str, Any]:
    """``generate_captions``' keyword arguments from ``evaluation.generate_config`` (4 beams over 128 tokens by
    default; the sampling flags are ignored with beams)."""
    gen_cfg = config.get("evaluation.generate_config", {}) if config else {}
    return dict(
        max_length=int(gen_cfg.get("max_length", 128)),
        num_beams=int(gen_cfg.get("num_beams", 4)),
        temperature=float(gen_cfg.get("temperature", 0.8)),
        do_sample=bool(gen_cfg.get("do_sample", True)),
        top_p=float(gen_cfg.get("top_p", 0.9)),
        repetition_penalty=float(gen_cfg.get("repetition_penalty", 1.1)),
        length_penalty=float(gen_cfg.get("length_penalty", 1.0)),
        # EOS early exit (a host sync a step). Off by default so
        # benchmark latencies stay run-to-run comparable unless asked for.
        early_stop=bool(gen_cfg.get("early_stop", False)),
    )


class EvaluationRunner:
    def __init__(
        self,
        model,
        config,
        metrics_calculator: Optional[CaptioningMetrics] = None,
        output_dir="./eval_outputs",
    ):
        self.model = model
        self.config = config
        self.metrics = metrics_calculator or CaptioningMetrics(model=model)
        if self.metrics.model is None:
            self.metrics.model = model
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------------- predictions

    def _generate_predictions(self, test_loader, max_batches: Optional[int] = None) -> Dict[str, Any]:
        gen_kwargs = generate_kwargs(self.config)
        predictions: List[str] = []
        references: List[List[str]] = []
        preferred: List[str] = []
        rejected: List[str] = []
        pref_scores: List[float] = []
        image_paths: List[str] = []
        latencies_ms: List[float] = []  # one entry per batch (request unit)
        batch_sizes: List[int] = []
        first_images = None
        warmup_ms = None

        for i, batch in enumerate(test_loader):
            if max_batches is not None and i >= max_batches:
                break
            images = batch["image"]
            if first_images is None:
                first_images = images
            if warmup_ms is None:
                # Warm up on the first batch UNTIMED, as the serving CLI's
                # warmup does: the kernels' first use and the decode graphs'
                # capture would otherwise land in the first request and make
                # the tail a start-up artifact. Its cost is reported
                # separately as ``decode_warmup_ms``.
                t_w = time.perf_counter()
                self.model.generate_captions(images, **gen_kwargs)
                warmup_ms = (time.perf_counter() - t_w) * 1000.0
                logger.info("Decode graph warmed in %.0f ms (reported separately)", warmup_ms)
            t0 = time.perf_counter()
            captions = self.model.generate_captions(images, **gen_kwargs)
            dt_ms = (time.perf_counter() - t0) * 1000.0
            # ONE latency sample per generate_captions call (the request unit):
            # replicating dt/batch_size per caption made every percentile
            # collapse to the mean when batches were few.
            latencies_ms.append(dt_ms)
            batch_sizes.append(max(len(captions), 1))
            predictions.extend(captions)
            if "raw_caption" in batch:
                references.extend([[c] for c in batch["raw_caption"]])
            if "raw_preferred" in batch:
                preferred.extend(batch["raw_preferred"])
                rejected.extend(batch["raw_rejected"])
                references.extend([[c] for c in batch["raw_preferred"]])
                scores = batch.get("preference_score")
                if scores is not None:
                    pref_scores.extend(np.asarray(scores).reshape(-1).tolist())
            if "image_path" in batch:
                image_paths.extend(batch["image_path"])

        return {
            "predictions": predictions,
            "references": references,
            "preferred": preferred,
            "rejected": rejected,
            "preference_scores": pref_scores,
            "image_paths": image_paths,
            "latencies_ms": latencies_ms,
            "batch_sizes": batch_sizes,
            "sample_images": first_images,
            "warmup_ms": warmup_ms,
        }

    # Minimum distinct request samples before tail percentiles mean anything;
    # below this, p95/p99 of a handful of batches is noise dressed as a tail.
    MIN_BATCHES_FOR_PERCENTILES = 20

    @classmethod
    def _latency_stats(
        cls, latencies_ms: List[float], batch_sizes: Optional[List[int]] = None
    ) -> Dict[str, float]:
        """Stats over PER-REQUEST (per generate_captions call) latencies.

        p95/p99 are only emitted from >= MIN_BATCHES_FOR_PERCENTILES request
        samples — otherwise ``latency_percentiles_omitted`` flags the artifact
        instead of quoting a percentile over near-identical values (reference
        metrics.py:844-903 reports per-sample times; its published p95 has the
        same small-n caveat, unflagged).
        """
        if not latencies_ms:
            return {}
        arr = np.asarray(latencies_ms)
        out = {
            "latency_ms_mean": float(arr.mean()),
            "latency_ms_median": float(np.median(arr)),
            "latency_n_requests": float(arr.size),
        }
        if batch_sizes:
            per_cap = arr / np.maximum(np.asarray(batch_sizes, np.float64), 1.0)
            out["latency_ms_per_caption_mean"] = float(per_cap.mean())
        if arr.size >= cls.MIN_BATCHES_FOR_PERCENTILES:
            out["latency_ms_p95"] = float(np.percentile(arr, 95))
            out["latency_ms_p99"] = float(np.percentile(arr, 99))
        else:
            out["latency_percentiles_omitted"] = 1.0
            logger.warning(
                "Only %d request samples (< %d): omitting latency p95/p99",
                arr.size, cls.MIN_BATCHES_FOR_PERCENTILES,
            )
        return out

    # ---------------------------------------------------------------- entry point

    def run_evaluation(self, test_loader, max_batches: Optional[int] = None) -> Dict[str, Any]:
        data = self._generate_predictions(test_loader, max_batches)
        if not data["predictions"]:
            raise ValueError("No predictions generated; empty test loader?")
        metrics = self.metrics.compute_all_metrics(
            data["predictions"],
            data["references"] or [[p] for p in data["predictions"]],
            images=data["sample_images"],
            preferred_captions=data["preferred"] or None,
            rejected_captions=data["rejected"] or None,
            preference_scores=data["preference_scores"] or None,
        )
        metrics.update(self._latency_stats(data["latencies_ms"], data["batch_sizes"]))
        if data.get("warmup_ms") is not None:
            # Steady-state percentiles above; the one-time warm-up is its own
            # line so the artifact can't conflate the two.
            metrics["decode_warmup_ms"] = float(data["warmup_ms"])
        self._save_predictions(data, metrics)
        try:
            self._generate_visualizations(metrics)
        except Exception as e:  # matplotlib optional
            logger.warning("Could not render evaluation figure: %s", e)
        return {"metrics": metrics, "num_samples": len(data["predictions"])}

    # ---------------------------------------------------------------- artifacts

    def _save_predictions(self, data: Dict[str, Any], metrics: Dict[str, float]):
        records = []
        for i, pred in enumerate(data["predictions"]):
            rec = {"prediction": pred}
            if i < len(data["references"]):
                rec["references"] = data["references"][i]
            if i < len(data["image_paths"]):
                rec["image_path"] = data["image_paths"][i]
            records.append(rec)
        with open(self.output_dir / "predictions.json", "w") as f:
            json.dump(records, f, indent=2)
        with open(self.output_dir / "metrics.json", "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
        logger.info("Saved predictions.json and metrics.json to %s", self.output_dir)

    def _generate_visualizations(self, metrics: Dict[str, float]):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        targets = (self.config.get_targets() if self.config else {}) or {
            "cider_score": 1.15,
            "preference_win_rate": 0.72,
            "latency_ms_p95": 150,
        }
        fig, axes = plt.subplots(2, 2, figsize=(12, 9))

        quality_keys = [k for k in ("bleu_4", "rouge_l", "meteor", "bert_score_f1") if k in metrics]
        axes[0, 0].bar(quality_keys, [metrics[k] for k in quality_keys])
        axes[0, 0].set_title("Caption quality")
        axes[0, 0].tick_params(axis="x", rotation=30)

        div_keys = [k for k in ("distinct_1", "distinct_2", "unique_captions") if k in metrics]
        axes[0, 1].bar(div_keys, [metrics[k] for k in div_keys])
        axes[0, 1].set_title("Diversity")

        tgt_names, actual, tgt = [], [], []
        for name, key in (
            ("CIDEr", "cider_score"),
            ("win rate", "preference_win_rate"),
            ("p95 ms", "latency_ms_p95"),
        ):
            if key in metrics and key in targets:
                tgt_names.append(name)
                actual.append(metrics[key])
                tgt.append(targets[key])
        x = np.arange(len(tgt_names))
        axes[1, 0].bar(x - 0.2, actual, width=0.4, label="actual")
        axes[1, 0].bar(x + 0.2, tgt, width=0.4, label="target")
        axes[1, 0].set_xticks(x, tgt_names)
        axes[1, 0].set_title("Actual vs target")
        axes[1, 0].legend()

        lat_keys = [k for k in metrics if k.startswith("latency_ms")]
        axes[1, 1].bar([k.replace("latency_ms_", "") for k in lat_keys], [metrics[k] for k in lat_keys])
        axes[1, 1].set_title("Latency (ms/request)")

        fig.tight_layout()
        out = self.output_dir / "evaluation_summary.png"
        fig.savefig(out, dpi=120)
        plt.close(fig)
        logger.info("Saved evaluation figure to %s", out)

    # ---------------------------------------------------------------- human eval

    def aggregate_human_eval(self, records: List[Dict[str, Any]]) -> Dict[str, float]:
        """Aggregate human-eval score records (reference metrics.py:1041-1070).

        Each record: {"helpfulness": float, "accuracy": float, ...} on a 1-5 scale.
        """
        if not records:
            return {}
        keys = set().union(*(r.keys() for r in records))
        out = {}
        for k in sorted(keys):
            vals = [float(r[k]) for r in records if k in r and isinstance(r[k], (int, float))]
            if vals:
                out[f"human_eval_{k}_mean"] = float(np.mean(vals))
                out[f"human_eval_{k}_std"] = float(np.std(vals))
        out["human_eval_count"] = float(len(records))
        return out
