"""Split evaluation CLI of the port (the counterpart of scripts/evaluate.py).

    python -m pgica_tpu_torch.scripts.evaluate --config configs/default.yaml --split test
    python -m pgica_tpu_torch.scripts.evaluate --model-path checkpoints/best_model_stage2 --max-samples 64 \\
        --output metrics.json

Captions a split of the config's conceptual data (the in-memory dummy data
when its path is missing) through ``EvaluationRunner`` and prints the
metrics. The flags are the JAX CLI's, with ``--platform`` replaced by
``--device`` (``cuda``, the default, or ``cpu``). ``main(argv)`` returns the
exit code.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional


class ModelEvaluator:
    def __init__(self, config, model_path=None, output_dir="./eval_outputs", device: str = "cuda"):
        from pgica_tpu_torch.evaluation.runner import EvaluationRunner
        from pgica_tpu_torch.utils.factories import (
            create_metrics,
            create_model,
            create_processors,
            create_tokenizer,
            restore_params,
        )

        self.config = config
        tokenizer = create_tokenizer(config)
        self.image_processor, self.text_processor = create_processors(config, tokenizer)
        self.model = create_model(config, tokenizer, device=device)
        if model_path:
            restore_params(self.model, model_path)
        self.runner = EvaluationRunner(self.model, config, create_metrics(config, self.model), output_dir)

    def evaluate_split(self, split: str = "test", max_samples=None) -> dict:
        from pgica_tpu_torch.utils.factories import create_loaders_with_fallback

        loaders = dict(zip(("train", "val", "test"), create_loaders_with_fallback(
            self.config, self.image_processor, self.text_processor, kind="conceptual")))
        loader = loaders[split]
        max_batches = max(1, max_samples // loader.batch_size) if max_samples else None
        return self.runner.run_evaluation(loader, max_batches=max_batches)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Caption model evaluation (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--split", type=str, default="test", choices=["train", "val", "test"])
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--output-dir", type=str, default="./eval_outputs")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cuda needs a card)")
    args = p.parse_args(argv)

    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import setup_logging

    config = Config(args.config)
    setup_logging(None, config.get("logging.level", "INFO"))
    evaluator = ModelEvaluator(config, args.model_path, args.output_dir, args.device)
    result = evaluator.evaluate_split(args.split, args.max_samples)
    text = json.dumps({"num_samples": result["num_samples"],
                       "metrics": {k: float(v) for k, v in result["metrics"].items()}}, indent=2)
    print(text)
    if args.output:
        Path(args.output).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
