"""Caption prediction CLI of the port (the counterpart of scripts/predict.py).

    python -m pgica_tpu_torch.scripts.predict --demo
    python -m pgica_tpu_torch.scripts.predict --image photo.jpg --model-path checkpoints/best_model_stage2
    python -m pgica_tpu_torch.scripts.predict --image-dir photos/ --output captions.json

The flags are the JAX CLI's, with ``--platform`` replaced by ``--device``
(``cuda``, the default, or ``cpu``). Captions come from
``generate_captions`` with the config's ``evaluation.generate_config``.
``main(argv)`` returns the exit code.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class CaptionPredictor:
    """Load a (possibly checkpointed) model and caption images."""

    def __init__(self, config, model_path=None, device: str = "cuda"):
        from pgica_tpu_torch.utils.factories import create_model, create_processors, create_tokenizer, restore_params

        self.config = config
        tokenizer = create_tokenizer(config)
        self.image_processor, self.text_processor = create_processors(config, tokenizer)
        self.model = create_model(config, tokenizer, device=device)
        if model_path:
            restore_params(self.model, model_path)

    def _generate(self, images) -> List[str]:
        from pgica_tpu_torch.evaluation.runner import generate_kwargs

        return self.model.generate_captions(images, **generate_kwargs(self.config))

    def predict_single(self, image_path) -> dict:
        t0 = time.perf_counter()
        caption = self._generate(self.image_processor.process_image(image_path)[None])[0]
        return {"image_path": str(image_path), "caption": caption, "latency_ms": (time.perf_counter() - t0) * 1000.0}

    def predict_directory(self, image_dir, batch_size: int = 8) -> list:
        paths = sorted(p for p in Path(image_dir).rglob("*") if p.suffix.lower() in IMAGE_SUFFIXES)
        results = []
        for start in range(0, len(paths), batch_size):
            chunk = paths[start : start + batch_size]
            captions = self._generate(self.image_processor.process_batch(chunk))
            results.extend({"image_path": str(p), "caption": c} for p, c in zip(chunk, captions))
        return results

    def demo(self) -> dict:
        """Architecture printout and the caption of a synthetic (normalized, seeded) image."""
        counts = self.model.num_parameters()
        size = self.image_processor.image_size
        image = np.random.default_rng(0).normal(0, 1, (1, size, size, 3)).astype(np.float32)
        return {
            "vision_model": self.config.get("model.vision_model"),
            "text_model": self.config.get("model.text_model"),
            "projection_dim": self.config.get("model.projection_dim"),
            "parameters_total": counts["total"],
            "parameters_trainable": counts["trainable"],
            "demo_caption": self._generate(image)[0],
        }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Caption prediction (PyTorch port)")
    p.add_argument("--config", type=str, default="configs/default.yaml")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--image", type=str, default=None)
    p.add_argument("--image-dir", type=str, default=None)
    p.add_argument("--demo", action="store_true")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (cuda needs a card)")
    args = p.parse_args(argv)
    if not (args.demo or args.image or args.image_dir):
        p.error("Provide --image, --image-dir, or --demo")

    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import setup_logging

    config = Config(args.config)
    setup_logging(None, config.get("logging.level", "INFO"))
    predictor = CaptionPredictor(config, args.model_path, args.device)
    if args.demo:
        result = predictor.demo()
    elif args.image:
        result = predictor.predict_single(args.image)
    else:
        result = predictor.predict_directory(args.image_dir)

    text = json.dumps(result, indent=2)
    print(text)
    if args.output:
        Path(args.output).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
