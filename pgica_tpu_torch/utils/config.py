"""Layered YAML configuration with env-var overrides and dot-path access.

The port's copy of pgica_tpu/utils/config.py (it imports nothing of the JAX
package); tests/test_torch_data.py holds the two equal on every config in
``configs/``. Semantics:

* YAML file load with validation of the required sections
  ``data / model / training / evaluation / targets``.
* Environment-variable override catalog with automatic type coercion
  (bool / int / float / str), same variable names as the reference
  (reference config.py:94-128).
* Dot-path ``get("a.b.c", default)`` / ``set("a.b.c", value)``.
* ``get_stage1_config() / get_stage2_config() / get_targets()`` accessors.
* ``save(path)`` round-trip.

Optional sections: ``mesh`` (device mesh axes) and ``pallas`` (kernel
dispatch switches); both have defaults and are not required, so
reference-shaped YAML files load unchanged. The port reads the same keys
(utils/factories.py and training/trainer.py say which it honours).
"""

from __future__ import annotations

import copy
import logging
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import yaml

logger = logging.getLogger(__name__)

_REQUIRED_SECTIONS = ("data", "model", "training", "evaluation", "targets")

_REQUIRED_KEYS = {
    "data": ("image_size", "max_caption_length", "num_workers"),
    "model": ("vision_model", "text_model", "projection_dim"),
}

# Same env-var catalog as the reference (config.py:94-128).
ENV_OVERRIDES: Dict[str, List[str]] = {
    # Data paths
    "CONCEPTUAL_CAPTIONS_PATH": ["data", "conceptual_captions_path"],
    "ULTRAFEEDBACK_PATH": ["data", "ultrafeedback_path"],
    "CAPTION_ALIGNMENT_DATA_DIR": ["data", "conceptual_captions_path"],
    # Directory paths
    "OUTPUT_DIR": ["paths", "output_dir"],
    "CACHE_DIR": ["paths", "cache_dir"],
    "CAPTION_ALIGNMENT_CACHE_DIR": ["paths", "cache_dir"],
    "CAPTION_ALIGNMENT_OUTPUT_DIR": ["paths", "output_dir"],
    "CAPTION_ALIGNMENT_LOG_DIR": ["paths", "log_dir"],
    # Model configuration
    "CAPTION_ALIGNMENT_VISION_MODEL": ["model", "vision_model"],
    "CAPTION_ALIGNMENT_TEXT_MODEL": ["model", "text_model"],
    "CAPTION_ALIGNMENT_DEVICE": ["hardware", "device"],
    # Training configuration
    "CAPTION_ALIGNMENT_BATCH_SIZE": ["training", "stage1", "batch_size"],
    "CAPTION_ALIGNMENT_LEARNING_RATE": ["training", "stage1", "learning_rate"],
    "CAPTION_ALIGNMENT_NUM_EPOCHS": ["training", "stage1", "num_epochs"],
    "CAPTION_ALIGNMENT_LOG_LEVEL": ["logging", "level"],
    # Logging
    "WANDB_PROJECT": ["logging", "wandb_project"],
    "WANDB_ENTITY": ["logging", "wandb_entity"],
    "MLFLOW_EXPERIMENT": ["logging", "mlflow_experiment"],
    "MLFLOW_TRACKING_URI": ["logging", "mlflow_tracking_uri"],
    # Hardware
    "CAPTION_ALIGNMENT_NUM_WORKERS": ["data", "num_workers"],
    "CAPTION_ALIGNMENT_PIN_MEMORY": ["data", "pin_memory"],
    "CAPTION_ALIGNMENT_MIXED_PRECISION": ["hardware", "mixed_precision"],
    # Mesh, kernels, RNG, vocab, workers, checkpoints
    "CAPTION_ALIGNMENT_MESH_SHAPE": ["mesh", "shape"],
    "CAPTION_ALIGNMENT_USE_PALLAS": ["pallas", "enabled"],
    "CAPTION_ALIGNMENT_RNG": ["hardware", "rng"],
    "CAPTION_ALIGNMENT_VOCAB_SIZE": ["model", "vocab_size"],
    "CAPTION_ALIGNMENT_WORKERS_MODE": ["data", "workers_mode"],
    "CAPTION_ALIGNMENT_SAVE_STEPS": ["training", "save_steps"],
    "CAPTION_ALIGNMENT_KEEP_CHECKPOINTS": ["training", "keep_checkpoints"],
}


def coerce_env_value(value: str) -> Any:
    """Coerce an env-var string to bool/int/float/str (reference config.py:138-168)."""
    lowered = value.lower()
    if lowered in ("true", "1", "yes", "on"):
        return True
    if lowered in ("false", "0", "no", "off"):
        return False
    try:
        if "." not in value and "e" not in lowered:
            return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


class Config:
    """YAML-backed config with validation, env overrides, and dot paths."""

    def __init__(self, config_path: Union[str, Path, None] = None, config_dict: Optional[dict] = None):
        if config_dict is not None:
            self.config: Dict[str, Any] = copy.deepcopy(config_dict)
            self.config_path: Optional[Path] = None
        else:
            if config_path is None:
                raise ValueError("Config requires either config_path or config_dict")
            self.config_path = Path(config_path)
            self.config = self._load(self.config_path)
        self._validate()
        self._apply_env_overrides()

    # -- loading / validation -------------------------------------------------

    @staticmethod
    def _load(path: Path) -> Dict[str, Any]:
        if not path.exists():
            raise FileNotFoundError(f"Configuration file not found: {path}")
        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if not isinstance(loaded, dict):
            raise ValueError(f"Configuration root must be a mapping: {path}")
        return loaded

    def _validate(self) -> None:
        for section in _REQUIRED_SECTIONS:
            if section not in self.config:
                raise ValueError(f"Missing required configuration section: {section}")
        for section, keys in _REQUIRED_KEYS.items():
            for key in keys:
                if key not in self.config[section]:
                    raise ValueError(f"Missing required {section} config: {key}")
        training = self.config["training"]
        if "stage1" not in training or "stage2" not in training:
            raise ValueError("Training config must have stage1 and stage2 sections")

    def _apply_env_overrides(self) -> None:
        for env_var, path in ENV_OVERRIDES.items():
            raw = os.getenv(env_var)
            if raw:
                value = coerce_env_value(raw)
                node = self.config
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = value
                logger.info("Config override from env %s: %r", env_var, value)

    # -- access ----------------------------------------------------------------

    def get(self, path: str, default: Any = None) -> Any:
        """Get a value by dot-notation path, e.g. ``get("training.stage1.batch_size")``."""
        node: Any = self.config
        for key in path.split("."):
            if isinstance(node, dict) and key in node:
                node = node[key]
            else:
                return default
        return node

    def set(self, path: str, value: Any) -> None:
        """Set a value by dot-notation path, creating intermediate dicts."""
        keys = path.split(".")
        node = self.config
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value

    def get_stage1_config(self) -> Dict[str, Any]:
        return self.get("training.stage1", {})

    def get_stage2_config(self) -> Dict[str, Any]:
        return self.get("training.stage2", {})

    def get_targets(self) -> Dict[str, Any]:
        return self.get("targets", {})

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.config)

    def save(self, path: Union[str, Path]) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.config, f, default_flow_style=False, sort_keys=False)

    # -- dict-ish conveniences ---------------------------------------------------

    def __getitem__(self, key: str) -> Any:
        return self.config[key]

    def __contains__(self, key: str) -> bool:
        return key in self.config

    def __repr__(self) -> str:
        src = self.config_path or "<dict>"
        return f"Config({src})"
