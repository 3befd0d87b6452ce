"""Declarative logging setup from configs/logging.yaml (the port's copy of
pgica_tpu/utils/logging_config.py).

Applies a dictConfig-style schema with per-subsystem loggers and
console/file/training/performance/error handlers; file handlers' directories
are created on demand. Returns the ``performance_logging`` options block for
callers that gate phase-timing instrumentation on it.
"""

from __future__ import annotations

import logging
import logging.config
from pathlib import Path
from typing import Dict, Optional, Union

import yaml

logger = logging.getLogger(__name__)


def configure_logging(path: Union[str, Path] = "configs/logging.yaml") -> Dict:
    path = Path(path)
    if not path.exists():
        logging.basicConfig(level=logging.INFO)
        logger.warning("Logging config %s not found; using basicConfig", path)
        return {}
    cfg = yaml.safe_load(path.read_text())
    perf_options = cfg.pop("performance_logging", {})
    for handler in cfg.get("handlers", {}).values():
        filename = handler.get("filename")
        if filename:
            Path(filename).parent.mkdir(parents=True, exist_ok=True)
    logging.config.dictConfig(cfg)
    return perf_options
