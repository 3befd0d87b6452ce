"""Caption-quality metrics and the evaluation runner (the port's copy of pgica_tpu/evaluation; lazy exports)."""

_LAZY = {
    "CaptioningMetrics": ("pgica_tpu_torch.evaluation.metrics", "CaptioningMetrics"),
    "word_tokenize": ("pgica_tpu_torch.evaluation.metrics", "word_tokenize"),
    "EvaluationRunner": ("pgica_tpu_torch.evaluation.runner", "EvaluationRunner"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        value = getattr(importlib.import_module(mod), attr)
        globals()[name] = value
        return value
    raise AttributeError(name)
