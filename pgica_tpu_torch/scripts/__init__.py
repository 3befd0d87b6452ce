"""Command-line entry points: ``python -m pgica_tpu_torch.scripts.train``."""
