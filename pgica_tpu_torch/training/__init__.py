"""pgica_tpu_torch.training subpackage."""
