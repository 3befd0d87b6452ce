"""pgica_tpu_torch.core: precision policy and device resolution."""
