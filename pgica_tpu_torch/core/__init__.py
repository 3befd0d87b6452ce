"""pgica_tpu_torch.core: precision policy, device resolution and seeds by purpose."""
