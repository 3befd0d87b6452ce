"""pgica_tpu_torch.ops: kernels (CUDA, csrc/) with their plain PyTorch versions."""
