"""pgica_tpu_torch.generation: greedy and sampled caption decoding."""
