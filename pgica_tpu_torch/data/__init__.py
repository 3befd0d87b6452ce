"""pgica_tpu_torch.data: tokenizer copy and the device-side image path."""
