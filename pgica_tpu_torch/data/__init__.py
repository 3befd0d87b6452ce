"""pgica_tpu_torch.data: tokenizer, preprocessing, datasets and loaders, native decode, augmentation."""
