"""Top-level captioning model, serving slice (PyTorch).

Mirrors pgica_tpu/models/model.py:43-173,184-231,234-476:

* :class:`PreferenceGuidedCaptioningModule` — the composed ``nn.Module``
  (vision tower + caption decoder) with ``encode_image``, ``decode_prefix``
  and ``decode_step``.
* :class:`PreferenceGuidedCaptioningModel` — the runtime wrapper owning the
  module, its float32 masters and the tokenizer, with the JAX package's
  ``generate_captions`` signature and return type.

Waiting for later slices: the text tower, ``compute_similarity``, the
training forward, LoRA, int8 decode, beam search and
``load_pretrained_towers``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from pgica_tpu_torch.core.device import resolve_device
from pgica_tpu_torch.core.precision import cast_floating
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.convert import load_jax_params
from pgica_tpu_torch.models.decoder import CaptionDecoder
from pgica_tpu_torch.models.presets import LMConfig, ViTConfig, get_text_config, get_vision_config
from pgica_tpu_torch.models.vit import VisionEncoder
from pgica_tpu_torch.ops.layernorm import LayerNorm

logger = logging.getLogger(__name__)


class PreferenceGuidedCaptioningModule(nn.Module):
    """Vision tower + caption decoder (the text tower waits for the training slice)."""

    def __init__(self, vision_config: ViTConfig, decoder_config: LMConfig, projection_dim: int = 512):
        super().__init__()
        self.vision_config = vision_config
        self.decoder_config = decoder_config
        self.vision_encoder = VisionEncoder(vision_config, projection_dim)
        self.caption_decoder = CaptionDecoder(decoder_config, projection_dim)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.caption_decoder.lm.wte.weight.dtype

    def encode_image(self, images: torch.Tensor) -> dict:
        """Normalized NHWC images -> ``features``, ``embeddings``, ``pooled_output``."""
        return self.vision_encoder(images)

    def decode_prefix(self, vision_embeddings, caches, attention_mask):
        return self.caption_decoder.decode_prefix(vision_embeddings, caches, attention_mask)

    def decode_step(self, token_ids, position, caches, attention_mask):
        return self.caption_decoder.decode_step(token_ids, position, caches, attention_mask)


def build_module(
    vision_model: Union[str, ViTConfig] = "openai/clip-vit-base-patch32",
    text_model: Union[str, LMConfig] = "gpt2-medium",
    projection_dim: int = 512,
    vocab_size: int = 50257,
    max_caption_length: int = 128,
) -> PreferenceGuidedCaptioningModule:
    """Resolve presets (or take configs as given, e.g. with a cut depth) and build the module."""
    vision_config = vision_model if isinstance(vision_model, ViTConfig) else get_vision_config(vision_model)
    base = text_model if isinstance(text_model, LMConfig) else get_text_config(text_model)
    max_pos = max(base.max_position_embeddings, max_caption_length + 1)
    decoder_config = dataclasses.replace(base, vocab_size=vocab_size, max_position_embeddings=max_pos)
    return PreferenceGuidedCaptioningModule(vision_config, decoder_config, projection_dim)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation in a fixed order from ``generator`` (CPU tensors).

    The same distributions as the JAX package's Flax initialisers: Dense and
    the patch conv lecun-normal (std 1/sqrt(fan_in)) with zero bias,
    embeddings normal(0.02) (``wpe`` 0.01), ``cls_token``/``pos_embed``
    normal(0.02), LayerNorm ones and zeros. The values differ from JAX's
    (other generator); tests bridge JAX weights with models/convert.py.
    """
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, LayerNorm):
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif isinstance(owner, nn.Embedding):
            p.normal_(0.0, 0.01 if name.endswith("wpe.weight") else 0.02, generator=generator)
        elif leaf in ("cls_token", "pos_embed"):
            p.normal_(0.0, 0.02, generator=generator)
        else:  # (out, in) weights of Linear and the patch embedding
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)


class PreferenceGuidedCaptioningModel:
    """Runtime wrapper with the JAX package's serving API."""

    def __init__(
        self,
        vision_model: Union[str, ViTConfig] = "openai/clip-vit-base-patch32",
        text_model: Union[str, LMConfig] = "gpt2-medium",
        projection_dim: int = 512,
        tokenizer: Optional[CaptionTokenizer] = None,
        max_caption_length: int = 128,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        image_size: Optional[int] = None,
        vocab_size: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        if tokenizer is None:
            from_name = isinstance(text_model, str)
            tokenizer = CaptionTokenizer.from_pretrained(text_model) if from_name else CaptionTokenizer()
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.max_caption_length = max_caption_length
        # The meta device skips PyTorch's default init; init_params then fills
        # every parameter once, on the CPU, so one seed gives the same weights
        # whatever the target device.
        with torch.device("meta"):
            module = build_module(
                vision_model, text_model, projection_dim,
                # may pad the embedding beyond the tokenizer; never below it
                vocab_size=max(vocab_size or 0, tokenizer.vocab_size),
                max_caption_length=max_caption_length,
            )
        module = module.to_empty(device="cpu")
        init_params(module, torch.Generator().manual_seed(seed))
        self.module = module.to(self.device).eval()
        self.image_size = image_size or self.module.vision_config.image_size
        self._inference_cache: Optional[nn.Module] = None

    def load_jax_params(self, params: Mapping) -> None:
        """Copy a JAX parameter tree (nested dicts of numpy arrays) into the masters."""
        load_jax_params(self.module, params)
        self._inference_cache = None

    def _inference_module(self) -> PreferenceGuidedCaptioningModule:
        """The module in the compute dtype for inference, cast once and cached.

        Float32 runs on the masters. bf16 runs on a copy with every floating
        parameter cast (JAX ``cast_floating``, model.py:370-387); LayerNorm
        parameters are then put back in float32 — holding the bf16-rounded
        values the JAX cast produces — because the kernel reads f32 gamma/beta.
        """
        if self.dtype == torch.float32:
            return self.module
        if self._inference_cache is None:
            copy = cast_floating(self.module, self.dtype)
            for m in copy.modules():
                if isinstance(m, LayerNorm):
                    m.float()
            self._inference_cache = copy.requires_grad_(False)
        return self._inference_cache

    def _images(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return prepare_images(images.to(self.device))

    @torch.inference_mode()
    def encode_image(self, images) -> dict:
        """uint8 (or normalized float) NHWC images -> dict of tensors on the device."""
        return self._inference_module().encode_image(self._images(images))

    def generate_captions(
        self,
        images,
        max_length: int = 128,
        num_beams: int = 1,
        temperature: float = 1.0,
        do_sample: bool = False,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        length_penalty: float = 1.0,
        seed: int = 0,
        early_stop: bool = False,
    ) -> List[str]:
        """Encode images, decode autoregressively, detokenize.

        ``early_stop=True`` ends the greedy/sampling loop once every caption
        in the batch emitted EOS (token-identical; the serving default).
        ``length_penalty`` applies to beam search only, which is not ported
        yet: ``num_beams > 1`` raises.
        """
        from pgica_tpu_torch.generation.decode import generate  # decode imports models: no cycle at import

        if num_beams > 1:
            raise NotImplementedError("beam search is not ported yet; use num_beams=1")
        module = self._inference_module()
        # Phase times below are enqueue-side except the last, which ends in a
        # device->host copy; only the total is a true wall-clock.
        t0 = time.perf_counter()
        vision = self.encode_image(images)
        t_encode = time.perf_counter() - t0

        t0 = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(seed) if do_sample else None
        token_ids = generate(
            module,
            vision["embeddings"],
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
            max_length=max_length,
            temperature=temperature,
            do_sample=do_sample,
            top_p=top_p,
            repetition_penalty=repetition_penalty,
            generator=generator,
            early_stop=early_stop,
        ).cpu().numpy()
        t_generate = time.perf_counter() - t0

        t0 = time.perf_counter()
        captions = [self.tokenizer.decode(row) for row in token_ids]
        t_decode = time.perf_counter() - t0
        logger.info(
            "generate_captions: encode %.3fs generate %.3fs decode %.3fs (%.1f ms/caption)",
            t_encode, t_generate, t_decode,
            1000.0 * (t_encode + t_generate + t_decode) / max(1, len(captions)),
        )
        return captions
