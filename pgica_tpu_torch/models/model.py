"""Top-level captioning model (PyTorch).

Mirrors pgica_tpu/models/model.py:43-231,234-476:

* :class:`PreferenceGuidedCaptioningModule` — the composed ``nn.Module``
  (vision tower, text tower, caption decoder) with ``encode_image``,
  ``encode_text``, ``compute_similarity``, ``decode_train``,
  ``decode_prefix``, ``decode_step`` and the forward in all three modes
  (contrastive, generation, dual).
* :func:`frozen_copy` — a frozen copy in a compute dtype: the bf16 serving
  copy and the stage-2 DPO reference.
* :class:`PreferenceGuidedCaptioningModel` — the runtime wrapper owning the
  module, its float32 masters, the tokenizer and, with ``lora_config``, the
  LoRA factors (models/lora.py), with the JAX package's
  ``generate_captions`` signature and return type. With ``quantization``
  its decode runs through an int8 twin of the module (JAX model.py:389-412),
  and ``load_pretrained_towers`` imports local HF checkpoints into the
  towers (models/convert.py).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from pgica_tpu_torch.core.device import resolve_device
from pgica_tpu_torch.core.precision import cast_floating
from pgica_tpu_torch.core.prng import stream_generator
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.convert import load_jax_params
from pgica_tpu_torch.models.decoder import CaptionDecoder
from pgica_tpu_torch.models.encoders import TextEncoder
from pgica_tpu_torch.models.lm import TransformerLM
from pgica_tpu_torch.models.lora import Adapters, count_lora_params, from_numpy, init_lora, target_shapes
from pgica_tpu_torch.models.presets import LMConfig, ViTConfig, get_text_config, get_vision_config
from pgica_tpu_torch.models.vit import VisionEncoder
from pgica_tpu_torch.ops.layernorm import LayerNorm
from pgica_tpu_torch.ops.losses import caption_cross_entropy, l2_normalize
from pgica_tpu_torch.ops.quant import INT8_MODES, cast_for_twin, quantize_like
from pgica_tpu_torch.ops.rmsnorm import RMSNorm

NORMS = (LayerNorm, RMSNorm)  # modules whose float32 parameters the kernels read as they are

logger = logging.getLogger(__name__)


class PreferenceGuidedCaptioningModule(nn.Module):
    """Vision tower + text tower + caption decoder, computing in ``dtype`` over float32 masters.

    The text tower is registered after the decoder (the JAX tree's order is
    vision, text, decoder), so that one seed gives the serving towers the
    same weights as before the text tower was ported; the weight bridge goes
    by name. ``decoder_quant`` builds the inference-only int8 twin
    (:meth:`PreferenceGuidedCaptioningModel._decode_module`).
    """

    def __init__(
        self,
        vision_config: ViTConfig,
        text_config: LMConfig,
        decoder_config: LMConfig,
        projection_dim: int = 512,
        temperature: float = 0.5,
        dropout: float = 0.1,
        freeze_vision_backbone: bool = False,
        freeze_text_backbone: bool = False,
        share_text_tower: bool = False,
        dtype: torch.dtype = torch.float32,
        decoder_quant: Optional[str] = None,
    ):
        super().__init__()
        if decoder_quant and share_text_tower:
            raise ValueError("decoder_quant with share_text_tower would quantize the training text tower; "
                             "use a dedicated decoder")
        self.vision_config = vision_config
        self.text_config = text_config
        self.decoder_config = decoder_config
        self.temperature = temperature
        self.dtype = dtype
        self.vision_encoder = VisionEncoder(
            vision_config, projection_dim, dropout, freeze_vision_backbone, dtype)
        # one LM as text tower and decoder backbone (JAX ``shared_lm``, model.py:77-107), registered once,
        # under its own name: the text tower and the decoder refer to it without owning it
        shared = TransformerLM(decoder_config, with_lm_head=True, dtype=dtype) if share_text_tower else None
        self.caption_decoder = CaptionDecoder(decoder_config, projection_dim, dropout=dropout, dtype=dtype,
                                              shared_lm=shared, quant=decoder_quant)
        self.text_encoder = TextEncoder(text_config, projection_dim, dropout, freeze_text_backbone, dtype,
                                        shared_backbone=shared)
        if shared is not None:
            self.shared_lm = shared

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.dtype

    def encode_image(self, images: torch.Tensor, generator: Optional[torch.Generator] = None) -> dict:
        """Normalized NHWC images -> ``features``, ``embeddings``, ``pooled_output``."""
        return self.vision_encoder(images, generator)

    def encode_text(
        self,
        caption_ids: torch.Tensor,
        caption_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """Token ids (B, S) and mask -> ``hidden_states``, ``pooled_output``, ``embeddings``."""
        return self.text_encoder(caption_ids, caption_mask, generator)

    def decode_train(
        self,
        caption_ids: torch.Tensor,
        caption_mask: Optional[torch.Tensor],
        vision_embeddings: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        with_logits: bool = True,
    ) -> dict:
        """The decoder's teacher-forced forward: ``hidden_states`` and (unless not asked) ``logits``."""
        return self.caption_decoder(caption_ids, caption_mask, vision_embeddings, generator, with_logits)

    def forward(
        self,
        images: torch.Tensor,
        caption_ids: Optional[torch.Tensor] = None,
        caption_mask: Optional[torch.Tensor] = None,
        labels: Optional[torch.Tensor] = None,
        mode: str = "contrastive",
        generator: Optional[torch.Generator] = None,
    ) -> dict:
        """The main forward (JAX model.py:142-173) in ``mode`` contrastive, generation or dual.

        Contrastive (and dual): l2-normalized ``image_embeddings`` and
        ``text_embeddings``. Generation (and dual): the decoder's ``logits``
        and, with ``labels``, the caption cross-entropy ``loss``. Always
        ``vision_embeddings``. ``generator`` drives dropout (None:
        deterministic, as JAX's ``deterministic=True``).
        """
        if mode not in ("contrastive", "generation", "dual"):
            raise ValueError(f"Unknown mode: {mode!r}")
        if caption_ids is None:
            raise ValueError(f"{mode} mode requires caption_ids")
        vision = self.encode_image(images, generator)
        outputs = {}
        if mode in ("contrastive", "dual"):
            text = self.encode_text(caption_ids, caption_mask, generator)
            outputs["image_embeddings"] = l2_normalize(vision["embeddings"])
            outputs["text_embeddings"] = l2_normalize(text["embeddings"])
        if mode in ("generation", "dual"):
            dec = self.decode_train(caption_ids, caption_mask, vision["embeddings"], generator)
            outputs["logits"] = dec["logits"]
            if labels is not None:
                mask = caption_mask if caption_mask is not None else torch.ones_like(labels)
                outputs["loss"] = caption_cross_entropy(dec["logits"], labels, mask)
        outputs["vision_embeddings"] = vision["embeddings"]
        return outputs

    def compute_similarity(
        self, images: torch.Tensor, caption_ids: torch.Tensor, caption_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B_img, B_txt) cosine similarity / temperature (JAX model.py:175-181)."""
        img = l2_normalize(self.encode_image(images)["embeddings"].to(torch.float32))
        txt = l2_normalize(self.encode_text(caption_ids, caption_mask)["embeddings"].to(torch.float32))
        return img @ txt.T / self.temperature

    def decode_prefix(self, vision_embeddings, caches, attention_mask):
        return self.caption_decoder.decode_prefix(vision_embeddings, caches, attention_mask)

    def decode_step(self, token_ids, position, caches, attention_mask, vision_embeddings=None):
        return self.caption_decoder.decode_step(token_ids, position, caches, attention_mask, vision_embeddings)


def build_module(
    vision_model: Union[str, ViTConfig] = "openai/clip-vit-base-patch32",
    text_model: Union[str, LMConfig] = "gpt2-medium",
    projection_dim: int = 512,
    temperature: float = 0.5,
    dropout: float = 0.1,
    vocab_size: int = 50257,
    max_caption_length: int = 128,
    freeze_vision_backbone: bool = False,
    freeze_text_backbone: bool = False,
    share_text_tower: bool = False,
    dtype: torch.dtype = torch.float32,
    remat: bool = False,
    decoder_quant: Optional[str] = None,
) -> PreferenceGuidedCaptioningModule:
    """Resolve presets (or take configs as given, e.g. with a cut depth) and build the module.

    As in the JAX package (model.py:184-231), the text tower and the decoder
    share one configuration: the text architecture with the tokenizer's
    vocab, room for the caption plus the vision token, and ``dropout``.
    ``remat`` turns on activation checkpointing in every tower.
    """
    vision_config = vision_model if isinstance(vision_model, ViTConfig) else get_vision_config(vision_model)
    vision_config = dataclasses.replace(vision_config, remat=remat)
    base = text_model if isinstance(text_model, LMConfig) else get_text_config(text_model)
    max_pos = max(base.max_position_embeddings, max_caption_length + 1)
    text_config = dataclasses.replace(base, vocab_size=vocab_size, max_position_embeddings=max_pos, dropout=dropout,
                                      remat=remat)
    return PreferenceGuidedCaptioningModule(
        vision_config, text_config, text_config, projection_dim, temperature, dropout,
        freeze_vision_backbone, freeze_text_backbone, share_text_tower, dtype, decoder_quant,
    )


def frozen_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` with every floating parameter cast to ``dtype``, frozen.

    As the JAX package's ``cast_floating`` (model.py:370-387, trainer.py:
    749-763); LayerNorm and RMSNorm parameters are then put back in float32,
    holding the rounded values that cast gives, because the norm kernels read
    f32 weights (JAX's ``_ln_ref`` and ``_rms_ref`` read the rounded values in
    f32 too). The bf16 serving copy and the stage-2 DPO reference are made
    here.
    """
    copy = cast_floating(module, dtype)
    for m in copy.modules():
        if isinstance(m, NORMS):
            m.float()
    return copy.requires_grad_(False)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Random initialisation in a fixed order from ``generator`` (CPU tensors).

    The same distributions as the JAX package's Flax initialisers: Dense and
    the patch conv lecun-normal (std 1/sqrt(fan_in)) with zero bias,
    embeddings normal(0.02) (``wpe`` 0.01), ``cls_token``/``pos_embed``
    normal(0.02), LayerNorm ones and zeros, RMSNorm ones. The values differ from JAX's
    (other generator); tests bridge JAX weights with models/convert.py.
    """
    for name, p in module.named_parameters():
        owner = module.get_submodule(name.rsplit(".", 1)[0])
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(owner, NORMS):
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
        temperature: float = 0.5,
        dropout: float = 0.1,
        freeze_vision_backbone: bool = True,
        freeze_text_backbone: bool = False,
        tokenizer: Optional[CaptionTokenizer] = None,
        max_caption_length: int = 128,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        image_size: Optional[int] = None,
        vocab_size: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        remat: bool = False,
        share_text_tower: bool = False,
        lora_config: Optional[Dict] = None,
        quantization: Optional[str] = None,
    ):
        if quantization and quantization not in INT8_MODES:
            raise ValueError(f"quantization must be one of {INT8_MODES}, got {quantization!r}")
        self.device = resolve_device(device)
        if tokenizer is None:
            from_name = isinstance(text_model, str)
            tokenizer = CaptionTokenizer.from_pretrained(text_model) if from_name else CaptionTokenizer()
        self.tokenizer = tokenizer
        self.dtype = dtype
        self.max_caption_length = max_caption_length
        self.freeze_vision_backbone = freeze_vision_backbone
        self.freeze_text_backbone = freeze_text_backbone
        self._build_kwargs = dict(
            vision_model=vision_model, text_model=text_model, projection_dim=projection_dim,
            temperature=temperature, dropout=dropout,
            # may pad the embedding beyond the tokenizer; never below it
            vocab_size=max(vocab_size or 0, tokenizer.vocab_size),
            max_caption_length=max_caption_length,
            freeze_vision_backbone=freeze_vision_backbone,
            freeze_text_backbone=freeze_text_backbone,
            share_text_tower=share_text_tower,
            dtype=dtype,
            remat=remat,
        )
        # The meta device skips PyTorch's default init; init_params then fills
        # every parameter once, on the CPU, so one seed gives the same weights
        # whatever the target device.
        with torch.device("meta"):
            module = build_module(**self._build_kwargs)
        module = module.to_empty(device="cpu")
        init_params(module, torch.Generator().manual_seed(seed))
        self.module = module.to(self.device).eval()
        self.image_size = image_size or self.module.vision_config.image_size
        self.quantization = quantization
        self._inference_cache: Optional[nn.Module] = None
        self._inference_key: List[Tuple[nn.Parameter, int]] = []
        self._quant_cache: Optional[nn.Module] = None  # the int8 decode twin
        self._quant_key: List[Tuple[nn.Parameter, int]] = []
        self._decode_graphs = None  # generation/slots.py:DecodeGraphs of the decode module, on the card
        # LoRA (JAX model.py:302-320): factors outside the module, models/lora.py; the normalized
        # schema of lora.normalize_lora_config
        self.lora_config = lora_config
        self.lora: Optional[Adapters] = None
        if lora_config:
            if lora_config.get("dropout", 0.0):
                logger.info("lora_dropout=%s active as per-step adapter-input DropConnect (peft drops per "
                            "token; see models/lora.py:dropout_masks)", lora_config["dropout"])
            self.lora = init_lora(self.module, stream_generator(seed, 1),
                                  rank=lora_config["rank"], targets=lora_config["targets"])

    def num_parameters(self) -> Dict[str, int]:
        """Parameter counts per top-level tower, ``total`` and ``trainable`` (JAX model.py:533-553).

        With LoRA the base is frozen: ``lora`` counts the factors and is the
        trainable count. A shared text tower counts once, as ``shared_lm``.
        """
        per = {name: sum(p.numel() for p in child.parameters()) for name, child in self.module.named_children()}
        per["total"] = sum(p.numel() for p in self.module.parameters())
        if self.lora is not None:
            per["lora"] = per["trainable"] = count_lora_params(self.lora)
            return per
        frozen = 0
        if self.freeze_vision_backbone:
            frozen += sum(p.numel() for p in self.module.vision_encoder.backbone.parameters())
        if self.freeze_text_backbone:
            frozen += sum(p.numel() for p in self.module.text_encoder.backbone.parameters())
        per["trainable"] = per["total"] - frozen
        return per

    def load_jax_params(self, params: Mapping, lora: Optional[Mapping] = None) -> None:
        """Copy a JAX parameter tree (nested dicts of numpy arrays) into the masters; ``lora``, a JAX
        factor dict ({path: (A, B)} of arrays), replaces the adapters (their paths and shapes checked)."""
        load_jax_params(self.module, params)
        if lora is not None:
            if not self.lora_config:
                raise ValueError("load_jax_params(lora=...) needs a model built with lora_config")
            want = target_shapes(self.module, self.lora_config["targets"])
            rank = self.lora_config["rank"]
            got = {p: (np.shape(a), np.shape(b)) for p, (a, b) in lora.items()}
            if got != {p: ((fi, rank), (rank, fo)) for p, (fi, fo) in want.items()}:
                raise ValueError("the JAX LoRA factors do not match this model's targets, paths or shapes")
            self.lora = from_numpy(lora, self.device)

    def load_pretrained_towers(self, vision_path=None, text_path=None, decoder_path=None) -> None:
        """Import weights from local HF checkpoint directories, offline (JAX model.py:478-529).

        ``vision_path``: a ``CLIPVisionModel`` directory for the vision
        backbone; ``text_path``: a GPT-2 or Llama directory for the text
        backbone (the shared LM under ``share_text_tower``); ``decoder_path``
        (the text path by default): the decoder's LM, unless it is shared.
        Each directory holds ``pytorch_model.bin`` or ``model.safetensors``.
        The projection heads and the cross-attention keep their values (the
        reference has no pretrained weights for them); embedding rows past the
        checkpoint's vocab keep the module's (:func:`convert.pad_vocab_rows`).
        Every tower is converted and checked before any master is written, and
        the masters change in place, so the bf16 serving copy, the int8 twin
        and the captured decode graphs follow them; an engine built earlier in
        float32 keeps the weights it was built with, one built after serves
        these.
        """
        from pgica_tpu_torch.models import convert

        module = self.module
        plan: convert.Plan = []
        if vision_path:
            tree = convert.convert_clip_vision(convert.read_state_dict(vision_path), module.vision_config)
            plan += convert.plan_jax_params(module.vision_encoder.backbone, tree, "vision")
        shared = getattr(module, "shared_lm", None)

        def lm_plan(path, lm: TransformerLM, name: str) -> convert.Plan:
            convert_lm = convert.convert_llama if lm.config.arch == "llama" else convert.convert_gpt2
            tree = convert.pad_vocab_rows(convert_lm(convert.read_state_dict(path), lm.config), lm, name)
            return convert.plan_jax_params(lm, tree, name)

        if text_path:
            plan += lm_plan(text_path, shared if shared is not None else module.text_encoder.backbone, "text")
        decoder_path = decoder_path or text_path
        if decoder_path and shared is None:
            plan += lm_plan(decoder_path, module.caption_decoder.lm, "decoder")
        convert.write_plan(plan)
        logger.info("Loaded pretrained towers (vision=%s text=%s decoder=%s)", vision_path, text_path,
                    decoder_path if shared is None else "shared")

    def _inference_module(self) -> PreferenceGuidedCaptioningModule:
        """The module in the compute dtype for inference.

        Float32 runs on the masters; bf16 on a :func:`frozen_copy`, cached
        until a master changes. The train steps and ``load_jax_params``
        update the masters in place, which bumps each tensor's version
        counter, so the cache is keyed on every master's identity and
        version (the JAX package keys its cast on the identity of
        ``self.params``, which its trainer replaces: model.py:370-387).
        Setting ``_inference_cache`` to None releases the copy's memory. A
        new copy drops the decode graphs captured on the old one (they hold
        its weights by address); the float32 masters change in place, so
        their graphs stay valid.
        """
        if self.dtype == torch.float32:
            return self.module
        if self._inference_cache is None or not self._fresh(self._inference_key):
            self._inference_cache = None  # free the old copy before casting the new one
            if not self.quantization:
                self._decode_graphs = None
            self._inference_cache = frozen_copy(self.module, self.dtype)
            self._inference_key = self._masters_key()
        return self._inference_cache

    def _masters_key(self) -> List[Tuple[nn.Parameter, int]]:
        return [(p, p._version) for p in self.module.parameters()]

    def _fresh(self, key: List[Tuple[nn.Parameter, int]]) -> bool:
        """Whether every master is the one ``key`` holds, unchanged since (identity and version)."""
        params = list(self.module.parameters())
        return len(params) == len(key) and all(p is q and p._version == v for p, (q, v) in zip(params, key))

    def _decode_module(self) -> PreferenceGuidedCaptioningModule:
        """The module that decodes: the inference module, or with ``quantization`` its int8 twin.

        The twin (JAX ``_decode_module_and_params``, model.py:389-412) is the
        module built with ``decoder_quant``: the decoder LM's blocks hold int8
        weights quantized from the float32 masters (never from the bf16
        copy), every other parameter the masters' values in the compute
        dtype. It is cached as the bf16 copy is, keyed on every master's
        identity and version, and rebuilt after any change; the decode graphs
        captured on the old twin are dropped with it.
        """
        if not self.quantization:
            return self._inference_module()
        if self._quant_cache is None or not self._fresh(self._quant_key):
            self._quant_cache = self._decode_graphs = None  # free the old twin and its graphs first
            with torch.device("meta"):
                twin = build_module(**{**self._build_kwargs, "decoder_quant": self.quantization})
            twin = cast_for_twin(twin.to_empty(device=self.device), self.dtype)
            self._quant_cache = quantize_like(twin, self.module,
                                              None if self.dtype == torch.float32 else self.dtype).eval()
            self._quant_key = self._masters_key()
            logger.info("Quantized decoder params (%s) for decode", self.quantization)
        return self._quant_cache

    def _images(self, images) -> torch.Tensor:
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return prepare_images(images.to(self.device))

    @torch.inference_mode()
    def encode_image(self, images) -> dict:
        """uint8 (or normalized float) NHWC images -> dict of tensors on the device."""
        return self._inference_module().encode_image(self._images(images))

    @property
    def temperature(self) -> float:
        """The contrastive temperature that ``compute_similarity`` divides by."""
        return self.module.temperature

    @torch.inference_mode()
    def compute_similarity(self, images, caption_ids, caption_mask=None) -> np.ndarray:
        """(B_img, B_txt) cosine similarity / temperature on the host (JAX model.py:366-368).

        ``images`` as ``encode_image`` takes them; ``caption_ids`` and
        ``caption_mask`` are (B_txt, S) integer arrays or tensors, the mask
        ones by default.
        """
        ids = torch.as_tensor(caption_ids, device=self.device)
        mask = torch.ones_like(ids) if caption_mask is None else torch.as_tensor(caption_mask, device=self.device)
        return self._inference_module().compute_similarity(self._images(images), ids, mask).cpu().numpy()

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

        ``num_beams > 1`` runs beam search (the sampling flags are then
        ignored) with ``length_penalty``. ``early_stop=True`` ends the loop
        once every caption in the batch emitted EOS, or, with beams, once no
        live beam can beat the finished ones (result-identical for
        ``length_penalty >= 0``; the serving default). On the card every
        decode step is a replayed CUDA graph, kept with the inference module
        (not safe for two threads at once): greedy and sampled decoding's,
        captured at the first call of each (batch, max_length, sampling
        flags); beam search's two (generation/decode.py:BeamGraphs), at the
        first call of each (batch, max_length, num_beams, length and
        repetition penalties), for the two beam shapes last used.
        """
        from pgica_tpu_torch.generation.decode import generate  # decode imports models: no cycle at import
        from pgica_tpu_torch.generation.slots import DecodeGraphs

        module = self._decode_module()
        if self.device.type == "cuda" and (self._decode_graphs is None or self._decode_graphs.module is not module):
            self._decode_graphs = DecodeGraphs(module, self.device)
        # Phase times below are enqueue-side except the last, which ends in a
        # device->host copy; only the total is a true wall-clock.
        t0 = time.perf_counter()
        vision = self.encode_image(images)
        t_encode = time.perf_counter() - t0

        t0 = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(seed) if do_sample and num_beams == 1 else None
        token_ids = generate(
            module,
            vision["embeddings"],
            eos_token_id=self.tokenizer.eos_token_id,
            pad_token_id=self.tokenizer.pad_token_id,
            max_length=max_length,
            num_beams=num_beams,
            temperature=temperature,
            do_sample=do_sample,
            top_p=top_p,
            repetition_penalty=repetition_penalty,
            length_penalty=length_penalty,
            generator=generator,
            early_stop=early_stop,
            graphs=self._decode_graphs if self.device.type == "cuda" else None,
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
