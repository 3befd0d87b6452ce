"""Image and text preprocessing (the port's copy of pgica_tpu/data/preprocessing.py).

* **Host side** (this module): JPEG/PNG decode (PIL, or the native libjpeg
  path of :mod:`pgica_tpu_torch.data.native_image`), resize-to-square,
  uint8 -> float32, ImageNet normalization. Arrays are NHWC, as the JAX
  package's, and the models take NHWC.
* **Device side** (:mod:`pgica_tpu_torch.data.augment`): normalization of
  uint8 batches and the train-time augmentation.

TextProcessor wraps the shared :class:`CaptionTokenizer`.
tests/test_torch_data.py holds both processors to the JAX package's.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from pgica_tpu_torch.data.tokenizer import CaptionTokenizer

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class ImageProcessor:
    """Decode + resize + normalize images to NHWC float32 (reference C2)."""

    def __init__(
        self,
        image_size: int = 224,
        augment: bool = False,
        normalize: bool = True,
        device_side_normalization: bool = False,
        native_decode: str = "off",
    ):
        self.image_size = int(image_size)
        self.augment = bool(augment)  # device-side augmentation flag (the train steps' ``augment``)
        self.normalize = bool(normalize)
        # When set, process_image returns resized uint8 and normalization
        # happens on device (augment.prepare_images) — 4x less host->device
        # transfer than float32.
        self.device_side_normalization = bool(device_side_normalization)
        # "fast": JPEG paths/bytes run native libjpeg decode with DCT-domain
        # pre-scaling + PIL-BILINEAR-equivalent triangle resize in one C call
        # (native/image.cpp, within ~1 LSB of the PIL path on bandlimited
        # content). "off" (default): exact PIL path. Anything the native
        # decoder rejects (non-JPEG, CMYK, corrupt), or a host where the
        # library does not build, falls back to PIL.
        if native_decode not in ("off", "fast"):
            raise ValueError(f"native_decode must be 'off' or 'fast', got {native_decode!r}")
        self.native_decode = native_decode

    # -- host path -------------------------------------------------------------

    def load_image(self, source) -> "np.ndarray":
        """PIL-decode a path/file/bytes/PIL image to uint8 RGB (H, W, 3)."""
        import io

        from PIL import Image

        if isinstance(source, (str, Path)):
            img = Image.open(source)
        elif isinstance(source, (bytes, bytearray)):
            # Encoded image bytes (serving wire format): JPEGs normally take
            # the native fast path before reaching here; this is the PIL
            # fallback for PNG/WebP/CMYK/corrupt-JPEG bytes.
            img = Image.open(io.BytesIO(source))
        elif isinstance(source, Image.Image):
            img = source
        elif isinstance(source, np.ndarray):
            return np.ascontiguousarray(source[..., :3]).astype(np.uint8)
        else:
            raise ValueError(f"Unsupported image input type: {type(source)}")
        return np.asarray(img.convert("RGB"), dtype=np.uint8)

    def resize(self, image_u8: np.ndarray) -> np.ndarray:
        from PIL import Image

        if image_u8.shape[:2] == (self.image_size, self.image_size):
            return image_u8
        pil = Image.fromarray(image_u8)
        pil = pil.resize((self.image_size, self.image_size), Image.BILINEAR)
        return np.asarray(pil, dtype=np.uint8)

    def _native_decode_resize(self, source):
        """JPEG path/bytes -> resized u8 via native/image.cpp, else None."""
        if self.native_decode != "fast":
            return None
        if isinstance(source, (str, Path)):
            try:
                with open(source, "rb") as f:
                    head = f.read(3)
                    if head != b"\xff\xd8\xff":
                        return None
                    data = head + f.read()
            except OSError:
                return None
        elif isinstance(source, (bytes, bytearray)):
            if not bytes(source[:3]) == b"\xff\xd8\xff":
                return None
            data = bytes(source)
        else:
            return None
        from pgica_tpu_torch.data.native_image import decode_resize_jpeg

        return decode_resize_jpeg(data, self.image_size, prescale=True)

    def process_image(self, source) -> np.ndarray:
        """Full host pipeline: decode → resize → float32 [0,1] → normalize.

        Returns (H, W, 3) float32. Invalid inputs raise ValueError.
        """
        resized = self._native_decode_resize(source)
        if resized is None:
            resized = self.resize(self.load_image(source))
        if self.device_side_normalization:
            return resized  # uint8; see augment.prepare_images
        arr = resized.astype(np.float32) / 255.0
        if self.normalize:
            arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
        return arr

    def process_batch(self, sources: Sequence) -> np.ndarray:
        return np.stack([self.process_image(s) for s in sources])

    def denormalize(self, image: np.ndarray) -> np.ndarray:
        """Invert normalization back to [0,1] (reference preprocessing.py:120-143)."""
        arr = np.asarray(image, np.float32)
        if self.normalize:
            arr = arr * IMAGENET_STD + IMAGENET_MEAN
        return np.clip(arr, 0.0, 1.0)

    def zero_image(self) -> np.ndarray:
        """Fallback tensor for corrupt images (reference loader.py:242-247)."""
        return np.zeros((self.image_size, self.image_size, 3), np.float32)


class TextProcessor:
    """Caption tokenization wrapper over the shared tokenizer (reference C3)."""

    def __init__(
        self,
        tokenizer: Optional[CaptionTokenizer] = None,
        model_name: str = "gpt2-medium",
        max_length: int = 128,
    ):
        self.tokenizer = tokenizer or CaptionTokenizer.from_pretrained(model_name)
        self.max_length = int(max_length)

    def encode_caption(self, caption: str, max_length: Optional[int] = None) -> dict:
        if not isinstance(caption, str):
            raise ValueError(f"Caption must be a string, got {type(caption)}")
        max_length = max_length or self.max_length
        ids, mask = self.tokenizer.encode_padded(caption, max_length)
        return {"input_ids": ids, "attention_mask": mask}

    def encode_batch(self, captions: Sequence[str], max_length: Optional[int] = None) -> dict:
        max_length = max_length or self.max_length
        ids, mask = self.tokenizer.encode_batch(list(captions), max_length)
        return {"input_ids": ids, "attention_mask": mask}

    def decode_caption(self, ids, skip_special_tokens: bool = True) -> str:
        ids = np.asarray(ids).reshape(-1)
        return self.tokenizer.decode(ids.tolist(), skip_special_tokens=skip_special_tokens)

    def decode_batch(self, batch_ids, skip_special_tokens: bool = True) -> List[str]:
        batch_ids = np.asarray(batch_ids)
        return [self.decode_caption(row, skip_special_tokens) for row in batch_ids]

    def prepare_for_generation(self, prompt: str = "") -> dict:
        """BOS-seeded (optionally prompted) ids for decoding (reference 339-363)."""
        ids = [self.tokenizer.bos_token_id] + self.tokenizer.encode(prompt)
        arr = np.asarray(ids, np.int32)[None, :]
        return {"input_ids": arr, "attention_mask": np.ones_like(arr)}

    # -- vocab properties (reference preprocessing.py:365-383) -------------------

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.vocab_size

    @property
    def pad_token_id(self) -> int:
        return self.tokenizer.pad_token_id

    @property
    def bos_token_id(self) -> int:
        return self.tokenizer.bos_token_id

    @property
    def eos_token_id(self) -> int:
        return self.tokenizer.eos_token_id
