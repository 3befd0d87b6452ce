"""Factories of the CLIs (the port's copy of pgica_tpu/utils/factories.py).

Logging setup, seeding, tokenizer, processors, model, metrics and loaders
from a :class:`~pgica_tpu_torch.utils.config.Config`, with the dummy-data fallback:
when a configured data path does not exist, an in-memory synthetic dataset
(the JAX package's, the same numpy values for one seed) takes its place, so
the CLI runs without any dataset.

Config keys the port reads differently:

* ``hardware.rng`` picks a JAX PRNG implementation; the port ignores it
  (its generators are ``torch.Generator``s).
* ``hardware.gradient_checkpointing`` sets the towers' ``remat``.
* ``pallas.enabled: false`` asks for the plain versions in place of the
  kernels; on the card that would take the kernels off the main path, so
  it raises there (on the CPU the plain versions run anyway).
* ``model.scan_layers`` (a ``lax.scan`` layout) has no meaning in eager
  PyTorch: the blocks stay unrolled, the weight bridge takes such a model's
  stacked tree (models/convert.py), and the trainer reads the flag only to
  refuse ``mesh.zero3`` without it, as the JAX trainer does.
* ``data.workers_mode: grain`` runs PyTorch's own batch-level worker pool
  (data/loader.py); the port never imports ``grain``.
* ``create_mesh`` builds the mesh over the ``torch.distributed`` ranks
  (parallel/mesh.py), initializing the process group from the environment
  (``torchrun``) unless the caller already has.
"""

from __future__ import annotations

import hashlib
import logging
import random
import sys
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

_DUMMY_CAPTION_PARTS = (
    ("a", "the", "one"),
    ("red", "blue", "green", "small", "large", "old", "young"),
    ("bird", "dog", "cat", "car", "house", "tree", "person", "boat"),
    ("sitting on", "standing near", "moving past", "resting under"),
    ("a branch", "the beach", "a table", "the street", "a mountain"),
)


def setup_logging(log_dir: Optional[str] = None, level: str = "INFO", filename: str = "training.log"):
    handlers = [logging.StreamHandler(sys.stdout)]
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(Path(log_dir) / filename))
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=handlers,
        force=True,
    )


def set_seed(seed: int = 42):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_dtype(config) -> torch.dtype:
    from pgica_tpu_torch.core.precision import compute_dtype

    return compute_dtype(config.get("hardware.mixed_precision", "no"))


def create_tokenizer(config):
    """Tokenizer resolution: local HF artifacts > dataset-trained BPE > byte fallback.

    ``data.bpe_vocab_size`` trains a byte-level BPE on the configured caption
    corpus, cached under ``paths.cache_dir`` as ``bpe_{size}_{key}`` (key: a
    hash of the corpus path and the size, as the JAX package's), so a second
    run loads it.
    """
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer

    name = config.get("model.text_model", "gpt2-medium")
    if Path(str(name)).is_dir():  # local HF artifacts win
        return CaptionTokenizer.from_pretrained(name)

    vocab_size = config.get("data.bpe_vocab_size")
    data_path = Path(config.get("data.conceptual_captions_path", ""))
    if vocab_size and data_path.exists():
        cache_root = Path(config.get("paths.cache_dir", "./cache"))
        key = hashlib.sha1(f"{data_path.resolve()}|{vocab_size}".encode()).hexdigest()[:12]
        cache_dir = cache_root / f"bpe_{vocab_size}_{key}"
        if (cache_dir / "vocab.json").exists():
            logger.info("Loading cached dataset BPE from %s", cache_dir)
            return CaptionTokenizer.load(cache_dir)
        corpus = read_caption_corpus(data_path)
        if corpus:
            logger.info("Training %d-entry BPE on %d captions from %s", vocab_size, len(corpus), data_path)
            tok = CaptionTokenizer.train_bpe(corpus, vocab_size=int(vocab_size))
            tok.save(cache_dir)
            return tok
    return CaptionTokenizer.from_pretrained(name)


def read_caption_corpus(data_path) -> list:
    """The caption strings of a CSV/TSV/JSON/directory dataset (its index only: no image is read)."""
    from pgica_tpu_torch.data.loader import ConceptualCaptionsDataset

    try:
        ds = ConceptualCaptionsDataset.__new__(ConceptualCaptionsDataset)
        ds.data_path = Path(data_path)
        ds.max_samples = None
        return [r["caption"] for r in ds._load_index()]
    except (OSError, ValueError, KeyError) as e:  # unreadable, an unknown format, or columns missing
        logger.warning("Could not read caption corpus from %s: %s", data_path, e)
        return []


def _check_kernels_enabled(config, device: torch.device) -> None:
    enabled = config.get("pallas.enabled", "auto")
    if device.type == "cuda" and enabled in (False, "false", "off", 0):
        raise ValueError("pallas.enabled: false would run the plain versions in place of the kernels on the card; "
                         "the port runs its kernels there (the plain versions run on the CPU)")


def create_model(config, tokenizer=None, seed: Optional[int] = None, device: Union[str, torch.device] = "cuda"):
    from pgica_tpu_torch.core.device import resolve_device
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

    from pgica_tpu_torch.models.lora import normalize_lora_config

    device = resolve_device(device)
    _check_kernels_enabled(config, device)
    tokenizer = tokenizer or create_tokenizer(config)
    return PreferenceGuidedCaptioningModel(
        lora_config=normalize_lora_config(config.get("model.lora_config")),
        share_text_tower=bool(config.get("model.share_text_tower", False)),
        # decode-time int8 ("int8" W8A8 | "int8_weight_only"); training is never quantized
        quantization=config.get("inference.quantization") or None,
        vocab_size=config.get("model.vocab_size"),
        vision_model=config.get("model.vision_model", "openai/clip-vit-base-patch32"),
        text_model=config.get("model.text_model", "gpt2-medium"),
        projection_dim=config.get("model.projection_dim", 512),
        temperature=config.get("model.temperature", 0.5),
        dropout=config.get("model.dropout", 0.1),
        freeze_vision_backbone=config.get("model.freeze_vision_backbone", True),
        freeze_text_backbone=config.get("model.freeze_text_backbone", False),
        tokenizer=tokenizer,
        max_caption_length=config.get("data.max_caption_length", 128),
        dtype=resolve_dtype(config),
        remat=bool(config.get("hardware.gradient_checkpointing", False)),
        seed=seed if seed is not None else config.get("training.seed", 42),
        image_size=config.get("data.image_size", None),
        device=device,
    )


def create_mesh(config, device: Union[str, torch.device] = "cuda"):
    """The config's ``mesh`` over this process's ranks (JAX factories.py:237-240); the process group
    is initialized first where ``WORLD_SIZE`` asks for one (NCCL on ``cuda``, gloo on the CPU)."""
    from pgica_tpu_torch.parallel.mesh import MeshContext, init_distributed

    init_distributed(device)
    return MeshContext.from_config(config)


def restore_params(model, checkpoint) -> None:
    """Load the parameters of a checkpoint directory (``CheckpointManager``'s layout) into ``model``'s masters."""
    from pgica_tpu_torch.training.checkpoint import CheckpointManager, effective_params

    path = Path(checkpoint)
    if not path.exists():
        raise FileNotFoundError(f"Checkpoint not found: {checkpoint}")
    model.module.load_state_dict(effective_params(CheckpointManager(path.parent).restore(path)))


def create_processors(config, tokenizer=None):
    from pgica_tpu_torch.data.preprocessing import ImageProcessor, TextProcessor

    tokenizer = tokenizer or create_tokenizer(config)
    image_processor = ImageProcessor(
        image_size=config.get("data.image_size", 224),
        # uint8 wire format: the loaders ship raw uint8 and the train steps
        # normalize on the device (augment.prepare_images)
        device_side_normalization=bool(config.get("data.device_side_normalization", False)),
        native_decode=str(config.get("data.native_decode", "off")),
    )
    text_processor = TextProcessor(tokenizer=tokenizer, max_length=config.get("data.max_caption_length", 128))
    return image_processor, text_processor


def create_metrics(config, model=None):
    """CaptioningMetrics wired from config (JAX factories.py:192-240):

    * ``evaluation.clip_judge_checkpoint`` — checkpoint dir of an INDEPENDENT
      contrastive model used as the CLIP-Score judge, built by
      :func:`create_model` on ``model``'s device (the card without a model)
      and restored into its masters. Self-scoring (flagged
      ``clip_score_self_judged``) is the fallback when the checkpoint is
      missing or does not fit the config's model.
    * ``evaluation.bert_score_model_path`` — local HF encoder checkpoint for
      real BERTScore embeddings; proxies (flagged) otherwise.
    * ``evaluation.wordnet_path`` — nltk data directory (real wordnet corpus)
      or JSON synonym table enabling METEOR's synonym stage; without it the
      stage is a flagged no-op.
    """
    from pgica_tpu_torch.evaluation.metrics import CaptioningMetrics

    clip_judge = None
    judge_ckpt = config.get("evaluation.clip_judge_checkpoint")
    if judge_ckpt and Path(str(judge_ckpt)).exists():
        on = {} if model is None else dict(tokenizer=model.tokenizer, device=model.device)
        clip_judge = create_model(config, **on)
        try:
            restore_params(clip_judge, judge_ckpt)
            logger.info("CLIP-Score judge restored from %s", judge_ckpt)
        except (OSError, KeyError, RuntimeError) as e:  # no state file, no params, or another architecture
            logger.warning("clip_judge_checkpoint unusable (%s); self-scoring", e)
            clip_judge = None
    bert_path = config.get("evaluation.bert_score_model_path")
    if bert_path and not Path(str(bert_path)).exists():
        logger.warning("bert_score_model_path %s not found; proxy BERTScore", bert_path)
        bert_path = None
    wordnet_path = config.get("evaluation.wordnet_path")
    if wordnet_path and not Path(str(wordnet_path)).exists():
        logger.warning("wordnet_path %s not found; METEOR synonym stage off", wordnet_path)
        wordnet_path = None
    return CaptioningMetrics(model=model, clip_judge=clip_judge, bert_model_path=bert_path,
                             wordnet_path=wordnet_path)


# ------------------------------------------------------------------ dummy data


def _dummy_caption(rng: np.random.Generator) -> str:
    return " ".join(rng.choice(part) for part in _DUMMY_CAPTION_PARTS)


def _caption_image(caption: str, size: int, rng: np.random.Generator) -> np.ndarray:
    """A synthetic image painted from the caption: each word a coloured block (hash -> colour and
    place), so the contrastive task is learnable on the fallback data."""
    img = 0.35 * rng.normal(0, 1, (size, size, 3)).astype(np.float32)
    block = max(size // 6, 4)
    for word in caption.split():
        h = int(hashlib.sha1(word.encode()).hexdigest()[:12], 16)
        color = np.array([(h >> 8) & 255, (h >> 16) & 255, (h >> 24) & 255], np.float32)
        color = (color / 127.5) - 1.0  # [-1, 1]
        x = h % max(size - block, 1)
        y = (h >> 5) % max(size - block, 1)
        img[y : y + block, x : x + block] += 2.0 * color
    return img


class DummyConceptualDataset:
    """In-memory synthetic (image, caption) data; images are normalized float32."""

    def __init__(self, image_processor, text_processor, num_samples: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        size = image_processor.image_size
        self.captions = [_dummy_caption(rng) for _ in range(num_samples)]
        self.images = np.stack([_caption_image(c, size, rng) for c in self.captions])
        self.text_processor = text_processor

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, i):
        enc = self.text_processor.encode_caption(self.captions[i])
        return {
            "image": self.images[i],
            "caption_ids": enc["input_ids"],
            "caption_mask": enc["attention_mask"],
            "raw_caption": self.captions[i],
            "image_path": f"dummy_{i}.jpg",
        }


class DummyPreferenceDataset:
    """In-memory synthetic preference pairs; the image matches the preferred caption."""

    def __init__(self, image_processor, text_processor, num_samples: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        size = image_processor.image_size
        self.preferred = [_dummy_caption(rng) for _ in range(num_samples)]
        self.rejected = [" ".join(_dummy_caption(rng).split()[:2]) for _ in range(num_samples)]
        self.images = np.stack([_caption_image(c, size, rng) for c in self.preferred])
        self.text_processor = text_processor

    def __len__(self):
        return len(self.preferred)

    def __getitem__(self, i):
        p = self.text_processor.encode_caption(self.preferred[i])
        r = self.text_processor.encode_caption(self.rejected[i])
        return {
            "image": self.images[i],
            "preferred_ids": p["input_ids"],
            "preferred_mask": p["attention_mask"],
            "rejected_ids": r["input_ids"],
            "rejected_mask": r["attention_mask"],
            "preference_score": np.float32(0.9),
            "raw_preferred": self.preferred[i],
            "raw_rejected": self.rejected[i],
            "image_path": f"dummy_{i}.jpg",
        }


def create_loaders_with_fallback(
    config, image_processor, text_processor, kind: str = "conceptual", dummy_samples: Optional[int] = None,
) -> Tuple:
    """(train, val, test) loaders from real data, or the dummy fallback."""
    from pgica_tpu_torch.data.loader import (
        ConceptualCaptionsDataset,
        DataLoader,
        UltraFeedbackDataset,
        create_dataloaders,
    )

    if kind == "conceptual":
        data_path = Path(config.get("data.conceptual_captions_path", ""))
        dataset_class = ConceptualCaptionsDataset
        batch_size = config.get("training.stage1.batch_size", 8)
    else:
        data_path = Path(config.get("data.ultrafeedback_path", ""))
        dataset_class = UltraFeedbackDataset
        batch_size = config.get("training.stage2.batch_size", 8)

    seed = config.get("training.seed", 42)
    if data_path and data_path.exists():
        return create_dataloaders(
            dataset_class,
            data_path,
            image_processor,
            text_processor,
            batch_size=batch_size,
            train_split=config.get("data.train_split", 0.8),
            val_split=config.get("data.val_split", 0.1),
            test_split=config.get("data.test_split", 0.1),
            seed=seed,
            num_workers=config.get("data.num_workers", 0),
            workers_mode=config.get("data.workers_mode", "thread"),
        )

    logger.warning("Data path %s not found; using in-memory dummy %s data", data_path, kind)
    if dummy_samples is None:
        dummy_samples = int(config.get("data.dummy_samples", 64))
    dummy_cls = DummyConceptualDataset if kind == "conceptual" else DummyPreferenceDataset
    n_val = max(dummy_samples // 8, batch_size)
    train = dummy_cls(image_processor, text_processor, dummy_samples, seed)
    val = dummy_cls(image_processor, text_processor, n_val, seed + 1)
    test = dummy_cls(image_processor, text_processor, n_val, seed + 2)
    return (
        DataLoader(train, batch_size, shuffle=True, drop_last=True, seed=seed),
        DataLoader(val, batch_size),
        DataLoader(test, batch_size),
    )
