"""Datasets and dataloaders (the port's copy of pgica_tpu/data/loader.py).

NHWC numpy batches, moved to the device by the train steps:

* :class:`ConceptualCaptionsDataset` — image/caption pairs from CSV/TSV/JSON
  (column-name normalization) or a directory of images with ``.txt`` /
  ``.caption`` sidecars; relative-path resolution; ``max_samples``; optional
  in-memory cache; zero-image fallback for corrupt files.
* :class:`UltraFeedbackDataset` — preference pairs in the three accepted
  formats (UltraFeedback conversations, direct pairs, scored caption lists)
  with a score-difference threshold.
* :class:`DataLoader` — batching iterator with seeded shuffling,
  ``drop_last``, a background prefetch thread and ``thread``/``process``
  item workers, or ``grain`` batch workers; its per-epoch order is a pure
  function of ``(seed, epoch)`` (``set_epoch``, ``iter_batches(start)``), so
  a mid-epoch resume replays it.
* :func:`create_dataloaders` — seeded 80/10/10 split, each split its own view.

On a device mesh (``DataLoader.set_shard(mesh)``, which the trainer calls)
each rank yields exactly the rows ``MeshContext.shard_batch`` keeps of the
batch the one-process loader gives: every rank decodes the whole global
batch, in the same seeded order, and keeps its block of rows (a batch the
ranks do not divide raises, as the JAX package's ``device_put`` does).

``workers_mode="grain"`` keeps the JAX package's design (spawned workers
that each fetch and collate whole batches, one persistent pool for the run,
the epoch's order recomputed in the worker) on PyTorch's own batch-level
worker pool, ``torch.utils.data.DataLoader`` with ``batch_size=None``; the
port never imports ``grain``. tests/test_torch_data.py and
tests/test_torch_grain.py hold every batch equal to the JAX loader's.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from pgica_tpu_torch.data.preprocessing import ImageProcessor, TextProcessor

logger = logging.getLogger(__name__)

_IMAGE_KEYS = ("image", "image_path", "image_url", "url")
_CAPTION_KEYS = ("caption", "text", "description")
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _resolve_path(path: str, base: Path) -> str:
    p = Path(path)
    if p.is_absolute():
        return str(p)
    if (base / p).exists():
        return str(base / p)
    return str(p.resolve())


class _BaseImageDataset:
    """Shared image loading with corrupt-file fallback and optional cache."""

    def __init__(self, image_processor: ImageProcessor, cache_images: bool = False):
        self.image_processor = image_processor
        self.cache_images = cache_images
        self._image_cache: Dict[str, np.ndarray] = {}

    def _load_image(self, path: str) -> np.ndarray:
        if self.cache_images and path in self._image_cache:
            return self._image_cache[path]
        try:
            img = self.image_processor.process_image(path)
        except Exception as e:  # zero fallback, reference loader.py:242-247
            logger.warning("Failed to load image %s (%s); using zero fallback", path, e)
            img = self.image_processor.zero_image()
        if self.cache_images:
            self._image_cache[path] = img
        return img


class ConceptualCaptionsDataset(_BaseImageDataset):
    """Conceptual-Captions-style (image, caption) dataset (reference C4)."""

    def __init__(
        self,
        data_path,
        image_processor: ImageProcessor,
        text_processor: TextProcessor,
        split: str = "train",
        max_samples: Optional[int] = None,
        cache_images: bool = False,
    ):
        super().__init__(image_processor, cache_images)
        self.data_path = Path(data_path)
        self.text_processor = text_processor
        self.split = split
        self.max_samples = max_samples
        self.data = self._load_index()
        if not self.data:
            raise ValueError(f"No valid image/caption pairs found in {self.data_path}")

    # -- index construction ------------------------------------------------------

    def _load_index(self) -> List[Dict[str, str]]:
        if not self.data_path.exists():
            raise FileNotFoundError(f"Data path does not exist: {self.data_path}")
        if self.data_path.is_dir():
            ann = self.data_path / "annotations.json"
            records = self._from_json(ann) if ann.exists() else self._from_directory()
            base = self.data_path
        else:
            ext = self.data_path.suffix.lower()
            if ext in (".csv", ".tsv"):
                records = self._from_table(ext)
            elif ext == ".json":
                records = self._from_json(self.data_path)
            else:
                raise ValueError(f"Unsupported file format: {ext}")
            base = self.data_path.parent

        out = []
        for rec in records:
            caption = str(rec.get("caption", "")).strip()
            if not caption:  # empty-caption filtering (reference test_data.py:299-318)
                continue
            out.append(
                {"image_path": _resolve_path(str(rec["image_path"]), base), "caption": caption}
            )
        if self.max_samples:
            out = out[: self.max_samples]
        logger.info("Loaded %d caption pairs from %s", len(out), self.data_path)
        return out

    def _from_table(self, ext: str) -> List[Dict[str, str]]:
        import pandas as pd

        df = pd.read_csv(self.data_path, delimiter="\t" if ext == ".tsv" else ",")
        image_col = next((c for c in df.columns if c.lower() in _IMAGE_KEYS), None)
        caption_col = next((c for c in df.columns if c.lower() in _CAPTION_KEYS), None)
        if image_col is None or caption_col is None:
            raise ValueError(f"Could not find image and caption columns in {list(df.columns)}")
        return [
            {"image_path": r[image_col], "caption": r[caption_col]}
            for r in df.to_dict("records")
        ]

    @staticmethod
    def _from_json(path: Path) -> List[Dict[str, str]]:
        with open(path, "r", encoding="utf-8") as f:
            data = json.load(f)
        if isinstance(data, dict) and "data" in data:
            data = data["data"]
        records = []
        for item in data:
            rec: Dict[str, str] = {}
            for key, value in item.items():
                kl = key.lower()
                if kl in _IMAGE_KEYS:
                    rec["image_path"] = value
                elif kl in _CAPTION_KEYS:
                    rec["caption"] = value
            if "image_path" in rec and "caption" in rec:
                records.append(rec)
        return records

    def _from_directory(self) -> List[Dict[str, str]]:
        """Pair image files with `.txt`/`.caption` sidecars (reference 159-210)."""
        records = []
        for img in sorted(self.data_path.rglob("*")):
            if img.suffix.lower() not in _IMAGE_EXTS:
                continue
            for sidecar_ext in (".txt", ".caption"):
                sidecar = img.with_suffix(sidecar_ext)
                if sidecar.exists():
                    records.append(
                        {"image_path": str(img), "caption": sidecar.read_text().strip()}
                    )
                    break
        return records

    # -- item access ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.data[idx]
        image = self._load_image(rec["image_path"])
        enc = self.text_processor.encode_caption(rec["caption"])
        return {
            "image": image,
            "caption_ids": enc["input_ids"],
            "caption_mask": enc["attention_mask"],
            "raw_caption": rec["caption"],
            "image_path": rec["image_path"],
        }

    def get_sample_by_path(self, image_path: str) -> Optional[Dict[str, Any]]:
        for i, rec in enumerate(self.data):
            if rec["image_path"] == image_path or Path(rec["image_path"]).name == Path(image_path).name:
                return self[i]
        return None


class UltraFeedbackDataset(_BaseImageDataset):
    """Preference-pair dataset in the three reference formats (reference C5)."""

    def __init__(
        self,
        data_path,
        image_processor: ImageProcessor,
        text_processor: TextProcessor,
        split: str = "train",
        max_samples: Optional[int] = None,
        preference_threshold: float = 0.6,
        cache_images: bool = False,
    ):
        super().__init__(image_processor, cache_images)
        self.data_path = Path(data_path)
        self.text_processor = text_processor
        self.split = split
        self.max_samples = max_samples
        self.preference_threshold = preference_threshold
        self.data = self._load_pairs()
        if not self.data:
            raise ValueError(f"No valid preference pairs found in {self.data_path}")

    def _load_pairs(self) -> List[Dict[str, Any]]:
        if not self.data_path.exists():
            raise FileNotFoundError(f"Data path does not exist: {self.data_path}")
        with open(self.data_path, "r", encoding="utf-8") as f:
            raw = json.load(f)
        if isinstance(raw, dict) and "data" in raw:
            raw = raw["data"]

        pairs: List[Dict[str, Any]] = []
        for item in raw:
            if "conversations" in item:
                pairs.extend(self._pairs_from_conversations(item))
            elif all(k in item for k in ("image_path", "preferred_caption", "rejected_caption")):
                pairs.append(
                    {
                        "image_path": item["image_path"],
                        "preferred_caption": item["preferred_caption"],
                        "rejected_caption": item["rejected_caption"],
                        "preference_score": item.get("preference_score", 1.0),
                    }
                )
            elif all(k in item for k in ("image_path", "captions", "scores")):
                pairs.extend(self._pairs_from_scored(item))

        base = self.data_path.parent
        for p in pairs:
            p["image_path"] = _resolve_path(str(p["image_path"]), base)

        pairs = [p for p in pairs if p.get("preference_score", 1.0) >= self.preference_threshold]
        if self.max_samples:
            pairs = pairs[: self.max_samples]
        logger.info("Loaded %d preference pairs from %s", len(pairs), self.data_path)
        return pairs

    def _pairs_from_conversations(self, item: Dict[str, Any]) -> List[Dict[str, Any]]:
        """UltraFeedback conversations: adjacent pairs by descending score."""
        if "image_path" not in item:
            return []
        scored = [
            {"caption": c["response"], "score": c["score"]}
            for c in item.get("conversations", [])
            if "response" in c and "score" in c
        ]
        scored.sort(key=lambda x: x["score"], reverse=True)
        pairs = []
        for hi, lo in zip(scored, scored[1:]):
            diff = hi["score"] - lo["score"]
            if diff >= self.preference_threshold:
                pairs.append(
                    {
                        "image_path": item["image_path"],
                        "preferred_caption": hi["caption"],
                        "rejected_caption": lo["caption"],
                        "preference_score": diff,
                    }
                )
        return pairs

    def _pairs_from_scored(self, item: Dict[str, Any]) -> List[Dict[str, Any]]:
        captions, scores = item["captions"], item["scores"]
        if len(captions) != len(scores):
            logger.warning("Mismatch between captions and scores length")
            return []
        ranked = sorted(zip(captions, scores), key=lambda x: x[1], reverse=True)
        pairs = []
        for (hi_c, hi_s), (lo_c, lo_s) in zip(ranked, ranked[1:]):
            diff = hi_s - lo_s
            if diff >= self.preference_threshold:
                pairs.append(
                    {
                        "image_path": item["image_path"],
                        "preferred_caption": hi_c,
                        "rejected_caption": lo_c,
                        "preference_score": diff,
                    }
                )
        return pairs

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        rec = self.data[idx]
        image = self._load_image(rec["image_path"])
        pref = self.text_processor.encode_caption(rec["preferred_caption"])
        rej = self.text_processor.encode_caption(rec["rejected_caption"])
        return {
            "image": image,
            "preferred_ids": pref["input_ids"],
            "preferred_mask": pref["attention_mask"],
            "rejected_ids": rej["input_ids"],
            "rejected_mask": rej["attention_mask"],
            "preference_score": np.float32(rec["preference_score"]),
            "raw_preferred": rec["preferred_caption"],
            "raw_rejected": rec["rejected_caption"],
            "image_path": rec["image_path"],
        }


class _SplitView:
    """Index-remapped view of a dataset with its own augmentation mode."""

    def __init__(self, dataset, indices: Sequence[int], split: str, augment: bool):
        self.dataset = dataset
        self.indices = list(indices)
        self.split = split
        # Per-split augmentation handled at train-step level; record intent here.
        self.augment = augment

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.dataset[self.indices[i]]


def _collate(items: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numpy fields; keep strings as lists."""
    batch: Dict[str, Any] = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray) or isinstance(vals[0], (int, float, np.number)):
            batch[key] = np.stack([np.asarray(v) for v in vals])
        else:
            batch[key] = vals
    return batch


# The dataset of a worker process, set once per worker by ``_worker_init``.
_WORKER_DATASET = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_getitem(i):
    return _WORKER_DATASET[i]


def _as_is(batch):
    """The grain pool's collate: a source's item is a collated batch already (PyTorch's default
    would turn its numpy arrays into tensors)."""
    return batch


def _pinned_batch_order(
    n: int, batch_size: int, shuffle: bool, drop_last: bool, seed: int, epoch: int
) -> List[List[int]]:
    """The per-epoch batch order as a pure function of ``(seed, epoch)``.

    What batch ``b`` of epoch ``e`` contains, including across a resume;
    the same numpy permutation as the JAX package's.
    """
    order = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed + epoch)
        rng.shuffle(order)
    batches = []
    for start in range(0, n, batch_size):
        idx = order[start : start + batch_size]
        if len(idx) < batch_size and drop_last:
            continue
        batches.append(idx.tolist())
    return batches


def _batches_per_epoch(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


class _BatchSource:
    """Random-access source of collated batches (given as index lists) for the grain pool's
    one-shot pipeline. Pickled into the spawned workers, one batch a task."""

    def __init__(self, dataset, batches, collate_fn):
        self.dataset = dataset
        self.batches = batches
        self.collate_fn = collate_fn

    def __len__(self) -> int:
        return len(self.batches)

    def __getitem__(self, i: int):
        return self.collate_fn([self.dataset[j] for j in self.batches[i]])


class _MultiEpochBatchSource:
    """Epoch-aware batch source behind the persistent grain pool (JAX loader.py:403-460).

    Record ``i`` is batch ``b`` of epoch ``e`` with ``(e, b) = divmod(i + base,
    batches_per_epoch)``; the worker recomputes the epoch's order from the
    pure ``(seed, epoch)`` shuffle of :func:`_pinned_batch_order`, so one
    pool serves every epoch of a run. ``base`` positions a pool built mid-run
    (a resume) without fetching the batches before it.
    """

    MAX_EPOCHS = 100_000  # epochs one pool serves before a rebuild

    def __init__(self, dataset, batch_size, shuffle, drop_last, seed, collate_fn, base=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.collate_fn = collate_fn
        self.base = base
        self.batches_per_epoch = _batches_per_epoch(len(dataset), batch_size, drop_last)
        self._order_epoch = -1
        self._order: List[List[int]] = []

    def __len__(self) -> int:
        return self.batches_per_epoch * self.MAX_EPOCHS - self.base

    def _epoch_order(self, epoch: int) -> List[List[int]]:
        if epoch != self._order_epoch:  # a worker's records advance, so one epoch's order is kept
            self._order = _pinned_batch_order(len(self.dataset), self.batch_size, self.shuffle, self.drop_last,
                                              self.seed, epoch)
            self._order_epoch = epoch
        return self._order

    def __getitem__(self, i: int):
        epoch, b = divmod(i + self.base, self.batches_per_epoch)
        return self.collate_fn([self.dataset[j] for j in self._epoch_order(epoch)[b]])


class DataLoader:
    """Host-side batching iterator with background prefetch.

    Prefetch uses a single daemon thread and a bounded queue (double
    buffering), so that image decode overlaps device compute. Intra-batch
    item fetch can fan out over worker THREADS (PIL decode releases the GIL)
    or, for GIL-bound work such as tokenization, worker PROCESSES
    (``workers_mode="process"``, a spawned pool, each worker holding a copy of
    the dataset). ``workers_mode="grain"`` (with ``num_workers > 0``) hands
    whole batches to spawned worker processes that fetch and collate them,
    ``prefetch`` batches ahead a worker: the JAX package's grain pipeline on
    ``torch.utils.data.DataLoader``.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        prefetch: int = 2,
        num_workers: int = 0,
        workers_mode: str = "thread",
        collate_fn: Callable = _collate,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        # worker THREADS (default) or PROCESSES for item fetch;
        # 0 = fetch inline on the prefetch thread.
        self.num_workers = int(num_workers)
        if workers_mode not in ("thread", "process", "grain"):
            raise ValueError(f"unknown workers_mode {workers_mode!r}")
        self.workers_mode = workers_mode
        self.collate_fn = collate_fn
        self._epoch = 0
        # the grain pool: the loader over a _MultiEpochBatchSource, its one iterator, and the global
        # record (epoch * batches_per_epoch + batch) that iterator yields next
        self._grain_dl = None
        self._grain_it = None
        self._grain_pos = 0
        self._grain_busy = False
        self._mesh = None  # set_shard: yield this rank's rows of each batch

    def set_shard(self, mesh) -> None:
        """Yield this rank's rows of every batch from now on (``mesh.shard_batch``; None: whole batches)."""
        self._mesh = mesh

    def _local_rows(self, batches):
        for batch in batches:
            yield self._mesh.shard_batch(batch)

    def __len__(self) -> int:
        return _batches_per_epoch(len(self.dataset), self.batch_size, self.drop_last)

    def _batch_indices(self) -> List[List[int]]:
        return _pinned_batch_order(
            len(self.dataset), self.batch_size, self.shuffle, self.drop_last,
            self.seed, self._epoch,
        )

    def _fetch(self, idx: List[int]):
        if self.num_workers > 1 and self.workers_mode == "process":
            items = self._process_pool().map(_worker_getitem, idx)
        elif self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            if not hasattr(self, "_pool"):
                self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
            items = list(self._pool.map(self.dataset.__getitem__, idx))
        else:
            items = [self.dataset[i] for i in idx]
        return self.collate_fn(items)

    def _process_pool(self):
        """Spawned workers, each holding one pickled copy of the dataset (the JAX package forks; a
        fork after CUDA or any other threads start can deadlock the children)."""
        if not hasattr(self, "_ppool"):
            import multiprocessing as mp

            self._ppool = mp.get_context("spawn").Pool(self.num_workers, initializer=_worker_init,
                                                       initargs=(self.dataset,))
        return self._ppool

    def close(self):
        """Release the worker pools."""
        if hasattr(self, "_ppool"):
            self._ppool.terminate()
            del self._ppool
        if hasattr(self, "_pool"):
            self._pool.shutdown(wait=False)
            del self._pool
        self._close_grain()

    def _torch_loader(self, source, persistent: bool):
        """PyTorch's worker pool over a batch source: spawned workers, one collated batch a task."""
        import torch.utils.data

        return torch.utils.data.DataLoader(
            source, batch_size=None, sampler=torch.utils.data.SequentialSampler(source), collate_fn=_as_is,
            num_workers=self.num_workers, multiprocessing_context="spawn", persistent_workers=persistent,
            prefetch_factor=max(self.prefetch, 1),
        )

    def _grain_iter(self, epoch: int, start: int, count: int):
        """``count`` batches of ``epoch`` from ``start``, from the persistent pool (JAX loader.py:377-460).

        The pool is built once and serves every epoch; it is rebuilt, positioned
        at the requested record by the source's ``base``, only when a request
        does not continue where the last one ended (a resume, a backward
        ``set_epoch``). A second iteration while one is running gets a
        one-shot pool of its own, so the shared position stays right.
        """
        if self._grain_busy:
            order = _pinned_batch_order(len(self.dataset), self.batch_size, self.shuffle, self.drop_last,
                                        self.seed, epoch)[start:start + count]
            yield from self._torch_loader(_BatchSource(self.dataset, order, self.collate_fn), persistent=False)
            return
        target = epoch * len(self) + start
        if self._grain_it is None or self._grain_pos != target:
            self._build_grain_pool(target)
        self._grain_busy = True
        try:
            for _ in range(count):
                batch = next(self._grain_it)
                self._grain_pos += 1
                yield batch
        finally:
            self._grain_busy = False

    def _build_grain_pool(self, base: int) -> None:
        self._close_grain()
        source = _MultiEpochBatchSource(self.dataset, self.batch_size, self.shuffle, self.drop_last, self.seed,
                                        self.collate_fn, base=base)
        self._grain_dl = self._torch_loader(source, persistent=True)
        self._grain_it = iter(self._grain_dl)
        self._grain_pos = base

    def _close_grain(self) -> None:
        """Stop the grain pool's worker processes."""
        if self._grain_it is not None:
            self._grain_it._shutdown_workers()
        self._grain_it = self._grain_dl = None

    def set_epoch(self, epoch: int) -> None:
        """Pin the shuffle epoch (torch DistributedSampler convention) so a
        resumed run replays the exact same batch order for that epoch."""
        self._epoch = int(epoch)

    def iter_batches(self, start: int = 0):
        """Iterate this epoch's batches from index ``start``.

        Mid-epoch resume path: the trainer passes the number of already-
        consumed batches so they are never fetched (the naive path decodes
        and discards them — O(epoch) wasted host work after a preemption).
        The batch order is the same pinned per-epoch order as ``__iter__``.
        """
        epoch = self._epoch
        batches = self._batch_indices()[start:]
        self._epoch += 1
        if self.workers_mode == "grain" and self.num_workers > 0:
            out = self._grain_iter(epoch, start, len(batches))
        else:
            out = self._iterate(batches)
        return out if self._mesh is None else self._local_rows(out)

    def __iter__(self):
        return self.iter_batches(0)

    def _iterate(self, batches):
        if self.prefetch <= 0:
            for idx in batches:
                yield self._fetch(idx)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            try:
                for idx in batches:
                    q.put(self._fetch(idx))
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()


def create_dataloaders(
    dataset_class: Type,
    data_path,
    image_processor: ImageProcessor,
    text_processor: TextProcessor,
    batch_size: int = 8,
    train_split: float = 0.8,
    val_split: float = 0.1,
    test_split: float = 0.1,
    seed: int = 42,
    max_samples: Optional[int] = None,
    num_workers: int = 0,
    workers_mode: str = "thread",
    **dataset_kwargs,
) -> Tuple[DataLoader, DataLoader, DataLoader]:
    """Seeded 3-way split into train/val/test loaders.

    Each split is an independent view with its own augmentation intent
    (train on, val/test off).
    """
    if abs(train_split + val_split + test_split - 1.0) > 1e-6:
        raise ValueError("train/val/test splits must sum to 1.0")

    dataset = dataset_class(
        data_path,
        image_processor=image_processor,
        text_processor=text_processor,
        max_samples=max_samples,
        **dataset_kwargs,
    )
    n = len(dataset)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    n_train = int(n * train_split)
    n_val = int(n * val_split)
    views = {
        "train": _SplitView(dataset, order[:n_train], "train", augment=True),
        "val": _SplitView(dataset, order[n_train : n_train + n_val], "val", augment=False),
        "test": _SplitView(dataset, order[n_train + n_val :], "test", augment=False),
    }
    train_loader = DataLoader(
        views["train"], batch_size, shuffle=True, drop_last=True, seed=seed,
        num_workers=num_workers, workers_mode=workers_mode,
    )
    val_loader = DataLoader(views["val"], batch_size, num_workers=num_workers, workers_mode=workers_mode)
    test_loader = DataLoader(views["test"], batch_size, num_workers=num_workers, workers_mode=workers_mode)
    return train_loader, val_loader, test_loader
