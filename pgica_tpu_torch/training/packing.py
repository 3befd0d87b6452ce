"""Length-bucketed caption batches (the port's copy of pgica_tpu/training/packing.py).

Each host batch's token columns are sliced to the smallest bucket (a
multiple of 32) that holds its longest real sequence. Bucketing is exact for
stage 1: the text tower is causal, so positions before the cut never read
the columns after it, and the masked mean pool ignores them. numpy only;
tests/test_torch_train.py pins this copy to the JAX module.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# (ids_key, mask_key) pairs bucketed together; stage-2 pairs share ONE bucket
# because the decoder folds [chosen; rejected] into a single 2B-row pass
# (train_step.py:_policy_pair_logprobs).
_STAGE1_KEYS = (("caption_ids", "caption_mask"),)
_STAGE2_KEYS = (("preferred_ids", "preferred_mask"), ("rejected_ids", "rejected_mask"))


def default_buckets(max_caption_length: int, step: int = 32) -> Tuple[int, ...]:
    """Multiples of ``step`` up to (and always including) max_caption_length."""
    buckets = list(range(step, max_caption_length + 1, step))
    if not buckets or buckets[-1] != max_caption_length:
        buckets.append(max_caption_length)
    return tuple(buckets)


def pick_bucket(max_len: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= max_len (falls back to the largest bucket)."""
    for b in buckets:
        if b >= max_len:
            return int(b)
    return int(buckets[-1])


def bucket_batch(
    batch: Dict[str, np.ndarray],
    buckets: Sequence[int],
    multiple_of: int = 1,
    global_len: Optional[Callable[[int], int]] = None,
) -> Dict[str, np.ndarray]:
    """Slice a host batch's token columns to its length bucket.

    Works for stage-1 (``caption_ids/mask``) and stage-2
    (``preferred_*``/``rejected_*``) batches; keys absent from ``batch`` are
    ignored. ``multiple_of`` rounds the bucket up so sharded-seq (context
    parallel) layouts keep divisibility. ``global_len`` maps this batch's
    longest sequence to the global batch's (a max over data-parallel ranks
    holding its other rows). Returns a shallow-copied dict; the
    image tensor and any extra keys pass through untouched.
    """
    keysets = [
        pairs
        for pairs in (_STAGE1_KEYS, _STAGE2_KEYS)
        if all(ids in batch and mask in batch for ids, mask in pairs)
    ]
    if not keysets:
        return batch
    out = dict(batch)
    for pairs in keysets:
        full = max(batch[mask].shape[1] for _, mask in pairs)
        # Bound = one past the LAST set mask column (not the per-row count):
        # a mask with interior holes — e.g. a collator masking special tokens
        # mid-sequence — has count < last-set-position, and a count-based
        # bucket would silently slice off real trailing tokens. Scanning for
        # the last nonzero column keeps the EXACTNESS contract for any mask.
        max_len = 0
        for _, mask in pairs:
            set_cols = np.flatnonzero(np.asarray(batch[mask]).any(axis=0))
            if set_cols.size:
                max_len = max(max_len, int(set_cols[-1]) + 1)
        if global_len is not None:
            max_len = global_len(max_len)
        bucket = pick_bucket(max(max_len, 1), buckets)
        if multiple_of > 1:
            bucket = min(full, -(-bucket // multiple_of) * multiple_of)
        if bucket >= full:
            continue
        for ids, mask in pairs:
            out[ids] = np.ascontiguousarray(batch[ids][:, :bucket])
            out[mask] = np.ascontiguousarray(batch[mask][:, :bucket])
    return out
