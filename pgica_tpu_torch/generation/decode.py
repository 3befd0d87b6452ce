"""Autoregressive caption decoding with KV caches (greedy or sampled).

Mirrors pgica_tpu/generation/decode.py:32-152,321-385. Sequence layout: the
projected vision embedding occupies cache slot 0, tokens extend from slot 1,
and the first token is predicted directly from the vision token; the cache
holds ``max_length + 1`` slots (decode.py:78). Each step attends over the
whole cache through the key mask ``arange(cache_len) <= t`` (decode.py:81-82);
causal masking is off whenever a cache is given (layers.py:165).

PyTorch runs the loop eagerly, one Python iteration per step, where the JAX
package compiles a ``lax.scan`` (fixed length) or a ``lax.while_loop``
(``early_stop``). The ``early_stop`` test ``finished.all()`` is therefore a
host synchronisation on every step; the two loops are token-identical.

Sampling draws from a ``torch.Generator``: its stream differs from
``jax.random``'s, so sampled captions match the JAX package in distribution
only. Beam search (decode.py:155-318) waits for a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from pgica_tpu_torch.models.lm import init_kv_cache

NEG_INF = -1.0e9


def _apply_repetition_penalty(logits: torch.Tensor, presence: torch.Tensor, penalty: float) -> torch.Tensor:
    """HF semantics: positive logits of seen tokens divided, negative multiplied."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(presence > 0, penalized, logits)


def _top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the nucleus (per row); top_p >= 1.0 keeps every token."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cdf = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # smallest set with cumulative prob >= top_p; keep at least 1 token
    cutoff_idx = (cdf < top_p).sum(dim=-1, keepdim=True).clamp(0, logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(logits < cutoff, NEG_INF, logits)


@torch.inference_mode()
def generate(
    module,
    vision_embeddings: torch.Tensor,
    *,
    eos_token_id: int,
    pad_token_id: int,
    max_length: int = 128,
    temperature: float = 1.0,
    do_sample: bool = False,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    generator: Optional[torch.Generator] = None,
    early_stop: bool = False,
) -> torch.Tensor:
    """Decode (B, max_length) int64 token ids from vision embeddings.

    ``module`` provides ``decode_prefix``/``decode_step`` and ``decoder_config``
    (models/model.py). Finished rows emit ``pad_token_id``; ``early_stop``
    ends the loop once every row has emitted EOS.
    """
    batch = vision_embeddings.shape[0]
    device = vision_embeddings.device
    cfg = module.decoder_config
    cache_len = max_length + 1  # +1 for the vision token at slot 0
    caches = init_kv_cache(cfg, batch, cache_len, module.compute_dtype, device)
    slots = torch.arange(cache_len, device=device)

    def mask_at(pos: int) -> torch.Tensor:
        return (slots[None, :] <= pos).to(torch.int32).expand(batch, cache_len)

    def pick(logits: torch.Tensor, presence: torch.Tensor) -> torch.Tensor:
        logits = _apply_repetition_penalty(logits.to(torch.float32), presence, repetition_penalty)
        if do_sample:
            logits = _top_p_filter(logits / max(temperature, 1e-6), top_p)
            probs = torch.softmax(logits, dim=-1)
            return torch.multinomial(probs, 1, generator=generator).squeeze(-1)
        return torch.argmax(logits, dim=-1)

    rows = torch.arange(batch, device=device)
    logits, caches = module.decode_prefix(vision_embeddings, caches, mask_at(0))
    presence = torch.zeros((batch, cfg.vocab_size), dtype=torch.int32, device=device)
    tokens = pick(logits, presence)
    finished = tokens == eos_token_id
    presence[rows, tokens] = 1
    sequences = torch.full((batch, max_length), pad_token_id, dtype=torch.int64, device=device)
    sequences[:, 0] = tokens

    for t in range(1, max_length):  # token t-1 sits at cache slot t
        if early_stop and bool(finished.all()):  # host sync on every step
            break
        logits, caches = module.decode_step(tokens[:, None], t, caches, mask_at(t))
        nxt = torch.where(finished, pad_token_id, pick(logits, presence))
        finished = finished | (nxt == eos_token_id)
        presence[rows, nxt] = 1
        sequences[:, t] = nxt
        tokens = nxt
    return sequences
