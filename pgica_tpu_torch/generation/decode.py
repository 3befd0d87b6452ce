"""Autoregressive caption decoding with KV caches: greedy, sampled, beam search.

Mirrors pgica_tpu/generation/decode.py:32-385. Sequence layout: the
projected vision embedding occupies cache slot 0, tokens extend from slot 1,
and the first token is predicted directly from the vision token; the cache
holds ``max_length + 1`` slots (decode.py:78). Each step attends over the
whole cache through the key mask ``arange(cache_len) <= t`` (decode.py:81-82);
causal masking is off whenever a cache is given (layers.py:165).

Greedy and sampled decoding run the slot step of generation/slots.py (the
JAX engine's, every row at its own position): the prefix admits every row,
then one step a token. On the card, ``graphs`` (a :class:`DecodeGraphs`, which
``generate_captions`` keeps) replays that step as a CUDA graph captured once
per (batch, max_length, sampler), where the JAX package compiles a
``lax.scan`` (fixed length) or a ``lax.while_loop`` (``early_stop``);
without it the step runs eagerly, on any device, with the same kernels and
bits. The ``early_stop`` test stays a host synchronisation on every step
(graphed or not), so both loops are token-identical to the fixed-length one.

Sampling takes the Gumbel-max of the filtered logits, with noise from a
``torch.Generator`` (slots.py): its stream differs from ``jax.random``'s, so
sampled captions match the JAX package in distribution only; graphed and
eager draw the same noise from the same generator state.

Beam search runs eagerly and is token-identical to the JAX package's: every
top-k runs through :func:`_top_k`, which breaks ties toward the lower index as
``jax.lax.top_k`` does (``torch.topk`` promises no order among equal values,
and ties are real: the ``NEG_INF`` fills and beams that end on EOS at once).

Beam search keeps its per-step state in preallocated pairs of buffers and
swaps them: the KV caches, per layer ``(B*K, H_kv, L, D)``, are reordered
along dim 0 to follow the chosen beams with ``index_select(..., out=)`` into
the second buffer (at the GPT-2 flagship, batch 32 x 4 beams x 128 tokens,
1.62 GB read and written a step), and so is the per-beam presence mask of
the repetition penalty, ``(B, K, V)`` int32. The whole cache moves, slots
not yet written included: a slice of the written slots is strided, and
PyTorch gathers it with its generic kernel, slower than the contiguous
gather of the whole cache on an H100 (187.7 against 130.0-131.6 ms a
batch-32 request, ``chip_smoke.py`` phase 5).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from pgica_tpu_torch.generation.slots import (  # noqa: F401 (the penalty and the filter are this module's API)
    NEG_INF,
    DecodeGraphs,
    Sampler,
    _apply_repetition_penalty,
    _top_p_filter,
    admit,
    decode_steps,
    init_slot_state,
)
from pgica_tpu_torch.models.lm import init_kv_cache


@torch.inference_mode()
def generate(
    module,
    vision_embeddings: torch.Tensor,
    *,
    eos_token_id: int,
    pad_token_id: int,
    max_length: int = 128,
    num_beams: int = 1,
    temperature: float = 1.0,
    do_sample: bool = False,
    top_p: float = 1.0,
    repetition_penalty: float = 1.0,
    length_penalty: float = 1.0,
    generator: Optional[torch.Generator] = None,
    early_stop: bool = False,
    graphs: Optional[DecodeGraphs] = None,
) -> torch.Tensor:
    """Decode (B, max_length) int64 token ids from vision embeddings.

    ``module`` provides ``decode_prefix``/``decode_step`` and ``decoder_config``
    (models/model.py). ``num_beams > 1`` runs beam search and ignores the
    sampling flags, as the JAX package does. Otherwise finished rows emit
    ``pad_token_id``, and ``early_stop`` ends the loop once every row has
    emitted EOS; for beam search see :func:`_beam_search`. With ``graphs``
    (CUDA only; beam search ignores it) each step is a replay of the graph
    it holds for this shape and sampler, captured at first use; with
    ``do_sample`` the graph's generator takes ``generator``'s state (the
    default CUDA generator's without one) and hands it back advanced.
    """
    if num_beams > 1:
        return _beam_search(module, vision_embeddings, repetition_penalty, max_length=max_length,
                            num_beams=num_beams, length_penalty=length_penalty, eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id, early_stop=early_stop)
    batch, device = vision_embeddings.shape[0], vision_embeddings.device
    pick = Sampler(do_sample, temperature, top_p, repetition_penalty)
    source = generator
    if graphs is None:
        state = init_slot_state(module.decoder_config, batch, max_length, module.compute_dtype, device,
                                eos_token_id=eos_token_id, pad_token_id=pad_token_id, generator=generator)
        step = functools.partial(decode_steps, module, state, 1, pick)
    else:
        if graphs.module is not module or device.type != "cuda":
            raise ValueError("graphs replay another module's steps, or the embeddings are not on the card")
        state, captured = graphs.get(batch, max_length, pick, eos_token_id, pad_token_id)
        step = captured.replay
        if do_sample:
            if source is None:
                source = torch.cuda.default_generators[device.index if device.index is not None
                                                       else torch.cuda.current_device()]
            state.generator.set_state(source.get_state())
    admit(module, state, vision_embeddings, range(batch), pick)
    for _ in range(1, max_length):  # token t-1 sits at cache slot t
        if early_stop and not bool(state.active.any()):  # host sync on every step
            break
        step()
    if graphs is not None and do_sample:
        source.set_state(state.generator.get_state())
    return state.seqs.clone()


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last dim: the k largest, descending, the lower index first on ties."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _gather_beams(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """x (B, K', ...) indexed along dim 1 by beam_idx (B, K) -> (B, K, ...)."""
    idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.dim() - 2)).expand(beam_idx.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


@torch.inference_mode()
def _beam_search(
    module,
    vision_embeddings: torch.Tensor,
    repetition_penalty: float = 1.0,
    *,
    max_length: int,
    num_beams: int,
    length_penalty: float,
    eos_token_id: int,
    pad_token_id: int,
    early_stop: bool = False,
) -> torch.Tensor:
    """Beam search (JAX decode.py:155-318) -> (B, max_length) int64 ids.

    Each step scores every beam's continuations, takes the top 2k of the
    (B, k*V) totals, moves the candidates that just ended on EOS into a pool
    of finished hypotheses ranked by ``score / length**length_penalty``
    (the top k of pool and newcomers), and keeps the best k of the others as
    the live beams. A finished live beam may only continue with PAD, at no
    cost; candidates that just finished, or that come from a finished beam,
    are left out of the live set. The repetition penalty is per beam. Beams
    whose first token is EOS enter the pool at length 1. The result is the
    best of the pool's best and the best live beam normalized at
    ``max_length`` (HF finalize; the pool wins a tie). ``early_stop`` (for
    ``length_penalty >= 0`` only) ends the loop once every row's best
    finished hypothesis reaches ``max live score / max_length**lp``, the
    best any live beam can still reach: result-identical to the full loop.
    """
    batch, k = vision_embeddings.shape[0], num_beams
    rows = batch * k
    device = vision_embeddings.device
    cfg = module.decoder_config
    vocab = cfg.vocab_size
    cache_len = max_length + 1
    caches = init_kv_cache(cfg, rows, cache_len, module.compute_dtype, device)
    spare = init_kv_cache(cfg, rows, cache_len, module.compute_dtype, device)
    slots = torch.arange(cache_len, device=device)

    def mask_at(pos: int) -> torch.Tensor:
        return (slots[None, :] <= pos).to(torch.int32).expand(rows, cache_len)

    def lp_norm(score: torch.Tensor, length: int) -> torch.Tensor:
        # jnp.power(float32(length), lp) as a float32 scalar
        return score / float(np.power(np.float32(length), np.float32(length_penalty)))

    vis = torch.repeat_interleave(vision_embeddings, k, dim=0)
    first_logits, caches = module.decode_prefix(vis, caches, mask_at(0))
    logp0 = torch.log_softmax(first_logits.to(torch.float32), dim=-1).reshape(batch, k, vocab)[:, 0]
    live_scores, tok0 = _top_k(logp0, k)
    live_seqs = torch.full((batch, k, max_length), pad_token_id, dtype=torch.int64, device=device)
    live_seqs[:, :, 0] = tok0
    presence = torch.zeros((batch, k, vocab), dtype=torch.int32, device=device)
    presence.scatter_(2, tok0[..., None], 1)
    presence_spare = torch.empty_like(presence)
    live_finished = tok0 == eos_token_id
    # beams whose FIRST token is EOS are complete hypotheses of length 1
    fin_seqs = torch.where(live_finished[..., None], live_seqs, pad_token_id)
    fin_scores = torch.where(live_finished, lp_norm(live_scores, 1), NEG_INF)
    pad_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=device)
    pad_only[pad_token_id] = 0.0
    base = (torch.arange(batch, device=device) * k)[:, None]
    stop_bound = float(max_length) ** float(length_penalty)

    for t in range(1, max_length):
        if early_stop and length_penalty >= 0:  # one host sync a step
            if bool((fin_scores[:, 0] >= live_scores.max(dim=1).values / stop_bound).all()):
                break
        logits, caches = module.decode_step(live_seqs[:, :, t - 1].reshape(rows, 1), t, caches, mask_at(t))
        logits = _apply_repetition_penalty(logits.to(torch.float32).reshape(batch, k, vocab), presence,
                                           repetition_penalty)
        logp = torch.log_softmax(logits, dim=-1)
        logp = torch.where(live_finished[..., None], pad_only, logp)  # finished beams continue with PAD only
        total = live_scores[..., None] + logp
        cand_scores, cand_idx = _top_k(total.reshape(batch, k * vocab), 2 * k)
        cand_beam = torch.div(cand_idx, vocab, rounding_mode="floor")
        cand_tok = cand_idx % vocab
        cand_seqs = _gather_beams(live_seqs, cand_beam)
        cand_seqs[:, :, t] = cand_tok
        was_finished = torch.gather(live_finished, 1, cand_beam)
        now_finished = (cand_tok == eos_token_id) & ~was_finished

        # the finished pool: the best k of the pool and the newly finished candidates
        new_fin_scores = torch.where(now_finished, lp_norm(cand_scores, t + 1), NEG_INF)
        fin_scores, best_fin = _top_k(torch.cat([fin_scores, new_fin_scores], dim=1), k)
        fin_seqs = _gather_beams(torch.cat([fin_seqs, cand_seqs], dim=1), best_fin)

        # the live set: the best k candidates that neither just finished nor extend a finished beam
        live_cand_scores = torch.where(~now_finished & ~was_finished, cand_scores, NEG_INF)
        live_scores, sel = _top_k(live_cand_scores, k)
        live_seqs = _gather_beams(cand_seqs, sel)
        sel_beam = torch.gather(cand_beam, 1, sel)
        sel_tok = torch.gather(cand_tok, 1, sel)
        live_finished = torch.gather(was_finished, 1, sel)

        # presence and caches follow the chosen beams, into the spare buffers
        src = (base + sel_beam).reshape(rows)
        torch.index_select(presence.view(rows, vocab), 0, src, out=presence_spare.view(rows, vocab))
        presence, presence_spare = presence_spare, presence
        presence.scatter_(2, sel_tok[..., None], 1)
        for (kc, vc), (ks, vs) in zip(caches, spare):
            torch.index_select(kc, 0, src, out=ks)
            torch.index_select(vc, 0, src, out=vs)
        caches, spare = spare, caches

    live_norm = lp_norm(live_scores, max_length)
    best_live_idx = torch.argmax(live_norm, dim=1)
    best_live_seq = live_seqs[torch.arange(batch, device=device), best_live_idx]
    best_live_score = live_norm.gather(1, best_live_idx[:, None])[:, 0]
    use_fin = (fin_scores[:, 0] > NEG_INF / 2) & (fin_scores[:, 0] >= best_live_score)
    return torch.where(use_fin[:, None], fin_seqs[:, 0], best_live_seq)
