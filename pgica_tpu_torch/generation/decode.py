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

Beam search is token-identical to the JAX package's and runs as the JAX
package compiles it: the prefix and the initial beams once
(:func:`_beam_init`), then one step a token (:func:`beam_step`, the body of
JAX's ``lax.scan`` / ``while_loop``: a function of device state, with the
position ``t`` a device scalar it advances), then the final pick
(:func:`_beam_finalize`). On the card ``graphs`` replays each step as one of
two CUDA graphs captured once per beam shape (:class:`BeamGraphs`); without
it the same step runs eagerly, on any device. Every top-k runs through
:func:`_top_k`, which breaks ties toward the lower index as
``jax.lax.top_k`` does (``torch.topk`` promises no order among equal values,
and ties are real: the ``NEG_INF`` fills and beams that end on EOS at once).

The step reorders the KV caches, per layer ``(B*K, H_kv, L, D)``, along dim 0
to follow the chosen beams with ``index_select(..., out=)`` into a second
buffer (at the GPT-2 flagship, batch 32 x 4 beams x 128 tokens, 1.62 GB read
and written a step), and so the per-beam presence mask of the repetition
penalty, ``(B, K, V)`` int32: odd steps read buffer A and write B, even steps
the reverse, so no copy moves them back. The whole cache moves, slots not yet
written included: a slice of the written slots is strided, and PyTorch
gathers it with its generic kernel, slower than the contiguous gather of the
whole cache on an H100 (187.7 against 130.0-131.6 ms a batch-32 request,
``chip_smoke.py`` phase 5).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from pgica_tpu_torch.generation.slots import (  # noqa: F401 (the penalty and the filter are this module's API)
    NEG_INF,
    CapturedSteps,
    DecodeGraphs,
    Sampler,
    _apply_repetition_penalty,
    _top_p_filter,
    admit,
    decode_steps,
    init_slot_state,
)
from pgica_tpu_torch.models.layers import KVCaches
from pgica_tpu_torch.models.lm import kv_cache_buffer


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
    (CUDA only) each step is a replay of a graph it holds for this shape and
    sampler (or beam shape), captured at first use; with
    ``do_sample`` the graph's generator takes ``generator``'s state (the
    default CUDA generator's without one) and hands it back advanced.
    """
    if num_beams > 1:
        return _beam_search(module, vision_embeddings, repetition_penalty, max_length=max_length,
                            num_beams=num_beams, length_penalty=length_penalty, eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id, early_stop=early_stop, graphs=graphs)
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
    admit(module, state, vision_embeddings, torch.arange(batch, device=device), pick)
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


@dataclasses.dataclass
class BeamState:
    """One beam search's state (JAX decode.py:210-283's carry), allocated once and written in place.

    ``caches`` and ``presence`` are pairs, A and B: the step at an odd ``t``
    reads A and writes the beams it keeps into B, at an even ``t`` the
    reverse. ``t`` is the position the next step writes, a device scalar
    that the step advances. ``lp_table[n]`` is ``n ** length_penalty`` in
    float32, as ``np.power`` gives it.
    """

    cache_buffers: Tuple[torch.Tensor, torch.Tensor]  # A and B, each (layers, 2, B*K, H_kv, L + 1, D)
    caches: Tuple[KVCaches, KVCaches]  # their per-layer (k, v) views
    presence: Tuple[torch.Tensor, torch.Tensor]  # A and B, each (B, K, V) int32
    live_seqs: torch.Tensor  # (B, K, L) int64
    live_scores: torch.Tensor  # (B, K) float32
    live_finished: torch.Tensor  # (B, K) bool
    fin_seqs: torch.Tensor  # (B, K, L) int64: the finished pool, best first
    fin_scores: torch.Tensor  # (B, K) float32, normalized by length
    t: torch.Tensor  # () int64
    lp_table: torch.Tensor  # (L + 1,) float32
    cache_slots: torch.Tensor  # arange(L + 1): the key mask's columns
    columns: torch.Tensor  # arange(L): the caption's columns
    pad_only: torch.Tensor  # (V,) float32: NEG_INF but 0 at PAD, a finished beam's continuation
    base: torch.Tensor  # (B, 1) int64: each row's first beam among the B*K cache rows
    repetition_penalty: float
    eos_token_id: int
    pad_token_id: int


def init_beam_state(cfg, batch: int, num_beams: int, max_length: int, dtype: torch.dtype, device: torch.device, *,
                    length_penalty: float, repetition_penalty: float, eos_token_id: int,
                    pad_token_id: int) -> BeamState:
    """A beam state for ``batch`` rows of ``num_beams`` beams and captions of up to ``max_length`` tokens;
    :func:`_beam_init` fills it."""
    rows, vocab = batch * num_beams, cfg.vocab_size
    (buffer_a, caches_a), (buffer_b, caches_b) = (kv_cache_buffer(cfg, rows, max_length + 1, dtype, device)
                                                  for _ in range(2))
    return BeamState(
        cache_buffers=(buffer_a, buffer_b), caches=(caches_a, caches_b),
        presence=tuple(torch.zeros((batch, num_beams, vocab), dtype=torch.int32, device=device) for _ in range(2)),
        live_seqs=torch.empty((batch, num_beams, max_length), dtype=torch.int64, device=device),
        live_scores=torch.empty((batch, num_beams), dtype=torch.float32, device=device),
        live_finished=torch.empty((batch, num_beams), dtype=torch.bool, device=device),
        fin_seqs=torch.empty((batch, num_beams, max_length), dtype=torch.int64, device=device),
        fin_scores=torch.empty((batch, num_beams), dtype=torch.float32, device=device),
        t=torch.ones((), dtype=torch.int64, device=device),
        cache_slots=torch.arange(max_length + 1, device=device), columns=torch.arange(max_length, device=device),
        base=(torch.arange(batch, device=device) * num_beams)[:, None],
        **beam_scoring(vocab, max_length, device, length_penalty=length_penalty,
                       repetition_penalty=repetition_penalty, eos_token_id=eos_token_id, pad_token_id=pad_token_id),
    )


def beam_scoring(vocab: int, max_length: int, device: torch.device, *, length_penalty: float,
                 repetition_penalty: float, eos_token_id: int, pad_token_id: int) -> dict:
    """The fields of a :class:`BeamState` that its scoring sets (the rest depend on its shape only)."""
    # today's scalar np.power per length (an array's power may take another route); 0 is never a length
    lp = [1.0] + [np.power(np.float32(n), np.float32(length_penalty)) for n in range(1, max_length + 1)]
    pad_only = torch.full((vocab,), NEG_INF, dtype=torch.float32, device=device)
    pad_only[pad_token_id] = 0.0
    return dict(lp_table=torch.tensor(np.array(lp, dtype=np.float32), device=device), pad_only=pad_only,
                repetition_penalty=repetition_penalty, eos_token_id=eos_token_id, pad_token_id=pad_token_id)


def _lp_norm(state: BeamState, score: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """score / length**length_penalty, the length a () int64 tensor on the device."""
    return score / state.lp_table.index_select(0, length.reshape(1))


def _beam_init(module, state: BeamState, vision_embeddings: torch.Tensor) -> None:
    """The prefix and the initial beams (JAX decode.py:178-208): every beam of a row shares the prefix,
    the top k first tokens start the k beams, and a beam whose first token is EOS is a finished
    hypothesis of length 1. Resets the whole state (``t`` to 1): one state serves many searches."""
    batch, k, max_length = state.live_seqs.shape
    rows, vocab = batch * k, state.pad_only.shape[0]
    vis = torch.repeat_interleave(vision_embeddings, k, dim=0)
    state.cache_buffers[0].zero_()
    mask = (state.cache_slots[None, :] <= 0).to(torch.int32).expand(rows, max_length + 1)
    first_logits, _ = module.decode_prefix(vis, state.caches[0], mask)
    logp0 = torch.log_softmax(first_logits.to(torch.float32), dim=-1).reshape(batch, k, vocab)[:, 0]
    live_scores, tok0 = _top_k(logp0, k)
    state.t.fill_(1)
    state.live_scores.copy_(live_scores)
    state.live_seqs.fill_(state.pad_token_id)
    state.live_seqs[:, :, 0] = tok0
    state.presence[0].zero_().scatter_(2, tok0[..., None], 1)
    state.live_finished.copy_(tok0 == state.eos_token_id)
    state.fin_seqs.copy_(torch.where(state.live_finished[..., None], state.live_seqs, state.pad_token_id))
    state.fin_scores.copy_(torch.where(state.live_finished, _lp_norm(state, live_scores, state.t), NEG_INF))


def beam_step(module, state: BeamState, odd: bool) -> torch.Tensor:
    """One step of beam search (JAX decode.py:210-283) at position ``state.t``, in place; the step's logits.

    Scores every beam's continuations, takes the top 2k of the (B, k*V)
    totals, moves the candidates that just ended on EOS into the pool of
    finished hypotheses ranked by ``score / length**length_penalty`` (the
    top k of pool and newcomers), and keeps the best k of the others as the
    live beams. A finished live beam may only continue with PAD, at no cost;
    candidates that just finished, or that come from a finished beam, are
    left out of the live set. The repetition penalty is per beam. ``odd``
    says which buffers the step reads (odd ``t``: A, into B), the host's
    count of the step. Every operation reads and writes the state's tensors
    on the device (no host synchronisation, no shape that depends on the
    data), so the same call runs eagerly or under CUDA-graph capture.
    """
    src, dst = (0, 1) if odd else (1, 0)
    caches, spare = state.caches[src], state.caches[dst]
    presence, presence_next = state.presence[src], state.presence[dst]
    batch, k, max_length = state.live_seqs.shape
    rows, vocab = batch * k, presence.shape[-1]
    t = state.t
    mask = (state.cache_slots[None, :] <= t).to(torch.int32).expand(rows, max_length + 1)
    last = state.live_seqs.gather(2, (t - 1).expand(batch, k, 1)).reshape(rows, 1)
    logits, _ = module.decode_step(last, t.expand(rows), caches, mask)  # per-row positions, all t
    scores = _apply_repetition_penalty(logits.to(torch.float32).reshape(batch, k, vocab), presence,
                                       state.repetition_penalty)
    logp = torch.log_softmax(scores, dim=-1)
    logp = torch.where(state.live_finished[..., None], state.pad_only, logp)  # finished beams continue with PAD only
    total = state.live_scores[..., None] + logp
    cand_scores, cand_idx = _top_k(total.reshape(batch, k * vocab), 2 * k)
    cand_beam = torch.div(cand_idx, vocab, rounding_mode="floor")
    cand_tok = cand_idx % vocab
    cand_seqs = torch.where(state.columns == t, cand_tok[..., None], _gather_beams(state.live_seqs, cand_beam))
    was_finished = torch.gather(state.live_finished, 1, cand_beam)
    now_finished = (cand_tok == state.eos_token_id) & ~was_finished

    # the finished pool: the best k of the pool and the newly finished candidates
    new_fin_scores = torch.where(now_finished, _lp_norm(state, cand_scores, t + 1), NEG_INF)
    fin_scores, best_fin = _top_k(torch.cat([state.fin_scores, new_fin_scores], dim=1), k)
    fin_seqs = _gather_beams(torch.cat([state.fin_seqs, cand_seqs], dim=1), best_fin)

    # the live set: the best k candidates that neither just finished nor extend a finished beam
    live_cand_scores = torch.where(~now_finished & ~was_finished, cand_scores, NEG_INF)
    live_scores, sel = _top_k(live_cand_scores, k)
    sel_beam = torch.gather(cand_beam, 1, sel)
    sel_tok = torch.gather(cand_tok, 1, sel)

    # presence and caches follow the chosen beams into the other buffers: the whole cache moves, slots not
    # yet written included (a slice of the written slots is strided, and its gather slower)
    beams = (state.base + sel_beam).reshape(rows)
    torch.index_select(presence.view(rows, vocab), 0, beams, out=presence_next.view(rows, vocab))
    presence_next.scatter_(2, sel_tok[..., None], 1)
    for (kc, vc), (ks, vs) in zip(caches, spare):
        torch.index_select(kc, 0, beams, out=ks)
        torch.index_select(vc, 0, beams, out=vs)
    state.live_seqs.copy_(_gather_beams(cand_seqs, sel))
    state.live_finished.copy_(torch.gather(was_finished, 1, sel))
    state.live_scores.copy_(live_scores)
    state.fin_seqs.copy_(fin_seqs)
    state.fin_scores.copy_(fin_scores)
    t.add_(1)
    return logits


def _beam_finalize(state: BeamState) -> torch.Tensor:
    """The best of the pool's best and the best live beam normalized at ``max_length`` (HF finalize;
    the pool wins a tie): (B, max_length) int64, a tensor of its own."""
    batch, _, max_length = state.live_seqs.shape
    live_norm = _lp_norm(state, state.live_scores, state.t.new_full((), max_length))
    best_live_idx = torch.argmax(live_norm, dim=1)
    best_live_seq = _gather_beams(state.live_seqs, best_live_idx[:, None])[:, 0]
    best_live_score = live_norm.gather(1, best_live_idx[:, None])[:, 0]
    use_fin = (state.fin_scores[:, 0] > NEG_INF / 2) & (state.fin_scores[:, 0] >= best_live_score)
    return torch.where(use_fin[:, None], state.fin_seqs[:, 0], best_live_seq)


class BeamGraphs:
    """A beam key's state and its two captured steps: A to B (odd ``t``) and B to A (even ``t``).
    A step that swapped the buffers in place could not be one static graph, and copying B back
    into A would move the whole cache again (1.62 GB a step at batch 32).

    Each graph is captured at its first step: the capture's eager run is that step itself, on the
    search's own state, so the first search of a key runs steps 1 and 2 eagerly and replays the
    rest. ``graphs`` holds the two once captured; a failed capture raises. Every graph of one
    beam shape draws on one memory pool, ``pools[shape]``: they replay one after another on one
    stream.
    """

    def __init__(self, module, state: BeamState, device: torch.device, stream: torch.cuda.Stream,
                 pools: dict, shape: tuple):
        self.module, self.state, self.device, self.stream = module, state, device, stream
        self.pools, self.shape = pools, shape
        self.graphs = [None, None]  # odd t, even t

    def step(self, t: int) -> None:
        i = (t + 1) % 2
        if self.graphs[i] is not None:
            self.graphs[i].replay()
            return
        self.graphs[i] = CapturedSteps(functools.partial(beam_step, self.module, self.state, i == 0), self.device,
                                       self.stream, pool=self.pools.get(self.shape))
        self.pools.setdefault(self.shape, self.graphs[i].graph.pool())


def beam_graphs(graphs: DecodeGraphs, batch: int, max_length: int, num_beams: int, length_penalty: float,
                repetition_penalty: float, eos_token_id: int, pad_token_id: int) -> BeamGraphs:
    """``graphs``' beam graphs of this shape and scoring, with their state; made at first use.

    Keys of one shape (batch, max_length, num_beams) share its buffers and
    its graphs' pool, each key with its own scoring (``beam_scoring``): a
    search resets the whole state, and searches run one at a time. At most
    ``graphs.beam_shapes`` shapes are kept: a new shape first drops the
    least recently used ones, every key of them, and their memory.
    """
    shape = (batch, max_length, num_beams)
    key = shape + (length_penalty, repetition_penalty, eos_token_id, pad_token_id)
    beams = graphs.beams
    if key not in beams:
        module = graphs.module
        scoring = dict(length_penalty=length_penalty, repetition_penalty=repetition_penalty,
                       eos_token_id=eos_token_id, pad_token_id=pad_token_id)
        same = next((g.state for k, g in beams.items() if k[:3] == shape), None)
        if same is None:
            recent = list(dict.fromkeys(k[:3] for k in reversed(beams)))  # the most recently used first
            for old in recent[max(graphs.beam_shapes - 1, 0):]:
                for k in [k for k in beams if k[:3] == old]:
                    del beams[k]
                graphs.beam_pools.pop(old, None)
            state = init_beam_state(module.decoder_config, batch, num_beams, max_length, module.compute_dtype,
                                    graphs.device, **scoring)
        else:
            state = dataclasses.replace(same, **beam_scoring(module.decoder_config.vocab_size, max_length,
                                                             graphs.device, **scoring))
        beams[key] = BeamGraphs(module, state, graphs.device, graphs.stream, graphs.beam_pools, shape)
    beams[key] = beams.pop(key)  # the most recently used last
    return beams[key]


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
    graphs: Optional[DecodeGraphs] = None,
) -> torch.Tensor:
    """Beam search (JAX decode.py:155-318) -> (B, max_length) int64 ids: :func:`_beam_init`, then
    :func:`beam_step` for t = 1 .. max_length - 1, then :func:`_beam_finalize`.

    Without ``graphs`` every step runs eagerly on a state of its own; with
    them (the card) each step is a replay of one of the two graphs that
    ``graphs`` keeps for this shape. Beams whose first token is EOS enter the
    pool at length 1. ``early_stop`` (for ``length_penalty >= 0`` only)
    ends the loop once every row's best finished hypothesis reaches ``max
    live score / max_length**lp``, the best any live beam can still reach:
    result-identical to the full loop. Its test is one host synchronisation
    a step, between steps.
    """
    batch, device = vision_embeddings.shape[0], vision_embeddings.device
    if graphs is None:
        state = init_beam_state(module.decoder_config, batch, num_beams, max_length, module.compute_dtype, device,
                                length_penalty=length_penalty, repetition_penalty=repetition_penalty,
                                eos_token_id=eos_token_id, pad_token_id=pad_token_id)

        def step(t: int) -> None:
            beam_step(module, state, t % 2 == 1)
    else:
        if graphs.module is not module or device.type != "cuda":
            raise ValueError("graphs replay another module's steps, or the embeddings are not on the card")
        captured = beam_graphs(graphs, batch, max_length, num_beams, length_penalty, repetition_penalty,
                               eos_token_id, pad_token_id)
        state, step = captured.state, captured.step
    _beam_init(module, state, vision_embeddings)
    stop_bound = float(max_length) ** float(length_penalty)
    for t in range(1, max_length):
        if early_stop and length_penalty >= 0:  # one host sync a step
            if bool((state.fin_scores[:, 0] >= state.live_scores.max(dim=1).values / stop_bound).all()):
                break
        step(t)
    return _beam_finalize(state)
