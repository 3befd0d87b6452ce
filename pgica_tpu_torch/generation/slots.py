"""Decode slots: the state that greedy and sampled decoding advance, and its CUDA graphs.

Both of the port's greedy and sampled decode paths run on a pool of S
slots, each holding one caption in flight: the batch path
(generation/decode.py:generate, every row admitted at once) and the
continuous-batching engine (generation/engine.py, rows admitted between
chunks of steps). A slot carries its own KV-cache rows, write position,
last token, repetition-penalty presence and active flag, and the step is the
JAX engine's (pgica_tpu/generation/engine.py:136-171): every row decodes at
its own position (per-row cache writes and ``wpe`` gathers, models/
layers.py and decoder.py), inactive rows emit PAD, write no column and hold
their position. A row goes inactive after EOS or at ``max_length``.

The state's tensors are allocated once and updated in place, so on the card
a run of steps is captured once as a CUDA graph (:class:`CapturedSteps`) and
replayed; the graph stands in for the JAX package's jitted ``lax.scan`` /
``while_loop``. Its kernels are the eager step's, on the same inputs, so a
replay gives the eager step's bits. The admission (:func:`admit`) reads
nothing back to the host either: its slot ids are a device tensor, and a
padding id writes the state's scratch row, so the engine captures it too,
one graph per admission bucket (the JAX engine jits ``admit_fn`` per bucket).

Sampling draws Gumbel noise and takes the argmax (Gumbel-max), as
``jax.random.categorical`` does; ``torch.multinomial`` checks its input on
the host and cannot be captured. The noise comes from the state's
``torch.Generator``, which a graph registers, so a replay draws what the
eager step would draw from the same generator state. The streams differ
from ``jax.random``'s: sampled captions match the JAX package in
distribution only.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from pgica_tpu_torch.models.layers import KVCaches
from pgica_tpu_torch.models.lm import kv_cache_buffer
from pgica_tpu_torch.models.presets import LMConfig
from pgica_tpu_torch.ops import _kernels

NEG_INF = -1.0e9
UNIFORM_MIN = torch.finfo(torch.float32).tiny  # jax.random.gumbel's lower bound on its uniform draws


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


@dataclasses.dataclass(frozen=True)
class Sampler:
    """The next-token choice of decode.py's ``pick`` and the JAX engine's ``_pick`` (engine.py:54).

    Greedy: the argmax of the penalized logits. Sampled: temperature, the
    top-p nucleus, then Gumbel-max with noise from ``generator``. Hashable,
    so that it keys a captured step.
    """

    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    repetition_penalty: float = 1.0

    def __call__(self, logits: torch.Tensor, presence: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        logits = _apply_repetition_penalty(logits.to(torch.float32), presence, self.repetition_penalty)
        if not self.do_sample:
            return torch.argmax(logits, dim=-1)
        logits = _top_p_filter(logits / max(self.temperature, 1e-6), self.top_p)
        u = torch.rand(logits.shape, generator=generator, device=logits.device).clamp_(min=UNIFORM_MIN)
        return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@dataclasses.dataclass
class SlotState:
    """S slots' decode state, each tensor allocated once and written in place.

    ``pos`` is the cache slot of the token in ``tok``, the next step's input
    (the vision token sits at slot 0, caption token t-1 at slot t);
    ``seqs`` holds the caption so far, PAD after its end. Every tensor has
    one row more, row S, the scratch row: an admission writes its padding
    rows there (JAX's ``mode="drop"`` scatter drops them), and nothing reads
    it. ``padded`` and ``cache_buffer`` own the tensors, scratch row
    included; the step and every reader see rows [:S] through the
    properties and ``caches``. A slice of the leading dim stays contiguous,
    so ``CacheRows.write``'s flat view still holds.
    """

    caches: KVCaches  # per-layer (k, v) views of cache_buffer's rows [:S]
    cache_buffer: torch.Tensor  # (layers, 2, S + 1, H_kv, max_length + 1, D): every layer's k and v
    padded: Dict[str, torch.Tensor]  # seqs, pos, tok, presence, active, each with the scratch row
    cache_slots: torch.Tensor  # arange(max_length + 1): the key mask's columns
    columns: torch.Tensor  # arange(max_length): the caption's columns
    generator: Optional[torch.Generator]
    eos_token_id: int
    pad_token_id: int

    @property
    def slots(self) -> int:
        return self.padded["seqs"].shape[0] - 1

    @property
    def max_length(self) -> int:
        return self.padded["seqs"].shape[1]

    @property
    def seqs(self) -> torch.Tensor:  # (S, max_length) int64
        return self.padded["seqs"][:self.slots]

    @property
    def pos(self) -> torch.Tensor:  # (S,) int64
        return self.padded["pos"][:self.slots]

    @property
    def tok(self) -> torch.Tensor:  # (S,) int64
        return self.padded["tok"][:self.slots]

    @property
    def presence(self) -> torch.Tensor:  # (S, V) int32
        return self.padded["presence"][:self.slots]

    @property
    def active(self) -> torch.Tensor:  # (S,) bool
        return self.padded["active"][:self.slots]

    def reset(self) -> None:
        """Every slot free, in place (a captured graph keeps the tensors' addresses)."""
        self.cache_buffer.zero_()
        self.padded["seqs"].fill_(self.pad_token_id)
        self.padded["pos"].zero_()
        self.padded["tok"].fill_(self.pad_token_id)
        self.padded["presence"].zero_()
        self.padded["active"].zero_()


def init_slot_state(cfg: LMConfig, slots: int, max_length: int, dtype: torch.dtype, device: torch.device, *,
                    eos_token_id: int, pad_token_id: int,
                    generator: Optional[torch.Generator] = None) -> SlotState:
    """``slots`` free slots for captions of up to ``max_length`` tokens (the cache holds one more
    slot, the vision token's), and the scratch row. A slot rests at position ``max_length`` once its
    caption is full, and GPT-2 gathers that position's ``wpe`` row: it must exist (a device-side
    index fault would end the process's CUDA context)."""
    if cfg.arch == "gpt2" and max_length >= cfg.max_position_embeddings:
        raise ValueError(f"max_length {max_length} needs {max_length + 1} learned positions; the decoder has "
                         f"{cfg.max_position_embeddings}")
    rows = slots + 1
    buffer, _ = kv_cache_buffer(cfg, rows, max_length + 1, dtype, device)
    padded = dict(seqs=torch.empty((rows, max_length), dtype=torch.int64, device=device),
                  pos=torch.empty(rows, dtype=torch.int64, device=device),
                  tok=torch.empty(rows, dtype=torch.int64, device=device),
                  presence=torch.empty((rows, cfg.vocab_size), dtype=torch.int32, device=device),
                  active=torch.empty(rows, dtype=torch.bool, device=device))
    state = SlotState(
        caches=[(layer[0, :slots], layer[1, :slots]) for layer in buffer], cache_buffer=buffer, padded=padded,
        cache_slots=torch.arange(max_length + 1, device=device), columns=torch.arange(max_length, device=device),
        generator=generator, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
    )
    state.reset()
    return state


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the stream: a copy from pageable memory
    would first wait for every kernel queued before it (the engine's chunks in flight), so on the
    card it goes through pinned memory, asynchronously."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def admit(module, state: SlotState, vision_embeddings: torch.Tensor, slot_ids: torch.Tensor,
          pick: Sampler) -> None:
    """Prefix a bucket of vision embeddings and move row i into slot ``slot_ids[i]`` (JAX engine.py:98-134).

    ``slot_ids`` is an int64 tensor on the state's device. The prefix runs
    on caches of the bucket's own, its first tokens are picked (a first
    token may be EOS), and the rows are scattered into their slots with
    ``index_copy_``. Ids outside [0, S) are padding: their rows go to the
    scratch row S, as JAX's ``mode="drop"`` scatter drops them. Several
    padding rows write that row in no defined order, which is harmless:
    nothing reads it. Nothing is read back to the host, so the same call
    runs eagerly or under CUDA-graph capture.
    """
    a, device = vision_embeddings.shape[0], vision_embeddings.device
    cache_len = state.max_length + 1
    buffer, caches = kv_cache_buffer(module.decoder_config, a, cache_len, module.compute_dtype, device)
    mask = (state.cache_slots == 0).to(torch.int32).expand(a, cache_len)  # the prefix sees slot 0 only
    logits, _ = module.decode_prefix(vision_embeddings, caches, mask)  # writes slot 0 of the buffer in place
    presence = torch.zeros((a, state.presence.shape[1]), dtype=torch.int32, device=device)
    tok0 = pick(logits, presence, state.generator)
    dst = torch.where((slot_ids >= 0) & (slot_ids < state.slots), slot_ids, state.slots)
    state.cache_buffer.index_copy_(2, dst, buffer)
    row = torch.full((a, state.max_length), state.pad_token_id, dtype=torch.int64, device=device)
    row[:, 0] = tok0
    padded = state.padded
    padded["seqs"].index_copy_(0, dst, row)
    padded["pos"].index_fill_(0, dst, 1)
    padded["tok"].index_copy_(0, dst, tok0)
    padded["presence"].index_copy_(0, dst, presence.scatter_(1, tok0[:, None], 1))
    padded["active"].index_copy_(0, dst, (tok0 != state.eos_token_id) & (state.max_length > 1))


def decode_steps(module, state: SlotState, steps: int, pick: Sampler) -> torch.Tensor:
    """Advance every slot by ``steps`` tokens in place (JAX engine.py:136-171); the last step's logits.

    Every operation reads and writes the state's tensors on the device (no
    host synchronisation, no shape that depends on the data), so the same
    call runs eagerly or under CUDA-graph capture.
    """
    max_length = state.max_length
    logits = None
    for _ in range(steps):
        active = state.active
        mask = (state.cache_slots[None, :] <= state.pos[:, None]).to(torch.int32)
        logits, _ = module.decode_step(state.tok[:, None], state.pos, state.caches, mask)
        nxt = torch.where(active, pick(logits, state.presence, state.generator), state.pad_token_id)
        hit = (state.columns[None, :] == state.pos[:, None]) & active[:, None]
        state.seqs.copy_(torch.where(hit, nxt[:, None], state.seqs))
        state.presence.scatter_reduce_(1, nxt[:, None], active[:, None].to(torch.int32), "amax")
        still = active & (nxt != state.eos_token_id) & (state.pos + 1 < max_length)
        state.tok.copy_(torch.where(active, nxt, state.tok))
        state.pos.add_(active.to(torch.int64))
        state.active.copy_(still)
    return logits


class CapturedSteps:
    """``fn`` (a run of steps on tensors that never move) captured as one CUDA graph on ``stream``.

    ``warmup`` (by default ``fn``) first runs once eagerly on that stream,
    so that the kernel libraries build and load and cuBLAS makes its handle
    and workspace outside the capture; ``first`` is what it returned. The
    capture then records ``fn``'s launches, the port's kernels included
    (their wrappers launch on the current stream, the capture stream). A
    failed capture raises: there is no eager fall-back. ``generators``, the
    ones ``fn`` draws from (None entries skipped), are registered with the
    graph after the warm-up (an iterable that the warm-up extends counts its
    new ones), so that every replay takes the next draws. ``out`` is
    ``fn``'s return value (tensors in the graph's memory pool: every replay
    overwrites them); ``kernels`` counts the port's kernels the graph holds
    (their wrappers' launches under capture; a replay adds nothing to those
    counts), and ``capture_s`` and ``pool_bytes`` time and size the
    capture. ``pool`` (another graph's ``graph.pool()``) shares that graph's
    memory pool: safe for graphs that replay one after another on one
    stream. Call under the same grad mode as the replays' callers
    (inference mode when serving).
    """

    def __init__(self, fn: Callable[[], Any], device: torch.device, stream: torch.cuda.Stream,
                 generators: Iterable[Optional[torch.Generator]] = (), pool: Optional[Tuple[int, int]] = None,
                 warmup: Optional[Callable[[], Any]] = None):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs capture CUDA work, got device {device}")
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            self.first = (warmup or fn)()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for generator in generators:
            if generator is not None:
                self.graph.register_generator_state(generator)
        before = _kernels.launch_counts()
        collecting = gc.isenabled()
        gc.disable()  # a collection inside the capture could free a dead graph's memory: a call that voids it
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.out = fn()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(device)
        after = _kernels.launch_counts()
        # a wrapper called under capture records its kernel into the graph: every replay launches these
        self.kernels = {name: after[name] - before[name] for name in after if after[name] != before[name]}
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved  # what the capture added to its pool

    def replay(self) -> None:
        self.graph.replay()


class DecodeGraphs:
    """The batch path's captured decode steps of one module: one graph of one step per (batch,
    max_length, sampler, EOS, PAD), with its slot state; and in ``beams`` beam search's
    (generation/decode.py:BeamGraphs, by beam shape and scoring), two step graphs with their state,
    the least recently used first, for at most ``beam_shapes`` shapes (a runner's full
    batch and its last, partial one: at the GPT-2 flagship a batch of 32 x 4 beams x 128 holds
    3.24 GB of caches), and ``beam_pools``, each beam shape's graph pool.

    The graphs hold the module's weights by address: the owner drops this
    object when the module is replaced (models/model.py keys it on the
    bf16 serving copy's identity). Not safe for two threads at once: they
    would share a state.
    """

    def __init__(self, module, device: torch.device, beam_shapes: int = 2):
        self.module = module
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None  # captures need the card
        self.captured: Dict[Tuple, Tuple[SlotState, CapturedSteps]] = {}
        self.beams: Dict[Tuple, Any] = {}  # decode.py:beam_graphs fills it: a BeamGraphs per beam key
        self.beam_pools: Dict[Tuple, Any] = {}
        self.beam_shapes = int(beam_shapes)

    def get(self, batch: int, max_length: int, pick: Sampler, eos_token_id: int,
            pad_token_id: int) -> Tuple[SlotState, CapturedSteps]:
        """The state (reset: every slot free) and the captured step; captured at first use."""
        key = (batch, max_length, pick, eos_token_id, pad_token_id)
        if key not in self.captured:
            generator = torch.Generator(self.device) if pick.do_sample else None
            state = init_slot_state(self.module.decoder_config, batch, max_length, self.module.compute_dtype,
                                    self.device, eos_token_id=eos_token_id, pad_token_id=pad_token_id,
                                    generator=generator)
            step = CapturedSteps(lambda: decode_steps(self.module, state, 1, pick), self.device, self.stream,
                                 (generator,))
            self.captured[key] = (state, step)
        state, step = self.captured[key]
        state.reset()
        return state, step
