"""Core transformer building blocks (PyTorch).

Mirrors pgica_tpu/models/layers.py:26-293: the norm factory (LayerNorm or
RMSNorm), rotary position embeddings, multi-head attention (self-attention
with a KV cache written at one position, or at one position per row for
continuous batching, or cross-attention to a ``kv`` input; grouped-query
heads; RoPE), the GELU and SwiGLU MLPs with dropout, and the pre-norm
block. With ``quant`` (an inference-only twin, models/model.py) the
attention projections and the MLP's dense layers are int8
:class:`~pgica_tpu_torch.ops.quant.QuantDense` (JAX layers.py:79-115,
174-190,203-215).

Tensor parallelism (``tp_axis``, set by parallel/sharding.py:shard_module
on a module whose weights it cut to this rank's block): attention keeps its
local heads and the MLP its local intermediate columns, the input passing
through ``collectives.copy_to`` and the output projection summing its
partial products with ``collectives.reduce_from`` before its replicated
bias; :class:`Embedding` looks up the ids of its vocab rows and sums the
ranks' rows. Where grouped-query k/v stay whole (the rules replicate them
when the axis does not divide the KV heads), a rank's q heads meet their
own KV heads, and the k/v weights' gradients, partial on each rank, are
summed over the axis. Context parallelism (``ring_axis``, set by
training/cp_step.py:ring_mode on the decoder): self-attention without a
cache runs :func:`~pgica_tpu_torch.ops.ring_attention.ring_attention` over
the sequence shards, RoPE at the shard's global positions, and the key
padding mask as the ring's additive ``kv_bias`` (JAX layers.py:125-138,
166-174); decode and cross-attention stay on the plain path.

Every module takes the compute ``dtype`` at construction, as the Flax
modules do. :class:`Dense` is Flax's ``Dense(dtype, param_dtype=float32)``:
it casts its input and its float32 master weights to ``dtype`` in every
forward, inside the autograd graph, so training in bf16 sends gradients to
the float32 masters. For bf16 inference the model casts a copy of the masters
once instead (model.py), and the per-forward cast is then a no-op. LayerNorm
and RMSNorm parameters stay float32 (see ops/layernorm.py, ops/rmsnorm.py).

Dropout follows the JAX modules' ``deterministic`` flag through an optional
``generator`` argument: ``None`` is the deterministic call (eval, serving);
training passes the step's ``torch.Generator`` (see ops/dropout.py).

Parameter shapes follow PyTorch (``nn.Linear`` weight is (out, in));
models/convert.py maps the JAX tree onto them.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from pgica_tpu_torch.ops.attention import xla_attention
from pgica_tpu_torch.ops.dropout import FastDropout
from pgica_tpu_torch.ops.flash_attention import flash_attention
from pgica_tpu_torch.ops.layernorm import LayerNorm
from pgica_tpu_torch.ops.quant import QuantDense
from pgica_tpu_torch.ops.ring_attention import ring_attention
from pgica_tpu_torch.ops.rmsnorm import RMSNorm
from pgica_tpu_torch.parallel import collectives, fsdp

# (k, v), each (B, H, max_len, D). Caches are plain lists of these tuples,
# written IN PLACE at the decode position — unlike the JAX package, whose
# caches are functional values threaded through the loop (layers.py:141-158).
KVCache = Tuple[torch.Tensor, torch.Tensor]
KVCaches = List[KVCache]
# A decode position: one int for every row, or a (B,) int64 tensor on the
# device with each row's own (continuous batching; a CUDA graph replays it).
Position = Union[int, torch.Tensor]


def make_norm(kind: str, hidden: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32) -> nn.Module:
    """``"rmsnorm"`` (Llama) or LayerNorm; eps defaults to 1e-5 (HF GPT-2/CLIP convention)."""
    if kind == "rmsnorm":
        return RMSNorm(hidden, eps, dtype)
    return LayerNorm(hidden, eps, dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE on (B, H, S, D) at integer ``positions`` (S,), or (B, S) per row, as JAX layers.py:41-52.

    Interleaved pairs (``x[..., 0::2]``, ``x[..., 1::2]``), not Hugging
    Face's ``rotate_half``; float32 angles ``positions / theta**(2i/d)``, cos
    and sin in float32, the result cast back to x's dtype.
    """
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    angles = positions.to(torch.float32)[..., None] * freqs  # (S, D/2), or (B, S, D/2)
    if angles.dim() == 3:
        angles = angles[:, None]  # (B, 1, S, D/2): one set of angles per row, for every head
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` from float32 master weights (Flax ``Dense``); ``bias`` optional."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


def replicated_dense(dense: Dense, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``dense(x)`` for a whole weight used by one rank's share of a tensor-parallel computation: its
    gradients, partial on each rank, are summed over ``axis`` (``copy_to`` on the weight and bias)."""
    bias = None if dense.bias is None else collectives.copy_to(dense.bias, axis).to(dense.dtype)
    return F.linear(x.to(dense.dtype), collectives.copy_to(dense.weight, axis).to(dense.dtype), bias)


def row_parallel(dense: Dense, x: torch.Tensor, axis: str) -> torch.Tensor:
    """A row-parallel product: this rank's input columns times its weight columns, summed over ``axis``,
    then the replicated bias added once."""
    y = collectives.reduce_from(F.linear(x.to(dense.dtype), dense.weight.to(dense.dtype)), axis)
    return y if dense.bias is None else y + dense.bias.to(dense.dtype)


class Embedding(nn.Embedding):
    """``nn.Embedding`` with the vocab-parallel lookup and head of a tensor-parallel ``wte``.

    With ``tp_axis`` its rows are this rank's block of the vocab: an id
    outside it gives a zero row, and the ranks' rows are summed
    (``reduce_from``); :meth:`attend` (the weight-tied head ``h @ W^T``)
    gathers the ranks' logit columns.
    """

    tp_axis: Optional[str] = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp_axis is None:
            return super().forward(ids)
        rows = self.weight.shape[0]
        local = ids - collectives.axis_index(self.tp_axis) * rows
        inside = ((local >= 0) & (local < rows))[..., None]
        out = F.embedding(local.clamp(0, rows - 1), self.weight) * inside.to(self.weight.dtype)
        return collectives.reduce_from(out, self.tp_axis)

    def attend(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Logits ``x @ W^T`` in ``dtype`` over the whole vocab (``W`` gathered where it is cut over ``fsdp``)."""
        w = fsdp.full(self, "weight").to(dtype)
        if self.tp_axis is None:
            return F.linear(x, w)
        return collectives.gather_from(F.linear(collectives.copy_to(x, self.tp_axis), w), self.tp_axis, -1)


def dense_factory(quant: Optional[str]):
    """``Dense``, or with ``quant`` ("int8" / "int8_weight_only") the int8 ``QuantDense``; same arguments."""
    if not quant:
        return Dense

    def make(in_features: int, out_features: int, dtype: torch.dtype = torch.float32, bias: bool = True):
        return QuantDense(in_features, out_features, dtype, bias, weight_only=quant == "int8_weight_only")

    return make


class CacheRows:
    """Where a decode step at per-row positions writes its new k and v in caches (B, H, L, D).

    Row b goes to slot ``position[b]``; a row whose position lies outside
    [0, L) keeps what it holds (JAX layers.py:148-156). Built once a forward
    (``TransformerLM``) and used by every layer's k and v: the caches,
    viewed as (B*H*L, D), take an ``index_copy_`` of the new rows, each
    out-of-range row writing back the value it read at a clamped slot.
    Every index stays on the device (no host synchronisation), so a CUDA
    graph can capture it.
    """

    def __init__(self, position: torch.Tensor, cache_shape: torch.Size):
        b, h, length, _ = cache_shape
        at = position.clamp(0, length - 1)
        slot0 = torch.arange(0, b * h * length, length, device=position.device).view(b, h)
        self.index = (slot0 + at[:, None]).view(-1)  # (B*H,) rows of the flat cache
        self.outside = (at != position)[:, None, None]  # (B, 1, 1)

    def write(self, cache: torch.Tensor, new: torch.Tensor) -> None:
        """cache[b, :, position[b]] = new (B, H, 1, D)[b, :, 0], in place, for the rows inside."""
        b, h, s, d = new.shape
        if s != 1:
            raise ValueError(f"per-row cache positions take one new token a row, got {s}")
        flat = cache.view(-1, d)
        old = flat.index_select(0, self.index).view(b, h, d)
        flat.index_copy_(0, self.index, torch.where(self.outside, old, new.view(b, h, d).to(cache.dtype)).view(-1, d))


class MultiHeadAttention(nn.Module):
    """Self-attention with an optional KV cache, or cross-attention to ``kv`` (JAX layers.py:55-193).

    ``num_kv_heads`` below ``num_heads`` is grouped-query attention: the k and
    v projections give ``num_kv_heads`` heads, the cache keeps that many, and
    each is repeated for its ``num_heads // num_kv_heads`` query heads after
    the cache (``repeat_interleave``, ``jnp.repeat``'s order). ``use_rope``
    rotates q and k before the cache write, at positions ``position ..
    position + S - 1`` (each row's own with a tensor ``position``). With
    ``quant`` the four projections are int8; ``out_proj``'s scales are per
    output channel over the flattened heads x head_dim, as the JAX
    ``axis=(-2, -1)`` contraction gives them. ``tp_axis``, ``kv_sharded``
    and ``ring_axis``: see the module docstring.
    """

    tp_axis: Optional[str] = None  # q/k/v/out cut to this rank's heads (parallel/sharding.py)
    kv_sharded: bool = False  # k/v cut too (else whole: grouped-query heads the axis does not divide)
    ring_axis: Optional[str] = None  # self-attention over sequence shards (training/cp_step.py)

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        causal: bool = False,
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        num_kv_heads: Optional[int] = None,
        use_bias: bool = True,
        use_rope: bool = False,
        rope_theta: float = 500000.0,
        quant: Optional[str] = None,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        self.use_rope = use_rope
        self.rope_theta = rope_theta
        inner = num_heads * self.head_dim
        kv_inner = self.num_kv_heads * self.head_dim
        dense = dense_factory(quant)
        self.q_proj = dense(hidden_size, inner, dtype, use_bias)
        self.k_proj = dense(hidden_size, kv_inner, dtype, use_bias)
        self.v_proj = dense(hidden_size, kv_inner, dtype, use_bias)
        self.out_proj = dense(inner, hidden_size, dtype, use_bias)
        self.dropout = FastDropout(dropout)

    def forward(
        self,
        x: torch.Tensor,
        key_bias: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        position: Position = 0,
        generator: Optional[torch.Generator] = None,
        kv: Optional[torch.Tensor] = None,
        rows: Optional[CacheRows] = None,
    ) -> torch.Tensor:
        """x (B, S, hidden); key_bias (B, Sk) float32 from ``key_padding_bias``, or None.

        With ``cache``, the new k/v are written into it at ``position`` (in
        place) and attention runs over the whole cache. A (B,) tensor
        ``position`` (S must be 1) writes row b at ``position[b]``, and a row
        whose position lies outside the cache writes nothing (JAX
        layers.py:148-156; ``rows``, the write's :class:`CacheRows`, when the
        caller has built it); when every row holds the same position, it gives
        the int's bits. With ``kv`` (B, Sk,
        hidden), keys and values come from it (cross-attention, unmasked):
        the decoder's single vision token, which the JAX package pins to the
        plain attention (decoder.py:78; "not flash-worthy" on the TPU). The
        training and teacher-forced forwards run ``xla_attention`` here too;
        a decode step (S = 1, ``cross_attend_at_decode``) runs the flash
        kernel (at S = Sk = 1 the head views are contiguous already, so
        ``.contiguous()`` copies nothing), which takes 5.06 us there on the
        H100 against 34.5 for its plain version (PERF.md §6). Over one key both give exactly v, so
        broadcasting v would be exact and launch nothing; the kernel branch
        is kept so that a cross-attending step runs the ported flash forward
        (ROADMAP.md, queue 1 item 8).
        """
        b, s, _ = x.shape

        def heads(t: torch.Tensor) -> torch.Tensor:  # (B, S, n*D) -> (B, n, S, D)
            return t.view(b, t.shape[1], -1, self.head_dim).transpose(1, 2)

        tp = self.tp_axis
        if tp is not None:
            x = collectives.copy_to(x, tp)
            kv = None if kv is None else collectives.copy_to(kv, tp)
        src = x if kv is None else kv
        q = heads(self.q_proj(x))
        if tp is not None and not self.kv_sharded:
            k, v = heads(replicated_dense(self.k_proj, src, tp)), heads(replicated_dense(self.v_proj, src, tp))
        else:
            k, v = heads(self.k_proj(src)), heads(self.v_proj(src))
        if kv is not None:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous()) if s == 1 else \
                xla_attention(q, k, v, None, False)
            return self.dropout(self._out(out.transpose(1, 2).reshape(b, s, -1)), generator)
        per_row = isinstance(position, torch.Tensor)
        ring = self.ring_axis is not None and cache is None
        if self.use_rope:
            if per_row:
                positions = position[:, None] + torch.arange(s, device=x.device)  # (B, S)
            elif ring:  # this shard's global positions
                start = collectives.axis_index(self.ring_axis) * s
                positions = torch.arange(start, start + s, device=x.device)
            else:
                positions = torch.arange(position, position + s, device=x.device)
            q = rotary_embedding(q, positions, self.rope_theta)
            k = rotary_embedding(k, positions, self.rope_theta)
        if cache is not None:
            k_cache, v_cache = cache
            if per_row:
                rows = rows or CacheRows(position, k_cache.shape)
                rows.write(k_cache, k)
                rows.write(v_cache, v)
            else:
                k_cache[:, :, position:position + s] = k
                v_cache[:, :, position:position + s] = v
            k, v = k_cache, v_cache
        if k.shape[1] != q.shape[1]:
            rep = self.num_heads // self.num_kv_heads
            k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
            if k.shape[1] != q.shape[1]:  # whole k/v under cut q: this rank's heads meet their own KV heads
                start = collectives.axis_index(tp) * q.shape[1]
                k, v = k[:, start:start + q.shape[1]], v[:, start:start + q.shape[1]]
        causal = self.causal and cache is None  # decode masks through `key_bias`
        if ring:
            out = ring_attention(q, k, v, self.ring_axis, causal, key_bias)
        else:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), key_bias, causal)
        return self.dropout(self._out(out.transpose(1, 2).reshape(b, s, -1)), generator)

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(x) if self.tp_axis is None else row_parallel(self.out_proj, x, self.tp_axis)


class MLP(nn.Module):
    """``gelu`` (GPT-2, SigLIP) or ``quick_gelu`` (CLIP): fc_in, activation, fc_out; ``swiglu``
    (Llama): down_proj(silu(gate_proj(x)) * up_proj(x)). Dropout on the output (JAX layers.py:196-232).
    With ``tp_axis`` the intermediate columns are this rank's (column- then row-parallel)."""

    tp_axis: Optional[str] = None

    def __init__(
        self,
        hidden_size: int,
        intermediate_size: int,
        kind: str = "gelu",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        use_bias: bool = True,
        quant: Optional[str] = None,
    ):
        super().__init__()
        self.kind = kind
        dense = dense_factory(quant)
        if kind == "swiglu":
            self.gate_proj = dense(hidden_size, intermediate_size, dtype, use_bias)
            self.up_proj = dense(hidden_size, intermediate_size, dtype, use_bias)
            self.down_proj = dense(intermediate_size, hidden_size, dtype, use_bias)
        elif kind in ("gelu", "quick_gelu"):
            self.fc_in = dense(hidden_size, intermediate_size, dtype, use_bias)
            self.fc_out = dense(intermediate_size, hidden_size, dtype, use_bias)
        else:
            raise ValueError(f"unknown MLP kind {kind!r}")
        self.dropout = FastDropout(dropout)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tp = self.tp_axis
        if tp is not None:
            x = collectives.copy_to(x, tp)
        if self.kind == "swiglu":
            h = F.silu(self.gate_proj(x)) * self.up_proj(x)
            out = self.down_proj
        else:
            h = self.fc_in(x)
            if self.kind == "quick_gelu":  # CLIP's activation: x * sigmoid(1.702x)
                h = h * torch.sigmoid(1.702 * h)
            else:  # GPT-2: flax nn.gelu(approximate=True)
                h = F.gelu(h, approximate="tanh")
            out = self.fc_out
        return self.dropout(out(h) if tp is None else row_parallel(out, h, tp), generator)


class _ReplayDropout:
    """Calls a block, replaying its dropout draws when ``torch.utils.checkpoint`` recomputes it.

    The checkpoint restores only the default CPU/CUDA RNG states, not the
    explicit generator the blocks draw their dropout masks from; a recompute
    would draw new masks and give wrong gradients. So the generator's state
    is taken before the first call, set back for each recompute, and the
    state that the recompute found is restored after it. The JAX package's
    ``nn.remat`` replays the same key, so neither package's gradients
    depend on the flag.
    """

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator
        self.state = None if generator is None else generator.get_state()
        self.calls = 0

    def __call__(self, block: nn.Module, x: torch.Tensor, *args) -> torch.Tensor:
        self.calls += 1
        if self.generator is None or self.calls == 1:
            return block(x, *args, self.generator)
        resume = self.generator.get_state()
        self.generator.set_state(self.state)
        try:
            return block(x, *args, self.generator)
        finally:
            self.generator.set_state(resume)


def checkpointed(block: Callable[..., torch.Tensor], x: torch.Tensor, key_bias: Optional[torch.Tensor],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``block(x, key_bias, None, 0, generator)`` with its activations recomputed in the backward.

    ``block`` is a block module or a callable of its signature (ZeRO-3's
    gathering block, whose gather is then recomputed too).

    Activation checkpointing (the JAX package's ``nn.remat`` over each block,
    lm.py:95-96, vit.py:62): only the block's input is kept for the backward.
    A block draws no number from the default RNGs (dropout takes the explicit
    generator, which ``_ReplayDropout`` replays), so their states are not
    stashed per block (``preserve_rng_state=False``).
    """
    return torch.utils.checkpoint.checkpoint(_ReplayDropout(generator), block, x, key_bias, None, 0,
                                             use_reentrant=False, preserve_rng_state=False)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block; ``ln_0``/``ln_1`` are the JAX ``LayerNorm_0``/``LayerNorm_1``
    (``RMSNorm_0``/``RMSNorm_1`` with ``norm="rmsnorm"``)."""

    def __init__(
        self,
        hidden_size: int,
        num_heads: int,
        intermediate_size: int = 0,
        causal: bool = False,
        norm_eps: float = 1e-5,
        mlp_kind: str = "gelu",
        dropout: float = 0.0,
        dtype: torch.dtype = torch.float32,
        norm: str = "layernorm",
        num_kv_heads: Optional[int] = None,
        use_bias: bool = True,
        use_rope: bool = False,
        rope_theta: float = 500000.0,
        quant: Optional[str] = None,
    ):
        super().__init__()
        self.ln_0 = make_norm(norm, hidden_size, norm_eps, dtype)
        self.attn = MultiHeadAttention(hidden_size, num_heads, causal, dropout, dtype, num_kv_heads, use_bias,
                                       use_rope, rope_theta, quant)
        self.ln_1 = make_norm(norm, hidden_size, norm_eps, dtype)
        self.mlp = MLP(hidden_size, intermediate_size or 4 * hidden_size, mlp_kind, dropout, dtype, use_bias, quant)

    def forward(
        self,
        x: torch.Tensor,
        key_bias: Optional[torch.Tensor] = None,
        cache: Optional[KVCache] = None,
        position: Position = 0,
        generator: Optional[torch.Generator] = None,
        rows: Optional[CacheRows] = None,
    ) -> torch.Tensor:
        x = x + self.attn(self.ln_0(x), key_bias, cache, position, generator, rows=rows)
        return x + self.mlp(self.ln_1(x), generator)
