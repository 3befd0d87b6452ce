"""Decoder-only transformer LM, GPT-2 and Llama architectures (PyTorch).

Mirrors pgica_tpu/models/lm.py:27-209: token embeddings (the ``input_ids``
path of the text tower; GPT-2 adds learned positions ``wpe``, Llama has none
and rotates q and k instead) or ``inputs_embeds`` (the decoder), causal
pre-norm blocks (GPT-2: LayerNorm, GELU, biases; Llama: RMSNorm, SwiGLU,
RoPE, grouped-query heads, no biases), ``ln_f`` and, with ``with_lm_head``,
the weight-tied head ``logits = h @ wte.T``. The head is one large matmul that
the JAX package leaves to XLA outside any kernel, so it stays ``F.linear``
here (``Embedding.attend``, models/layers.py). ``with_logits=False`` skips it for one call: the stage-2 step takes
its log-probs from the hidden states through the fused linear-CE kernels,
where XLA drops the unused logits from the JAX graph (train_step.py:268-269);
eager PyTorch would compute and keep them.

Under ZeRO-3 (parallel/zero3.py) and FSDP (parallel/fsdp.py) ``sharded``
holds the blocks' weights as shards over the ranks: each block runs on its
weights gathered at its entry (a differentiable gather whose backward
reduce-scatters the gradient) and drops them after; with ``remat`` the
gather sits inside the checkpointed function, so the backward pass gathers
again.

Under tensor parallelism (parallel/sharding.py) ``wte`` is vocab-parallel
(models/layers.py:Embedding): the lookup sums the ranks' rows and the tied
head gathers their logit columns. Under context parallelism
(``ring_axis``, training/cp_step.py) the ids are this rank's sequence shard
and GPT-2's ``wpe`` takes the shard's global positions (JAX lm.py:175-181).

``quant`` ("int8" / "int8_weight_only") builds the blocks' matmuls as int8
``QuantDense`` for an inference-only twin (JAX lm.py:60-70,113); the
embeddings and the tied head stay in the compute dtype. It refuses a config
with ``remat``, a training-time transform.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from pgica_tpu_torch.models.layers import (
    CacheRows,
    Embedding,
    KVCaches,
    Position,
    TransformerBlock,
    checkpointed,
    make_norm,
)
from pgica_tpu_torch.models.presets import LMConfig
from pgica_tpu_torch.ops.attention import key_padding_bias
from pgica_tpu_torch.parallel import collectives


def kv_cache_buffer(cfg: LMConfig, rows: int, length: int, dtype: torch.dtype,
                    device: torch.device) -> Tuple[torch.Tensor, KVCaches]:
    """Zeroed k and v caches of every layer in one buffer (layers, 2, rows, H_kv, length, D), and the
    per-layer (k, v) views of it that the decoder writes (a reset or a scatter of rows is one call)."""
    buffer = torch.zeros((cfg.num_layers, 2, rows, cfg.kv_heads, length, cfg.head_dim), dtype=dtype, device=device)
    return buffer, [(layer[0], layer[1]) for layer in buffer]


def init_kv_cache(
    cfg: LMConfig, batch: int, max_len: int, dtype: torch.dtype, device: torch.device
) -> KVCaches:
    """All-zeros per-layer (k, v) caches, each (B, H_kv, max_len, D): the views of :func:`kv_cache_buffer`.

    Slots past the current position stay zero; the decode key mask keeps
    them out of attention (JAX lm.py:185-192).
    """
    return kv_cache_buffer(cfg, batch, max_len, dtype, device)[1]


class TransformerLM(nn.Module):
    """Causal transformer over token ids or input embeddings, with an optional tied LM head."""

    ring_axis: Optional[str] = None  # the sequence is sharded over this mesh axis (training/cp_step.py)

    def __init__(self, config: LMConfig, with_lm_head: bool = True, dtype: torch.dtype = torch.float32,
                 quant: Optional[str] = None):
        super().__init__()
        cfg = config
        if cfg.arch not in ("gpt2", "llama"):
            raise ValueError(f"unknown arch {cfg.arch!r}")
        if quant and cfg.remat:
            raise ValueError("quant is an inference-only transform (no remat)")
        llama = cfg.arch == "llama"
        self.config = cfg
        self.with_lm_head = with_lm_head
        self.dtype = dtype
        self.wte = Embedding(cfg.vocab_size, cfg.hidden_size)
        if not llama:  # Llama's positions come from RoPE alone
            self.wpe = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                cfg.hidden_size, cfg.num_heads, int(cfg.hidden_size * cfg.mlp_ratio),
                causal=True, norm_eps=cfg.norm_eps, mlp_kind="swiglu" if llama else "gelu",
                dropout=cfg.dropout, dtype=dtype, norm="rmsnorm" if llama else "layernorm",
                num_kv_heads=cfg.num_kv_heads, use_bias=not llama, use_rope=llama, rope_theta=cfg.rope_theta,
                quant=quant,
            )
            for _ in range(cfg.num_layers)
        )
        self.ln_f = make_norm("rmsnorm" if llama else "layernorm", cfg.hidden_size, cfg.norm_eps, dtype)
        self.sharded = None  # ZeRO-3's or FSDP's block gather (parallel/zero1.py, parallel/fsdp.py), else None

    @property
    def learned_positions(self) -> bool:
        """GPT-2 adds ``wpe``; Llama rotates q and k (RoPE) instead."""
        return self.config.arch == "gpt2"

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        caches: Optional[KVCaches] = None,
        position: Position = 0,
        generator: Optional[torch.Generator] = None,
        with_logits: bool = True,
    ) -> dict:
        """input_ids (B, S) or inputs_embeds (B, S, hidden); attention_mask (B, S), or (B, max_len) with caches.

        Token ids get ``wte`` plus, for GPT-2, ``wpe`` of positions
        ``position .. position + S - 1`` (JAX lm.py:172-181); Llama's
        attention rotates q and k at those positions. With ``caches``,
        ``position`` may be a (B,) tensor, each row's own (inputs_embeds of
        one token; see ``MultiHeadAttention``). Returns ``hidden_states``,
        ``logits`` (B, S, V) with the LM head unless ``with_logits`` is
        False, and ``caches`` (the same list, written in place, or None).
        ``generator`` drives dropout (None: off). With ``config.remat`` a
        training forward (gradients on, no cache) checkpoints every block.
        """
        if inputs_embeds is None:
            if input_ids is None:
                raise ValueError("Provide input_ids or inputs_embeds")
            x = self.wte(input_ids).to(self.dtype)
            if self.learned_positions:
                start = position
                if self.ring_axis is not None and caches is None:  # this shard's global positions
                    start = collectives.axis_index(self.ring_axis) * input_ids.shape[1]
                positions = torch.arange(start, start + input_ids.shape[1], device=input_ids.device)
                x = x + self.wpe(positions).to(self.dtype)[None]
        else:
            x = inputs_embeds.to(self.dtype)
        # one key bias for the whole forward, shared by every layer's attention
        key_bias = None if attention_mask is None else key_padding_bias(attention_mask)
        per_row = isinstance(position, torch.Tensor)
        remat = self.config.remat and caches is None and torch.is_grad_enabled() and not per_row and position == 0
        # per-row positions: one write plan for every layer's cache
        rows = CacheRows(position, caches[0][0].shape) if per_row and caches else None
        for i, block in enumerate(self.blocks):
            run = block if self.sharded is None else self.sharded.block(self, i)
            if remat:
                x = checkpointed(run, x, key_bias, generator)
            else:
                x = run(x, key_bias, None if caches is None else caches[i], position, generator, rows=rows)
        x = self.ln_f(x)
        out = {"hidden_states": x, "caches": caches}
        if self.with_lm_head and with_logits:
            out["logits"] = self.wte.attend(x, self.dtype)
        return out
