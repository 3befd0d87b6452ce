"""Vision-conditioned caption decoder (PyTorch).

Mirrors pgica_tpu/models/decoder.py:41-183.

* ``forward`` is the teacher-forced training forward (decoder.py:88-131):
  the projected vision token (Dense, tanh, ``vision_dropout``); cross-
  attention of the TOKEN-ONLY ``wte`` embeddings to it, residual and
  ``cross_ln`` (eps 1e-5); then, for GPT-2, ``wpe`` positions, added after
  the LN; then the LM over these ``inputs_embeds`` with the caption mask.
* ``decode_prefix`` puts the vision token (plus ``wpe(0)`` for GPT-2) at
  position 0 and primes the caches (decoder.py:142-153); ``decode_step``
  adds ``wpe(position)`` to the token embedding for GPT-2
  (decoder.py:169-176), gathered per row when ``position`` is a (B,) tensor
  (continuous batching). As in the JAX package and the reference it mirrors,
  cross-attention does NOT run at decode time (decoder.py:16-21) unless the
  decoder is built with ``cross_attend_at_decode=True`` and the step is given
  the vision embeddings: then the step's token embedding is fused with the
  projected vision token, through cross-attention and ``cross_ln``, before
  ``wpe`` (the training forward's order; JAX decoder.py:165-168). No decode
  loop passes them, in either package.

``quant`` builds the LM's blocks int8 for the inference-only twin (JAX
decoder.py:58-63,85), with remat off; the vision projection and the
cross-attention stay in the compute dtype. ``shared_lm`` is the
``share_text_tower`` LM, owned by the top-level module: the decoder keeps a
reference that is not registered as a child, so its parameters appear once,
under ``shared_lm``.

Under context parallelism (``ring_axis``, training/cp_step.py) the caption
ids are this rank's sequence shard: GPT-2's ``wpe`` takes the shard's global
positions (JAX decoder.py:118-127) and the LM's self-attention runs the
ring; the vision token is the same on every shard. Under tensor parallelism
the cross-attention's q/k/v/out are cut like the LM's (parallel/sharding.py).

Llama has no ``wpe``: its positions come from RoPE alone, so caption tokens
sit at 0..S-1 in training and at 1.. after the vision token at decode. That
asymmetry is the JAX package's, and the port keeps it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from pgica_tpu_torch.models.layers import Dense, KVCaches, MultiHeadAttention, Position
from pgica_tpu_torch.models.lm import TransformerLM
from pgica_tpu_torch.models.presets import LMConfig
from pgica_tpu_torch.ops.dropout import FastDropout
from pgica_tpu_torch.ops.layernorm import LayerNorm
from pgica_tpu_torch.parallel import collectives, fsdp


class CaptionDecoder(nn.Module):
    ring_axis: Optional[str] = None  # the caption sequence is sharded over this mesh axis

    def __init__(
        self,
        config: LMConfig,
        projection_dim: int = 512,
        num_cross_heads: int = 8,
        dropout: float = 0.1,
        dtype: torch.dtype = torch.float32,
        shared_lm: Optional[TransformerLM] = None,
        quant: Optional[str] = None,
        cross_attend_at_decode: bool = False,
    ):
        super().__init__()
        self.config = config
        self.cross_attend_at_decode = cross_attend_at_decode
        self.vision_projection = Dense(projection_dim, config.hidden_size, dtype)
        self.vision_dropout = FastDropout(dropout)
        self.cross_attention = MultiHeadAttention(config.hidden_size, num_cross_heads, dropout=dropout, dtype=dtype)
        self.cross_ln = LayerNorm(config.hidden_size, 1e-5, dtype)
        if shared_lm is not None:
            object.__setattr__(self, "lm", shared_lm)  # not a child: the top-level module owns it
        else:
            lm_config = dataclasses.replace(config, remat=False) if quant else config
            self.lm = TransformerLM(lm_config, with_lm_head=True, dtype=dtype, quant=quant)

    def project_vision(
        self, vision_embeddings: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """(B, projection_dim) -> (B, 1, hidden) vision token."""
        v = torch.tanh(self.vision_projection(vision_embeddings))
        return self.vision_dropout(v, generator)[:, None, :]

    def fuse(
        self, token_embeds: torch.Tensor, vision_token: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Cross-attend token embeddings to the vision token; residual + LN."""
        attended = self.cross_attention(token_embeds, generator=generator, kv=vision_token)
        return self.cross_ln(token_embeds + attended)

    def forward(
        self,
        caption_ids: torch.Tensor,
        caption_mask: Optional[torch.Tensor],
        vision_embeddings: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        with_logits: bool = True,
    ) -> dict:
        """Teacher-forced forward: ``hidden_states`` (B, S, hidden) and, unless
        ``with_logits`` is False, ``logits`` (B, S, V). ``generator`` drives dropout."""
        if caption_mask is None:
            caption_mask = torch.ones_like(caption_ids)
        dtype = self.lm.dtype
        vision_token = self.project_vision(vision_embeddings, generator)
        token_embeds = self.lm.wte(caption_ids).to(dtype)
        fused = self.fuse(token_embeds, vision_token, generator)
        if self.lm.learned_positions:
            s = caption_ids.shape[1]
            start = 0 if self.ring_axis is None else collectives.axis_index(self.ring_axis) * s
            fused = fused + fsdp.full(self.lm.wpe, "weight")[start:start + s].to(dtype)[None]
        out = self.lm(inputs_embeds=fused, attention_mask=caption_mask, generator=generator,
                      with_logits=with_logits)
        return {key: out[key] for key in ("hidden_states", "logits") if key in out}

    def decode_prefix(
        self, vision_embeddings: torch.Tensor, caches: KVCaches, attention_mask: torch.Tensor
    ) -> Tuple[torch.Tensor, KVCaches]:
        """Vision token at position 0 -> (logits for the first token (B, V), caches)."""
        vision_token = self.project_vision(vision_embeddings)
        if self.lm.learned_positions:
            vision_token = vision_token + self.lm.wpe.weight[:1].to(self.lm.dtype)[None]
        out = self.lm(inputs_embeds=vision_token, attention_mask=attention_mask, caches=caches, position=0)
        return out["logits"][:, -1, :], out["caches"]

    def decode_step(
        self, token_ids: torch.Tensor, position: Position, caches: KVCaches, attention_mask: torch.Tensor,
        vision_embeddings: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, KVCaches]:
        """One step: (B, 1) tokens written at cache slot ``position`` (an int, or (B,) per row)
        -> (B, V) next-token logits. ``vision_embeddings`` (B, projection_dim) are fused in only
        with ``cross_attend_at_decode``."""
        dtype = self.lm.dtype
        embeds = self.lm.wte(token_ids).to(dtype)
        if self.cross_attend_at_decode and vision_embeddings is not None:
            embeds = self.fuse(embeds, self.project_vision(vision_embeddings))
        if self.lm.learned_positions:
            pe = self.lm.wpe.weight[position].to(dtype)  # (hidden,), or (B, hidden) per row
            embeds = embeds + (pe[:, None] if pe.dim() == 2 else pe[None, None])
        out = self.lm(inputs_embeds=embeds, attention_mask=attention_mask, caches=caches, position=position)
        return out["logits"][:, -1, :], out["caches"]
