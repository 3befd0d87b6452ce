"""Ring attention: context-parallel attention over a mesh axis (port of pgica_tpu/ops/ring_attention.py).

The sequence dimension is split over a mesh axis; each rank holds its
queries and passes its (k, v) block around the ring with
``collectives.ppermute``, folding every block into an online softmax
(running max, running sum, rescaled accumulator). The score block of one
pair of shards is the largest thing a rank holds: the (S, S) scores never
exist anywhere.

Causal masking across the ring: rank ``my`` attends its own block causally,
the blocks of earlier ranks fully and those of later ranks not at all. A
key-padding ``kv_bias`` (B, S_local) travels with its block. A row that no
key reaches keeps ``l == 0`` and returns zeros, as the JAX version's guard.

Plain PyTorch ops (the JAX version is pure ``lax``, no Pallas kernel), in
float32, differentiated by autograd through the ``ppermute``s. Call it
with the mesh bound (``with mesh:``) and q/k/v of every rank of ``axis``
the same shape; matches one-device attention to float tolerance
(tests/test_torch_context_parallel.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from pgica_tpu_torch.ops.flash_attention import NEG_INF
from pgica_tpu_torch.parallel import collectives


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name: str,
    causal: bool = False,
    kv_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, H, S_local, D) q/k/v shards -> (B, H, S_local, D) output shard, in q's dtype."""
    n = collectives.axis_size(axis_name)
    my = collectives.axis_index(axis_name)
    b, h, s_loc, d = q.shape
    scale = 1.0 / (d ** 0.5)
    perm = [(i, (i + 1) % n) for i in range(n)]  # pass KV to the next shard
    if kv_bias is None:
        kv_bias = torch.zeros((b, s_loc), dtype=torch.float32, device=q.device)
    q32 = q.to(torch.float32) * scale
    diag = torch.where(torch.ones(s_loc, s_loc, dtype=torch.bool, device=q.device).tril(), 0.0, NEG_INF)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    k_blk, v_blk, bias_blk = k, v, kv_bias.to(torch.float32)
    for step in range(n):
        src = (my - step) % n  # the shard this block came from
        s = q32 @ k_blk.to(torch.float32).transpose(-1, -2) + bias_blk[:, None, None, :]
        if causal and src == my:
            s = s + diag
        elif causal and src > my:
            s = s + NEG_INF  # a later shard's keys: masked entirely
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ v_blk.to(torch.float32)
        m = m_new
        if step < n - 1:  # rotate KV (and its key bias) to the next shard
            k_blk = collectives.ppermute(k_blk, axis_name, perm)
            v_blk = collectives.ppermute(v_blk, axis_name, perm)
            bias_blk = collectives.ppermute(bias_blk, axis_name, perm)
    l_safe = torch.where(l == 0.0, 1.0, l)
    return (acc / l_safe[..., None]).to(q.dtype)
