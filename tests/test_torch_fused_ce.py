"""The port's fused linear cross-entropy against the JAX package, on the CPU.

On a CPU tensor the kernel wrappers run their plain versions, and the
autograd Function routes its backward through the same wrappers. The JAX
side runs ``fused_token_logprobs`` with ``impl="pallas"`` — the Pallas
kernels in interpret mode, with small ``block_rows``/``block_vocab`` so that
several row and vocab tiles and a partial last tile occur — and with
``impl="xla"``. Inputs come from a numpy seed. Tolerances: float32 forward
atol 1e-5 and gradients atol 1e-5 (the same sums taken in another order,
tile by tile; the JAX package's own fused-CE test allows 1e-5 and 1e-4);
bf16 outputs within one bf16 rounding (rtol 2**-7) of JAX's, since both cast
an f32 result that may straddle a rounding boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.ops.fused_ce import fused_token_logprobs as jax_fused
from pgica_tpu_torch.ops import _kernels
from pgica_tpu_torch.ops.fused_ce import (
    VOCAB_TILE,
    fused_ce_bwd_dh,
    fused_ce_bwd_dh_ref,
    fused_ce_bwd_dw,
    fused_ce_bwd_dw_ref,
    fused_ce_bwd_ref,
    fused_ce_fwd,
    fused_ce_fwd_ref,
    fused_token_logprobs,
    token_logprobs_ref,
    vocab_splits,
)

F32_ATOL = 1e-5
BF16_RTOL = 2.0**-7
BLOCKS = dict(block_rows=8, block_vocab=64)  # 37 rows -> 5 row tiles; 261 vocab -> 5 tiles, the last of 5 columns


def _data(rng, rows=37, d=32, vocab=261):
    h = rng.normal(size=(rows, d)).astype(np.float32)
    w = (0.3 * rng.normal(size=(vocab, d))).astype(np.float32)
    y = rng.integers(0, vocab, size=rows).astype(np.int32)
    y[:3] = vocab - 1  # targets in the last, partial vocab tile
    g = rng.normal(size=rows).astype(np.float32)
    g[::4] = 0.0  # masked positions: zero cotangent
    return h, w, y, g


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_jax(rng, impl):
    h, w, y, _ = _data(rng)
    ref = np.asarray(jax_fused(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y), impl=impl, **BLOCKS))
    th, tw, ty = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(y).long()
    got = fused_token_logprobs(th, tw, ty)
    assert got.dtype == torch.float32 and got.shape == (37,)
    np.testing.assert_allclose(got.numpy(), ref, atol=F32_ATOL)
    np.testing.assert_allclose(token_logprobs_ref(th, tw, ty).numpy(), ref, atol=F32_ATOL)
    logp, lse = fused_ce_fwd(th, tw, ty)
    np.testing.assert_array_equal(logp.numpy(), got.numpy())
    logits = h.astype(np.float64) @ w.astype(np.float64).T
    want_lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=F32_ATOL)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_gradients_match_jax(rng, impl):
    h, w, y, g = _data(rng)

    def loss(jh, jw):
        return (jax_fused(jh, jw, jnp.asarray(y), impl=impl, **BLOCKS) * jnp.asarray(g)).sum()

    jdh, jdw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    (fused_token_logprobs(th, tw, torch.from_numpy(y).long()) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=F32_ATOL, err_msg="dh")
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), atol=F32_ATOL, err_msg="dW")
    assert not th.grad[::4].any(), "a row with g = 0 has no dh"


def test_rows_with_zero_cotangent_add_nothing_to_dw(rng):
    h, w, y, g = _data(rng)
    th, tw, ty, tg = (torch.from_numpy(a) for a in (h, w, y, g))
    _, lse = fused_ce_fwd(th, tw, ty)
    keep = tg != 0
    full = fused_ce_bwd_dw(th, tw, ty, lse, tg)
    dropped = fused_ce_bwd_dw(th[keep], tw, ty[keep], lse[keep], tg[keep])
    np.testing.assert_allclose(full.numpy(), dropped.numpy(), atol=1e-6)


@pytest.mark.parametrize("h_dtype,w_dtype", [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_bf16_inputs_match_jax(rng, h_dtype, w_dtype):
    """The stage-2 pairs: bf16 hidden states with the f32 master W (policy) or bf16 W (reference)."""
    h, w, y, g = _data(rng)
    th = torch.from_numpy(h).to(h_dtype)
    tw = torch.from_numpy(w).to(w_dtype)
    jh = jnp.asarray(th.float().numpy()).astype(jnp.bfloat16)
    jw = jnp.asarray(tw.float().numpy()).astype(jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32)

    def loss(a, b):
        return (jax_fused(a, b, jnp.asarray(y), impl="pallas", **BLOCKS) * jnp.asarray(g)).sum()

    ref = np.asarray(jax_fused(jh, jw, jnp.asarray(y), impl="pallas", **BLOCKS))
    jdh, jdw = jax.grad(loss, argnums=(0, 1))(jh, jw)
    th.requires_grad_()
    tw.requires_grad_()
    out = fused_token_logprobs(th, tw, torch.from_numpy(y).long())
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=F32_ATOL)  # both upcast the same values
    assert th.grad.dtype == h_dtype and tw.grad.dtype == w_dtype
    for name, got, want in (("dh", th.grad, jdh), ("dW", tw.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        tol = BF16_RTOL * np.abs(want) + 1e-6 if got.dtype == torch.bfloat16 else F32_ATOL
        assert (np.abs(got.float().numpy() - want) <= tol).all(), name


def test_plain_backward_pieces_agree(rng):
    h, w, y, g = _data(rng)
    th, tw, ty, tg = (torch.from_numpy(a) for a in (h, w, y, g))
    _, lse = fused_ce_fwd_ref(th, tw, ty)
    dh, dw = fused_ce_bwd_ref(th, tw, ty, lse, tg)
    assert torch.equal(dh, fused_ce_bwd_dh_ref(th, tw, ty, lse, tg))
    assert torch.equal(dw, fused_ce_bwd_dw_ref(th, tw, ty, lse, tg))
    assert torch.equal(dh, fused_ce_bwd_dh(th, tw, ty, lse, tg))
    assert torch.equal(dw, fused_ce_bwd_dw(th, tw, ty, lse, tg))


def test_wrappers_run_the_plain_version_on_cpu_and_refuse_other_devices(rng):
    counts = _kernels.launch_counts()
    h, w, y, g = _data(rng)
    th, tw, ty, tg = (torch.from_numpy(a) for a in (h, w, y, g))
    for got, want in zip(fused_ce_fwd(th, tw, ty), fused_ce_fwd_ref(th, tw, ty)):
        assert torch.equal(got, want)
    assert _kernels.launch_counts() == counts  # the plain versions launch nothing
    meta = [t.to("meta") for t in (th, tw, ty, tg)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce_fwd(*meta[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_ce_bwd_dh(meta[0], meta[1], meta[2], meta[3], meta[3])
    for name in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw"):
        assert name in _kernels.KERNELS and _kernels.KERNELS[name][0] == "fused_ce.cu"


@pytest.mark.parametrize("rows,vocab,sms", [(8128, 50262, 132), (1984, 50262, 132), (37, 261, 132),
                                            (1, 1, 132), (100_000, 300, 8), (64, 50262, 1)])
def test_vocab_splits_cover_the_vocab_with_non_empty_splits(rows, vocab, sms):
    splits, span = vocab_splits(rows, vocab, sms)
    assert span % VOCAB_TILE == 0 and 1 <= splits <= 65535
    assert (splits - 1) * span < vocab <= splits * span  # every split holds a column, all are covered
