"""The port's ops and copied modules against the JAX package, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages. On
the JAX side the Pallas kernels run as their own tests run them
(``interpret=True``) or through their plain references. On the port side a
CPU tensor makes each kernel wrapper run its plain PyTorch version.
Tolerances: float32 throughout; 1e-5 for LayerNorm and 2e-5 for attention
(the JAX kernel tests' own bound, tests/test_flash_attention.py) — sums taken
in another order, nothing more.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data import _unicode_classes as jax_unicode
from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.generation.decode import _apply_repetition_penalty as jax_penalty
from pgica_tpu.generation.decode import _top_p_filter as jax_top_p
from pgica_tpu.models import presets as jax_presets
from pgica_tpu.ops.attention import _xla_attention
from pgica_tpu.ops.flash_attention import _flash_fwd_impl
from pgica_tpu.ops.flash_attention import flash_attention as jax_flash
from pgica_tpu.ops.layernorm import _fused_fwd_impl, _ln_ref, fused_layernorm
from pgica_tpu_torch.data import _unicode_classes as port_unicode
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import _apply_repetition_penalty, _top_p_filter
from pgica_tpu_torch.models import presets
from pgica_tpu_torch.ops.attention import dot_product_attention, key_padding_bias, xla_attention
from pgica_tpu_torch.ops.flash_attention import (
    F32_TILED_MIN_SQ,
    NEG_INF,
    TC_MIN_SQ,
    flash_attention_fwd,
    flash_attention_ref,
    fwd_route,
)
from test_torch_backward import _f32_p_ds, _fma
from pgica_tpu_torch.ops.layernorm import LayerNorm, layer_norm_fwd

LN_ATOL = 1e-5
ATTN_ATOL = 2e-5


def _np(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------- LayerNorm


# the widths at which the kernels change shape: 1,152 (SigLIP, two warps a bf16 row), 4,096 (Llama's
# cross_ln, four) and 1,001 (no multiple of the 16-byte slot: the element-by-element instance)
@pytest.mark.parametrize("rows,hidden", [(10, 32), (37, 768), (3, 1152), (2, 4096), (5, 1001)])
def test_layernorm_matches_jax(rng, rows, hidden):
    x, g, b = _np(rng, rows, hidden, scale=3.0), 1 + _np(rng, hidden, scale=0.1), _np(rng, hidden, scale=0.1)
    y, mu, rstd = layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), 1e-5)

    ref = np.asarray(_ln_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    kern = np.asarray(fused_layernorm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(y.numpy(), ref, atol=LN_ATOL)
    np.testing.assert_allclose(y.numpy(), kern, atol=LN_ATOL)
    _, jmu, jrstd = _fused_fwd_impl(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5, 512, True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[0, :rows], atol=LN_ATOL)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[0, :rows], rtol=1e-5)


def test_layernorm_module_keeps_leading_axes(rng):
    ln = LayerNorm(32)
    x = torch.from_numpy(_np(rng, 2, 5, 32))
    ref = np.asarray(_ln_ref(jnp.asarray(x.numpy()), jnp.ones(32), jnp.zeros(32), 1e-5))
    out = ln(x)
    assert out.shape == x.shape and ln.weight.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=LN_ATOL)


# ---------------------------------------------------------------- attention

# (B, H, Sq, Sk, D, key_mask, causal): the ViT shape (S=50, D=64, no mask),
# the decode shape (Sq=1 over a 17-slot cache, keys past the position
# masked), causal, and a row whose keys are all masked.
ATTN_CASES = {
    "vit": (2, 2, 50, 50, 64, None, False),
    "decode": (2, 2, 1, 17, 16, [5, 17], False),
    "causal": (2, 2, 24, 24, 16, None, True),
    "all_masked_row": (2, 2, 8, 16, 16, [0, 11], False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_jax(rng, case):
    b, h, sq, sk, d, valid, causal = ATTN_CASES[case]
    q, k, v = _np(rng, b, h, sq, d), _np(rng, b, h, sk, d), _np(rng, b, h, sk, d)
    mask = None
    if valid is not None:
        mask = (np.arange(sk)[None, :] < np.asarray(valid)[:, None]).astype(np.int32)[:, None, None, :]
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    jmask = None if mask is None else jnp.asarray(mask)
    ref = np.asarray(_xla_attention(jq, jk, jv, jmask, causal))
    kern = np.asarray(jax_flash(jq, jk, jv, mask=jmask, causal=causal, interpret=True))

    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    tmask = None if mask is None else torch.from_numpy(mask)
    out = dot_product_attention(tq, tk, tv, tmask, causal).numpy()
    np.testing.assert_allclose(out, kern, atol=ATTN_ATOL)
    np.testing.assert_allclose(out, ref, atol=ATTN_ATOL)
    np.testing.assert_allclose(xla_attention(tq, tk, tv, tmask, causal).numpy(), ref, atol=ATTN_ATOL)

    # the row logsumexp the kernel writes for the backward pass
    jbias = (jnp.zeros((b, 1, sk), jnp.float32) if mask is None
             else jnp.where(jnp.asarray(mask[:, 0, 0, :]).astype(bool), 0.0, -1e9)[:, None, :])
    _, jlse = _flash_fwd_impl(jq, jk, jv, jbias, causal, 128, 128, True)
    tbias = None if mask is None else torch.from_numpy(np.array(jbias[:, 0, :]))
    _, lse = flash_attention_fwd(tq, tk, tv, tbias, causal)
    np.testing.assert_allclose(lse.numpy().reshape(-1), np.asarray(jlse).reshape(-1), rtol=1e-6, atol=ATTN_ATOL)
    if case == "all_masked_row":  # finite fill: the masked batch row averages V
        np.testing.assert_allclose(out[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True), out[0].shape), atol=1e-5)


def test_causal_row_with_every_key_padded_matches_jax(rng):
    """A causal batch row whose keys are all padding averages V over all Sk
    keys, as the plain JAX path does, and its gradients are those of
    ``jax.grad`` of that path: dO / Sk to every key's dV, nothing to dq or
    dk. The other batch row is ragged. Tolerance 2e-5 (f32, the forward's)."""
    b, h, s, d = 2, 2, 8, 16
    q, k, v, g = (_np(rng, b, h, s, d) for _ in range(4))
    mask = (np.arange(s)[None, :] < np.array([0, 5])[:, None]).astype(np.int32)[:, None, None, :]

    def jax_loss(jq, jk, jv):
        return (_xla_attention(jq, jk, jv, jnp.asarray(mask), True) * jnp.asarray(g)).sum()

    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), True))
    ref_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = dot_product_attention(tq, tk, tv, torch.from_numpy(mask), causal=True)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATTN_ATOL)
    np.testing.assert_allclose(out[0].detach().numpy(), np.broadcast_to(v[0].mean(axis=1, keepdims=True), (h, s, d)),
                               atol=ATTN_ATOL)
    for name, t, want in zip("qkv", (tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=ATTN_ATOL, err_msg=f"d{name}")
    np.testing.assert_allclose(tv.grad[0].numpy(), np.broadcast_to(g[0].sum(axis=1, keepdims=True) / s, (h, s, d)),
                               atol=ATTN_ATOL)
    assert not tq.grad[0].any() and not tk.grad[0].any()


@pytest.mark.parametrize("causal", [False, True])
def test_trailing_padded_keys_add_nothing(rng, causal):
    """The kernel reads no key after a batch row's last kept one: with the
    padding bias those keys' p is exactly 0 (rows that keep a key) or they
    lie above the causal diagonal. A row with no kept key averages them all."""
    b, h, sq, sk, d = 3, 2, 12, 20, 16
    q, k, v = (torch.from_numpy(_np(rng, b, h, s, d)) for s in (sq, sk, sk))
    valid = torch.tensor([7, 20, 0])
    mask = torch.arange(sk)[None, :] < valid[:, None]
    bias = key_padding_bias(mask)
    o, lse = flash_attention_fwd(q, k, v, bias, causal)
    for i, n in enumerate(valid.tolist()[:2]):
        oi, lsei = flash_attention_fwd(q[i:i + 1], k[i:i + 1, :, :n], v[i:i + 1, :, :n],
                                       bias[i:i + 1, :n], causal)
        np.testing.assert_allclose(o[i:i + 1].numpy(), oi.numpy(), atol=1e-6)
        np.testing.assert_allclose(lse[i:i + 1].numpy(), lsei.numpy(), atol=1e-6)
    np.testing.assert_allclose(o[2].numpy(), np.broadcast_to(v[2].mean(1, keepdim=True).numpy(), o[2].shape),
                               atol=1e-5)


def test_key_padding_mask_becomes_the_kernel_bias(rng):
    b, h, sq, sk, d = 2, 2, 3, 9, 16
    q, k, v = (torch.from_numpy(_np(rng, b, h, s, d)) for s in (sq, sk, sk))
    mask = torch.tensor([[1] * 4 + [0] * 5, [1] * 9], dtype=torch.int32)
    bias = key_padding_bias(mask)
    assert bias.dtype == torch.float32 and bias.is_contiguous()
    assert set(bias.unique().tolist()) == {0.0, -1e9}
    out = dot_product_attention(q, k, v, mask[:, None, None, :])
    np.testing.assert_array_equal(out.numpy(), flash_attention_fwd(q, k, v, bias)[0].numpy())


def test_general_mask_takes_the_plain_path(rng):
    b, h, s, d = 2, 2, 6, 16
    q, k, v = (_np(rng, b, h, s, d) for _ in range(3))
    mask = (rng.random((b, 1, s, s)) > 0.3).astype(np.int32)
    mask[..., 0] = 1
    ref = np.asarray(_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask), False))
    out = dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATTN_ATOL)


# The bf16 forward at Sq >= TC_MIN_SQ (csrc/flash_attn_fwd.cu, flash_attn_fwd_tc) runs S = Q K^T
# and O += P V on the tensor cores (bf16 in, f32 sums) over 64-row q tiles and 64-key tiles, the
# online max and sum in f32 and P rounded once to bf16 for PV. chip_smoke.py holds its o to the
# plain version within TOL[bf16] and its lse within (1e-4, 1e-6). The emulation below repeats that
# arithmetic on the CPU (products of bf16 values are exact in f32, so f32 matmuls repeat the card's
# up to the order of the sums), with the kernel's tile skipping: keys past a q tile's kv_end are
# neither in the max nor in the sum, and a tile whose first row keeps no key reads all Sk keys.
BF16_TOL = (2e-2, 1e-2)  # chip_smoke.py: TOL[torch.bfloat16]
LSE_TOL = (1e-4, 1e-6)
TC_ROWS = TC_KEYS = 64  # csrc/flash_attn_fwd.cu: kTcRows, kTcKeys


def _fwd_tensor_core_scheme(q, k, v, bias, causal):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    o = torch.empty(b, h, sq, d)
    lse = torch.empty(b, h, sq)
    keys = torch.arange(sk)
    kept = torch.ones(b, sk, dtype=torch.bool) if bias is None else bias > NEG_INF
    for q0 in range(0, sq, TC_ROWS):
        rows = torch.arange(q0, min(q0 + TC_ROWS, sq))
        kv_end = torch.full((b,), min(sk, int(rows[-1]) + 1) if causal else sk)
        if bias is not None:  # per batch row, as the kernel's per-block scan
            for i in range(b):
                idx = torch.nonzero(kept[i, :int(kv_end[i])]).flatten()
                no_key = len(idx) == 0 or (causal and int(idx[0]) > q0)
                kv_end[i] = sk if no_key else int(idx[-1]) + 1
        m = torch.full((b, h, len(rows)), NEG_INF)
        l = torch.zeros(b, h, len(rows))
        acc = torch.zeros(b, h, len(rows), d)
        for k0 in range(0, int(kv_end.max()), TC_KEYS):
            tile = keys[k0:k0 + TC_KEYS]
            s = qf[:, :, rows] @ kf[:, :, tile].transpose(-1, -2) * (1.0 / d**0.5)
            keep = kept[:, None, None, tile]
            if causal:
                keep = keep & (rows[:, None] >= tile[None, :])
            x = torch.where(keep, s + (0.0 if bias is None else bias[:, None, None, tile]), NEG_INF)
            x = torch.where((tile[None, :] >= kv_end[:, None])[:, None, None, :], -torch.inf, x)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, tile]
            m = m_new
        o[:, :, rows] = acc / l[..., None]
        lse[:, :, rows] = m + torch.log(l)
    return o.to(q.dtype), lse


def _bf16_attention_case(b, h, sq, d, valid, causal, seed=3):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(_np(rng, b, h, sq, d)).to(torch.bfloat16) for _ in range(3))
    bias = None
    if valid is not None:
        lengths = rng.integers(1, sq + 1, size=b) if valid == "random" else np.asarray(valid)
        bias = key_padding_bias(torch.from_numpy((np.arange(sq)[None, :] < lengths[:, None]).astype(np.int32)))
    return q, k, v, bias, causal


# (B, H, S, D, key lengths: None, a list, or "random" 1..S; causal): SigLIP's heads of 72 over 730
# keys; Llama's 128 causal with batch row 0 keeping no key; GPT-2 stage 1, causal, ragged
FWD_TC_CASES = {
    "siglip_d72": (2, 2, 730, 72, None, False),
    "llama_d128_row_without_keys": (2, 2, 200, 128, (0, 150), True),
    "gpt2_stage1": (128, 16, 128, 64, "random", True),
}


@pytest.mark.parametrize("case", list(FWD_TC_CASES))
def test_flash_fwd_tensor_core_scheme_holds_the_bf16_bound(case):
    q, k, v, bias, causal = _bf16_attention_case(*FWD_TC_CASES[case])
    got_o, got_lse = _fwd_tensor_core_scheme(q, k, v, bias, causal)
    want_o, want_lse = flash_attention_ref(q, k, v, bias, causal)
    atol, rtol = BF16_TOL
    np.testing.assert_allclose(got_o.float().numpy(), want_o.float().numpy(), atol=atol, rtol=rtol)
    np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=LSE_TOL[0], rtol=LSE_TOL[1])
    if bias is not None and not bool((bias > NEG_INF).any(-1).all()):  # a batch row without keys: mean of V
        np.testing.assert_allclose(got_o[0].float().numpy(),
                                   v[0].float().mean(1, keepdim=True).expand_as(got_o[0]).numpy(), atol=atol,
                                   rtol=rtol)


@pytest.mark.parametrize("sq", sorted({1, TC_MIN_SQ - 1, TC_MIN_SQ, F32_TILED_MIN_SQ - 1, F32_TILED_MIN_SQ, 730}))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_kernel_is_chosen_by_dtype_and_sq(sq, dtype):
    """bf16 from TC_MIN_SQ rows on runs on the tensor cores, f32 from F32_TILED_MIN_SQ rows on
    register-tiled; decode and short Sq on the CUDA cores."""
    if dtype == torch.bfloat16:
        want = "tensor_cores" if sq >= TC_MIN_SQ else "cuda_cores"
    else:
        want = "f32_tiled" if sq >= F32_TILED_MIN_SQ else "cuda_cores"
    assert fwd_route(dtype, sq) == want
    assert fwd_route(dtype, 1) == "cuda_cores"


# The f32 forward at Sq >= F32_TILED_MIN_SQ (csrc/flash_attn_fwd.cu, flash_attn_fwd_f32) forms every
# product in full f32 FMAs on the CUDA cores; chip_smoke.py holds it to the plain version within
# ATTN_F32_ATOL on o and LSE_TOL on lse. The emulation below repeats its arithmetic on the CPU: the score
# one FMA chain over the D columns in order from the unscaled q and k, then fmaf(s, scale, bias) (the
# backward's score, tests/test_torch_backward.py:_f32_p_ds); the kernel's key tiles of 64 and skips (a
# q tile of 64 rows reads keys up to its last causal column and its batch row's last kept key, or all
# Sk keys where its first row keeps none; keys past that neither in the max nor in the sum); per tile
# the max, alpha = exp(m - m_new) and p = exp(x - m_new) in f32, each row's sum kept as the shares of the
# lanes that hold its scores (16, at D = 72 8; lane g: keys g, g + lanes, ... of a tile, l alpha then + p
# in key order) summed by a butterfly at the end; O = O alpha, then one FMA chain over the tile's keys
# in order; o = O / l, lse = m + log(l). The keys a warp skips past its rows add fma(0, v, acc) = acc:
# the same bits. An FMA is emulated in float64 (the f32 product is exact there) with one rounding to f32.
F32_TILE = 64  # csrc/flash_attn_fwd.cu: kF32Rows, kF32Keys


def _row_lanes(d):
    return 8 if d == 72 else 16  # csrc/flash_attn_fwd.cu: fwd_f32_row_lanes


def _kv_end_rows(sq, sk, bias, causal):
    """(B, Sq): the kv_end of each row's 64-row q tile, as the block computes it."""
    b = 1 if bias is None else bias.shape[0]
    kept = torch.ones(b, sk, dtype=torch.bool) if bias is None else bias > NEG_INF
    out = torch.empty(b, sq, dtype=torch.long)
    for q0 in range(0, sq, F32_TILE):
        q_end = min(q0 + F32_TILE, sq)
        for i in range(b):
            kv_end = min(sk, q_end) if causal else sk
            idx = torch.nonzero(kept[i, :kv_end]).flatten()
            if bias is not None:
                every_row_keeps = len(idx) > 0 and not (causal and int(idx[0]) > q0)
                kv_end = int(idx[-1]) + 1 if every_row_keeps else sk
            out[i, q0:q_end] = kv_end
    return out


@functools.lru_cache(maxsize=None)
def _fwd_f32_case(b, h, s, d, valid, causal):
    """f32 inputs (key lengths: None, a tuple, or "random" 1..s), the kernel's emulated (o, lse, x) (x
    the masked scores) and the forward computed in float64 from the same f32 inputs."""
    rng = np.random.default_rng(19)
    q, k, v = (torch.from_numpy(_np(rng, b, h, s, d)) for _ in range(3))
    bias = None
    if valid is not None:
        lengths = rng.integers(1, s + 1, size=b) if valid == "random" else np.asarray(valid)
        bias = key_padding_bias(torch.from_numpy((np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)))
    return (q, k, v, bias), _fwd_f32_scheme(q, k, v, bias, causal), _fwd_f64(q, k, v, bias, causal)


def _fwd_f32_scheme(q, k, v, bias, causal):
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = torch.tensor(1.0 / d**0.5, dtype=torch.float32)
    s = torch.zeros(b, h, sq, sk)
    for c in range(d):
        s = _fma(q[..., c, None], k[..., None, :, c], s)
    keep = torch.ones(1, 1, 1, sk, dtype=torch.bool)
    b_row = torch.zeros(1, 1, 1, sk)
    if bias is not None:
        keep, b_row = (bias > NEG_INF)[:, None, None, :], bias[:, None, None, :]
    if causal:
        keep = keep & (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :])
    x = torch.where(keep, _fma(s, scale, b_row), NEG_INF)
    n_tiles = -(-sk // F32_TILE)
    pad = n_tiles * F32_TILE - sk
    cut = torch.arange(sk + pad)[None, None, :] >= _kv_end_rows(sq, sk, bias, causal)[:, :, None]
    x_tiles = torch.nn.functional.pad(x, (0, pad), value=-torch.inf).masked_fill(cut[:, None], -torch.inf)
    v_tiles = torch.nn.functional.pad(v, (0, 0, 0, pad))
    n_lanes = _row_lanes(d)
    m = torch.full((b, h, sq), NEG_INF)
    lanes = torch.zeros(b, h, sq, n_lanes)
    acc = torch.zeros(b, h, sq, d)
    for k0 in range(0, sk + pad, F32_TILE):
        xt = x_tiles[..., k0:k0 + F32_TILE]
        m_new = torch.maximum(m, xt.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(xt - m_new[..., None])
        lanes = lanes * alpha[..., None]
        for j in range(F32_TILE // n_lanes):  # lane g adds keys g + lanes j in order of j
            lanes = lanes + p[..., n_lanes * j:n_lanes * (j + 1)]
        acc = acc * alpha[..., None]
        for kk in range(F32_TILE):
            acc = _fma(p[..., kk, None], v_tiles[:, :, None, k0 + kk, :], acc)
        m = m_new
    l = lanes
    while l.shape[-1] > 1:  # the butterfly: xor 1, 2, 4, ...
        l = l[..., 0::2] + l[..., 1::2]
    l = l[..., 0]
    return acc / l[..., None], m + torch.log(l), x


def _fwd_f64(q, k, v, bias, causal):
    """(o, lse) of the plain forward in float64 from the same f32 inputs."""
    q, k, v = (t.double() for t in (q, k, v))
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = (q / d**0.5) @ k.transpose(-1, -2)
    keep = torch.ones(1, 1, 1, sk, dtype=torch.bool)
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
        keep = (bias > NEG_INF)[:, None, None, :]
    if causal:
        keep = keep & (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :])
    s = torch.where(keep, s, NEG_INF)
    lse = torch.logsumexp(s, -1)
    return torch.exp(s - lse[..., None]) @ v, lse


# (B, H, S, D, key lengths, causal): GPT-2 stage 1 at reduced batch (causal, ragged keys); SigLIP's heads
# of 72 over 730 keys; Llama's 128, causal, batch row 0 keeping no key
FWD_F32_CASES = {
    "gpt2_stage1": (8, 4, 128, 64, "random", True),
    "siglip_d72": (2, 2, 730, 72, None, False),
    "llama_d128_row_without_keys": (2, 2, 256, 128, (0, 150), True),
}


@pytest.mark.parametrize("case", list(FWD_F32_CASES))
def test_flash_fwd_f32_scheme_holds_the_f32_bound(case):
    (_, _, v, bias), (o, lse, _), (want_o, want_lse) = _fwd_f32_case(*FWD_F32_CASES[case])
    np.testing.assert_allclose(o.double().numpy(), want_o.numpy(), atol=ATTN_ATOL, rtol=0)
    np.testing.assert_allclose(lse.double().numpy(), want_lse.numpy(), atol=LSE_TOL[0], rtol=LSE_TOL[1])
    if bias is not None and not bool((bias > NEG_INF).any(-1).all()):  # a batch row without keys: mean of V
        np.testing.assert_allclose(o[0].numpy(), v[0].mean(1, keepdim=True).expand_as(o[0]).numpy(),
                                   atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("case", list(FWD_F32_CASES))
def test_flash_fwd_f32_scores_are_the_backwards_bit_for_bit(case):
    """The f32 backward's p = exp(s - lse) (flash_attn_bwd_dq_f32, flash_attn_bwd_dkv_f32) comes from the
    very scores whose lse the forward summed: from the same lse, both give the same p bits."""
    (q, k, v, bias), (_, lse, x), _ = _fwd_f32_case(*FWD_F32_CASES[case])
    causal = FWD_F32_CASES[case][5]
    keep = x > NEG_INF
    if not causal and bias is None:
        assert bool(keep.all())
    zeros = torch.zeros_like(q)
    want_p, _ = _f32_p_ds(q, k, v, bias, causal, lse, torch.zeros_like(lse), zeros)
    got_p = torch.where(keep & (lse > 0.5 * NEG_INF)[..., None], torch.exp(x - lse[..., None]), 0.0)
    assert torch.equal(got_p, want_p)


# ---------------------------------------------------------------- decode helpers


def test_repetition_penalty_matches_jax(rng):
    logits = _np(rng, 3, 40, scale=2.0)
    presence = (rng.random((3, 40)) > 0.5).astype(np.int32)
    ref = np.asarray(jax_penalty(jnp.asarray(logits), jnp.asarray(presence), 1.3))
    out = _apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(presence), 1.3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


@pytest.mark.parametrize("top_p", [0.5, 0.9, 1.0])
def test_top_p_filter_matches_jax(rng, top_p):
    logits = _np(rng, 3, 40, scale=2.0)
    ref = np.asarray(jax_top_p(jnp.asarray(logits), top_p))
    out = _top_p_filter(torch.from_numpy(logits), top_p)
    np.testing.assert_array_equal(out.numpy(), ref)


# ---------------------------------------------------------------- data and copies


def test_prepare_images_matches_jax(rng):
    images = rng.integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    ref = np.asarray(jax_prepare_images(jnp.asarray(images)))
    out = prepare_images(torch.from_numpy(images))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    normalized = torch.from_numpy(_np(rng, 1, 4, 4, 3))
    assert prepare_images(normalized) is normalized


def test_presets_are_copies_of_the_jax_presets():
    for port, ref in ((presets.VISION_PRESETS, jax_presets.VISION_PRESETS),
                      (presets.TEXT_PRESETS, jax_presets.TEXT_PRESETS)):
        assert port.keys() == ref.keys()
        for name in port:
            want = {k: v for k, v in dataclasses.asdict(ref[name]).items() if k != "scan_layers"}
            got = dataclasses.asdict(port[name])
            assert got.pop("remat") is False, name  # the port's activation-checkpointing flag
            assert got == want, name


def test_tokenizer_is_a_copy_of_the_jax_tokenizer():
    assert port_unicode.LETTER_RANGES == jax_unicode.LETTER_RANGES
    assert port_unicode.NUMBER_RANGES == jax_unicode.NUMBER_RANGES
    port, ref = CaptionTokenizer(), JaxTokenizer()
    assert port.vocab == ref.vocab
    assert (port.pad_token_id, port.eos_token_id, port.bos_token_id) == (
        ref.pad_token_id, ref.eos_token_id, ref.bos_token_id)
    text = "a red bird, 2 dogs — café!"
    assert port.encode(text, add_bos=True, add_eos=True) == ref.encode(text, add_bos=True, add_eos=True)
    ids = np.random.default_rng(1).integers(0, ref.vocab_size, size=40)
    assert port.decode(ids) == ref.decode(ids)
