"""Backward passes of the port's kernels against the JAX package, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; the autograd
Functions route their backward through the same wrappers. The JAX side is
``jax.grad`` of the Pallas kernels in interpret mode (as the JAX package's
own tests run them on the CPU) and of the plain references (``_ln_ref``,
``_xla_attention``). Inputs are made from a numpy seed; every gradient is
taken of sum(output * g) for a random cotangent g. Tolerances, float32
throughout: 1e-5 for LayerNorm (dgamma/dbeta are sums over up to 74 rows:
rtol 1e-5 beside it) and 2e-5 for attention (the JAX flash tests' bound) —
sums taken in another order, nothing more.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.ops.attention import _xla_attention
from pgica_tpu.ops.flash_attention import flash_attention as jax_flash
from pgica_tpu.ops.layernorm import _ln_ref, fused_layernorm
from pgica_tpu_torch.ops import _kernels
from pgica_tpu_torch.ops.attention import dot_product_attention, key_padding_bias
from pgica_tpu_torch.ops.flash_attention import flash_attention_bwd_ref, flash_attention_fwd
from pgica_tpu_torch.ops.layernorm import (
    MAX_PARTS,
    bwd_partition,
    layer_norm,
    layer_norm_bwd,
    layer_norm_bwd_ref,
    layer_norm_fwd,
)

LN_ATOL, LN_RTOL = 1e-5, 1e-5
ATTN_ATOL = 2e-5


def _np(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


# ---------------------------------------------------------------- LayerNorm


@pytest.mark.parametrize("rows,hidden", [(10, 32), (74, 512), (3, 1024), (3, 1152), (2, 4096), (5, 1001)])
def test_layernorm_backward_matches_jax(rng, rows, hidden):
    x, g = _np(rng, rows, hidden, scale=3.0), _np(rng, rows, hidden)
    w, b = 1 + _np(rng, hidden, scale=0.1), _np(rng, hidden, scale=0.1)

    def loss(fn):
        return lambda jx, jw, jb: (fn(jx, jw, jb) * jnp.asarray(g)).sum()

    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    kern = jax.grad(loss(lambda *a: fused_layernorm(*a, interpret=True)), argnums=(0, 1, 2))(*args)
    ref = jax.grad(loss(lambda *a: _ln_ref(*a, 1e-5)), argnums=(0, 1, 2))(*args)

    tx, tw, tb = (torch.from_numpy(t).requires_grad_() for t in (x, w, b))
    (layer_norm(tx, tw, tb) * torch.from_numpy(g)).sum().backward()
    _, mu, rstd = layer_norm_fwd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    plain = layer_norm_bwd_ref(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), mu, rstd)
    for i, name in enumerate(("dx", "dweight", "dbias")):
        got = (tx.grad, tw.grad, tb.grad)[i].numpy()
        np.testing.assert_allclose(got, np.asarray(kern[i]), atol=LN_ATOL, rtol=LN_RTOL, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(ref[i]), atol=LN_ATOL, rtol=LN_RTOL, err_msg=name)
        np.testing.assert_array_equal(plain[i].numpy(), got, err_msg=name)  # autograd runs the plain bwd
    assert tw.grad.dtype == tb.grad.dtype == torch.float32


def test_layernorm_backward_keeps_x_dtype_and_launches_nothing_on_cpu(rng):
    counts = _kernels.launch_counts()
    x = torch.from_numpy(_np(rng, 6, 64)).to(torch.bfloat16)
    w, b = torch.ones(64), torch.zeros(64)
    _, mu, rstd = layer_norm_fwd(x, w, b, 1e-5)
    dx, dw, db = layer_norm_bwd(x, w, x, mu, rstd)
    assert dx.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    assert _kernels.launch_counts() == counts


# The backward kernel's row partition (ops/layernorm.py:bwd_partition) sizes its grid and `partials`:
# the shapes the main paths give it, and ragged row counts.
PARTITION_SHAPES = [(128, 512), (2048, 4096), (16384, 1024), (8192, 1024), (32, 1024), (1460, 1152)] + [
    (rows, 768) for rows in (1, 7, 37, 129)]


@pytest.mark.parametrize("rows,hidden", PARTITION_SHAPES)
def test_layernorm_bwd_partition_covers_each_row_once_within_the_cap(rows, hidden):
    per, n_parts = bwd_partition(rows, hidden)
    covered = np.zeros(rows, dtype=int)
    for b in range(n_parts):
        covered[b * per:min((b + 1) * per, rows)] += 1
    assert (covered == 1).all() and n_parts * per - rows < per  # every block holds at least one row
    assert n_parts <= MAX_PARTS <= 114 * 2  # co-resident on an H100 PCIe (114 SMs) at 2 blocks an SM
    # a function of (rows, H) alone: the same with no card, and again
    with mock.patch.object(torch.cuda, "get_device_properties", side_effect=AssertionError("reads the card")):
        assert bwd_partition(rows, hidden) == (per, n_parts)


SUM_TOL = (1e-3, 1e-4)  # chip_smoke.py's (atol, rtol) on LN's dgamma/dbeta


def _dgamma_kernel_order(terms, per, n_parts, row_slots, warps):
    """csrc/layernorm_bwd.cu's order for sum over rows of ``terms`` (f32): each block's row slots add
    their rows in order, the slots meet in slot order, then warp w sums the partials w, w + warps, ...
    and the warps meet in order."""
    partials = []
    for b in range(n_parts):
        r0, r1 = b * per, min((b + 1) * per, terms.shape[0])
        slots = []
        for s in range(row_slots):
            acc = torch.zeros(terms.shape[1])
            for row in range(r0 + s, r1, row_slots):
                acc = acc + terms[row]
            slots.append(acc)
        partial = slots[0]
        for acc in slots[1:]:
            partial = partial + acc
        partials.append(partial)
    total = None
    for w in range(warps):
        acc = torch.zeros(terms.shape[1])
        for p in range(w, n_parts, warps):
            acc = acc + partials[p]
        total = acc if total is None else total + acc
    return total


def test_layernorm_dgamma_dbeta_in_the_kernels_order_hold_the_sum_bound(rng):
    """At (2048, 1024), bf16's layout (four rows of one warp a 128-thread block), the kernel's order
    of the dgamma and dbeta sums stays within chip_smoke.py's SUM_TOL of the plain sum(dim=0)."""
    rows, hidden = 2048, 1024
    x, dy = _np(rng, rows, hidden, scale=3.0), _np(rng, rows, hidden)
    w, b = torch.ones(hidden), torch.zeros(hidden)
    _, mu, rstd = layer_norm_fwd(torch.from_numpy(x), w, b, 1e-5)
    xhat = (torch.from_numpy(x) - mu[:, None]) * rstd[:, None]
    dyf = torch.from_numpy(dy)
    per, n_parts = bwd_partition(rows, hidden)
    for terms in (dyf * xhat, dyf):
        got = _dgamma_kernel_order(terms, per, n_parts, row_slots=4, warps=4)
        np.testing.assert_allclose(got.numpy(), terms.sum(dim=0).numpy(), atol=SUM_TOL[0], rtol=SUM_TOL[1])


# ---------------------------------------------------------------- attention

# (B, H, Sq=Sk, D, valid key counts or None, causal)
BWD_CASES = {
    "plain": (2, 2, 16, 16, None, False),
    "ragged": (2, 2, 16, 16, [9, 16], False),
    "causal": (2, 2, 16, 16, None, True),
    "causal_ragged": (3, 2, 8, 32, [5, 8, 1], True),
}


def _grads(fn, q, k, v, g):
    return jax.grad(lambda a, b_, c: (fn(a, b_, c) * jnp.asarray(g)).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_backward_matches_jax(rng, case):
    b, h, s, d, valid, causal = BWD_CASES[case]
    q, k, v, g = (_np(rng, b, h, s, d) for _ in range(4))
    mask = None if valid is None else (
        (np.arange(s)[None, :] < np.asarray(valid)[:, None]).astype(np.int32)[:, None, None, :])
    jmask = None if mask is None else jnp.asarray(mask)
    kern = _grads(lambda *a: jax_flash(*a, mask=jmask, causal=causal, interpret=True), q, k, v, g)
    ref = _grads(lambda *a: _xla_attention(*a, jmask, causal), q, k, v, g)

    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    out = dot_product_attention(tq, tk, tv, tmask, causal)
    (out * torch.from_numpy(g)).sum().backward()

    bias = None if mask is None else key_padding_bias(tmask[:, 0, 0, :])
    with torch.no_grad():
        o, lse = flash_attention_fwd(*(torch.from_numpy(t) for t in (q, k, v)), bias, causal)
        plain = flash_attention_bwd_ref(*(torch.from_numpy(t) for t in (q, k, v)), bias, causal, o, lse,
                                        torch.from_numpy(g))
    np.testing.assert_allclose(plain[3].numpy(), (g * o.numpy()).sum(-1), rtol=1e-5, atol=1e-6)  # delta
    for i, name in enumerate(("dq", "dk", "dv")):
        got = (tq, tk, tv)[i].grad.numpy()
        np.testing.assert_allclose(got, np.asarray(kern[i]), atol=ATTN_ATOL, err_msg=f"{name} vs Pallas")
        np.testing.assert_allclose(got, np.asarray(ref[i]), atol=ATTN_ATOL, err_msg=f"{name} vs XLA")
        np.testing.assert_array_equal(plain[i].numpy(), got, err_msg=name)


def test_flash_backward_of_a_batch_row_without_keys_matches_xla(rng):
    """Non-causal, one batch row with every key padded: its output is the mean
    of V, so dV gets dO / Sk per key and dq, dk nothing (the Pallas backward
    zeroes that row's p instead and disagrees with XLA's own gradient)."""
    b, h, s, d = 2, 2, 8, 16
    q, k, v, g = (_np(rng, b, h, s, d) for _ in range(4))
    mask = (np.arange(s)[None, :] < np.array([0, 6])[:, None]).astype(np.int32)[:, None, None, :]
    ref = _grads(lambda *a: _xla_attention(*a, jnp.asarray(mask), False), q, k, v, g)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    (dot_product_attention(tq, tk, tv, torch.from_numpy(mask)) * torch.from_numpy(g)).sum().backward()
    for i, name in enumerate(("dq", "dk", "dv")):
        np.testing.assert_allclose((tq, tk, tv)[i].grad.numpy(), np.asarray(ref[i]), atol=ATTN_ATOL, err_msg=name)
    assert not tq.grad[0].any() and not tk.grad[0].any()


def test_flash_serving_path_builds_no_graph(rng):
    q, k, v = (torch.from_numpy(_np(rng, 1, 2, 5, 16)) for _ in range(3))
    with torch.inference_mode():
        out = dot_product_attention(q, k, v, causal=True)
    assert out.grad_fn is None


# The bf16 dK/dV kernel (csrc/flash_attn_bwd.cu, flash_attn_bwd_dkv_tc) runs dV = P^T dO and
# dK = dS^T Q on the tensor cores (bf16 in, f32 sums) with P and dS as two bf16 parts each:
# x0 = bf16(x), x1 = bf16(x - x0). chip_smoke.py holds its bf16 dk and dv to the plain version
# within (atol, rtol) = TOL[bf16]. The emulation below repeats that arithmetic on the CPU and holds
# it to the same bound at the Llama (D = 128) and SigLIP (D = 72) head dims, causal with one batch
# row that keeps no key (its rows spread dO / Sk over dV), and at GPT-2 stage 1's shape, where P
# rounded once to bf16 (the usual tensor-core backward) misses the bound. The bf16 dQ kernel
# (flash_attn_bwd_dq_tc) runs dQ = dS K the same way; its emulation shows that dS rounded once
# holds the bound at all three shapes, so the kernel takes one rounding where dK/dV takes two parts.
BF16_TOL = (2e-2, 1e-2)  # chip_smoke.py: TOL[torch.bfloat16]


def _two_bf16_parts(x):
    x0 = x.to(torch.bfloat16).float()
    return x0 + (x - x0).to(torch.bfloat16).float()


def _dkv_tensor_core_scheme(q, k, v, bias, causal, lse, delta, do, parts=_two_bf16_parts):
    from pgica_tpu_torch.ops.flash_attention import NEG_INF, _scores

    sk, d = k.shape[2], q.shape[3]
    s, keep = _scores(q, k, bias, causal)
    without_key = (lse <= 0.5 * NEG_INF)[..., None]
    p = torch.where(keep & ~without_key, torch.exp(s - lse[..., None]), 0.0)
    dof = do.float()
    ds = p * (dof @ v.float().transpose(-1, -2) - delta[..., None])
    spread = (dof * without_key).sum(2, keepdim=True) / sk
    dv = parts(p).transpose(-1, -2) @ dof + spread
    dk = (parts(ds).transpose(-1, -2) @ q.float()) * (1.0 / d**0.5)
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_tensor_core_scheme(q, k, v, bias, causal, lse, delta, do, parts=_two_bf16_parts):
    from pgica_tpu_torch.ops.flash_attention import NEG_INF, _scores

    d = q.shape[3]
    s, keep = _scores(q, k, bias, causal)
    without_key = (lse <= 0.5 * NEG_INF)[..., None]
    p = torch.where(keep & ~without_key, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    return ((parts(ds) @ k.float()) * (1.0 / d**0.5)).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _bwd_case(b, h, s, d, valid):
    """bf16 inputs, causal, key bias from ``valid`` (None: random lengths 1..s, as chip_smoke.py's
    stage-1 rows); the plain dq, dk and dv, and what the schemes need."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(_np(rng, b, h, s, d)).to(torch.bfloat16) for _ in range(4))
    lengths = rng.integers(1, s + 1, size=b) if valid is None else np.asarray(valid)
    bias = key_padding_bias(torch.from_numpy((np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)))
    o, lse = flash_attention_fwd(q, k, v, bias, True)
    dq, dk, dv, delta = flash_attention_bwd_ref(q, k, v, bias, True, o, lse, do)
    return (q, k, v, bias, True, lse, delta, do), dq, dk, dv


def _worst_over_bound(got, want):
    atol, rtol = BF16_TOL
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


BWD_SHAPES = dict(argvalues=[(2, 2, 512, 72, (0, 300)), (2, 2, 512, 128, (0, 300)), (128, 16, 128, 64, None)],
                  ids=["siglip_d72", "llama_d128", "gpt2_stage1"])


@pytest.mark.parametrize("shape", **BWD_SHAPES)
def test_flash_dkv_with_p_and_ds_in_two_bf16_parts_holds_the_bf16_bound(shape):
    args, _, want_dk, want_dv = _bwd_case(*shape)
    got_dk, got_dv = _dkv_tensor_core_scheme(*args)
    assert _worst_over_bound(got_dk, want_dk) <= 1.0 and _worst_over_bound(got_dv, want_dv) <= 1.0
    if shape[4] is not None:  # batch row 0 keeps no key: dk 0, dv its spread
        assert not got_dk[0].any() and got_dv[0].abs().max() > 0


def test_flash_dkv_with_p_rounded_once_to_bf16_misses_the_bound_at_gpt2_stage1():
    args, _, _, want_dv = _bwd_case(128, 16, 128, 64, None)
    _, got_dv = _dkv_tensor_core_scheme(*args, parts=lambda x: x.to(torch.bfloat16).float())
    assert _worst_over_bound(got_dv, want_dv) > 1.0


@pytest.mark.parametrize("parts", [_two_bf16_parts, lambda x: x.to(torch.bfloat16).float()],
                         ids=["ds_in_two_bf16_parts", "ds_rounded_once"])
@pytest.mark.parametrize("shape", **BWD_SHAPES)
def test_flash_dq_on_the_tensor_cores_holds_the_bf16_bound(shape, parts):
    """dQ = dS K with dS in two bf16 parts, and rounded once (the kernel's choice): both hold the
    bound at every shape, GPT-2 stage 1's included (a dq element's own rounding to bf16 dominates);
    a batch row that keeps no key gets dq exactly 0."""
    args, want_dq, _, _ = _bwd_case(*shape)
    got_dq = _dq_tensor_core_scheme(*args, parts=parts)
    assert _worst_over_bound(got_dq, want_dq) <= 1.0
    if shape[4] is not None:  # batch row 0 keeps no key
        assert not got_dq[0].any() and got_dq[1].abs().max() > 0


# The float32 kernels (csrc/flash_attn_bwd.cu: flash_attn_bwd_dq_f32, flash_attn_bwd_dkv_f32) form every
# product in full f32 FMAs on the CUDA cores; only the order of the sums is theirs. chip_smoke.py holds
# them to the plain version within ATTN_BWD_F32_TOL. The emulations below repeat that arithmetic on the
# CPU: the scores s and dP each one FMA chain over the D columns in order, p = exp(s * scale + bias -
# lse) with the scale fused, dS = p (dP - delta), delta = rowsum(dO O) as lane-strided partials summed
# by the warp's butterfly; dV and dK one FMA chain over the q rows in order (the tiles from the key
# tile's diagonal on, each in row order), dQ over the keys in order. A fused multiply-add is emulated
# in float64 (the f32 product is exact there) with one rounding to f32. They are held to the same
# bound against the backward computed in float64 from the same f32 inputs, at GPT-2 stage 1's shape
# (D = 64, causal, ragged keys) at reduced batch, and at D = 128 and 72 (causal, batch row 0 keeping no
# key: its dq and dk are 0, its dv the spread of dO). P and dS rounded once to TF32 (10 mantissa bits)
# before their products miss the bound: why the kernels take no single-pass TF32 tensor-core product.
F32_TOL = (2e-5, 1e-5)  # chip_smoke.py: ATTN_BWD_F32_TOL
DELTA_TOL = (1e-4, 1e-5)  # chip_smoke.py's bound on delta


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero (cvt.rna.tf32.f32)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _f32_p_ds(q, k, v, bias, causal, lse, delta, do):
    from pgica_tpu_torch.ops.flash_attention import NEG_INF

    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = torch.tensor(1.0 / d**0.5, dtype=torch.float32)
    s, dp = torch.zeros(b, h, sq, sk), torch.zeros(b, h, sq, sk)
    for c in range(d):
        s = _fma(q[..., c, None], k[..., None, :, c], s)
        dp = _fma(do[..., c, None], v[..., None, :, c], dp)
    keep = (lse > 0.5 * NEG_INF)[..., None].expand(b, h, sq, sk)
    b_row = torch.zeros(sk) if bias is None else bias[:, None, None, :]
    if bias is not None:
        keep = keep & (bias > NEG_INF)[:, None, None, :]
    if causal:
        keep = keep & (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :])
    p = torch.where(keep, torch.exp(_fma(s, scale, b_row) - lse[..., None]), 0.0)
    return p, p * (dp - delta[..., None])


def _dq_f32_scheme(q, k, v, bias, causal, o, lse, do):
    """(dq, delta) as flash_attn_bwd_dq_f32 forms them."""
    d = q.shape[3]
    part = torch.zeros(*q.shape[:3], 32)
    for c0 in range(0, d, 32):
        cols = torch.arange(c0, c0 + 32)
        live = cols < d
        cols = cols.clamp(max=d - 1)
        part = torch.where(live, _fma(do[..., cols], o[..., cols], part), part)
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., torch.arange(32) ^ off]
    delta = part[..., 0]
    _, ds = _f32_p_ds(q, k, v, bias, causal, lse, delta, do)
    dq = torch.zeros_like(q)
    for key in range(k.shape[2]):
        dq = _fma(ds[..., key, None], k[..., key, None, :], dq)
    return dq * torch.tensor(1.0 / d**0.5, dtype=torch.float32), delta


def _dkv_f32_scheme(q, k, v, bias, causal, lse, delta, do, cut=lambda x: x):
    """(dk, dv) as flash_attn_bwd_dkv_f32 forms them; ``cut`` rounds P and dS before their products."""
    from pgica_tpu_torch.ops.flash_attention import NEG_INF

    sq, d, sk = q.shape[2], q.shape[3], k.shape[2]
    p, ds = (cut(x) for x in _f32_p_ds(q, k, v, bias, causal, lse, delta, do))
    dk, dv, spread = torch.zeros_like(k), torch.zeros_like(v), torch.zeros(*do.shape[:2], 1, d)
    without_key = (lse <= 0.5 * NEG_INF).float()
    for r in range(sq):
        dv = _fma(p[..., r, :, None], do[..., r, None, :], dv)
        dk = _fma(ds[..., r, :, None], q[..., r, None, :], dk)
        spread = spread + do[..., r, None, :] * without_key[..., r, None, None]
    return dk * torch.tensor(1.0 / d**0.5, dtype=torch.float32), dv + spread / sk


def _bwd_f64(q, k, v, bias, causal, do):
    """(dq, dk, dv, delta) of the plain backward in float64 from the same f32 inputs."""
    from pgica_tpu_torch.ops.flash_attention import NEG_INF

    q, k, v, do = (t.double() for t in (q, k, v, do))
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    s = (q / d**0.5) @ k.transpose(-1, -2)
    keep = torch.ones(1, 1, 1, sk, dtype=torch.bool)
    if bias is not None:
        s = s + bias.double()[:, None, None, :]
        keep = (bias > NEG_INF)[:, None, None, :]
    if causal:
        keep = keep & (torch.arange(sq)[:, None] >= torch.arange(sk)[None, :])
    s = torch.where(keep, s, NEG_INF)
    lse = torch.logsumexp(s, -1, keepdim=True)
    p = torch.exp(s - lse)
    delta = (do * (p @ v)).sum(-1)
    ds = torch.where(keep & (lse > 0.5 * NEG_INF), p * (do @ v.transpose(-1, -2) - delta[..., None]), 0.0) / d**0.5
    return ds @ k, ds.transpose(-1, -2) @ q, p.transpose(-1, -2) @ do, delta


@functools.lru_cache(maxsize=None)
def _f32_case(b, h, s, d, valid):
    """f32 inputs, causal, the key bias from ``valid`` (None: random lengths 1..s); the float64 backward
    and both kernels' emulated outputs (dq, delta, dk, dv)."""
    rng = np.random.default_rng(17)
    q, k, v, do = (torch.from_numpy(_np(rng, b, h, s, d)) for _ in range(4))
    lengths = rng.integers(1, s + 1, size=b) if valid is None else np.asarray(valid)
    bias = key_padding_bias(torch.from_numpy((np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)))
    o, lse = flash_attention_fwd(q, k, v, bias, True)  # the plain f32 forward
    dq, delta = _dq_f32_scheme(q, k, v, bias, True, o, lse, do)
    dk, dv = _dkv_f32_scheme(q, k, v, bias, True, lse, delta, do)
    return (q, k, v, bias, lse, do), _bwd_f64(q, k, v, bias, True, do), (dq, delta, dk, dv)


def _f32_worst_over_bound(got, want, tol=F32_TOL):
    return float(((got.double() - want).abs() / (tol[0] + tol[1] * want.abs())).max())


F32_SHAPES = dict(argvalues=[(8, 4, 128, 64, None), (2, 2, 512, 128, (0, 300)), (2, 2, 512, 72, (0, 300))],
                  ids=["gpt2_stage1", "llama_d128", "siglip_d72"])


@pytest.mark.parametrize("shape", **F32_SHAPES)
def test_flash_dq_f32_scheme_holds_the_f32_bound(shape):
    _, (want_dq, _, _, want_delta), (dq, delta, _, _) = _f32_case(*shape)
    assert _f32_worst_over_bound(delta, want_delta, DELTA_TOL) <= 1.0
    assert _f32_worst_over_bound(dq, want_dq) <= 1.0
    if shape[4] is not None:  # batch row 0 keeps no key
        assert not dq[0].any() and dq[1].abs().max() > 0


@pytest.mark.parametrize("shape", **F32_SHAPES)
def test_flash_dkv_f32_scheme_holds_the_f32_bound(shape):
    _, (_, want_dk, want_dv, _), (_, _, dk, dv) = _f32_case(*shape)
    assert _f32_worst_over_bound(dk, want_dk) <= 1.0 and _f32_worst_over_bound(dv, want_dv) <= 1.0
    if shape[4] is not None:  # batch row 0 keeps no key: dk 0, dv the spread of dO / Sk
        assert not dk[0].any() and dv[0].abs().max() > 0 and dk[1].abs().max() > 0


def test_flash_dkv_with_p_and_ds_rounded_once_to_tf32_misses_the_f32_bound():
    (q, k, v, bias, lse, do), (_, want_dk, want_dv, _), (_, delta, _, _) = _f32_case(8, 4, 128, 64, None)
    dk, dv = _dkv_f32_scheme(q, k, v, bias, True, lse, delta, do, cut=_tf32)
    assert _f32_worst_over_bound(dv, want_dv) > 1.0 and _f32_worst_over_bound(dk, want_dk) > 1.0
    assert torch.equal(_tf32(torch.tensor([1.0 + 2.0**-11, 1.0 + 2.0**-12, -3.0])),
                       torch.tensor([1.0 + 2.0**-10, 1.0, -3.0]))  # ties away from zero, 10 bits kept
