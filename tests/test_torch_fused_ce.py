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
    DH_SCRATCH_BYTES,
    GEMM_TILE,
    MAX_GRID_Y,
    _coeff_ref,
    dh_vocab_chunk,
    fused_ce_bwd_dh,
    fused_ce_bwd_dh_ref,
    fused_ce_bwd_dw,
    fused_ce_bwd_dw_ref,
    fused_ce_bwd_ref,
    fused_ce_fwd,
    fused_ce_fwd_ref,
    fused_token_logprobs,
    fwd_tiles,
    live_rows_first,
    token_logprobs_ref,
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
    for name, source in (("fused_ce_fwd", "fused_ce.cu"), ("fused_ce_bwd_dh", "fused_ce_bwd.cu"),
                         ("fused_ce_bwd_dw", "fused_ce_bwd.cu")):
        assert name in _kernels.KERNELS and _kernels.KERNELS[name][0] == source


@pytest.mark.parametrize("vocab", [128256, 50262, 261, 1000, 1, 128, 129])
def test_fwd_tiles_cover_the_vocab_with_non_empty_tiles(vocab):
    tiles = fwd_tiles(vocab)
    assert 1 <= tiles <= MAX_GRID_Y
    assert (tiles - 1) * GEMM_TILE < vocab <= tiles * GEMM_TILE  # every tile holds a column below V, all are covered


def test_fwd_tiles_refuse_a_vocab_past_the_grid():
    assert fwd_tiles(MAX_GRID_Y * GEMM_TILE) == MAX_GRID_Y
    with pytest.raises(ValueError, match="column tiles"):
        fwd_tiles(MAX_GRID_Y * GEMM_TILE + 1)


@pytest.mark.parametrize("rows,vocab", [(2044, 128256), (8128, 50262), (1984, 50262), (37, 261), (300, 1000),
                                        (1, 1), (200_000, 50262)])
def test_dh_vocab_chunks_cover_the_vocab_within_the_scratch_cap(rows, vocab):
    chunk = dh_vocab_chunk(rows, vocab)
    chunks = -(-vocab // chunk)
    assert chunk % GEMM_TILE == 0 and chunk >= GEMM_TILE
    assert chunk <= -(-vocab // GEMM_TILE) * GEMM_TILE  # no wider than the vocab needs
    assert 4 * rows * chunk <= DH_SCRATCH_BYTES or chunk == GEMM_TILE  # hi and lo bf16 coefficients
    assert (chunks - 1) * chunk < vocab <= chunks * chunk  # every chunk holds a column, all are covered


# ---- the dh and dW kernels' precision scheme (csrc/fused_ce_bwd.cu), emulated on the CPU
#
# The kernel multiplies bf16 values on the tensor cores with f32 sums. An f32 operand x goes in as
# bf16 parts x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1); a pass multiplies one part of
# each operand, and the passes whose parts' orders sum below an order are taken: 3 for the scores
# (f32 operands in three parts), 2 for the product (the coefficients and W in two). Products of
# bf16 values are exact in f32, so float32 matmuls of the parts on the CPU repeat the card's
# arithmetic up to the order of the sums. chip_smoke.py holds each dh element to FCE_SCALE_RTOL of
# its own sum of |terms| (|coeff| @ |W|) against the f32 plain version; these tests hold the
# emulation to that bound, before any rounding of dh to h's dtype, at a Llama-like d and W scale,
# with p flat (random weights) and peaked on a few tokens (trained ones).

FCE_SCALE_RTOL = 1e-4  # chip_smoke.py's bound
SCORE_ORDER, PRODUCT_ORDER = 3, 2  # csrc/fused_ce_bwd.cu: kScoreOrder, kProductOrder


def _parts(x, n):
    """[x] for a bf16 tensor; its n bf16 parts (values held in f32) for an f32 one."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    out, rest = [], x
    for _ in range(n):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _passes(a_parts, b_parts, order, fn):
    """sum of fn(a_i, b_j) over the passes i + j < order."""
    return sum(fn(a, b) for i, a in enumerate(a_parts) for j, b in enumerate(b_parts) if i + j < order)


def _dh_kernel_scheme(h, w, y, lse, g, score_parts=SCORE_ORDER, w_product=None):
    """dh in f32 (before the cast to h's dtype) as the kernel's passes compute it."""
    s = _passes(_parts(h, score_parts), _parts(w, score_parts), score_parts, lambda a, b: a @ b.T)
    c = torch.where(g[:, None] != 0, -torch.exp(s - lse[:, None]), 0.0)
    c[torch.arange(len(y)), y.long()] += (g != 0).float()
    w_parts = _parts(w, PRODUCT_ORDER) if w_product is None else w_product
    return _passes(_parts(c, PRODUCT_ORDER), w_parts, PRODUCT_ORDER, lambda a, b: a @ b) * g[:, None]


# token gains along h: none (flat p), a few tokens carrying most of p, one token carrying ~0.995
PEAKS = {"flat": (), "peaked": (7.0, 5.0, 4.0), "sharp": (9.0, 6.0, 5.0)}


def _llama_like(peak, rows=12, vocab=4096, d=4096):
    """h ~ LN outputs, W ~ 0.02-normal at Llama's d, targets also in the last, partial 128-column
    tile; a peak adds to each row its target's and two other tokens' directions."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(rows, d)).astype(np.float32)
    w = (0.02 * rng.normal(size=(vocab + 37, d))).astype(np.float32)
    y = rng.integers(0, vocab, size=rows)
    y[:2] = vocab + 36
    for r in range(rows):
        for tok, gain in zip((y[r], rng.integers(vocab), rng.integers(vocab)), PEAKS[peak]):
            h[r] += gain * w[tok] / np.linalg.norm(w[tok])
    g = rng.normal(size=rows).astype(np.float32)
    g[3] = 0.0
    return h, w, y, g


def _dh_case(peak, h_dtype, w_dtype):
    """(inputs, the f32 plain dh before its cast, FCE_SCALE_RTOL x sum|terms|) as chip_smoke.py forms them."""
    h, w, y, g = _llama_like(peak)
    th, tw, ty, tg = (torch.from_numpy(h).to(h_dtype), torch.from_numpy(w).to(w_dtype), torch.from_numpy(y),
                      torch.from_numpy(g))
    _, lse = fused_ce_fwd_ref(th, tw, ty)
    coeff = _coeff_ref(th, tw, ty, lse, tg)
    return (th, tw, ty, lse, tg), coeff @ tw.float(), FCE_SCALE_RTOL * (coeff.abs() @ tw.float().abs())


def _worst(got, want, bound):
    return float(((got - want).abs() / bound.clamp_min(1e-30)).max())


@pytest.mark.parametrize("peak", ["flat", "peaked"])
@pytest.mark.parametrize("h_dtype,w_dtype", [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_dh_split_bf16_scheme_holds_the_scaled_bound(peak, h_dtype, w_dtype):
    args, want, bound = _dh_case(peak, h_dtype, w_dtype)
    th, tw, _, lse, tg = args
    if peak == "peaked":  # the data is what it claims: three of the 4,133 tokens carry much of p
        p_top = torch.exp(th.float() @ tw.float().T - lse[:, None]).topk(3, dim=1).values.sum(1)
        assert float(p_top.min()) > 0.25 and float(p_top.mean()) > 0.5
    got = _dh_kernel_scheme(*args)
    assert _worst(got, want, bound) <= 1.0
    assert not got[tg == 0].any()  # a row with g = 0 gets exactly 0


def test_dh_scores_need_the_master_w_in_three_parts_at_a_sharp_peak():
    """The policy's pair (h bf16, W f32) where a target takes p ~ 0.995: lse is fixed, so a score's
    error moves 1 - p_y undamped; three parts of W hold the bound, two (~2^-17 of W) do not."""
    args, want, bound = _dh_case("sharp", torch.bfloat16, torch.float32)
    th, tw, _, lse, _ = args
    assert float(torch.exp(th.float() @ tw.float().T - lse[:, None]).max()) > 0.99
    assert _worst(_dh_kernel_scheme(*args), want, bound) <= 1.0
    assert _worst(_dh_kernel_scheme(*args, score_parts=2), want, bound) > 1.0


@pytest.mark.parametrize("peak", ["flat", "peaked"])
def test_dh_product_with_w_rounded_once_to_bf16_misses_the_bound(peak):
    """Why the product takes the master W in two parts: the same passes with W rounded once to bf16."""
    args, want, bound = _dh_case(peak, torch.bfloat16, torch.float32)
    got = _dh_kernel_scheme(*args, w_product=[args[1].to(torch.bfloat16).float()])
    assert _worst(got, want, bound) > 1.0


# The forward (csrc/fused_ce.cu) runs the same score passes (csrc/fce_gemm.cuh), one block per 128 x 128
# tile: each row's max m over the tile's columns below V, its sum l of exp(s - m) and its target's score
# (0 if the target lies elsewhere) as one partial per column tile, then a combine per row in vocab order
# with the `l == 0` guard. chip_smoke.py holds logp and lse to FCE_LOGP_TOL against the f32 plain
# version, and dh and dW, computed from the kernel forward's lse, to their bounds. The backward holds
# that lse fixed, so the forward must take the backward's three parts of an f32 W: with two, its lse
# moves p_y at a sharp peak past dh's bound.
FCE_LOGP_TOL = (1e-4, 1e-5)  # chip_smoke.py's (atol, rtol) on logp and lse


def _fwd_kernel_scheme(h, w, y, score_parts=SCORE_ORDER):
    """(logp, lse) in f32 as the forward's passes, tile partials and in-order combine compute them."""
    s = _passes(_parts(h, score_parts), _parts(w, score_parts), score_parts, lambda a, b: a @ b.T)
    rows = torch.arange(len(y))
    m_all, l_all, t_all = [], [], []
    for v0 in range(0, s.shape[1], GEMM_TILE):
        tile = s[:, v0:v0 + GEMM_TILE]  # the last tile holds the columns below V only
        m = tile.amax(1)
        m_all.append(m)
        l_all.append(torch.exp(tile - m[:, None]).sum(1))
        inside = (y >= v0) & (y < v0 + tile.shape[1])
        t_all.append(torch.where(inside, tile[rows, (y.long() - v0).clamp(0, tile.shape[1] - 1)], 0.0))
    m = torch.stack(m_all).amax(0)
    l, t = torch.zeros(len(y)), torch.zeros(len(y))
    for m_z, l_z, t_z in zip(m_all, l_all, t_all):
        l = l + l_z * torch.exp(m_z - m)
        t = t + t_z
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    return t - lse, lse


@pytest.mark.parametrize("peak", list(PEAKS))
@pytest.mark.parametrize("h_dtype,w_dtype", [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_fwd_split_bf16_scheme_holds_logp_and_feeds_dh_within_its_bound(peak, h_dtype, w_dtype):
    args, want, bound = _dh_case(peak, h_dtype, w_dtype)
    th, tw, ty, _, tg = args
    assert int(ty.max()) >= tw.shape[0] - tw.shape[0] % GEMM_TILE  # a target in the last, partial tile
    logp, lse = _fwd_kernel_scheme(th, tw, ty)
    want_logp, want_lse = fused_ce_fwd_ref(th, tw, ty)
    np.testing.assert_allclose(logp.numpy(), want_logp.numpy(), atol=FCE_LOGP_TOL[0], rtol=FCE_LOGP_TOL[1])
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=FCE_LOGP_TOL[0], rtol=FCE_LOGP_TOL[1])
    assert _worst(_dh_kernel_scheme(th, tw, ty, lse, tg), want, bound) <= 1.0


def test_fwd_with_the_master_w_in_two_parts_misses_dh_bound_at_a_sharp_peak():
    """Why the forward takes the backward's three parts of W: the lse of two parts, held fixed by dh's
    (three-part) scores, moves 1 - p_y at a target with p ~ 0.995 past dh's bound."""
    args, want, bound = _dh_case("sharp", torch.bfloat16, torch.float32)
    th, tw, ty, _, tg = args
    assert _worst(_dh_kernel_scheme(th, tw, ty, _fwd_kernel_scheme(th, tw, ty)[1], tg), want, bound) <= 1.0
    lse_two = _fwd_kernel_scheme(th, tw, ty, score_parts=2)[1]
    assert _worst(_dh_kernel_scheme(th, tw, ty, lse_two, tg), want, bound) > 1.0


# dW (same file, same GEMM template): the scores with W's chunk as A and h as B, the coefficients
# C^T = (g (onehot - p))^T in two bf16 parts, then dW = C^T @ h with h as it is (bf16) or in two
# parts (f32), its K loop over the rows with each 32-row k tile summed apart and promoted into an f32
# total (csrc/fused_ce_bwd.cu: mainloop). The kernel takes the rows reordered by live_rows_first and
# stops at the live count; chip_smoke.py holds each dW element to FCE_SCALE_RTOL of its own sum of
# |terms| (|coeff|^T @ |h|) and dW bit-identical with the masked rows dropped.
K_TILE = 32  # csrc/fused_ce_bwd.cu: kBK


def _dw_kernel_scheme(h, w, y, lse, g, c_parts=PRODUCT_ORDER, reorder=True):
    """dW in f32 (before the cast to W's dtype) as the kernel's passes and k tiles compute it.
    ``reorder=False`` leaves the masked rows where they are (their C is 0), as a kernel without
    live_rows_first would."""
    if reorder:
        order, live = live_rows_first(g)
        h, y, lse, g = h[order], y[order], lse[order], g[order]
        n = int(live)
    else:
        n = len(g)
    h, y, lse, g = h[:n], y[:n], lse[:n], g[:n]
    s = _passes(_parts(w, SCORE_ORDER), _parts(h, SCORE_ORDER), SCORE_ORDER, lambda a, b: a @ b.T)  # (V, n)
    ct = torch.where(g[None, :] != 0, -torch.exp(s - lse[None, :]), 0.0)
    ct[y.long(), torch.arange(n)] += (g != 0).float()
    ct = ct * g[None, :]
    c = _parts(ct, c_parts) if c_parts > 1 else [ct.to(torch.bfloat16).float()]
    h_parts = _parts(h, PRODUCT_ORDER)
    acc = torch.zeros(w.shape[0], h.shape[1])
    for k0 in range(0, n, K_TILE):
        acc += _passes([x[:, k0:k0 + K_TILE] for x in c], [x[k0:k0 + K_TILE] for x in h_parts], PRODUCT_ORDER,
                       lambda a, b: a @ b)
    return acc


def _dw_case(peak, h_dtype, w_dtype, rows=12):
    """(inputs, the f32 plain dW before its cast, FCE_SCALE_RTOL x sum|terms|) as chip_smoke.py forms them."""
    h, w, y, g = _llama_like(peak, rows=rows)
    th, tw, ty, tg = (torch.from_numpy(h).to(h_dtype), torch.from_numpy(w).to(w_dtype), torch.from_numpy(y),
                      torch.from_numpy(g))
    _, lse = fused_ce_fwd_ref(th, tw, ty)
    coeff = _coeff_ref(th, tw, ty, lse, tg)
    return (th, tw, ty, lse, tg), coeff.T @ th.float(), FCE_SCALE_RTOL * (coeff.abs().T @ th.float().abs())


@pytest.mark.parametrize("peak", ["flat", "peaked"])
@pytest.mark.parametrize("h_dtype,w_dtype", [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_dw_split_bf16_scheme_holds_the_scaled_bound(peak, h_dtype, w_dtype):
    args, want, bound = _dw_case(peak, h_dtype, w_dtype)
    assert _worst(_dw_kernel_scheme(*args), want, bound) <= 1.0


@pytest.mark.parametrize("peak", ["flat", "peaked"])
def test_dw_product_with_c_rounded_once_to_bf16_misses_the_bound(peak):
    """Why the product takes the coefficients in two parts: the same passes with C rounded once."""
    args, want, bound = _dw_case(peak, torch.bfloat16, torch.float32)
    assert _worst(_dw_kernel_scheme(*args, c_parts=1), want, bound) > 1.0


def test_dw_over_live_rows_alone_is_bit_identical_under_the_kernel_row_order():
    """96 rows, every third masked (g = 0) and interleaved with the live ones: with the live rows
    taken first, dW equals dW over the live rows alone bit for bit, and holds the bound; left where
    they are, the masked rows regroup the live rows' k tiles and change dW's bits."""
    args, _, _ = _dw_case("peaked", torch.bfloat16, torch.float32, rows=96)
    h, w, y, lse, g = args
    g = g.clone()
    g[::3] = 0.0
    live = g != 0
    full = _dw_kernel_scheme(h, w, y, lse, g)
    alone = _dw_kernel_scheme(h[live], w, y[live], lse[live], g[live])
    assert torch.equal(full, alone)
    coeff = _coeff_ref(h, w, y, lse, g)
    assert _worst(full, coeff.T @ h.float(), FCE_SCALE_RTOL * (coeff.abs().T @ h.float().abs())) <= 1.0
    assert not torch.equal(_dw_kernel_scheme(h, w, y, lse, g, reorder=False), alone)


def test_live_rows_first_keeps_each_group_in_order():
    g = torch.tensor([0.0, 1.5, 0.0, -2.0, 3.0, 0.0, 0.25])
    order, live = live_rows_first(g)
    assert order.tolist() == [1, 3, 4, 6, 0, 2, 5]
    assert live.dtype == torch.int32 and live.dim() == 0 and int(live) == 4
