"""The port's int8 decode (ops/quant.py, the quantized twin) against the JAX package (CPU).

JAX weights are bridged with ``load_jax_params``; both packages build their
int8 twin from the same float32 masters. On CPU tensors ``q8_matmul`` runs
its plain version, which sums the int8 products exactly (float64), as the
kernel (int32) and XLA's int8 dot do. Tolerances and why:

* ``quantize_weight`` and the per-row activation quantizer: bit-equal (the
  same f32 amax, IEEE division, round half to even);
* the int8 products: equal (integers); W8A8 ``q8_matmul`` rel 1e-6 (the same
  products rescaled by the same f32 multiplies; XLA may fuse them);
* weight-only, float32: 1e-5 (an f32 dot of K terms, summed in another order);
  its bf16 dequantized weight: bit-equal to XLA's;
* the twin's prefix and step logits: atol 1e-4 (float32 through a few layers,
  as tests/test_torch_models.py), greedy captions token-identical;
* against full precision, the JAX package's own bounds (tests/test_quant.py).

The kernel (csrc/q8_matmul.cu) is emulated here with numpy: its fragment
layouts (the weight as mma.sync's A operand by ldmatrix, x's rows as B; the
weight-only route's permuted k) must give the exact product; its quantizer
(a reciprocal multiply, the division near half-integers) must equal
rint(x / s) on every bf16 value; the fused W8A8 path with K split over a
cluster (each rank's amax, the cluster's max, rank-order int32 sums) must give
JAX's scales, int8 x and int32 sums exactly and its f32 output bit for bit; the
weight-only split's rank-order f32 sums stay within the weight-only tolerance.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu.ops import quant as jq
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine
from pgica_tpu_torch.models.lm import TransformerLM, init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
from pgica_tpu_torch.models.presets import get_text_config
from pgica_tpu_torch.ops import _kernels
from pgica_tpu_torch.ops.quant import (
    QuantDense,
    int8_products,
    q8_matmul,
    q8_matmul_ref,
    quantize_rows,
    quantize_weight,
)

B, IMG, SEQ, PROJ = 2, 32, 10, 16
MODES = ("int8", "int8_weight_only")
LOGIT_ATOL = 1e-4
TINY = {"gpt2": dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, max_caption_length=SEQ,
                     image_size=IMG),
        "llama": dict(vision_model="tiny-vit", text_model="tiny-llama", projection_dim=PROJ, max_caption_length=SEQ,
                      image_size=IMG)}


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ the quantizers


@pytest.mark.parametrize("shape,features", [((64, 32), 1), ((48, 4, 8), 2), ((4, 8, 48), 1)])
def test_quantize_weight_bit_equal_to_jax(rng, shape, features):
    """Dense (in, out), q/k/v (hidden, H, D) and out_proj (H, D, hidden) kernels: the port quantizes the
    (out, in) weight that models/convert.py makes of each."""
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel of the Dense pattern stays finite
    jqw, jscale = jq.quantize_weight(jnp.asarray(w), features)
    k = int(np.prod(shape[:-features]))
    port_w = _t(w.reshape(k, -1).T)
    q, scale = quantize_weight(port_w)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw).reshape(k, -1).T)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale).reshape(-1))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantize_rows_bit_equal_to_jax(rng, dtype):
    x = rng.normal(size=(8, 64)).astype(np.float32) * rng.uniform(0.01, 10.0, size=(8, 1)).astype(np.float32)
    x[0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]  # amax 127: scale 1, so x / scale lands on halves (ties to even)
    x[1] = 0.0  # the 1e-12 floor
    jx = jnp.asarray(x).astype(dtype)
    jxq, jsx = jq._quantize_rows(jx)
    xq, sx = quantize_rows(_t(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16 if dtype == jnp.bfloat16
                                                                       else torch.float32))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx)[:, 0])
    assert xq[0, :6].tolist() == [127, 2, -4, 0, 0, 2]


def test_int8_products_exact_and_w8a8_matches_jax(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)  # JAX (in, out)
    jqw, jscale = jq.quantize_weight(jnp.asarray(w), 1)
    jxq, _ = jq._quantize_rows(jnp.asarray(x))
    jacc = jax.lax.dot_general(jxq, jqw, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    qw = _t(np.asarray(jqw).T)
    np.testing.assert_array_equal(int8_products(_t(np.asarray(jxq)), qw).numpy(), np.asarray(jacc))
    want = jq.q8_matmul(jnp.asarray(x), jqw, jscale, out_dtype=jnp.float32)
    got = q8_matmul_ref(_t(x), qw, _t(jscale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)


def test_weight_only_matches_jax(rng):
    x = rng.normal(size=(8, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    jqw, jscale = jq.quantize_weight(jnp.asarray(w), 1)
    want = jq.q8_matmul(jnp.asarray(x), jqw, jscale, weight_only=True, out_dtype=jnp.float32)
    got = q8_matmul_ref(_t(x), _t(np.asarray(jqw).T), _t(jscale), weight_only=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # bf16: the dequantized weight, bf16(float(q) * float(bf16(scale))), is XLA's bit for bit
    jdeq = jqw.astype(jnp.bfloat16) * jscale.astype(jnp.bfloat16)[None, :]
    deq = _t(np.asarray(jqw).T).to(torch.bfloat16) * _t(jscale).to(torch.bfloat16)[:, None]
    np.testing.assert_array_equal(deq.float().numpy().T, np.asarray(jdeq.astype(jnp.float32)))


@pytest.mark.parametrize("weight_only", [False, True])
def test_q8_matmul_close_to_f32(rng, weight_only):
    """The JAX package's own bound against the f32 product (tests/test_quant.py)."""
    x = _t(rng.normal(size=(8, 64)).astype(np.float32))
    w = _t(rng.normal(size=(32, 64)).astype(np.float32))
    q, scale = quantize_weight(w)
    got, want = q8_matmul(x, q, scale, weight_only=weight_only), x @ w.T
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) < (0.01 if weight_only else 0.02)


def test_cpu_tensors_run_the_plain_version(rng):
    counts = _kernels.launch_counts()
    x = _t(rng.normal(size=(5, 40)).astype(np.float32))
    q, scale = quantize_weight(_t(rng.normal(size=(24, 40)).astype(np.float32)))
    bias = _t(rng.normal(size=24).astype(np.float32))
    for weight_only in (False, True):
        assert torch.equal(q8_matmul(x, q, scale, bias, weight_only), q8_matmul_ref(x, q, scale, bias, weight_only))
    assert _kernels.launch_counts() == counts
    assert _kernels.KERNELS["q8_matmul_w8a8"][0] == _kernels.KERNELS["q8_matmul_w8"][0] == "q8_matmul.cu"


@pytest.mark.parametrize("pattern", ["qkv", "out_proj"])
def test_quant_dense_matches_jax_quant_dense_general(rng, pattern):
    """(B, S, hidden) -> (B, S, H, D) and (B, S, H, D) -> (B, S, hidden) with axis=(-2, -1), with a bias."""
    h, d, hidden = 4, 16, 64
    features, axis, x_shape = ((h, d), -1, (2, 5, hidden)) if pattern == "qkv" else (hidden, (-2, -1), (2, 5, h, d))
    x = rng.normal(size=x_shape).astype(np.float32)
    ref = nn.DenseGeneral(features=features, axis=axis)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params["bias"] = rng.normal(size=params["bias"].shape).astype(np.float32)
    qmod = jq.QuantDenseGeneral(features=features, axis=axis, dtype=jnp.float32)
    template = jax.eval_shape(lambda: qmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    want = qmod.apply({"params": jq.quantize_like(template, params)}, jnp.asarray(x))
    kernel = params["kernel"]
    k = int(np.prod(kernel.shape[:-1])) if pattern == "out_proj" else kernel.shape[0]
    dense = QuantDense(k, int(np.prod(kernel.shape)) // k)
    dense.load_from(_t(kernel.reshape(k, -1).T), _t(params["bias"].reshape(-1)))
    got = dense(_t(x.reshape(2, 5, k)))
    np.testing.assert_allclose(got.numpy().reshape(want.shape), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ the kernel's layouts and sums

# csrc/q8_matmul.cu, emulated with numpy: the weight is the 16-row A operand of mma.sync and x's rows the n8 B
# operand; a block stages 128-wide k chunks; K is split over a cluster of `split` blocks whose partial tiles
# are summed in rank order.
KBK = 128
ROUND_MAGIC = np.float32(12582912.0)


def _ldmatrix(smem: np.ndarray, addrs) -> np.ndarray:
    """ldmatrix .b16 on an int8 array: lanes 8i..8i+7 give (row, byte column) of matrix i's rows; lane (g, t)
    receives bytes 4t..4t+3 of row g of each matrix (its b16 elements 2t, 2t + 1). Returns (32, matrices, 4)."""
    mats = len(addrs) // 8
    regs = np.zeros((32, mats, 4), np.int64)
    for i in range(mats):
        for lane in range(32):
            g, t = lane // 4, lane % 4
            row, col = addrs[8 * i + g]
            regs[lane, i] = smem[row, col + 4 * t:col + 4 * t + 4]
    return regs


def _a_addrs(ks):  # chunk_s8 / chunk_bf16: the weight's A fragments
    return [(lane & 15, ks * 32 + (lane >> 4) * 16) for lane in range(32)]


def _b_addrs(ks, j, tiles):  # chunk_s8: x's B fragments of tiles j, j + 1 (ldmatrix .x4) or of one tile (.x2)
    if tiles == 1:
        return [(lane & 7, ks * 32 + ((lane >> 3) & 1) * 16) for lane in range(16)]
    return [((j + (lane >> 4)) * 8 + (lane & 7), ks * 32 + ((lane >> 3) & 1) * 16) for lane in range(32)]


def _mma(a_frag, b_frag, kdim):
    """A (16, kdim) and B (kdim, 8) from mma.sync's fragments (per lane: a 4 regs, b 2 regs, each kdim / 8
    values): a0 = (g, t-th group), a1 = (g + 8, ...), a2 = (g, second half), a3 = (g + 8, second half); b0 = (t-th
    group, g), b1 = (second half, g). Returns the C tile (16, 8) = A @ B."""
    per = kdim // 8
    a = np.zeros((16, kdim))
    b = np.zeros((kdim, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i, (row, half) in enumerate(((g, 0), (g + 8, 0), (g, 1), (g + 8, 1))):
            a[row, half * kdim // 2 + per * t:half * kdim // 2 + per * t + per] = a_frag[lane][i]
        for i in range(2):
            b[i * kdim // 2 + per * t:i * kdim // 2 + per * t + per, g] = b_frag[lane][i]
    return a @ b


def _emulate_chunk_s8(wq: np.ndarray, xq: np.ndarray, tiles: int) -> np.ndarray:
    """gemm_w8a8_fused's products of one 128-wide chunk for one warp: wq (16, 128) weight rows, xq (8 * tiles,
    128) x rows, both int8 in shared memory; returns C as (x row, weight row), as push_partials writes it."""
    out = np.zeros((8 * tiles, 16))
    for ks in range(KBK // 32):
        a = _ldmatrix(wq, _a_addrs(ks)).reshape(32, 4, 4)
        for j in range(0, tiles, 2):
            b = _ldmatrix(xq, _b_addrs(ks, j, tiles)).reshape(32, -1, 4)
            for h in range(min(2, tiles)):
                c = _mma(a, b[:, 2 * h:2 * h + 2], 32)
                out[(j + h) * 8:(j + h) * 8 + 8] += c.T
    return out


def _dequant2(word4, h, s):
    """dequant2: bytes 2h, 2h + 1 of a lane's 4 int8 values, as bf16(float(q) * s)."""
    q = np.asarray(word4[2 * h:2 * h + 2], np.float32)
    return _t(q * np.float32(s)).to(torch.bfloat16).float().numpy()


def _emulate_chunk_bf16(wq: np.ndarray, scale_bf16: np.ndarray, x: np.ndarray, tiles: int) -> np.ndarray:
    """gemm_w8_bf16_tiled's products of one chunk for one warp: the int8 A fragments by ldmatrix, dequantized in
    registers; x's B fragments by 8-byte reads of k 4t..4t+3 and 16 + 4t..; two m16n8k16 products per 32 k."""
    out = np.zeros((8 * tiles, 16))
    for ks in range(KBK // 32):
        a = _ldmatrix(wq, _a_addrs(ks))
        for j in range(tiles):
            for step in range(2):
                a_frag, b_frag = [], []
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    lo, hi = a[lane, 2 * step], a[lane, 2 * step + 1]  # rows g and g + 8
                    a_frag.append([_dequant2(lo, 0, scale_bf16[g]), _dequant2(hi, 0, scale_bf16[g + 8]),
                                   _dequant2(lo, 1, scale_bf16[g]), _dequant2(hi, 1, scale_bf16[g + 8])])
                    k0 = ks * 32 + 16 * step + 4 * t
                    row = x[j * 8 + g]
                    b_frag.append([row[k0:k0 + 2], row[k0 + 2:k0 + 4]])
                out[j * 8:j * 8 + 8] += _mma(a_frag, b_frag, 16).T
    return out


@pytest.mark.parametrize("tiles", [1, 2, 8])
def test_kernel_fragment_layouts_give_the_product(rng, tiles):
    wq = rng.integers(-127, 128, size=(16, KBK))
    xq = rng.integers(-127, 128, size=(8 * tiles, KBK))
    np.testing.assert_array_equal(_emulate_chunk_s8(wq, xq, tiles), xq @ wq.T)
    scale = rng.uniform(0.001, 0.1, size=16).astype(np.float32)
    s_bf16 = _t(scale).to(torch.bfloat16).float().numpy()
    x = _t(rng.normal(size=(8 * tiles, KBK)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    deq = (_t(wq.astype(np.float32)).to(torch.bfloat16) * _t(scale).to(torch.bfloat16)[:, None]).float().numpy()
    np.testing.assert_allclose(_emulate_chunk_bf16(wq, s_bf16, x, tiles), x.astype(np.float64) @ deq.T.astype(np.float64),
                               rtol=1e-12, atol=1e-12)


def _quantize_like_kernel(x: np.ndarray, s: np.ndarray) -> np.ndarray:
    """quantize_piece: t = x * (1 / s) + 1.5 * 2^23 in one FMA (the product exact, one rounding), whose low byte
    is the int8; the division itself where x * r lies within 4e-5 of a half-integer. s broadcasts against x.
    The FMAs are taken in float64, where x * r is exact (and t's double rounding can only differ next to a
    half-integer, which takes the division)."""
    x = np.asarray(x, np.float32)
    s = np.broadcast_to(np.asarray(s, np.float32), x.shape)
    prod = x.astype(np.float64) * (np.float32(1) / s).astype(np.float64)
    t = (prod + np.float64(ROUND_MAGIC)).astype(np.float32)
    near_half = np.abs((prod - (t - ROUND_MAGIC).astype(np.float64)).astype(np.float32)) > np.float32(0.49996)
    t[near_half] = (x[near_half] / s[near_half]) + ROUND_MAGIC
    low = (t.view(np.int32) & 0xFF).astype(np.int16)
    return np.where(low > 127, low - 256, low).astype(np.int8)


def test_kernel_quantizer_is_the_division(rng):
    """Every finite bf16 value within a row's amax, against 200 row scales (ties at amax 127 among them), and 2M
    random float32 values: the kernel's quantizer equals rint(x / s) clamped, IEEE division."""
    bits = np.arange(65536, dtype=np.uint32) << 16
    every = bits.view(np.float32)
    every = every[np.isfinite(every)]
    amaxes = np.concatenate([[127.0, 63.5, 1.0, 1e-13], rng.uniform(0, 8, 196) ** 3]).astype(np.float32)
    slow = 0
    for amax in amaxes:
        s = np.float32(max(amax, np.float32(1e-12))) / np.float32(127)
        x = every[np.abs(every) <= amax]
        want = np.clip(np.rint(x / s), -127, 127).astype(np.int8)
        np.testing.assert_array_equal(_quantize_like_kernel(x, s), want, err_msg=f"amax {amax}")
        prod = x.astype(np.float64) * np.float64(np.float32(1) / s)
        slow += int((np.abs(prod - np.rint(prod)) > 0.49996).sum())
    x = rng.normal(size=(2000, 1000)).astype(np.float32) * rng.uniform(0.01, 100, size=(2000, 1)).astype(np.float32)
    s = np.maximum(np.abs(x).max(axis=1, keepdims=True), np.float32(1e-12)) / np.float32(127)
    np.testing.assert_array_equal(_quantize_like_kernel(x, s), np.clip(np.rint(x / s), -127, 127).astype(np.int8))
    assert 0 < slow < 1e-3 * len(every) * len(amaxes)


def _slices(k: int, split: int):
    """Each rank's run of 128-wide chunks (as k_slice: ceil(chunks / split) a rank, the last ones short)."""
    chunks = -(-k // KBK)
    per = -(-chunks // split)
    return [(min(r * per * KBK, k), min((r + 1) * per * KBK, k)) for r in range(split)]


def _emulate_fused_w8a8(x32: np.ndarray, wq: np.ndarray, scale: np.ndarray, bias: np.ndarray, split: int):
    """gemm_w8a8_fused on float32 x (the compute dtype's values): each rank's amax over its k slice, the
    cluster's max, sx = max(amax, 1e-12) / 127; each rank quantizes its slice (quantize1) and sums its int8
    products in int32; the ranks' partial tiles added in rank order; y = (float(acc) * sx) * scale + bias, f32."""
    slices = _slices(x32.shape[1], split)
    amax = np.max([np.abs(x32[:, a:b]).max(axis=1) if b > a else np.zeros(len(x32), np.float32)
                   for a, b in slices], axis=0).astype(np.float32)
    sx = np.maximum(amax, np.float32(1e-12)) / np.float32(127)
    acc = np.zeros((x32.shape[0], wq.shape[0]), np.int64)
    xq = np.zeros(x32.shape, np.int8)
    for a, b in slices:  # rank order
        if b > a:
            xq[:, a:b] = _quantize_like_kernel(x32[:, a:b], sx[:, None])
            acc += (xq[:, a:b].astype(np.float64) @ wq[:, a:b].T.astype(np.float64)).astype(np.int64)
    y = (acc.astype(np.float32) * sx[:, None]) * scale[None, :]
    return sx, xq, acc, y + bias[None, :]


# GPT-2 Medium fc_in at 32 x 4 beams, and ragged tails of chip_smoke.py's Q8_RAGGED (M, K, N)
FUSED_SHAPES = [(128, 1024, 4096), (70, 4104, 24), (129, 64, 8), (5, 1000, 1001)]


@pytest.mark.parametrize("shape", FUSED_SHAPES)
@pytest.mark.parametrize("split", [1, 8])
def test_fused_w8a8_emulation_matches_jax(rng, shape, split):
    """The fused path's scales, int8 x, int32 sums and f32 output against the JAX package's q8_matmul."""
    m, k, n = shape
    x = rng.normal(size=(m, k)).astype(np.float32) * rng.uniform(0.05, 20, size=(m, 1)).astype(np.float32)
    x[0, : min(k, 4)] = [127.0, 2.5, -3.5, 0.5][: min(k, 4)]  # ties at the row's scale of 1
    w = rng.normal(size=(k, n)).astype(np.float32)  # JAX (in, out)
    bias = rng.normal(size=n).astype(np.float32)
    jqw, jscale = jq.quantize_weight(jnp.asarray(w), 1)
    jxq, jsx = jq._quantize_rows(jnp.asarray(x))
    jacc = jax.lax.dot_general(jxq, jqw, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    want = np.asarray(jq.q8_matmul(jnp.asarray(x), jqw, jscale, out_dtype=jnp.float32)) + bias[None, :]
    sx, xq, acc, y = _emulate_fused_w8a8(x, np.asarray(jqw).T.copy(), np.asarray(jscale), bias, split)
    np.testing.assert_array_equal(sx, np.asarray(jsx)[:, 0])
    np.testing.assert_array_equal(xq, np.asarray(jxq))
    np.testing.assert_array_equal(acc, np.asarray(jacc))
    np.testing.assert_array_equal(y, want)


def _emulate_w8_split(x_bf16: np.ndarray, wq: np.ndarray, scale: np.ndarray, split: int, tile: int = 0) -> np.ndarray:
    """gemm_w8_bf16_tiled's sums: the weight dequantized as bf16(float(q) * float(bf16(scale))); each rank's
    f32 partial over its slice, its chunks taken from chunk `tile % chunks` on (the k loop's rotation), each
    chunk's products rounded once to f32; the partials added in rank order (__fadd_rn)."""
    deq = (_t(wq.astype(np.float32)).to(torch.bfloat16) * _t(scale).to(torch.bfloat16)[:, None]).float().numpy()
    total = None
    for a, b in _slices(x_bf16.shape[1], split):
        part = np.zeros((x_bf16.shape[0], wq.shape[0]), np.float32)
        chunks = list(range(a, b, KBK))
        for c in chunks[tile % len(chunks):] + chunks[:tile % len(chunks)] if chunks else []:
            prod = x_bf16[:, c:c + KBK].astype(np.float64) @ deq[:, c:c + KBK].T.astype(np.float64)
            part = (part + prod.astype(np.float32)).astype(np.float32)
        total = part if total is None else (total + part).astype(np.float32)
    return total


@pytest.mark.parametrize("shape", [(128, 1024, 4096), (70, 4104, 24)])
@pytest.mark.parametrize("split", [1, 8])
def test_weight_only_split_emulation_matches_jax(rng, shape, split):
    """The weight-only K split with its rank-order sum: the f32 sums within test_weight_only_matches_jax's
    tolerance of JAX's product on the same bf16 dequantized weight, and bf16 outputs within a bf16 ulp or two of
    JAX's bf16 q8_matmul. The weight is drawn at a layer's 1 / sqrt(K) scale (as chip_smoke.py's q8 inputs), so
    the outputs are O(1) like test_weight_only_matches_jax's and the same absolute tolerance reads the same."""
    m, k, n = shape
    x = _t(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16).float().numpy()
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    jqw, jscale = jq.quantize_weight(jnp.asarray(w), 1)
    jdeq = (jqw.astype(jnp.bfloat16) * jscale.astype(jnp.bfloat16)[None, :]).astype(jnp.float32)
    want = np.asarray(jnp.dot(jnp.asarray(x), jdeq, precision=jax.lax.Precision.HIGHEST))
    got = _emulate_w8_split(x, np.asarray(jqw).T.copy(), np.asarray(jscale), split, tile=3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    jbf16 = jq.q8_matmul(jnp.asarray(x).astype(jnp.bfloat16), jqw, jscale, weight_only=True, out_dtype=jnp.bfloat16)
    np.testing.assert_allclose(_t(got).to(torch.bfloat16).float().numpy(), np.asarray(jbf16.astype(jnp.float32)),
                               atol=2e-2, rtol=1e-2)


# ------------------------------------------------------------------ the twin against JAX's


@pytest.fixture(scope="module")
def jax_models(tiny_model):
    models = {}
    for arch in TINY:
        for mode in MODES:
            models[arch, mode] = JaxModel(tokenizer=JaxTokenizer(), seed=0, quantization=mode, **TINY[arch])
    return models


def _port(jm, arch, mode, **kw):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", quantization=mode,
                                           **TINY[arch], **kw)
    port.load_jax_params(jax.tree.map(np.array, jm.params))
    return port


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8)


def _jax_prefix_and_step(module, params, vis, cache_len=6):
    mask0 = (jnp.arange(cache_len)[None, :] <= 0).astype(jnp.int32).repeat(B, 0)
    caches = jax_init_kv_cache(module.decoder_config, B, cache_len, module.dtype)
    logits0, caches = module.apply({"params": params}, vis, caches, mask0, method="decode_prefix")
    tok = jnp.argmax(logits0, -1)[:, None].astype(jnp.int32)
    mask1 = (jnp.arange(cache_len)[None, :] <= 1).astype(jnp.int32).repeat(B, 0)
    logits1, _ = module.apply({"params": params}, tok, 1, caches, mask1, method="decode_step")
    return np.asarray(logits0, np.float32), np.asarray(logits1, np.float32)


def _port_prefix_and_step(module, vis, cache_len=6):
    with torch.inference_mode():
        slots = torch.arange(cache_len)
        caches = init_kv_cache(module.decoder_config, B, cache_len, module.compute_dtype, torch.device("cpu"))
        logits0, caches = module.decode_prefix(vis, caches, (slots[None] <= 0).to(torch.int32).expand(B, -1))
        tok = torch.argmax(logits0, -1)[:, None]
        logits1, _ = module.decode_step(tok, 1, caches, (slots[None] <= 1).to(torch.int32).expand(B, -1))
    return logits0.float().numpy(), logits1.float().numpy()


@pytest.mark.parametrize("arch", list(TINY))
@pytest.mark.parametrize("mode", MODES)
def test_twin_logits_match_jax_twin(jax_models, rng, arch, mode):
    jm = jax_models[arch, mode]
    twin, qparams = jm._decode_module_and_params()
    vis = rng.normal(size=(B, PROJ)).astype(np.float32)
    want = _jax_prefix_and_step(twin, qparams, jnp.asarray(vis))
    port = _port(jm, arch, mode)
    got = _port_prefix_and_step(port._decode_module(), torch.from_numpy(vis))
    for g, w, what in zip(got, want, ("prefix", "step")):
        np.testing.assert_allclose(g, w, atol=LOGIT_ATOL, rtol=0, err_msg=f"{arch} {mode} {what}")
    # and within the JAX package's bound of the full-precision logits (tests/test_quant.py)
    full = _port_prefix_and_step(port.module, torch.from_numpy(vis))[0]
    assert np.linalg.norm(got[0] - full) / np.linalg.norm(full) < 0.05


@pytest.mark.parametrize("arch", list(TINY))
@pytest.mark.parametrize("mode", MODES)
def test_greedy_captions_token_identical_to_jax(jax_models, images, arch, mode):
    jm = jax_models[arch, mode]
    want = jm.generate_captions(images, max_length=8)
    port = _port(jm, arch, mode)
    assert port.generate_captions(images, max_length=8) == want
    assert all(isinstance(c, str) for c in want) and len(want) == B


def test_twin_structure_and_masters(jax_models):
    """Only the decoder LM's blocks are int8; the masters stay float32 Dense weights; a bf16 twin keeps
    scales and biases float32 and the other weights bf16 (norm weights float32, holding bf16 values)."""
    port = _port(jax_models["gpt2", "int8"], "gpt2", "int8", dtype=torch.bfloat16)
    twin = port._decode_module()
    block = twin.caption_decoder.lm.blocks[0]
    for dense in (block.attn.q_proj, block.attn.k_proj, block.attn.v_proj, block.attn.out_proj, block.mlp.fc_in,
                  block.mlp.fc_out):
        assert isinstance(dense, QuantDense) and not dense.weight_only
        assert dense.weight_q.dtype == torch.int8 and dense.scale.dtype == dense.bias.dtype == torch.float32
    assert not isinstance(twin.caption_decoder.cross_attention.q_proj, QuantDense)
    assert not any(isinstance(m, QuantDense) for m in twin.vision_encoder.modules())
    assert twin.caption_decoder.lm.wte.weight.dtype == twin.caption_decoder.vision_projection.weight.dtype \
        == torch.bfloat16
    ln = block.ln_0.weight
    assert ln.dtype == torch.float32 and torch.equal(ln, ln.to(torch.bfloat16).float())
    master = port.module.caption_decoder.lm.blocks[0].attn.q_proj.weight
    assert master.dtype == torch.float32
    q, scale = quantize_weight(master)
    assert torch.equal(block.attn.q_proj.weight_q, q) and torch.equal(block.attn.q_proj.scale, scale)


def test_twin_cache_reused_and_invalidated(jax_models, images):
    port = _port(jax_models["gpt2", "int8"], "gpt2", "int8")
    port.generate_captions(images, max_length=4)
    twin = port._decode_module()
    assert twin is port._decode_module()
    with torch.no_grad():
        port.module.caption_decoder.lm.blocks[0].mlp.fc_in.weight.mul_(2.0)
    rebuilt = port._decode_module()
    assert rebuilt is not twin
    assert torch.equal(rebuilt.caption_decoder.lm.blocks[0].mlp.fc_in.weight_q,
                       quantize_weight(port.module.caption_decoder.lm.blocks[0].mlp.fc_in.weight)[0])
    port.load_jax_params(jax.tree.map(np.array, jax_models["gpt2", "int8"].params))
    assert port._decode_module() is not rebuilt


def test_engine_keeps_the_twin_it_was_built_with(jax_models, images):
    port = _port(jax_models["gpt2", "int8"], "gpt2", "int8")
    engine = ContinuousDecodeEngine(port, slots=2, chunk=2, max_length=6)
    twin = port._decode_module()
    assert engine.module is twin
    engine.warmup()
    engine.start()
    try:
        before = [engine.submit(im)["caption"] for im in images]
        with torch.no_grad():
            port.module.caption_decoder.lm.wte.weight.mul_(-3.0)
        assert port._decode_module() is not twin and engine.module is twin
        assert [engine.submit(im)["caption"] for im in images] == before
        assert port.generate_captions(images, max_length=6) != before
    finally:
        engine.stop()


def test_bad_mode_and_combinations_rejected():
    with pytest.raises(ValueError, match="quantization"):
        PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", quantization="int4", **TINY["gpt2"])
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", quantization="int8",
                                           share_text_tower=True, **TINY["gpt2"])
    with pytest.raises(ValueError, match="share_text_tower"):
        port._decode_module()
    cfg = get_text_config("tiny-gpt2")
    with pytest.raises(ValueError, match="remat"):
        TransformerLM(cfg.__class__(**{**cfg.__dict__, "remat": True}), quant="int8")
