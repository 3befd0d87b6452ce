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

The kernel's fragment layouts (csrc/q8_matmul.cu: each lane's 16 contiguous
bytes split over the mma fragments) are emulated here with numpy and must
give the exact product.
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


# ------------------------------------------------------------------ the kernel's fragment layouts


def _emulate_gemm_s8(xq: np.ndarray, wq: np.ndarray) -> np.ndarray:
    """csrc/q8_matmul.cu gemm_s8 at one 16 x 8 tile: lane (g, t) holds the 16 bytes k0 + 16t .. of its rows;
    bytes 8j..8j+3 and 8j+4..8j+7 are the m16n8k32 fragment columns 4t.. and 16 + 4t.. of product j."""
    m, k = xq.shape
    acc = np.zeros((16, 8), np.int64)
    for k0 in range(0, k, 64):
        for j in range(2):
            a = np.zeros((16, 32), np.int64)
            b = np.zeros((32, 8), np.int64)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for e in range(4):
                    phys = k0 + 16 * t + 8 * j
                    a[g, 4 * t + e], a[g + 8, 4 * t + e] = xq[g, phys + e], xq[g + 8, phys + e]
                    a[g, 16 + 4 * t + e], a[g + 8, 16 + 4 * t + e] = xq[g, phys + 4 + e], xq[g + 8, phys + 4 + e]
                    b[4 * t + e, g], b[16 + 4 * t + e, g] = wq[g, phys + e], wq[g, phys + 4 + e]
            acc += a @ b
    return acc


def _emulate_gemm_w8_bf16(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """gemm_w8_bf16 at one tile: product j (0-3) of m16n8k16 takes the lane's values 4j, 4j + 1 as the
    fragment columns 2t, 2t + 1 and 4j + 2, 4j + 3 as 2t + 8, 2t + 9."""
    acc = np.zeros((16, 8))
    for k0 in range(0, x.shape[1], 64):
        for j in range(4):
            a = np.zeros((16, 16))
            b = np.zeros((16, 8))
            for lane in range(32):
                g, t = lane // 4, lane % 4
                phys = k0 + 16 * t + 4 * j
                for e in range(2):
                    a[g, 2 * t + e], a[g + 8, 2 * t + e] = x[g, phys + e], x[g + 8, phys + e]
                    a[g, 2 * t + 8 + e], a[g + 8, 2 * t + 8 + e] = x[g, phys + 2 + e], x[g + 8, phys + 2 + e]
                    b[2 * t + e, g], b[2 * t + 8 + e, g] = w[g, phys + e], w[g, phys + 2 + e]
            acc += a @ b
    return acc


def test_kernel_fragment_layouts_give_the_product(rng):
    xq = rng.integers(-127, 128, size=(16, 128))
    wq = rng.integers(-127, 128, size=(8, 128))
    np.testing.assert_array_equal(_emulate_gemm_s8(xq, wq), xq @ wq.T)
    x, w = rng.normal(size=(16, 128)), rng.normal(size=(8, 128))
    np.testing.assert_allclose(_emulate_gemm_w8_bf16(x, w), x @ w.T, rtol=1e-12, atol=1e-12)


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
