"""The port's Llama architecture (RMSNorm, RoPE, GQA, SwiGLU) against the JAX package, on the CPU.

Models: the tiny presets, ``tiny-vit`` (and a SigLIP-style variant of it:
GELU-tanh, LayerNorm eps 1e-6) with ``tiny-llama`` (hidden 32, 4 query and 2
KV heads of 8, 2 layers) as text tower and caption decoder, dropout 0; the
JAX parameters are bridged into the port with ``load_jax_params``; every
input comes from a numpy seed. The JAX RMSNorm runs its Pallas kernels in
interpret mode (``fused_rmsnorm(interpret=True, block_r=32)``: the forward
``_rms_fwd_kernel`` and, under ``jax.grad``, ``_rms_bwd_kernel``); the
port's kernel wrappers run their plain versions on CPU tensors.

Tolerances and why:

* RMSNorm forward: atol 1e-6 in float32 (one normalisation of values ~1;
  the mean square summed in another order);
* RMSNorm gradients: rel 1e-5, and 1e-5 of the largest element where a
  sum cancels (a row mean of products, then a sum over up to 70 rows, in
  another order);
* the bf16 RMSNorm module: within one bf16 rounding, 2**-8 relative (both
  round float32 values that may differ in their last bits);
* RoPE: atol 1e-6 (cos and sin of the same float32 angles, two libms);
* one attention or MLP layer: atol 1e-5 (float32, a few sums);
* tower embeddings, decoder hidden states and logits: atol 1e-4 (as
  tests/test_torch_models.py: float32 through a few layers);
* greedy tokens: identical;
* three stage-1 and three stage-2 updates, each under the JAX trainer's
  partition (trainer.py:232-237): losses and metrics rel 1e-5, gradient
  norms rel 1e-4, parameters atol 1e-6, gradients per leaf within 1e-3 of
  the leaf's largest |g|, as tests/test_torch_train.py and
  tests/test_torch_stage2.py hold the GPT-2 model; elements whose gradient
  differs between the two sides by enough to move Adam's update past 1e-6
  are held to Adam's own bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.generation.decode import generate as jax_generate
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.models.layers import MLP as JaxMLP
from pgica_tpu.models.layers import MultiHeadAttention as JaxAttention
from pgica_tpu.models.layers import rotary_embedding as jax_rotary_embedding
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu.models.presets import get_vision_config as jax_vision_config
from pgica_tpu.models.vit import VisionEncoder as JaxVisionEncoder
from pgica_tpu.ops.layernorm import RMSNorm as JaxRMSNorm
from pgica_tpu.ops.layernorm import _fused_rms_fwd_impl, fused_rmsnorm
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import make_stage1_train_step as jax_make_stage1_train_step
from pgica_tpu.training.train_step import make_stage2_train_step as jax_make_stage2_train_step
from pgica_tpu.training.train_step import stage1_loss_fn as jax_stage1_loss_fn
from pgica_tpu.training.train_step import stage2_loss_fn as jax_stage2_loss_fn
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import generate
from pgica_tpu_torch.models.convert import _flatten, _port_name, _port_value, load_jax_params
from pgica_tpu_torch.models.layers import MLP, MultiHeadAttention, rotary_embedding
from pgica_tpu_torch.models.lm import init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.models.presets import get_text_config, get_vision_config
from pgica_tpu_torch.models.vit import VisionEncoder
from pgica_tpu_torch.ops import _kernels
from pgica_tpu_torch.ops.attention import key_padding_bias
from pgica_tpu_torch.ops.flash_attention import HEAD_DIMS
from pgica_tpu_torch.ops.rmsnorm import (
    MAX_PARTS,
    RMSNorm,
    bwd_partition,
    bwd_scratch,
    rms_norm,
    rms_norm_bwd,
    rms_norm_fwd,
)
from pgica_tpu_torch.training.optim import create_optimizer
from pgica_tpu_torch.training.train_step import (
    TrainState,
    make_stage1_train_step,
    make_stage2_train_step,
    stage1_loss_fn,
    stage2_loss_fn,
)

SEQ, IMG, B, PROJ, VOCAB = 10, 32, 3, 16, 261
LR, TOTAL, WARMUP, TEMP, BETA = 1e-3, 10, 2, 0.5, 0.1
RMS_ATOL, RMS_GRAD_RTOL, ROPE_ATOL, LAYER_ATOL, ATOL = 1e-6, 1e-5, 1e-6, 1e-5, 1e-4
RTOL, NORM_RTOL, PARAM_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-6, 1e-3
TINY = dict(vision_model="tiny-vit", text_model="tiny-llama", projection_dim=PROJ, dropout=0.0,
            max_caption_length=SEQ, image_size=IMG)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _mask(rng, lo=2):
    lengths = rng.integers(lo, SEQ + 1, size=B)
    return (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)


def _captions(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
            "caption_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32), "caption_mask": _mask(rng)}


def _pairs(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
            "preferred_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32), "preferred_mask": _mask(rng),
            "rejected_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32), "rejected_mask": _mask(rng)}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _numpy_tree(params):
    return jax.tree.map(np.array, params)


# ---------------------------------------------------------------- RMSNorm against the Pallas kernels


# decode-like and odd row counts at Llama-3-8B's width: the 4-beam requests' 4 rows, the engine's 8 slots, one
# row, and 33 (one past the Pallas kernel's row block)
LLAMA_ROWS = [(1, 4096), (4, 4096), (8, 4096), (33, 4096)]


@pytest.mark.parametrize("shape", [(37, 32), (70, 64), (3, 5, 48)] + LLAMA_ROWS)
def test_rms_norm_forward_matches_the_pallas_kernel(shape):
    rng = np.random.default_rng(sum(shape))
    x, scale = _f32(rng, *shape, scale=2.0), 1 + _f32(rng, shape[-1], scale=0.1)
    want = fused_rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-5, block_r=32, interpret=True)
    got = rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=RMS_ATOL)
    rows = x.size // shape[-1]
    _, want_rstd = _fused_rms_fwd_impl(jnp.asarray(x.reshape(rows, -1)), jnp.asarray(scale), 1e-5, 32, True)
    _, rstd = rms_norm_fwd(torch.from_numpy(x.reshape(rows, -1)), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(want_rstd)[0, :rows], rtol=RMS_GRAD_RTOL)


@pytest.mark.parametrize("shape", [(37, 32), (70, 64)] + LLAMA_ROWS)
def test_rms_norm_gradients_match_the_pallas_kernel(shape):
    rng = np.random.default_rng(7 + shape[0])
    x, scale, dy = _f32(rng, *shape, scale=2.0), 1 + _f32(rng, shape[-1], scale=0.1), _f32(rng, *shape)
    jdx, jdg = jax.grad(lambda a, s: jnp.sum(fused_rmsnorm(a, s, 1e-5, block_r=32, interpret=True) * dy),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    tx, ts = torch.from_numpy(x).requires_grad_(), torch.from_numpy(scale).requires_grad_()
    rms_norm(tx, ts, 1e-5).backward(torch.from_numpy(dy))
    for name, got, want in (("dx", tx.grad, jdx), ("dg", ts.grad, jdg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=RMS_GRAD_RTOL, atol=RMS_GRAD_RTOL * np.abs(want).max(),
                                   err_msg=name)


def test_rms_norm_module_rounds_to_bf16_and_zero_cotangents_add_zero():
    rng = np.random.default_rng(11)
    x, scale = _f32(rng, 2, 7, 32, scale=3.0), 1 + _f32(rng, 32, scale=0.1)
    module = RMSNorm(32, 1e-5, torch.bfloat16)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(scale))
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    want = JaxRMSNorm(dtype=jnp.bfloat16).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    assert got.dtype == torch.bfloat16 and module.weight.dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32), rtol=2.0**-8, atol=0)
    x2 = torch.from_numpy(x.reshape(14, 32))
    w = torch.from_numpy(scale)
    _, rstd = rms_norm_fwd(x2, w, 1e-5)
    dy = torch.from_numpy(_f32(rng, 14, 32))
    dy[3:9] = 0.0
    dx, dg = rms_norm_bwd(x2, w, dy, rstd)
    assert not dx[3:9].any()
    _, dg_zero = rms_norm_bwd(x2, w, torch.zeros_like(dy), rstd)
    assert not dg_zero.any()
    live = torch.cat([torch.arange(3), torch.arange(9, 14)])
    np.testing.assert_allclose(dg.numpy(), rms_norm_bwd(x2[live], w, dy[live], rstd[live])[1].numpy(), rtol=1e-6)


# ---------------------------------------------------------------- the backward kernel's partition and dg order

# (rows, H): Llama's stage-1 and stage-2 blocks (2048), the decode rows, and ragged counts either side of one
# row a block (MAX_PARTS = 114) and of several
PARTITION_SHAPES = [(2048, 4096), (1, 4096), (4, 4096), (8, 4096), (32, 4096), (33, 32), (113, 64), (114, 4096),
                    (115, 4096), (229, 1024), (4099, 4096)]
SUM_TOL = (1e-3, 1e-4)  # chip_smoke.py's (atol, rtol) on dweight
KERNEL_WARPS = 8  # csrc/rmsnorm_bwd.cu: 256 threads a block, the instance every width up to 8,192 bf16 takes


def _kernel_rows(rows):
    """csrc/rmsnorm_bwd.cu's rows of each block, in the order it adds them: b, b + G, b + 2G, ..."""
    n_parts = bwd_partition(rows)
    return [list(range(b, rows, n_parts)) for b in range(n_parts)]


@pytest.mark.parametrize("rows,hidden", PARTITION_SHAPES)
def test_rms_norm_bwd_partition_covers_each_row_once_in_order(rows, hidden):
    blocks = _kernel_rows(rows)
    assert sorted(r for b in blocks for r in b) == list(range(rows))
    assert all(b and b == sorted(b) for b in blocks)  # in order, and no block without a row
    assert len(blocks) <= MAX_PARTS <= 114  # co-resident on an H100 PCIe (114 SMs) at one block an SM
    assert max(len(b) for b in blocks) - min(len(b) for b in blocks) <= 1  # balanced
    # the scratch holds what the kernel writes: one float32 row of H for each block
    scratch = bwd_scratch(rows, hidden, "cpu")
    assert scratch.shape == (len(blocks), hidden) and scratch.dtype == torch.float32 and scratch.is_contiguous()


def _dg_kernel_order(terms):
    """csrc/rmsnorm_bwd.cu's order for dg = sum over rows of ``terms`` (f32): block b adds its rows b, b + G,
    ... in order; then warp w sums the partials w, w + warps, ... and the warps meet in warp order."""
    rows, hidden = terms.shape
    n_parts = bwd_partition(rows)
    partials = torch.zeros(n_parts, hidden)
    for k in range(0, rows, n_parts):  # every block's next row at once
        step = terms[k:k + n_parts]
        partials[:step.shape[0]] += step
    total = torch.zeros(hidden)
    for w in range(KERNEL_WARPS):
        acc = torch.zeros(hidden)
        for p in range(w, n_parts, KERNEL_WARPS):
            acc = acc + partials[p]
        total = total + acc
    return total


def _dg_terms(rng, rows, hidden):
    x, dy = torch.from_numpy(_f32(rng, rows, hidden, scale=3.0)), torch.from_numpy(_f32(rng, rows, hidden))
    _, rstd = rms_norm_fwd(x, torch.ones(hidden), 1e-5)
    return dy, x * rstd[:, None]


def test_rms_norm_dg_in_the_kernels_order_holds_the_sum_bound():
    """At Llama's (2048, 4096), the kernel's order of the dg sum stays within chip_smoke.py's SUM_TOL of the
    float64 sum."""
    dy, xhat = _dg_terms(np.random.default_rng(20), 2048, 4096)
    terms = dy * xhat
    want = terms.double().sum(dim=0)
    np.testing.assert_allclose(_dg_kernel_order(terms).numpy(), want.numpy(), atol=SUM_TOL[0], rtol=SUM_TOL[1])


@pytest.mark.parametrize("rows", [2048, 4, 8, 32, 37, 229])
def test_rms_norm_dg_of_dead_trailing_rows_is_the_dg_without_them(rows):
    """chip_smoke.py's check in the kernel's order: with dy = 0 on the second half of the rows, dg is the bits
    of the call over the first half alone (the partition keeps every live row's place, the dead rows add 0)."""
    dy, xhat = _dg_terms(np.random.default_rng(rows), rows, 64)
    live = rows // 2  # as chip_smoke.py: rows from rows // 2 on are dead
    dead = dy.clone()
    dead[live:] = 0.0
    assert torch.equal(_dg_kernel_order(dead * xhat), _dg_kernel_order(dy[:live] * xhat[:live]))


# ---------------------------------------------------------------- RoPE, GQA attention, SwiGLU


@pytest.mark.parametrize("positions", ["train", "decode"])
def test_rotary_embedding_matches_jax(positions):
    rng = np.random.default_rng(5)
    s = 12 if positions == "train" else 1
    x = _f32(rng, 2, 4, s, 8)
    pos = np.arange(s) if positions == "train" else np.array([37])
    want = jax_rotary_embedding(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    got = rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROPE_ATOL)


def _attention_pair(rng):
    """A JAX GQA + RoPE self-attention (4 query heads, 2 KV heads of 8, no biases) and the port's, bridged."""
    kwargs = dict(hidden_size=32, num_heads=4, num_kv_heads=2, causal=True, use_rope=True, use_bias=False)
    jax_layer = JaxAttention(**kwargs)
    params = jax_layer.init(jax.random.PRNGKey(3), jnp.asarray(_f32(rng, 2, 5, 32)))["params"]
    port = MultiHeadAttention(32, 4, causal=True, num_kv_heads=2, use_bias=False, use_rope=True)
    load_jax_params(port, _numpy_tree(params))
    return jax_layer, params, port


def test_gqa_rope_attention_matches_jax():
    rng = np.random.default_rng(6)
    jax_layer, params, port = _attention_pair(rng)
    x = _f32(rng, 2, 9, 32)
    mask = (np.arange(9)[None, :] < np.array([9, 6])[:, None]).astype(np.int32)
    want, _ = jax_layer.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask)[:, None, None, :])
    with torch.no_grad():
        got = port(torch.from_numpy(x), key_padding_bias(torch.from_numpy(mask)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL)


def test_gqa_rope_attention_with_a_kv_cache_matches_jax():
    """Decode: one token at a time written at positions 0..5 of a cache of n_kv heads."""
    rng = np.random.default_rng(8)
    jax_layer, params, port = _attention_pair(rng)
    cache_len = 7
    jcache = (jnp.zeros((2, 2, cache_len, 8)), jnp.zeros((2, 2, cache_len, 8)))
    pcache = (torch.zeros(2, 2, cache_len, 8), torch.zeros(2, 2, cache_len, 8))
    for t in range(6):
        x = _f32(rng, 2, 1, 32)
        mask = (np.arange(cache_len)[None, :] <= t).astype(np.int32).repeat(2, 0)
        want, jcache = jax_layer.apply({"params": params}, jnp.asarray(x), mask=jnp.asarray(mask)[:, None, None, :],
                                       cache=jcache, position=t)
        with torch.no_grad():
            got = port(torch.from_numpy(x), key_padding_bias(torch.from_numpy(mask)), pcache, t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LAYER_ATOL, err_msg=f"step {t}")
        for name, p, j in zip("kv", pcache, jcache):
            np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=LAYER_ATOL, err_msg=f"{name} cache, step {t}")


def test_swiglu_mlp_matches_jax():
    rng = np.random.default_rng(9)
    x = _f32(rng, 2, 5, 32)
    jax_mlp = JaxMLP(hidden_size=32, intermediate_size=48, kind="swiglu", use_bias=False)
    params = jax_mlp.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    port = MLP(32, 48, "swiglu", use_bias=False)
    load_jax_params(port, _numpy_tree(params))
    assert port.gate_proj.bias is None
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mlp.apply({"params": params}, jnp.asarray(x))),
                               atol=LAYER_ATOL)


# ---------------------------------------------------------------- the SigLIP-style vision tower


def test_siglip_style_vision_tower_matches_jax():
    """tiny-vit with SigLIP's activation (GELU-tanh), LayerNorm eps (1e-6) and an image size that is not a
    multiple of the patch (36 px at patch 8, as 384 px at 14): the VALID patch convolution drops the rest."""
    overrides = dict(hidden_act="gelu", norm_eps=1e-6, image_size=36)
    jax_tower = JaxVisionEncoder(jax_vision_config("tiny-vit", **overrides), projection_dim=PROJ, dropout=0.0)
    images = np.array(jax_prepare_images(jnp.asarray(
        np.random.default_rng(12).integers(0, 256, size=(2, 36, 36, 3), dtype=np.uint8))))
    params = jax_tower.init(jax.random.PRNGKey(2), jnp.asarray(images))["params"]
    port = VisionEncoder(get_vision_config("tiny-vit", **overrides), PROJ, dropout=0.0)
    load_jax_params(port, _numpy_tree(params))
    assert port.backbone.blocks[0].mlp.kind == "gelu" and port.backbone.pre_ln.eps == 1e-6
    want = jax_tower.apply({"params": params}, jnp.asarray(images))
    with torch.no_grad():
        got = port(torch.from_numpy(images))
    for key in ("features", "pooled_output", "embeddings"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)


# ---------------------------------------------------------------- the tiny-llama model


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel(tokenizer=JaxTokenizer(), seed=0, **TINY)


def _port(params, **overrides):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **{**TINY, **overrides})
    port.load_jax_params(_numpy_tree(params))
    return port


def test_bridge_fills_every_llama_leaf_and_raises_on_bad_ones(jax_model):
    port = _port(jax_model.params)
    named = dict(port.module.named_parameters())
    leaves = list(_flatten(_numpy_tree(jax_model.params)))
    assert len(leaves) == len(named)  # load_jax_params raises on a port parameter left unfilled
    for path, value in leaves:
        np.testing.assert_array_equal(named[_port_name(path)].detach().numpy(), _port_value(path, value),
                                      err_msg="/".join(path))
    block = named["caption_decoder.lm.blocks.0.attn.k_proj.weight"]
    assert block.shape == (2 * 8, 32)  # two KV heads of 8
    assert "caption_decoder.lm.wpe.weight" not in named and "caption_decoder.lm.blocks.0.attn.q_proj.bias" not in named
    for edit, error, match in (
            (lambda t: t["caption_decoder"]["lm"]["block_1"].pop("RMSNorm_1"), KeyError, "blocks.1.ln_1"),
            (lambda t: t["text_encoder"]["backbone"]["ln_f"].update(bias=np.zeros(32, np.float32)), KeyError,
             "ln_f/bias"),
            (lambda t: t["caption_decoder"]["lm"]["block_0"]["attn"]["k_proj"].update(
                kernel=np.zeros((32, 4, 8), np.float32)), ValueError, "k_proj")):
        params = _numpy_tree(jax_model.params)
        edit(params)
        with pytest.raises(error, match=match):
            load_jax_params(_port(jax_model.params).module, params)


def test_frozen_copy_keeps_rmsnorm_weights_in_float32(jax_model):
    params = _numpy_tree(jax_model.params)
    params["caption_decoder"]["lm"]["ln_f"]["scale"] += np.float32(1.0 / 3.0)  # not representable in bf16
    port = _port(params)
    ref = frozen_copy(port.module, torch.bfloat16)
    norms = [m for m in ref.modules() if isinstance(m, RMSNorm)]
    assert len(norms) == 2 * (2 * 2 + 1)  # two towers: two per block, and ln_f
    assert all(m.weight.dtype == torch.float32 and not m.weight.requires_grad for m in norms)
    master = port.module.caption_decoder.lm.ln_f.weight
    assert torch.equal(ref.caption_decoder.lm.ln_f.weight, master.to(torch.bfloat16).float())
    assert not torch.equal(ref.caption_decoder.lm.ln_f.weight, master)
    assert ref.caption_decoder.lm.blocks[0].mlp.gate_proj.weight.dtype == torch.bfloat16


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(3).integers(0, 256, size=(2, IMG, IMG, 3), dtype=np.uint8)


def test_text_tower_matches_jax(jax_model):
    port = _port(jax_model.params)
    batch = _captions(4)
    ids, mask = jnp.asarray(batch["caption_ids"]), jnp.asarray(batch["caption_mask"])
    want = jax_model.module.apply({"params": jax_model.params}, ids, mask, method="encode_text")
    with torch.no_grad():
        got = port.module.encode_text(torch.from_numpy(batch["caption_ids"]), torch.from_numpy(batch["caption_mask"]))
    for key in ("hidden_states", "pooled_output", "embeddings"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)


def test_decoder_training_forward_matches_jax(jax_model, images):
    port = _port(jax_model.params)
    batch = _captions(5)
    vis = jax_model.module.apply({"params": jax_model.params}, jax_prepare_images(jnp.asarray(images[:1].repeat(B, 0))),
                                 method="encode_image")["embeddings"]
    want = jax_model.module.apply({"params": jax_model.params}, jnp.asarray(batch["caption_ids"]),
                                  jnp.asarray(batch["caption_mask"]), vis, True, method="decode_train")
    with torch.no_grad():
        got = port.module.decode_train(torch.from_numpy(batch["caption_ids"]), torch.from_numpy(batch["caption_mask"]),
                                       torch.from_numpy(np.array(vis)))
    for key in ("hidden_states", "logits"):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)


def test_decode_prefix_steps_and_caches_match_jax(jax_model, images):
    port = _port(jax_model.params)
    cfg, cache_len = port.module.decoder_config, 9
    emb_j = jax_model.module.apply({"params": jax_model.params}, jax_prepare_images(jnp.asarray(images)),
                                   method="encode_image")["embeddings"]
    emb_p = port.encode_image(images)["embeddings"]

    def mask_at(pos):
        return (np.arange(cache_len)[None, :] <= pos).astype(np.int32).repeat(2, 0)

    caches_j = jax_init_kv_cache(jax_model.module.decoder_config, 2, cache_len, jnp.float32)
    caches_p = init_kv_cache(cfg, 2, cache_len, torch.float32, torch.device("cpu"))
    assert caches_p[0][0].shape == (2, 2, cache_len, 8)  # the cache keeps the two KV heads
    with torch.inference_mode():
        logits_j, caches_j = jax_model.module.apply({"params": jax_model.params}, emb_j, caches_j,
                                                    jnp.asarray(mask_at(0)), method="decode_prefix")
        logits_p, caches_p = port.module.decode_prefix(emb_p, caches_p, torch.from_numpy(mask_at(0)))
        for t in range(4):
            np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=ATOL, err_msg=f"logits {t}")
            for layer, ((kj, vj), (kp, vp)) in enumerate(zip(caches_j, caches_p)):
                np.testing.assert_allclose(kp.numpy(), np.asarray(kj), atol=ATOL, err_msg=f"k{layer}, {t}")
                np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, err_msg=f"v{layer}, {t}")
            tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)[:, None]
            logits_j, caches_j = jax_model.module.apply({"params": jax_model.params}, jnp.asarray(tok), t + 1,
                                                        caches_j, jnp.asarray(mask_at(t + 1)), method="decode_step")
            logits_p, caches_p = port.module.decode_step(torch.from_numpy(tok).long(), t + 1, caches_p,
                                                         torch.from_numpy(mask_at(t + 1)))


@pytest.mark.parametrize("early_stop", [False, True])
def test_greedy_captions_are_token_identical_to_jax(jax_model, images, early_stop):
    port = _port(jax_model.params)
    emb = jax_model.module.apply({"params": jax_model.params}, jax_prepare_images(jnp.asarray(images)),
                                 method="encode_image")["embeddings"]
    tok = jax_model.tokenizer
    want = np.asarray(jax_generate(jax_model.module, jax_model.params, emb, bos_token_id=tok.bos_token_id,
                                   eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, max_length=8,
                                   early_stop=early_stop))
    got = generate(port.module, port.encode_image(images)["embeddings"], eos_token_id=port.tokenizer.eos_token_id,
                   pad_token_id=port.tokenizer.pad_token_id, max_length=8, early_stop=early_stop).numpy()
    np.testing.assert_array_equal(got, want)
    assert port.generate_captions(images, max_length=8, early_stop=early_stop) == jax_model.generate_captions(
        images, max_length=8, early_stop=early_stop)


# ---------------------------------------------------------------- train steps under the trainer's partitions


class Gradients:
    """Each step's gradients on both sides, compared per leaf, and the elements Adam cannot pin down.

    Adam's update is lr * m / (sqrt(v) + eps), so an element whose gradient
    differs between the sides by a relative r moves by up to about lr * r:
    where 4 * lr * r exceeds ``PARAM_ATOL`` it is marked loose and held to
    Adam's bound instead (see tests/test_torch_stage2.py).
    """

    def __init__(self, module):
        self.named = [(n, p) for n, p in module.named_parameters() if p.requires_grad]
        self.loose = {n: np.zeros(p.shape, bool) for n, p in self.named}

    def add(self, port_loss, jax_grads, where):
        got = dict(zip([n for n, _ in self.named], torch.autograd.grad(
            port_loss, [p for _, p in self.named], allow_unused=True)))
        for path, value in _flatten(_numpy_tree(jax_grads)):
            name = _port_name(path)
            if name not in got:
                continue
            want = np.asarray(_port_value(path, value))
            gp = np.zeros_like(want) if got[name] is None else got[name].numpy()
            diff = np.abs(gp - want)
            assert diff.max() <= GRAD_RTOL * np.abs(want).max(), f"{where}: gradient of {name}"
            with np.errstate(divide="ignore", invalid="ignore"):
                self.loose[name] |= 4 * LR * diff / np.abs(want) > PARAM_ATOL  # 0 / 0 is nan: not loose

    def share(self):
        return sum(int(m.sum()) for m in self.loose.values()) / sum(m.size for m in self.loose.values())


def _assert_params_match(module, jax_params, updates, where, loose):
    ref = dict(_port(jax_params).module.named_parameters())
    for name, p in module.named_parameters():
        got, want = p.detach().numpy(), ref[name].detach().numpy()
        held = ~loose[name] if name in loose else np.ones(got.shape, bool)
        np.testing.assert_allclose(got[held], want[held], atol=PARAM_ATOL, err_msg=f"{where}: {name}")
        np.testing.assert_allclose(got[~held], want[~held], atol=2 * LR * updates, err_msg=f"{where}: {name}, loose")


def _optimizers(jax_model, frozen):
    """The trainer's partition: the frozen vision backbone and one frozen tower."""
    jopt = jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, params_for_freezing=jax_model.params,
                                freeze_vision_backbone=True, frozen_prefixes=((frozen,),))
    return jopt, create_optimizer(LR, TOTAL, WARMUP, freeze_vision_backbone=True, frozen_prefixes=(frozen,))


def test_stage1_trajectory_matches_jax(jax_model):
    """Three contrastive updates; the text tower trains, the decoder and the vision backbone are frozen."""
    jopt, popt = _optimizers(jax_model, "caption_decoder")
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jax_model.module, jopt, TEMP, augment=False))
    jgrad = jax.jit(jax.grad(lambda p, batch: jax_stage1_loss_fn(
        p, batch, jax.random.PRNGKey(0), jax_model.module, TEMP, False)[0]))
    port = _port(jax_model.params)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage1_train_step(port.module, popt, TEMP)
    assert not port.module.caption_decoder.lm.ln_f.weight.requires_grad
    norm = port.module.text_encoder.backbone.blocks[1].ln_0.weight
    start = norm.detach().clone()
    grads = Gradients(port.module)
    for i in range(3):
        batch = _captions(20 + i)
        grads.add(stage1_loss_fn(port.module, _torch(batch), None, TEMP)[0], jgrad(jstate.params, _jnp(batch)),
                  f"step {i}")
        jstate, jm = jstep(jstate, _jnp(batch), jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, batch, 0)
        for key in ("loss", "loss_i2t", "loss_t2i", "contrastive_accuracy"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=RTOL, err_msg=f"{key} {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"after step {i}", grads.loose)
    assert not torch.equal(start, norm), "the text tower's RMSNorm weights trained"
    assert pstate.step == int(jstate.step) == 3 and grads.share() < 0.1


def test_stage2_trajectory_matches_jax(jax_model):
    """Three DPO updates against a frozen float32 reference; the decoder trains, the text tower and the
    vision backbone are frozen."""
    jopt, popt = _optimizers(jax_model, "text_encoder")
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jstep = jax.jit(jax_make_stage2_train_step(jax_model.module, jopt, BETA, augment=False))
    jgrad = jax.jit(jax.grad(lambda p, ref, batch: jax_stage2_loss_fn(
        p, ref, batch, jax.random.PRNGKey(0), jax_model.module, BETA, False, False, 0.0, False)[0]))
    jref = jax.tree.map(jnp.array, jax_model.params)
    port = _port(jax_model.params)
    ref = frozen_copy(port.module, torch.float32)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage2_train_step(port.module, popt, BETA)
    assert not port.module.text_encoder.backbone.wte.weight.requires_grad
    norm = port.module.caption_decoder.lm.ln_f.weight
    start = norm.detach().clone()
    grads = Gradients(port.module)
    for i in range(3):
        batch = _pairs(30 + i)
        grads.add(stage2_loss_fn(port.module, ref, _torch(batch), None, BETA, False, False, 0.0)[0],
                  jgrad(jstate.params, jref, _jnp(batch)), f"step {i}")
        jstate, jm = jstep(jstate, jref, _jnp(batch), jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, ref, batch, 0)
        for key in ("loss", "reward_margin", "reward_accuracy", "chosen_reward", "rejected_reward",
                    "policy_chosen_logp", "policy_rejected_logp"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=RTOL, atol=1e-6, err_msg=f"{key} {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"after step {i}", grads.loose)
    assert not torch.equal(start, norm), "the decoder's final RMSNorm trained"
    assert pstate.step == int(jstate.step) == 3 and grads.share() < 0.1


def test_the_slice_head_dims_have_kernel_instances():
    """SigLIP so400m's heads of 72 and Llama-3-8B's of 128 have instances in both flash sources; the
    wrappers refuse a head dim outside ``HEAD_DIMS`` before any launch."""
    siglip = get_vision_config("google/siglip-so400m-patch14-384")
    llama = get_text_config("meta-llama/Meta-Llama-3-8B")
    assert (siglip.hidden_size // siglip.num_heads, llama.head_dim, llama.kv_heads) == (72, 128, 8)
    assert {72, 128} <= set(HEAD_DIMS)
    for source in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        text = (_kernels.CSRC / source).read_text()
        assert all(f"_CASE({d})" in text for d in HEAD_DIMS), source
