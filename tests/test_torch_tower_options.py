"""``model.share_text_tower`` and ``model.freeze_text_backbone`` in the port against the JAX package (CPU, float32).

The JAX model is the tiny preset pair with dropout 0 and the option on; its
parameters (``shared_lm`` for a shared tower) are bridged with
``load_jax_params``. Tolerances as tests/test_torch_train.py and
tests/test_torch_stage2.py hold the full models: embeddings and logits atol
1e-4 (float32 through a few layers), losses and DPO metrics rel 1e-5,
gradient norms rel 1e-4, parameters atol 1e-6 after each stage-1 update
(the key biases, zero-gradient in exact arithmetic, to Adam's own bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.core.precision import cast_floating as jax_cast_floating
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.models import lora as jl
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import make_stage1_train_step as jax_make_stage1_train_step
from pgica_tpu.training.train_step import make_stage2_train_step as jax_make_stage2_train_step
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.lm import init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.training.optim import create_optimizer
from pgica_tpu_torch.training.train_step import (
    TrainState,
    decoder_embedding,
    make_stage1_train_step,
    make_stage2_train_step,
)
from pgica_tpu_torch.utils.config import Config

SEQ, IMG, B, PROJ, VOCAB = 10, 32, 3, 16, 261
LR, TOTAL, WARMUP, TEMP, BETA = 1e-3, 10, 2, 0.5, 0.1
RTOL, ATOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-4, 1e-6
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, dropout=0.0,
            max_caption_length=SEQ, image_size=IMG)
OPTIONS = {"share": dict(share_text_tower=True), "freeze": dict(freeze_text_backbone=True)}


@pytest.fixture(scope="module")
def jax_models():
    return {name: JaxModel(tokenizer=JaxTokenizer(), seed=0, **TINY, **kw) for name, kw in OPTIONS.items()}


def _port(jm, **kw):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY, **kw)
    port.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return port


def _captions(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, SEQ + 1, size=B)
    return {"image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
            "caption_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32),
            "caption_mask": (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)}


def _pairs(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def mask():
        return (np.arange(SEQ)[None, :] < rng.integers(2, SEQ + 1, size=B)[:, None]).astype(np.int32)

    return {"image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
            "preferred_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32), "preferred_mask": mask(),
            "rejected_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32), "rejected_mask": mask()}


def _assert_params_match(module, jax_params, updates, where):
    ref = dict(_port_of(jax_params, module).named_parameters())
    for name, p in module.named_parameters():
        atol = 2 * LR * updates if name.endswith("attn.k_proj.bias") else PARAM_ATOL
        np.testing.assert_allclose(p.detach().numpy(), ref[name].detach().numpy(), atol=atol, err_msg=f"{where}: {name}")


def _port_of(jax_params, like):
    share = hasattr(like, "shared_lm")
    scratch = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", share_text_tower=share, **TINY)
    scratch.load_jax_params(jax.tree.map(np.asarray, jax_params))
    return scratch.module


# ------------------------------------------------------------------ share_text_tower


def test_shared_tower_is_one_lm(jax_models):
    port = _port(jax_models["share"], share_text_tower=True)
    m = port.module
    assert m.text_encoder.backbone is m.caption_decoder.lm is m.shared_lm
    names = [n for n, _ in m.named_parameters()]
    assert not any(n.startswith(("text_encoder.backbone", "caption_decoder.lm")) for n in names)
    assert sorted(m.state_dict()) == sorted(names)
    assert decoder_embedding(m) is m.shared_lm.wte.weight
    ref = frozen_copy(m, torch.bfloat16)
    assert ref.text_encoder.backbone is ref.caption_decoder.lm is ref.shared_lm
    assert ref.shared_lm.wte.weight.dtype == torch.bfloat16
    assert port.num_parameters() == jax_models["share"].num_parameters()


def test_shared_tower_forward_matches_jax(jax_models):
    jm = jax_models["share"]
    port = _port(jm, share_text_tower=True)
    batch = _captions(0)
    want = jm(batch["image"], batch["caption_ids"], batch["caption_mask"], mode="dual")
    with torch.no_grad():
        got = port.module(_prepared(batch["image"]), torch.from_numpy(batch["caption_ids"]),
                          torch.from_numpy(batch["caption_mask"]), mode="dual")
    for key in ("image_embeddings", "text_embeddings", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, err_msg=key)
    # decode: the prefix through the shared LM
    vis = np.random.default_rng(1).normal(size=(B, PROJ)).astype(np.float32)
    mask = (np.arange(4)[None, :] <= 0).astype(np.int32).repeat(B, 0)
    jl0, _ = jm.module.apply({"params": jm.params}, jnp.asarray(vis),
                             jax_init_kv_cache(jm.module.decoder_config, B, 4, jnp.float32), jnp.asarray(mask),
                             method="decode_prefix")
    with torch.no_grad():
        pl0, _ = port.module.decode_prefix(torch.from_numpy(vis), init_kv_cache(
            port.module.decoder_config, B, 4, torch.float32, torch.device("cpu")), torch.from_numpy(mask))
    np.testing.assert_allclose(pl0.numpy(), np.asarray(jl0), atol=ATOL)


def _prepared(images):
    from pgica_tpu_torch.data.augment import prepare_images

    return prepare_images(torch.from_numpy(images))


def _jax_stage1_optimizer(jm, freeze_text):
    return jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, params_for_freezing=jm.params,
                                freeze_vision_backbone=True, freeze_text_backbone=freeze_text,
                                frozen_prefixes=(("caption_decoder",),))


def _port_stage1_optimizer(freeze_text):
    return create_optimizer(LR, TOTAL, WARMUP, freeze_vision_backbone=True,
                            frozen_prefixes=("caption_decoder",) + (("text_encoder.backbone",) if freeze_text else ()))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_stage1_trajectory_matches_jax(jax_models, option):
    """Three stage-1 updates under the JAX trainer's partition; a frozen text backbone stays unchanged."""
    jm = jax_models[option]
    freeze = option == "freeze"
    jopt = _jax_stage1_optimizer(jm, freeze)
    jstate = JaxTrainState.create(jm.params, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jm.module, jopt, TEMP, augment=False))
    port = _port(jm, **OPTIONS[option])
    popt = _port_stage1_optimizer(freeze)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage1_train_step(port.module, popt, TEMP)
    tower = port.module.text_encoder.backbone
    before = {n: p.detach().clone() for n, p in tower.named_parameters()}
    for i in range(3):
        batch = _captions(i)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, batch, 0)
        np.testing.assert_allclose(float(pm["loss"]), float(jm_["loss"]), rtol=RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm_["grad_norm"]), rtol=NORM_RTOL)
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"{option} after step {i}")
    unchanged = all(torch.equal(p, before[n]) for n, p in tower.named_parameters())
    assert unchanged == freeze


def test_freeze_text_backbone_stops_its_gradient(jax_models):
    """The JAX ``stop_gradient``: with the backbone in the optimizer (as LoRA leaves it), its gradient is
    zero and AdamW only decays it, on both sides."""
    jm = jax_models["freeze"]
    jopt = _jax_stage1_optimizer(jm, False)
    jstate = JaxTrainState.create(jm.params, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jm.module, jopt, TEMP, augment=False))
    port = _port(jm, freeze_text_backbone=True)
    popt = _port_stage1_optimizer(False)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage1_train_step(port.module, popt, TEMP)
    for i in range(2):
        batch = _captions(i)
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, batch, 0)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm_["grad_norm"]), rtol=NORM_RTOL)
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"after step {i}")
    w = port.module.text_encoder.backbone.blocks[0].attn.q_proj.weight
    assert w.requires_grad and torch.equal(pstate.opt_state.mu[pstate.opt_state.names.index(
        "text_encoder.backbone.blocks.0.attn.q_proj.weight")], torch.zeros_like(w))


def test_shared_tower_stage2_matches_jax(jax_models):
    """DPO through the shared LM (the fused-CE embedding is the shared ``wte``), the text tower's
    projection frozen as the JAX trainer's stage 2 freezes ``text_encoder``."""
    jm = jax_models["share"]
    jopt = jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, params_for_freezing=jm.params,
                                freeze_vision_backbone=True, frozen_prefixes=(("text_encoder",),))
    jstate = JaxTrainState.create(jm.params, jopt)
    jref = jax_cast_floating(jm.params, jnp.float32)
    jstep = jax.jit(jax_make_stage2_train_step(jm.module, jopt, BETA, augment=False))
    port = _port(jm, share_text_tower=True)
    ref = frozen_copy(port.module, torch.float32)
    popt = create_optimizer(LR, TOTAL, WARMUP, freeze_vision_backbone=True, frozen_prefixes=("text_encoder",))
    pstate = TrainState.create(port.module, popt)
    assert any(n.startswith("shared_lm.") for n in pstate.opt_state.names)
    pstep = make_stage2_train_step(port.module, popt, BETA)
    for i in range(3):
        batch = _pairs(20 + i)
        jstate, jm_ = jstep(jstate, jref, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, ref, batch, 0)
        for key in ("loss", "chosen_reward", "rejected_reward", "policy_chosen_logp", "policy_rejected_logp"):
            np.testing.assert_allclose(float(pm[key]), float(jm_[key]), rtol=RTOL, atol=1e-6, err_msg=f"{key} {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm_["grad_norm"]), rtol=NORM_RTOL)


# ------------------------------------------------------------------ with LoRA and the factories


def test_lora_scope_and_counts_with_the_options(jax_models):
    """LoRA over a shared tower adapts ``shared_lm``; over a frozen backbone it still adapts the backbone (the
    optimizer partition does not freeze adapters, as in the JAX trainer); counts equal JAX's."""
    cfg = jl.normalize_lora_config({"r": 4, "lora_alpha": 8, "target_modules": ["c_attn", "c_proj"]})
    for option, kw in OPTIONS.items():
        jm = JaxModel(tokenizer=JaxTokenizer(), seed=0, lora_config=cfg, **TINY, **kw)
        port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", lora_config=cfg, **TINY,
                                               **kw)
        assert {p: tuple(a.shape) for p, (a, _) in port.lora.items()} == \
            {p: tuple(a.shape) for p, (a, _) in jm.lora.items()}
        assert port.num_parameters() == jm.num_parameters()
        if option == "freeze":
            assert any(p.startswith("text_encoder/backbone") for p in port.lora)


def test_create_model_builds_the_options():
    from pgica_tpu_torch.utils.factories import create_model

    cfg = Config("configs/smoke.yaml")
    cfg.set("model.share_text_tower", True)
    cfg.set("model.freeze_text_backbone", True)
    cfg.set("inference.quantization", "int8_weight_only")
    with pytest.raises(ValueError, match="share_text_tower"):
        create_model(cfg, device="cpu")._decode_module()
    cfg.set("inference.quantization", None)
    model = create_model(cfg, device="cpu")
    assert model.module.text_encoder.freeze_backbone and model.module.shared_lm is model.module.caption_decoder.lm
    assert model.generate_captions(np.zeros((1, 32, 32, 3), np.uint8), max_length=3)
