"""The port's stage-1 training against the JAX package, on the CPU (float32).

The JAX model is the tiny preset pair (tiny-vit + tiny-gpt2) with dropout
0, frozen vision backbone; its parameters are bridged into the port with
``load_jax_params``. Both packages then take the same stage-1 steps on the
same numpy-seeded batches (augmentation off) with the same optimizer chain,
and the losses, gradient norms and every parameter are compared after each
step. Tolerances and why: losses rel 1e-5 (the JAX package's own
step-parity bound, tests/test_step_parity.py); gradient norms rel 1e-4
(a sum of squares over every gradient); parameters atol 1e-6 (an update
moves a parameter by about lr = 1e-3; the two sides' gradients differ in
the last bits). One exception: the key projections' biases, whose gradient
is zero in exact arithmetic (a constant added to every key's score of a row
leaves its softmax unchanged), so both sides feed Adam rounding noise and
only Adam's own bound holds, |update| <= lr per update.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.ops.dropout import fast_dropout as jax_fast_dropout
from pgica_tpu.ops.losses import ntxent_loss as jax_ntxent
from pgica_tpu.training import packing as jax_packing
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.optim import warmup_cosine_schedule as jax_schedule
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import make_stage1_train_step as jax_make_stage1_train_step
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
from pgica_tpu_torch.ops.dropout import FastDropout, fast_dropout, keep_threshold
from pgica_tpu_torch.ops.losses import ntxent_loss
from pgica_tpu_torch.training import packing
from pgica_tpu_torch.training.optim import create_optimizer, warmup_cosine_schedule
from pgica_tpu_torch.training.train_step import TrainState, make_stage1_eval_step, make_stage1_train_step

SEQ, IMG, B, PROJ = 10, 32, 4, 16
LR, TOTAL, WARMUP, TEMP = 1e-3, 10, 2, 0.5
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, dropout=0.0,
            max_caption_length=SEQ, image_size=IMG)


def _batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, SEQ + 1, size=B)
    return {
        "image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
        "caption_ids": rng.integers(0, 261, size=(B, SEQ)).astype(np.int32),
        "caption_mask": (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel(tokenizer=JaxTokenizer(), seed=0, **TINY)


def _port(jax_model):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY)
    port.load_jax_params(jax.tree.map(np.asarray, jax_model.params))
    return port


def _jax_optimizer(jax_model, accum):
    return jax_create_optimizer(
        LR, total_steps=TOTAL, warmup_steps=WARMUP, gradient_accumulation_steps=accum,
        params_for_freezing=jax_model.params, freeze_vision_backbone=True,
        frozen_prefixes=(("caption_decoder",),),
    )


def _port_optimizer(accum):
    return create_optimizer(LR, TOTAL, WARMUP, gradient_accumulation_steps=accum,
                            freeze_vision_backbone=True, frozen_prefixes=("caption_decoder",))


def _assert_params_match(module, jax_params, updates, where):
    """Bridge the JAX parameters into a scratch port module and compare by name."""
    scratch = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY)
    scratch.load_jax_params(jax.tree.map(np.asarray, jax_params))
    ref = dict(scratch.module.named_parameters())
    for name, p in module.named_parameters():
        atol = 2 * LR * updates if name.endswith("attn.k_proj.bias") else PARAM_ATOL
        np.testing.assert_allclose(p.detach().numpy(), ref[name].detach().numpy(), atol=atol,
                                   err_msg=f"{where}: {name}")


@pytest.mark.parametrize("accum", [1, 2])
def test_stage1_trajectory_matches_jax(jax_model, accum):
    """Three optimizer updates (3 * accum micro-steps), each on its own batch."""
    jopt = _jax_optimizer(jax_model, accum)
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jax_model.module, jopt, TEMP, augment=False))
    port = _port(jax_model)
    popt = _port_optimizer(accum)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage1_train_step(port.module, popt, TEMP)
    moved = False
    for i in range(3 * accum):
        batch = _batch(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        before = port.module.text_encoder.projection.fc1.weight.detach().clone()
        pstate, pm = pstep(pstate, batch, 0)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL, err_msg=f"step {i}")
        for key in ("loss_i2t", "loss_t2i", "contrastive_accuracy"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=LOSS_RTOL, err_msg=f"{key} {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"after step {i}")
        moved |= not torch.equal(before, port.module.text_encoder.projection.fc1.weight)
    assert moved, "no step changed the trained parameters"
    assert pstate.step == int(jstate.step) == 3 * accum and pstate.skipped == int(jstate.skipped) == 0
    frozen = port.module.vision_encoder.backbone.cls_token
    np.testing.assert_array_equal(frozen.detach().numpy(),
                                  np.asarray(jax_model.params["vision_encoder"]["backbone"]["cls_token"]))


def test_nan_batch_is_skipped_as_in_jax(jax_model):
    jopt = _jax_optimizer(jax_model, 1)
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jax_model.module, jopt, TEMP, augment=False))
    port = _port(jax_model)
    popt = _port_optimizer(1)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage1_train_step(port.module, popt, TEMP)
    # one clean step first, so the moments are nonzero when the bad batch comes
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(0).items()}, jax.random.PRNGKey(0))
    pstate, _ = pstep(pstate, _batch(0), 0)
    params = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    moments = [t.clone() for t in pstate.opt_state.mu + pstate.opt_state.nu]
    count = pstate.opt_state.count

    bad = _batch(1)
    bad["image"] = (bad["image"] / 255.0).astype(np.float32)
    bad["image"][0, 0, 0, 0] = np.nan
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in bad.items()}, jax.random.PRNGKey(0))
    pstate, pm = pstep(pstate, bad, 0)
    assert int(jstate.skipped) == pstate.skipped == pm["skipped"] == 1
    assert not np.isfinite(float(pm["loss"]))
    for name, p in port.module.named_parameters():
        assert torch.equal(p, params[name]), name
    for old, new in zip(moments, pstate.opt_state.mu + pstate.opt_state.nu):
        assert torch.equal(old, new)
    assert pstate.opt_state.count == count

    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(2).items()}, jax.random.PRNGKey(0))
    pstate, pm = pstep(pstate, _batch(2), 0)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    assert pstate.skipped == int(jstate.skipped) == 1
    _assert_params_match(port.module, jstate.params, pstate.opt_state.count, "after the recovery step")


def test_eval_step_matches_the_train_forward(jax_model):
    port = _port(jax_model)
    metrics = make_stage1_eval_step(port.module, TEMP)(_batch(3))
    popt = _port_optimizer(1)
    _, pm = make_stage1_train_step(port.module, popt, TEMP)(TrainState.create(port.module, popt), _batch(3), 0)
    assert float(metrics["loss"]) == pytest.approx(float(pm["loss"]), rel=1e-6)  # dropout 0: the same forward


def test_unported_options_raise(jax_model):
    port = _port(jax_model)
    with pytest.raises(NotImplementedError, match="item 7"):
        make_stage1_train_step(port.module, _port_optimizer(1), TEMP, augment=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        make_stage1_train_step(port.module, _port_optimizer(1), TEMP, lora=(16.0, 4))
    with pytest.raises(NotImplementedError):
        ntxent_loss(torch.zeros(2, 4), torch.zeros(2, 4), axis_name="data")


# ---------------------------------------------------------------- optimizer pieces


@pytest.mark.parametrize("warmup,total", [(10, 100), (2, 10), (50, 20)])
def test_schedule_matches_optax(warmup, total):
    port, ref = warmup_cosine_schedule(LR, warmup, total), jax_schedule(LR, warmup, total)
    assert port(0) == 0.0
    for count in range(0, total + 5):
        assert port(count) == pytest.approx(float(ref(count)), rel=1e-6, abs=1e-12), count


def test_clip_and_adamw_match_optax(rng):
    """One AdamW update of two leaves, above and below the clip norm, against optax."""
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32), "b": rng.normal(size=5).astype(np.float32)}
    for scale in (0.01, 10.0):  # global norm below and above max_grad_norm = 1
        grads = {k: (scale * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
        jopt = jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=1)
        jstate = jopt.init(params)
        for _ in range(2):  # the first update has lr 0
            upd, jstate = jopt.update(grads, jstate, params)
            jparams = optax.apply_updates(params, upd)
        module = torch.nn.Module()
        for k, v in params.items():
            module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
        popt = create_optimizer(LR, TOTAL, 1)
        state = popt.init(module)
        for _ in range(2):
            popt.update([torch.from_numpy(grads[n]) for n in state.names], state)
        for n, p in zip(state.names, state.params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------- losses, dropout, packing


def test_ntxent_matches_jax(rng):
    img, txt = rng.normal(size=(6, 8)).astype(np.float32), rng.normal(size=(6, 8)).astype(np.float32)
    for normalized in (False, True):
        if normalized:
            img, txt = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (img, txt))
        loss, metrics = ntxent_loss(torch.from_numpy(img), torch.from_numpy(txt), 0.07, normalized=normalized)
        jloss, jmetrics = jax_ntxent(jnp.asarray(img), jnp.asarray(txt), 0.07, normalized=normalized)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        for key, value in jmetrics.items():
            np.testing.assert_allclose(float(metrics[key]), float(value), rtol=1e-6, err_msg=key)


def test_dropout_identity_at_rate_zero_and_when_deterministic(rng):
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    assert FastDropout(0.0)(x, gen) is x
    assert FastDropout(0.1)(x, None) is x
    assert fast_dropout(x, 0.0, gen) is x
    assert not fast_dropout(x, 1.0, gen).any()


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.003])
def test_dropout_scale_has_exact_expectation(rate):
    t = keep_threshold(rate)
    assert t == min(max(int(round((1.0 - rate) * 256)), 1), 255)  # the JAX quantization
    assert (t / 256) * (256.0 / t) == 1.0
    x = torch.ones(200_000)
    out = fast_dropout(x, rate, torch.Generator().manual_seed(1))
    ref = np.asarray(jax_fast_dropout(jax.random.PRNGKey(1), jnp.ones(1000), rate))
    np.testing.assert_array_equal(np.unique(out.numpy()), np.unique(ref))  # {0, 256 / t}
    kept = float((out != 0).float().mean())
    assert abs(kept - t / 256) < 5 * (t / 256 * (1 - t / 256) / x.numel()) ** 0.5 + 1e-9


def test_packing_is_a_copy_of_the_jax_module(rng):
    for n in (16, 32, 100, 128, 129):
        assert packing.default_buckets(n) == jax_packing.default_buckets(n)
    buckets = packing.default_buckets(128)
    for trial in range(20):
        lengths = rng.integers(0, 129, size=5)
        mask = (np.arange(128)[None, :] < lengths[:, None]).astype(np.int32)
        if trial % 4 == 3:
            mask[0, rng.integers(0, 128)] = 1  # an interior hole pattern
        batch = {"image": np.zeros((5, 2, 2, 3), np.uint8), "caption_ids": rng.integers(0, 9, size=(5, 128)),
                 "caption_mask": mask}
        for multiple_of in (1, 3):
            got = packing.bucket_batch(batch, buckets, multiple_of)
            want = jax_packing.bucket_batch(batch, buckets, multiple_of)
            assert got.keys() == want.keys()
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert packing.pick_bucket(40, buckets) == jax_packing.pick_bucket(40, buckets) == 64
