"""The port's stage 2 (DPO) and stage 0 against the JAX package, on the CPU.

The JAX model is the tiny preset pair (tiny-vit + tiny-gpt2) with dropout 0
and a frozen vision backbone; its parameters are bridged into the port with
``load_jax_params``. On CPU tensors the fused linear-CE wrappers run their
plain versions, and the JAX package runs its own CPU path. Inputs come from
numpy seeds. Tolerances and why:

* losses, reward metrics, log-probs: rel 1e-5 (the JAX package's own
  step-parity bound); summed sequence log-probs of a few tokens also atol
  1e-4 (float32 through a few layers, sums in another order);
* decoder hidden states and logits: atol 1e-4 (as tests/test_torch_models.py);
* gradient norms rel 1e-4 (a sum of squares over every gradient); each
  leaf's gradient within 1e-3 of its largest |g| (see ``GRAD_RTOL``);
* parameters atol 1e-6 after each update (an update moves a parameter by
  about lr = 1e-3), except where Adam cannot pin the update down: elements
  whose gradient differs between the two sides by a relative amount that
  moves Adam's update by more than that (see ``Gradients``), and the leaves
  whose gradient is zero in exact arithmetic (the self-attention key
  biases: a constant added to every key's score of a row leaves its softmax
  unchanged). Those are held to Adam's own bound, |update| <= lr per update;
* the bf16 reference's sequence log-probs: rel 1e-3 (both packages round
  the activations to bf16, 2**-9 relative, but not at the same places; a
  log-prob is an f32 sum of f32 log-softmax terms of logits each moved by a
  fraction of that; measured ~1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgica_tpu.core.precision import cast_floating as jax_cast_floating
from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.ops import losses as jax_losses
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import _policy_pair_logprobs as jax_pair_logprobs
from pgica_tpu.training.train_step import make_stage0_train_step as jax_make_stage0_train_step
from pgica_tpu.training.train_step import make_stage2_eval_step as jax_make_stage2_eval_step
from pgica_tpu.training.train_step import make_stage2_train_step as jax_make_stage2_train_step
from pgica_tpu.training.train_step import stage0_loss_fn as jax_stage0_loss_fn
from pgica_tpu.training.train_step import stage2_loss_fn as jax_stage2_loss_fn
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.convert import _flatten, _port_name, _port_value
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.ops import losses
from pgica_tpu_torch.ops.layernorm import LayerNorm
from pgica_tpu_torch.training.optim import create_optimizer
from pgica_tpu_torch.training.train_step import (
    TrainState,
    _policy_pair_logprobs,
    make_stage0_train_step,
    make_stage2_eval_step,
    make_stage2_train_step,
    stage0_loss_fn,
    stage2_loss_fn,
)

SEQ, IMG, B, PROJ, VOCAB = 10, 32, 3, 16, 261
LR, TOTAL, WARMUP, BETA = 1e-3, 10, 2, 0.1
RTOL, ATOL, NORM_RTOL, PARAM_ATOL, BF16_RTOL = 1e-5, 1e-4, 1e-4, 1e-6, 1e-3
# Gradients: the two sides differ by up to ~4e-4 of a leaf's largest |g| in the attention
# projections q/k (near uniform attention: the softmax backward P * (dP - rowsum(dP * P)) cancels
# terms ~1e4 times larger than its result; the two packages take it in another order), ~2e-6
# elsewhere.
GRAD_RTOL = 1e-3
# Loose elements (see Gradients) are those whose gradient is under ~1% of their leaf's largest:
# about 4-5% of the trained elements in these runs.
LOOSE_SHARE = 0.1
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, dropout=0.0,
            max_caption_length=SEQ, image_size=IMG)
METRICS = ("loss", "reward_margin", "reward_accuracy", "chosen_reward", "rejected_reward")


def _mask(rng, lo=2):
    lengths = rng.integers(lo, SEQ + 1, size=B)
    return (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)


def _pairs(seed: int) -> dict:
    """A preference batch: chosen and rejected captions of their own ids and lengths."""
    rng = np.random.default_rng(seed)
    return {
        "image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
        "preferred_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32),
        "preferred_mask": _mask(rng),
        "rejected_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32),
        "rejected_mask": _mask(rng),
    }


def _captions(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
        "caption_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32),
        "caption_mask": _mask(rng),
    }


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel(tokenizer=JaxTokenizer(), seed=0, **TINY)


def _port(params, **overrides):
    """A port model on the CPU holding the JAX parameter tree ``params``."""
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **{**TINY, **overrides})
    port.load_jax_params(jax.tree.map(np.asarray, params))
    return port


def _assert_params_match(module, jax_params, updates, where, loose=None):
    """Bridge the JAX parameters into a scratch port module and compare by name.

    ``loose`` maps a parameter name to the elements whose update Adam does not
    pin down (see :class:`Gradients`): those are held to Adam's own bound.
    """
    ref = dict(_port(jax_params).module.named_parameters())
    adam_bound = 2 * LR * updates
    for name, p in module.named_parameters():
        got, want = p.detach().numpy(), ref[name].detach().numpy()
        if name.endswith("attn.k_proj.bias"):
            np.testing.assert_allclose(got, want, atol=adam_bound, err_msg=f"{where}: {name}")
            continue
        held = np.ones(got.shape, bool) if loose is None or name not in loose else ~loose[name]
        np.testing.assert_allclose(got[held], want[held], atol=PARAM_ATOL, err_msg=f"{where}: {name}")
        np.testing.assert_allclose(got[~held], want[~held], atol=adam_bound, err_msg=f"{where}: {name}, loose")


class Gradients:
    """Each update's gradients on both sides, compared, and the elements Adam cannot pin down.

    Every trained leaf's gradient (averaged over an update's micro-steps) must
    match JAX's within ``GRAD_RTOL`` of the leaf's largest |g|. Adam's update
    is lr * m / (sqrt(v) + eps), so a relative difference r in an element's
    gradient moves it by up to about lr * r: where 4 * lr * r exceeds
    ``PARAM_ATOL`` in some update, the element is marked loose. The
    self-attention key biases (zero gradient in exact arithmetic) must be ~0
    on both sides.
    """

    def __init__(self, module):
        self.names = [n for n, p in module.named_parameters() if p.requires_grad]
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.sums = {n: [torch.zeros_like(p), torch.zeros_like(p)] for n, p in zip(self.names, self.params)}
        self.loose = {n: np.zeros(p.shape, bool) for n, p in zip(self.names, self.params)}
        self.micro = 0

    def add(self, port_loss, jax_grads, accum: int, where: str) -> None:
        grads = dict(zip(self.names, torch.autograd.grad(port_loss, self.params, allow_unused=True)))
        for path, value in _flatten(jax.tree.map(np.asarray, jax_grads)):
            name = _port_name(path)
            if name in self.sums:
                self.sums[name][1] += torch.from_numpy(np.array(_port_value(path, value)))
                if grads[name] is not None:
                    self.sums[name][0] += grads[name]
        self.micro += 1
        if self.micro % accum:
            return
        for name, (gp, gj) in self.sums.items():
            if name.endswith("attn.k_proj.bias"):
                assert max(float(gp.abs().max()), float(gj.abs().max())) < 1e-8, f"{where}: {name}"
            else:
                diff = (gp - gj).abs() / accum
                scale = float(gj.abs().max()) / accum
                assert float(diff.max()) <= GRAD_RTOL * scale, f"{where}: gradient of {name}"
                rel = diff / (gj.abs() / accum)  # 0/0 (both exactly 0) is nan: not loose
                self.loose[name] |= (4 * LR * rel > PARAM_ATOL).numpy()
            gp.zero_()
            gj.zero_()

    def loose_share(self) -> float:
        return sum(int(m.sum()) for m in self.loose.values()) / sum(m.size for m in self.loose.values())


# ---------------------------------------------------------------- losses


def _logits_case(rng, b=3, s=7, v=29):
    logits = rng.normal(size=(b, s, v)).astype(np.float32)
    ids = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < np.array([7, 3, 1])[:b, None]).astype(np.int32)  # one row: no target
    return logits, ids, mask


@pytest.mark.parametrize("normalized", [False, True])
def test_sequence_logprobs_match_jax(rng, normalized):
    logits, ids, mask = _logits_case(rng)
    want = jax_losses.sequence_logprobs(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask), normalized)
    got = losses.sequence_logprobs(torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(mask),
                                   normalized)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("normalized", [False, True])
def test_sequence_logprobs_from_hidden_match_jax(rng, normalized):
    hidden = rng.normal(size=(3, 7, 16)).astype(np.float32)
    emb = (0.3 * rng.normal(size=(29, 16))).astype(np.float32)
    _, ids, mask = _logits_case(rng)
    args = (jnp.asarray(hidden), jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(mask), normalized)
    want = jax_losses.sequence_logprobs_from_hidden(*args)
    from_logits = jax_losses.sequence_logprobs(jnp.asarray(hidden @ emb.T), *args[2:])
    th, te = torch.from_numpy(hidden).requires_grad_(), torch.from_numpy(emb).requires_grad_()
    got = losses.sequence_logprobs_from_hidden(th, te, torch.from_numpy(ids), torch.from_numpy(mask), normalized)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(from_logits), rtol=RTOL, atol=1e-5)
    # gradients through the fused path's autograd Function
    jdh, jde = jax.grad(lambda h, e: jax_losses.sequence_logprobs_from_hidden(h, e, *args[2:]).sum(),
                        argnums=(0, 1))(*args[:2])
    got.sum().backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jdh), atol=1e-5, err_msg="d hidden")
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jde), atol=1e-5, err_msg="d embedding")
    assert not th.grad[:, -1].any() and not th.grad[2].any(), "positions with no target get no gradient"


def test_sequence_logprobs_from_hidden_refuses_a_mesh():
    with pytest.raises(NotImplementedError, match="parallel slice"):
        losses.sequence_logprobs_from_hidden(torch.zeros(1, 2, 8), torch.zeros(5, 8), torch.zeros(1, 2, dtype=torch.long),
                                             torch.ones(1, 2), mesh=object())


@pytest.mark.parametrize("case", ["reference", "reference_free", "label_smoothing", "no_reference"])
def test_dpo_loss_matches_jax(rng, case):
    pc, pr, rc, rr = (rng.normal(scale=5.0, size=8).astype(np.float32) for _ in range(4))
    kwargs = dict(beta=0.3, label_smoothing=0.2 if case == "label_smoothing" else 0.0,
                  reference_free=case == "reference_free")
    refs = (None, None) if case == "no_reference" else (rc, rr)
    jloss, jm = jax_losses.dpo_loss(jnp.asarray(pc), jnp.asarray(pr),
                                    *(None if r is None else jnp.asarray(r) for r in refs), **kwargs)
    loss, m = losses.dpo_loss(torch.from_numpy(pc), torch.from_numpy(pr),
                              *(None if r is None else torch.from_numpy(r) for r in refs), **kwargs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    assert m.keys() == jm.keys()
    for key in jm:
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=RTOL, atol=1e-7, err_msg=key)


def test_caption_cross_entropy_matches_jax(rng):
    logits, ids, mask = _logits_case(rng)
    want = jax_losses.caption_cross_entropy(jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(mask))
    got = losses.caption_cross_entropy(torch.from_numpy(logits), torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
    empty = losses.caption_cross_entropy(torch.from_numpy(logits), torch.from_numpy(ids), torch.zeros(3, 7))
    assert float(empty) == 0.0  # no valid token: 0, not NaN (the clip to 1 in the denominator)


# ---------------------------------------------------------------- decoder and model forwards


def _vision(jax_model, images):
    return jax_model.module.apply({"params": jax_model.params}, jax_prepare_images(jnp.asarray(images)),
                                  method="encode_image")["embeddings"]


def test_decoder_training_forward_matches_jax(jax_model):
    port = _port(jax_model.params)
    batch = _captions(5)
    vis = _vision(jax_model, batch["image"])
    ref = jax_model.module.apply({"params": jax_model.params}, jnp.asarray(batch["caption_ids"]),
                                 jnp.asarray(batch["caption_mask"]), vis, True, method="decode_train")
    args = (torch.from_numpy(batch["caption_ids"]), torch.from_numpy(batch["caption_mask"]),
            torch.from_numpy(np.array(vis)))
    with torch.no_grad():
        out = port.module.decode_train(*args)
        hidden_only = port.module.decode_train(*args, with_logits=False)
    for key in ("hidden_states", "logits"):
        assert out[key].shape == ref[key].shape
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=ATOL, err_msg=key)
    assert set(hidden_only) == {"hidden_states"}
    assert torch.equal(hidden_only["hidden_states"], out["hidden_states"])


@pytest.mark.parametrize("mode", ["generation", "dual"])
def test_generation_and_dual_forward_match_jax(jax_model, mode):
    port = _port(jax_model.params)
    batch = _captions(6)
    images = jax_prepare_images(jnp.asarray(batch["image"]))
    ids, mask = jnp.asarray(batch["caption_ids"]), jnp.asarray(batch["caption_mask"])
    ref = jax_model.module.apply({"params": jax_model.params}, images, ids, mask, ids, mode=mode)
    tids = torch.from_numpy(batch["caption_ids"])
    with torch.no_grad():
        out = port.module(torch.from_numpy(np.array(images)), tids, torch.from_numpy(batch["caption_mask"]),
                          labels=tids, mode=mode)
        no_labels = port.module(torch.from_numpy(np.array(images)), tids, None, mode=mode)
    assert out.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=RTOL, atol=ATOL, err_msg=key)
    assert "loss" not in no_labels and no_labels["logits"].shape == (B, SEQ, VOCAB)


@pytest.mark.parametrize("subtree", ["cross_attention", "cross_ln", "vision_projection"])
def test_bridge_fills_the_decoder_fusion_and_the_training_forward_uses_it(jax_model, subtree):
    """Perturb one fusion subtree on the JAX side: the bridged port must follow it, and a
    tree without that subtree must not load."""
    params = jax.tree.map(np.array, jax_model.params)
    rng = np.random.default_rng(7)
    params["caption_decoder"][subtree] = jax.tree.map(
        lambda x: (x + rng.normal(scale=0.5, size=x.shape)).astype(x.dtype), params["caption_decoder"][subtree])
    batch = _captions(8)
    vis = _vision(jax_model, batch["image"])
    args = (jnp.asarray(batch["caption_ids"]), jnp.asarray(batch["caption_mask"]), vis, True)
    ref = jax_model.module.apply({"params": params}, *args, method="decode_train")["hidden_states"]
    before = jax_model.module.apply({"params": jax_model.params}, *args, method="decode_train")["hidden_states"]
    assert float(jnp.abs(ref - before).max()) > 1e-2, "the perturbation must show in the JAX forward"
    port = _port(params)
    with torch.no_grad():
        got = port.module.decode_train(torch.from_numpy(batch["caption_ids"]),
                                       torch.from_numpy(batch["caption_mask"]), torch.from_numpy(np.array(vis)))
    np.testing.assert_allclose(got["hidden_states"].numpy(), np.asarray(ref), atol=ATOL)
    del params["caption_decoder"][subtree]
    with pytest.raises(KeyError, match=f"caption_decoder.{subtree}"):
        _port(params)


def test_frozen_copy_casts_freezes_and_keeps_layernorm_in_float32(jax_model):
    port = _port(jax_model.params)
    ref = frozen_copy(port.module, torch.bfloat16)
    masters = dict(port.module.named_parameters())
    for name, p in ref.named_parameters():
        assert not p.requires_grad
        owner = ref.get_submodule(name.rsplit(".", 1)[0])
        assert p.dtype == (torch.float32 if isinstance(owner, LayerNorm) else torch.bfloat16), name
        assert torch.equal(p, masters[name].to(torch.bfloat16).to(p.dtype)), name  # the bf16-rounded values
        assert masters[name].dtype == torch.float32 and masters[name].requires_grad, name  # masters untouched
    assert port._inference_module() is port.module  # float32 serving runs on the masters


# ---------------------------------------------------------------- stage 2 steps


def _jax_optimizer(jax_model, accum):
    return jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, gradient_accumulation_steps=accum,
                                params_for_freezing=jax_model.params, freeze_vision_backbone=True)


def _port_optimizer(accum):
    return create_optimizer(LR, TOTAL, WARMUP, gradient_accumulation_steps=accum, freeze_vision_backbone=True)


@pytest.fixture(scope="module")
def jax_stage2_steps(jax_model):
    """jit-compiled JAX stage-2 steps and loss gradients, built once for the module:
    ``get(accum, reference_free) -> (optimizer, step, grad(params, ref_params, batch))``."""
    cache, grads = {}, {}

    def get(accum, reference_free=False):
        if reference_free not in grads:
            grads[reference_free] = jax.jit(jax.grad(lambda p, ref, batch: jax_stage2_loss_fn(
                p, ref, batch, jax.random.PRNGKey(0), jax_model.module, BETA, reference_free, False, 0.0, False)[0]))
        if (accum, reference_free) not in cache:
            opt = _jax_optimizer(jax_model, accum)
            cache[accum, reference_free] = opt, jax.jit(jax_make_stage2_train_step(
                jax_model.module, opt, BETA, reference_free=reference_free, augment=False))
        return (*cache[accum, reference_free], grads[reference_free])

    return get


@pytest.mark.parametrize("accum,reference_free", [(1, False), (2, False), (1, True)])
def test_stage2_trajectory_matches_jax(jax_model, jax_stage2_steps, accum, reference_free):
    """Three optimizer updates (3 * accum micro-steps) against a frozen float32 reference."""
    jopt, jstep, jgrad = jax_stage2_steps(accum, reference_free)
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jref = None if reference_free else jax.tree.map(jnp.array, jax_model.params)
    port = _port(jax_model.params)
    ref = None if reference_free else frozen_copy(port.module, torch.float32)
    popt = _port_optimizer(accum)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage2_train_step(port.module, popt, BETA, reference_free=reference_free)
    decoder_w = port.module.caption_decoder.lm.wte.weight
    text_w = port.module.text_encoder.backbone.wte.weight
    start = decoder_w.detach().clone(), text_w.detach().clone()
    grads = Gradients(port.module)
    for i in range(3 * accum):
        batch = _pairs(10 + i)
        grads.add(stage2_loss_fn(port.module, ref, _torch(batch), None, BETA, reference_free, False, 0.0)[0],
                  jgrad(jstate.params, jref, _jnp(batch)), accum, f"step {i}")
        jstate, jm = jstep(jstate, jref, _jnp(batch), jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, ref, batch, 0)
        for key in METRICS + ("policy_chosen_logp", "policy_rejected_logp"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=RTOL, atol=1e-6, err_msg=f"{key} {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        assert pm["skipped"] == int(jm["skipped"]) == 0
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"after step {i}", grads.loose)
    assert pstate.step == int(jstate.step) == 3 * accum and grads.loose_share() < LOOSE_SHARE
    assert not torch.equal(start[0], decoder_w), "the decoder's (tied) embedding trained"
    # the text tower never runs in stage 2: zero gradients, but AdamW still decays it
    assert not torch.equal(start[1], text_w) and torch.allclose(start[1], text_w, rtol=1e-4)
    if ref is not None:
        assert all(not p.requires_grad for p in ref.parameters())


def test_stage2_path_never_computes_the_logits(jax_model):
    port = _port(jax_model.params)
    seen = []
    hook = port.module.caption_decoder.lm.register_forward_hook(lambda mod, args, out: seen.append(set(out)))
    popt = _port_optimizer(1)
    make_stage2_train_step(port.module, popt, BETA)(TrainState.create(port.module, popt),
                                                     frozen_copy(port.module, torch.float32), _pairs(1), 0)
    hook.remove()
    assert len(seen) == 2 and all("logits" not in keys for keys in seen)  # policy and reference passes


def test_stage2_eval_step_matches_jax(jax_model):
    batch = _pairs(20)
    port = _port(jax_model.params)
    ref = frozen_copy(port.module, torch.float32)
    want = jax_make_stage2_eval_step(jax_model.module, BETA)(jax_model.params, jax_model.params, _jnp(batch))
    got = make_stage2_eval_step(port.module, BETA)(ref, batch)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL, atol=1e-6, err_msg=key)


def test_bf16_reference_logprobs_match_jax(jax_model):
    """The frozen bf16 reference (as the JAX trainer makes it) on a bf16 module."""
    jm = JaxModel(tokenizer=JaxTokenizer(), seed=0, dtype=jnp.bfloat16, **TINY)
    jparams = jax_cast_floating(jm.params, jnp.bfloat16)
    port = _port(jm.params, dtype=torch.bfloat16)
    ref = frozen_copy(port.module, torch.bfloat16)
    batch = _pairs(30)
    images = jax_prepare_images(jnp.asarray(batch["image"]))
    want = jax_pair_logprobs(jm.module, jparams, images, _jnp(batch))
    with torch.no_grad():
        got = _policy_pair_logprobs(ref, torch.from_numpy(np.array(images)),
                                    {k: torch.from_numpy(v) for k, v in batch.items()}, None, False)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w, dtype=np.float32), rtol=BF16_RTOL)
    assert ref.caption_decoder.lm.wte.weight.dtype == torch.bfloat16


def test_stage2_nan_batch_is_skipped_as_in_jax(jax_model, jax_stage2_steps):
    jopt, jstep, jgrad = jax_stage2_steps(1)
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jref = jax.tree.map(jnp.array, jax_model.params)
    port = _port(jax_model.params)
    ref = frozen_copy(port.module, torch.float32)
    popt = _port_optimizer(1)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage2_train_step(port.module, popt, BETA)
    grads = Gradients(port.module)
    # two clean steps first (the first has lr 0), so the moments are nonzero when the bad batch comes
    for i in range(2):
        grads.add(stage2_loss_fn(port.module, ref, _torch(_pairs(i)), None, BETA, False, False, 0.0)[0],
                  jgrad(jstate.params, jref, _jnp(_pairs(i))), 1, f"step {i}")
        jstate, _ = jstep(jstate, jref, _jnp(_pairs(i)), jax.random.PRNGKey(0))
        pstate, _ = pstep(pstate, ref, _pairs(i), 0)
    params = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    moments = [t.clone() for t in pstate.opt_state.mu + pstate.opt_state.nu]
    count = pstate.opt_state.count

    bad = _pairs(2)
    bad["image"] = (bad["image"] / 255.0).astype(np.float32)
    bad["image"][0, 0, 0, 0] = np.nan
    jstate, jm = jstep(jstate, jref, _jnp(bad), jax.random.PRNGKey(0))
    pstate, pm = pstep(pstate, ref, bad, 0)
    assert int(jstate.skipped) == pstate.skipped == pm["skipped"] == 1
    assert not np.isfinite(float(pm["loss"])) and not np.isfinite(float(jm["loss"]))
    for name, p in port.module.named_parameters():
        assert torch.equal(p, params[name]), name
    for old, new in zip(moments, pstate.opt_state.mu + pstate.opt_state.nu):
        assert torch.equal(old, new)
    assert pstate.opt_state.count == count

    grads.add(stage2_loss_fn(port.module, ref, _torch(_pairs(3)), None, BETA, False, False, 0.0)[0],
              jgrad(jstate.params, jref, _jnp(_pairs(3))), 1, "recovery step")
    jstate, jm = jstep(jstate, jref, _jnp(_pairs(3)), jax.random.PRNGKey(0))
    pstate, pm = pstep(pstate, ref, _pairs(3), 0)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=RTOL)
    _assert_params_match(port.module, jstate.params, pstate.opt_state.count, "after the recovery step", grads.loose)


def test_stage2_unported_options_raise(jax_model):
    port = _port(jax_model.params)
    with pytest.raises(NotImplementedError, match="item 7"):
        make_stage2_train_step(port.module, _port_optimizer(1), BETA, augment=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        make_stage2_train_step(port.module, _port_optimizer(1), BETA, lora=(16.0, 4))
    with pytest.raises(NotImplementedError, match="item 12"):
        make_stage2_eval_step(port.module, BETA, lora=(16.0, 4))


# ---------------------------------------------------------------- stage 0


def test_stage0_trajectory_matches_jax(jax_model):
    """Three caption cross-entropy updates (the decoder warm-up) against JAX ``make_stage0_train_step``."""
    jopt = _jax_optimizer(jax_model, 1)
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jstep = jax.jit(jax_make_stage0_train_step(jax_model.module, jopt, augment=False))
    jgrad = jax.jit(jax.grad(lambda p, batch: jax_stage0_loss_fn(
        p, batch, jax.random.PRNGKey(0), jax_model.module, False)[0]))
    port = _port(jax_model.params)
    popt = _port_optimizer(1)
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage0_train_step(port.module, popt)
    grads = Gradients(port.module)
    for i in range(3):
        batch = _captions(40 + i)
        grads.add(stage0_loss_fn(port.module, _torch(batch), None)[0], jgrad(jstate.params, _jnp(batch)), 1,
                  f"step {i}")
        jstate, jm = jstep(jstate, _jnp(batch), jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, batch, 0)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        _assert_params_match(port.module, jstate.params, pstate.opt_state.count, f"after step {i}", grads.loose)
    assert grads.loose_share() < LOOSE_SHARE
    with pytest.raises(NotImplementedError, match="item 7"):
        make_stage0_train_step(port.module, popt, augment=True)


def test_stage2_optimizer_unfreezes_what_the_stage1_optimizer_froze(jax_model):
    """One module through both stages, as the trainer runs it: stage 1's optimizer freezes the
    decoder (it sits outside the contrastive graph); stage 2's must train it again."""
    port = _port(jax_model.params)
    create_optimizer(LR, TOTAL, WARMUP, freeze_vision_backbone=True, frozen_prefixes=("caption_decoder",)).init(
        port.module)
    assert not port.module.caption_decoder.lm.wte.weight.requires_grad
    popt = _port_optimizer(1)
    pstate = TrainState.create(port.module, popt)
    assert port.module.caption_decoder.lm.wte.weight.requires_grad
    assert not port.module.vision_encoder.backbone.cls_token.requires_grad  # still frozen in stage 2
    step = make_stage2_train_step(port.module, popt, BETA)
    ref = frozen_copy(port.module, torch.float32)
    for i in range(2):  # the first update has lr 0
        pstate, pm = step(pstate, ref, _pairs(50 + i), 0)
    assert float(pm["grad_norm"]) > 0 and not torch.equal(ref.caption_decoder.lm.wte.weight,
                                                          port.module.caption_decoder.lm.wte.weight)
