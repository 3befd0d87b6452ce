"""The graphed train step (training/graphs.py) and the update on the device, on the CPU.

First the graphed step's body, run over its static buffers as the card's
replays run it, against the eager step of the same stage from the same
weights, bit for bit: the parameters, Adam's moments, the accumulator, the
update count, the micro-step and the skip counter after every step, and the
metrics, for stages 0, 1 and 2 and LoRA. On the CPU there is nothing to
capture, so this holds what the graphed step adds around the body: the
static buffers and their copies, the augmentation's draws copied in, the
re-seeded generators, the keys (a bucket change), and the accumulation's
variant chosen on the host with the device's micro-step read only where it
may be the k-th. The cases turn on
dropout 0.1, augmentation and activation checkpointing, and take NaN
batches, one inside an accumulation window and one on the micro-step that
would update.

Then a skip inside an accumulation window against the JAX package: the
port's stage-1 step at k = 2 with a NaN batch at the second micro-step
against ``make_stage1_train_step`` under optax ``MultiSteps``, at
tests/test_torch_train.py's tolerances (loss rel 1e-5, gradient norm rel
1e-4, parameters atol 1e-6 with the key-bias exception) and
tests/test_torch_trainer.py's rule for the elements Adam does not pin down
(fewer than 2% beyond 1e-6, every one within Adam's bound of 2 lr an
update: an element whose gradient is near 0 moves by up to lr on the last
bits of that gradient), the skip leaving the moments and the accumulator
exactly as they were on both sides. Last,
the learning rate and Adam's bias corrections computed on the device from
the count tensor against optax's, at counts 0, warmup, total and beyond:
the rate at rel 1e-6 (test_torch_train.py's schedule bound: a float32 cosine
on another library), the bias corrections at rel 2e-6 (optax raises b to
an int32 count by repeated squaring, the port takes float32 ``pow``: a few
ulps apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.optim import warmup_cosine_schedule as jax_schedule
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import make_stage1_train_step as jax_make_stage1_train_step
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.lora import normalize_lora_config
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.training.graphs import GraphedTrainStep
from pgica_tpu_torch.training.optim import bias_corrections, create_optimizer, warmup_cosine_schedule
from pgica_tpu_torch.training.train_step import (
    TrainState,
    make_stage0_train_step,
    make_stage1_train_step,
    make_stage2_train_step,
)

SEQ, IMG, B, PROJ, VOCAB = 10, 32, 3, 16, 261
LR, TOTAL, WARMUP, TEMP, BETA = 1e-3, 10, 2, 0.5, 0.1
LOSS_RTOL, NORM_RTOL, PARAM_ATOL, LOOSE_SHARE = 1e-5, 1e-4, 1e-6, 0.02
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, max_caption_length=SEQ,
            image_size=IMG)
LORA = normalize_lora_config({"r": 4, "lora_alpha": 8.0, "target_modules": ["c_attn", "c_proj"],
                              "lora_dropout": 0.1})
WIDTHS = (10, 6, 6, 10, 6, 10)  # two buckets: the keys change between steps


def _images(rng, nan: bool) -> np.ndarray:
    """Normalized float images (a NaN batch needs floats; every step keeps one dtype, so one key a width); a
    NaN batch's first image is NaN throughout, so that no crop or rotation leaves it out."""
    images = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    if nan:
        images[0] = np.nan
    return images


def _mask(rng, width: int) -> np.ndarray:
    return (np.arange(width)[None, :] < rng.integers(2, width + 1, size=B)[:, None]).astype(np.int32)


def _captions(i: int, nan: bool = False) -> dict:
    rng, width = np.random.default_rng(i), WIDTHS[i % len(WIDTHS)]
    return {"image": _images(rng, nan), "caption_ids": rng.integers(0, VOCAB, size=(B, width)).astype(np.int32),
            "caption_mask": _mask(rng, width)}


def _pairs(i: int, nan: bool = False) -> dict:
    rng, width = np.random.default_rng(100 + i), WIDTHS[i % len(WIDTHS)]
    return {"image": _images(rng, nan),
            "preferred_ids": rng.integers(0, VOCAB, size=(B, width)).astype(np.int32), "preferred_mask": _mask(rng, width),
            "rejected_ids": rng.integers(0, VOCAB, size=(B, width)).astype(np.int32), "rejected_mask": _mask(rng, width)}


def _model(lora: bool):
    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=0, dropout=0.1,
                                            remat=True, lora_config=LORA if lora else None, **TINY)
    if lora:  # B made nonzero, so that every factor has a gradient from the first step
        gen = torch.Generator().manual_seed(1)
        for _, b in model.lora.values():
            b.data.copy_(0.05 * torch.randn(b.shape, generator=gen))
    return model


def _snapshot(state: TrainState) -> dict:
    o = state.opt_state
    out = {f"param:{n}": p.detach().clone() for n, p in state.module.named_parameters()}
    for key in ("params", "mu", "nu") + (("acc",) if o.acc is not None else ()):
        out.update({f"{key}:{n}": t.detach().clone() for n, t in zip(o.names, getattr(o, key))})
    out.update(count=o.count_t.clone(), mini_step=o.mini_step_t.clone(), skipped=state.skipped_t.clone())
    return out


def _assert_same(got: dict, want: dict, where: str) -> None:
    assert got.keys() == want.keys(), where
    for k in want:
        assert torch.equal(got[k], want[k]), f"{where}: {k}"


# (stage, LoRA, accumulation, the micro-steps fed a NaN batch)
CASES = {
    "stage0": (0, False, 1, (2,)),
    "stage1": (1, False, 1, (3,)),
    "stage1-accumulation-4": (1, False, 4, (2, 4)),  # mini-step 2 of the first window, then its update micro-step
    "stage2": (2, False, 1, (2,)),
    "lora-stage2-accumulation-2": (2, True, 2, (1,)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_body_is_the_eager_step_bit_for_bit(case):
    stage, lora, accum, nans = CASES[case]
    frozen = ("caption_decoder",) if stage == 1 else ("text_encoder",)
    runs = {}
    for graphed in (False, True):
        model = _model(lora)
        opt = create_optimizer(LR, TOTAL, WARMUP, gradient_accumulation_steps=accum,
                               freeze_vision_backbone=not lora, frozen_prefixes=() if lora else frozen)
        state = TrainState.create(model.module, opt, model.lora)
        spec = (model.lora_config["alpha"], model.lora_config["rank"], model.lora_config["dropout"]) if lora else None
        if stage == 0:
            step = make_stage0_train_step(model.module, opt, augment=True)
        elif stage == 1:
            step = make_stage1_train_step(model.module, opt, TEMP, augment=True, lora=spec)
        else:
            step = make_stage2_train_step(model.module, opt, beta=BETA, augment=True, lora=spec)
            ref = frozen_copy(model.module, torch.float32)
        if graphed:
            step = GraphedTrainStep(step)
        snaps, metrics = [], []
        for i in range(len(WIDTHS)):
            batch = (_pairs if stage == 2 else _captions)(i, nan=i in nans)
            state, m = step(state, ref, batch, 7) if stage == 2 else step(state, batch, 7)
            snaps.append(_snapshot(state))
            metrics.append({k: float(v) for k, v in m.items()})
        runs[graphed] = (snaps, metrics, state, step)
    (eager, em, estate, _), (graph, gm, gstate, gstep) = runs[False], runs[True]
    for i, (want, got) in enumerate(zip(eager, graph)):
        _assert_same(got, want, f"{case} step {i}")
        assert gm[i].keys() == em[i].keys()
        np.testing.assert_array_equal([gm[i][k] for k in sorted(gm[i])], [em[i][k] for k in sorted(em[i])])
    assert gstate.step == estate.step == len(WIDTHS) and gstate.skipped == estate.skipped == len(nans)
    assert all(not np.isfinite(em[i]["loss"]) for i in nans)
    moved = [k for k in eager[0] if k.startswith("mu:") and not torch.equal(eager[-1][k], eager[0][k])]
    assert moved and estate.opt_state.count > 0, "no update reached the moments"
    widths = {key[2][1][1] for key in gstep.graphs}  # (due, image, ids, ...): each (name, shape, dtype)
    assert widths == set(WIDTHS), gstep.graphs.keys()
    assert {key[0] for key in gstep.graphs} == ({True} if accum == 1 else {False, True})


def test_accumulation_reads_the_micro_step_only_where_it_may_be_due():
    """k = 4: the host reads the device's micro-step before a micro-step its bound cannot rule out, and
    a skip on the update micro-step keeps the next one due."""
    model = _model(False)
    opt = create_optimizer(LR, TOTAL, WARMUP, gradient_accumulation_steps=4, freeze_vision_backbone=True,
                           frozen_prefixes=("caption_decoder",))
    state = TrainState.create(model.module, opt)
    step = GraphedTrainStep(make_stage1_train_step(model.module, opt, TEMP))
    seen = []
    for i, nan in enumerate((False, False, False, True, False, False)):
        before = state.opt_state.mini_step_bound
        state, _ = step(state, _captions(i, nan), 0)
        seen.append((before, state.opt_state.mini_step, state.opt_state.count))
    # bounds before each step: unknown (read), 1, 2, 3 (read: due, NaN), 3 (read: due again), 3 (read: 0)
    assert [s[0] for s in seen] == [None, 1, 2, 3, 3, 3]
    assert [(s[1], s[2]) for s in seen] == [(1, 0), (2, 0), (3, 0), (3, 0), (0, 1), (1, 1)]


# ---------------------------------------------------------------- against JAX


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel(tokenizer=JaxTokenizer(), seed=0, dropout=0.0, **TINY)


def _jax_captions(i: int, nan: bool = False) -> dict:
    rng = np.random.default_rng(i)
    return {"image": _images(rng, nan), "caption_ids": rng.integers(0, VOCAB, size=(B, SEQ)).astype(np.int32),
            "caption_mask": _mask(rng, SEQ)}


def test_skip_inside_an_accumulation_window_matches_jax(jax_model):
    jopt = jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, gradient_accumulation_steps=2,
                                params_for_freezing=jax_model.params, freeze_vision_backbone=True,
                                frozen_prefixes=(("caption_decoder",),))
    jstate = JaxTrainState.create(jax_model.params, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jax_model.module, jopt, TEMP, augment=False))
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", dropout=0.0, **TINY)
    port.load_jax_params(jax.tree.map(np.asarray, jax_model.params))
    popt = create_optimizer(LR, TOTAL, WARMUP, gradient_accumulation_steps=2, freeze_vision_backbone=True,
                            frozen_prefixes=("caption_decoder",))
    pstate = TrainState.create(port.module, popt)
    pstep = make_stage1_train_step(port.module, popt, TEMP)
    scratch = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", dropout=0.0, **TINY)
    for i in range(5):  # micro-steps: clean, NaN (the window's second: its update), clean, clean, clean
        nan = i == 1
        batch = _jax_captions(i, nan)
        before = [t.clone() for t in pstate.opt_state.mu + pstate.opt_state.nu + pstate.opt_state.acc]
        jbefore = jax.tree.leaves(jstate.opt_state)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
        pstate, pm = pstep(pstate, batch, 0)
        assert int(jstate.skipped) == pstate.skipped == int(pm["skipped"]) == int(i >= 1), i
        assert pstate.opt_state.mini_step == int(jstate.opt_state.mini_step), i
        if nan:
            after = pstate.opt_state.mu + pstate.opt_state.nu + pstate.opt_state.acc
            assert all(torch.equal(a, b) for a, b in zip(before, after))
            assert all(np.array_equal(a, b) for a, b in zip(jbefore, jax.tree.leaves(jstate.opt_state)))
            assert not np.isfinite(float(pm["loss"]))
            continue
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        scratch.load_jax_params(jax.tree.map(np.asarray, jstate.params))
        want = dict(scratch.module.named_parameters())
        bound = 2 * LR * pstate.opt_state.count  # Adam's: at most lr an update, each side
        loose = total = 0
        for name, p in port.module.named_parameters():
            got, exp = p.detach().numpy(), want[name].detach().numpy()
            np.testing.assert_allclose(got, exp, atol=bound if name.endswith("attn.k_proj.bias") else max(bound, PARAM_ATOL),
                                       err_msg=f"step {i}: {name}")
            if not name.endswith("attn.k_proj.bias"):
                loose += int((np.abs(got - exp) > PARAM_ATOL).sum())
                total += got.size
        assert loose / total < LOOSE_SHARE, f"step {i}: {loose} of {total} elements beyond {PARAM_ATOL}"
    assert pstate.opt_state.count == 2 and pstate.step == 5


@pytest.mark.parametrize("warmup,total", [(10, 100), (2, 10)])
def test_device_schedule_and_bias_corrections_match_optax(warmup, total):
    port, ref = warmup_cosine_schedule(LR, warmup, total), jax_schedule(LR, warmup, total)
    counts = torch.tensor([0, 1, warmup, (warmup + total) // 2, total, total + 5], dtype=torch.int32)
    lr = port(counts)
    assert lr.dtype == torch.float32 and float(lr[0]) == 0.0
    np.testing.assert_allclose(lr.numpy(), [float(ref(int(c))) for c in counts], rtol=1e-6, atol=1e-12)
    assert [port(int(c)) for c in counts] == lr.tolist()  # the host form is the same computation
    bc1, bc2 = bias_corrections(counts)
    for b, got in ((0.9, bc1), (0.999, bc2)):
        inv = optax.tree_utils.tree_bias_correction(jnp.ones(counts.shape), b, jnp.asarray(counts.numpy() + 1))
        np.testing.assert_allclose(got.numpy(), 1.0 / np.asarray(inv, np.float64), rtol=2e-6)
