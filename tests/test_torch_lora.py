"""The port's LoRA (models/lora.py, the LoRA train steps and trainer) against the JAX package (CPU, float32).

Mirrors tests/test_lora.py. The JAX model is the tiny preset pair with
dropout 0; its parameters and its factor dict are bridged into the port
(``load_jax_params(params, lora=...)``), so both packages start from the
same numbers. Tolerances and why:

* factor paths, shapes and counts: equal;
* merged weights: atol 1e-6 (a rank-r product of f32 factors, summed in
  another order, times alpha / r);
* train-step trajectories (dropout 0): losses rel 1e-5, gradient norms rel
  1e-4, each factor's gradient within 1e-3 of its largest |g|, factors atol
  1e-6 after each update except where Adam cannot pin the update down, as
  tests/test_torch_stage2.py holds full fine-tuning (``GRAD_RTOL``, loose
  elements: a relative gradient difference r moves Adam's update by up to
  about lr * r, so where 4 * lr * r exceeds 1e-6 the element is held to
  Adam's own bound, |update| <= lr per update); the base stays bit-unchanged;
* DropConnect: its semantics only (rows of A zeroed or scaled by 1 / keep,
  one mask a step, none in eval), since torch's and JAX's random streams
  differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.models import lora as jl
from pgica_tpu.training.optim import create_optimizer as jax_create_optimizer
from pgica_tpu.training.train_step import TrainState as JaxTrainState
from pgica_tpu.training.train_step import make_stage1_train_step as jax_make_stage1_train_step
from pgica_tpu.training.train_step import make_stage2_train_step as jax_make_stage2_train_step
from pgica_tpu.training.train_step import stage1_loss_fn as jax_stage1_loss_fn
from pgica_tpu.training.train_step import stage2_loss_fn as jax_stage2_loss_fn
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models import lora
from pgica_tpu_torch.models.convert import _flatten, _port_name, _port_value
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.training.checkpoint import CheckpointManager, effective_params
from pgica_tpu_torch.training.optim import create_optimizer
from pgica_tpu_torch.training.train_step import (
    PAIR_KEYS,
    TrainState,
    _adapted,
    _on_device,
    make_stage1_eval_step,
    make_stage1_train_step,
    make_stage2_train_step,
    stage1_loss_fn,
    stage2_loss_fn,
)

SEQ, IMG, B, PROJ, VOCAB = 10, 32, 3, 16, 261
LR, TOTAL, WARMUP, TEMP, BETA = 1e-3, 10, 2, 0.5, 0.1
RANK, ALPHA = 4, 8.0
LOSS_RTOL, NORM_RTOL, PARAM_ATOL, MERGE_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-6, 1e-6, 1e-3
CONFIG = jl.normalize_lora_config({"r": RANK, "lora_alpha": ALPHA, "target_modules": ["c_attn", "c_proj"],
                                   "lora_dropout": 0.0})
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, dropout=0.0,
            max_caption_length=SEQ, image_size=IMG)


@pytest.fixture(scope="module")
def jax_model():
    return JaxModel(tokenizer=JaxTokenizer(), seed=0, lora_config=CONFIG, **TINY)


@pytest.fixture(scope="module")
def jax_lora(jax_model):
    """The JAX model's factors with B made nonzero, so that every factor has a gradient from the first step."""
    rng = np.random.default_rng(1)
    return {p: (np.asarray(a), rng.normal(scale=0.05, size=b.shape).astype(np.float32))
            for p, (a, b) in jax_model.lora.items()}


def _port(jax_model, jax_lora=None, **overrides):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", lora_config=CONFIG,
                                           **{**TINY, **overrides})
    port.load_jax_params(jax.tree.map(np.asarray, jax_model.params), jax_lora)
    return port


def _port_tree(jax_params) -> dict:
    """A JAX parameter tree by port name, in the port's layout."""
    return {_port_name(path): torch.from_numpy(np.array(_port_value(path, v))) for path, v in _flatten(jax_params)}


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


class Factors:
    """Each update's factor gradients on both sides, and the factors after it (see the module docstring)."""

    def __init__(self, port_lora):
        self.loose = {(p, i): np.zeros(t.shape, bool) for p, ab in port_lora.items() for i, t in enumerate(ab)}
        self.updates = 0

    def grads(self, port_lora, port_loss, jax_grads, where):
        tensors = [t for p in sorted(port_lora) for t in port_lora[p]]
        grads = dict(zip([(p, i) for p in sorted(port_lora) for i in range(2)],
                         torch.autograd.grad(port_loss, tensors, allow_unused=True)))
        for (p, i), g in grads.items():  # None: a tower the loss does not run (JAX: zeros)
            gp, gj = np.zeros(port_lora[p][i].shape) if g is None else g.numpy(), np.asarray(jax_grads[p][i])
            diff = np.abs(gp - gj)
            assert diff.max() <= GRAD_RTOL * np.abs(gj).max(), f"{where}: gradient of {p} {'AB'[i]}"
            with np.errstate(divide="ignore", invalid="ignore"):
                self.loose[p, i] |= 4 * LR * diff / np.abs(gj) > PARAM_ATOL  # 0/0 is nan: not loose
        self.updates += 1

    def match(self, port_lora, jax_lora, where):
        assert set(port_lora) == set(jax_lora)
        for p, ab in port_lora.items():
            for i, t in enumerate(ab):
                got, want, loose = t.detach().numpy(), np.asarray(jax_lora[p][i]), self.loose[p, i]
                np.testing.assert_allclose(got[~loose], want[~loose], atol=PARAM_ATOL, err_msg=f"{where}: {p}")
                np.testing.assert_allclose(got[loose], want[loose], atol=2 * LR * self.updates,
                                           err_msg=f"{where}: {p}, loose")

    def loose_share(self):
        return sum(int(m.sum()) for m in self.loose.values()) / sum(m.size for m in self.loose.values())


# ------------------------------------------------------------------ factors


@pytest.mark.parametrize("share", [False, True])
def test_factor_paths_shapes_and_count_match_jax(share):
    jm = JaxModel(tokenizer=JaxTokenizer(), seed=0, lora_config=CONFIG, share_text_tower=share, **TINY)
    port = _port(jm, share_text_tower=share)
    want = {p: (tuple(a.shape), tuple(b.shape)) for p, (a, b) in jm.lora.items()}
    assert {p: (tuple(a.shape), tuple(b.shape)) for p, (a, b) in port.lora.items()} == want
    out_proj = [p for p in want if p.endswith("out_proj/kernel")]
    heads, hidden = 2, 32  # tiny-gpt2: out_proj's JAX kernel is (H, D, hidden)
    assert out_proj and all(want[p] == ((heads, RANK), (RANK, hidden // heads * hidden)) for p in out_proj)
    assert not any(p.startswith("vision_encoder") or "cross_attention" in p for p in want)
    assert any(p.startswith("shared_lm") for p in want) == share
    assert lora.count_lora_params(port.lora) == jl.count_lora_params(jm.lora)
    counts, jcounts = port.num_parameters(), jm.num_parameters()
    assert counts == jcounts


def test_default_targets_and_path_names(jax_model):
    port = _port(jax_model)
    paths = lora.target_shapes(port.module)
    assert paths and all(p.endswith(("q_proj/kernel", "v_proj/kernel")) for p in paths)
    want = jl.init_lora(jax_model.params, jax.random.PRNGKey(0), rank=RANK)
    assert set(paths) == set(want)
    for p in paths:
        assert lora.jax_path(lora.port_name(p)) == p
        assert port.module.get_parameter(lora.port_name(p)).dim() == 2


def test_zero_init_is_identity(jax_model):
    port = _port(jax_model)
    params = dict(port.module.named_parameters())
    merged = lora.apply_lora(params, port.lora, ALPHA, RANK)
    assert all(torch.equal(merged[n], p) for n, p in params.items())
    assert all(not torch.any(b) for _, b in port.lora.values())


def test_merged_weights_match_jax(jax_model, jax_lora):
    port = _port(jax_model, jax_lora)
    want = _port_tree(jl.apply_lora(jax_model.params, {p: tuple(map(jnp.asarray, ab)) for p, ab in jax_lora.items()},
                                    alpha=ALPHA, rank=RANK))
    got = lora.apply_lora(dict(port.module.named_parameters()), port.lora, ALPHA, RANK)
    moved = 0
    for name, w in got.items():
        np.testing.assert_allclose(w.detach().numpy(), want[name].numpy(), atol=MERGE_ATOL, err_msg=name)
        moved += not torch.equal(w, port.module.get_parameter(name))
    assert moved == len(jax_lora)


def test_normalize_lora_config_translates_peft_names():
    for raw in ({"r": 4, "lora_alpha": 8, "target_modules": ["c_attn", "c_proj"], "lora_dropout": 0.0},
                {"r": 16, "lora_alpha": 32, "target_modules": ["c_attn", "c_proj", "c_fc"], "lora_dropout": 0.1},
                {"rank": 2, "alpha": 4.0, "target_modules": ["q_proj", "c_fc"]}, None, {}):
        assert lora.normalize_lora_config(raw) == jl.normalize_lora_config(raw)
    assert set(CONFIG["targets"]) == {"q_proj", "k_proj", "v_proj", "out_proj", "fc_out"}


def test_tree_roundtrip(jax_model, jax_lora):
    port = _port(jax_model, jax_lora)
    tree = lora.lora_to_tree(port.lora)
    assert set(tree) == set(jl.lora_to_tree(jax_lora))
    back = lora.lora_from_tree(tree)
    assert set(back) == set(port.lora)
    assert all(torch.equal(back[p][0], a) and torch.equal(back[p][1], b) for p, (a, b) in port.lora.items())


# ------------------------------------------------------------------ train steps


def _jax_optimizer():
    return jax_create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP)


def _port_optimizer():
    return create_optimizer(LR, TOTAL, WARMUP)


def test_stage1_lora_trajectory_matches_jax(jax_model, jax_lora):
    jopt = _jax_optimizer()
    jstate = JaxTrainState.create({p: tuple(map(jnp.asarray, ab)) for p, ab in jax_lora.items()}, jopt)
    jstep = jax.jit(jax_make_stage1_train_step(jax_model.module, jopt, TEMP, augment=False, lora=(ALPHA, RANK)))
    port = _port(jax_model, jax_lora)
    base = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    popt = _port_optimizer()
    pstate = TrainState.create(port.module, popt, lora=port.lora)
    pstep = make_stage1_train_step(port.module, popt, TEMP, lora=(ALPHA, RANK))
    factors = Factors(port.lora)
    for i in range(3):
        batch = _captions(i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads = jax.grad(lambda lp: jax_stage1_loss_fn(lp, jbatch, jax.random.PRNGKey(0), jax_model.module, TEMP,
                                                        False, None, jax_model.params, (ALPHA, RANK))[0])(jstate.params)
        with torch.enable_grad(), _adapted(port.module, port.lora, (ALPHA, RANK)):
            loss = stage1_loss_fn(port.module, _on_device(batch, torch.device("cpu")), None, TEMP)[0]
            factors.grads(port.lora, loss, jgrads, f"step {i}")
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(0), jax_model.params)
        pstate, pm = pstep(pstate, batch, 0)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        factors.match(port.lora, jstate.params, f"after step {i}")
    assert factors.loose_share() < 0.1
    assert pstate.opt_state.names == [f"{p}/{x}" for p in sorted(port.lora) for x in "ab"]
    assert any(not torch.equal(port.lora[p][1], torch.from_numpy(jax_lora[p][1])) for p in jax_lora)
    for n, p in port.module.named_parameters():
        assert torch.equal(p, base[n]), f"the base moved: {n}"
        assert not p.requires_grad


def test_stage2_lora_trajectory_matches_jax(jax_model, jax_lora):
    jopt = _jax_optimizer()
    jlora = {p: tuple(map(jnp.asarray, ab)) for p, ab in jax_lora.items()}
    jstate = JaxTrainState.create(jlora, jopt)
    jref = jl.apply_lora(jax_model.params, jlora, alpha=ALPHA, rank=RANK)  # the JAX trainer's reference
    jstep = jax.jit(jax_make_stage2_train_step(jax_model.module, jopt, BETA, augment=False, lora=(ALPHA, RANK)))
    port = _port(jax_model, jax_lora)
    base = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    ref = frozen_copy(port.module, torch.float32)
    with torch.no_grad():
        for n, w in lora.merged_targets(port.module, port.lora, ALPHA, RANK).items():
            ref.get_parameter(n).copy_(w)
    popt = _port_optimizer()
    pstate = TrainState.create(port.module, popt, lora=port.lora)
    pstep = make_stage2_train_step(port.module, popt, BETA, lora=(ALPHA, RANK))
    factors = Factors(port.lora)
    for i in range(3):
        batch = _pairs(10 + i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jgrads = jax.grad(lambda lp: jax_stage2_loss_fn(lp, jref, jbatch, jax.random.PRNGKey(0), jax_model.module,
                                                        BETA, False, False, 0.0, False, jax_model.params,
                                                        (ALPHA, RANK))[0])(jstate.params)
        with torch.enable_grad(), _adapted(port.module, port.lora, (ALPHA, RANK)):
            loss = stage2_loss_fn(port.module, ref, _on_device(batch, torch.device("cpu"), PAIR_KEYS), None, BETA,
                                  False, False, 0.0)[0]
            factors.grads(port.lora, loss, jgrads, f"step {i}")
        jstate, jm = jstep(jstate, jref, jbatch, jax.random.PRNGKey(0), jax_model.params)
        pstate, pm = pstep(pstate, ref, batch, 0)
        for key in ("loss", "chosen_reward", "rejected_reward", "policy_chosen_logp", "policy_rejected_logp"):
            np.testing.assert_allclose(float(pm[key]), float(jm[key]), rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"{key} step {i}")
        np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_RTOL)
        factors.match(port.lora, jstate.params, f"after step {i}")
    assert factors.loose_share() < 0.1
    for n, p in port.module.named_parameters():
        assert torch.equal(p, base[n]), f"the base moved: {n}"


# ------------------------------------------------------------------ DropConnect


def test_dropout_masks_rows_of_a_with_inverted_scaling(jax_model, jax_lora):
    port = _port(jax_model, jax_lora)
    path = next(p for p in sorted(port.lora) if p.endswith("q_proj/kernel"))  # 32 rows of A
    sub = {path: port.lora[path]}
    params = dict(port.module.named_parameters())
    name = lora.port_name(path)
    plain = lora.apply_lora(params, sub, ALPHA, RANK)[name] - params[name]
    dropped = lora.apply_lora(params, sub, ALPHA, RANK, 0.5, torch.Generator().manual_seed(3))[name] - params[name]
    fan_in = sub[path][0].shape[0]
    # JAX rows of A are the kernel's leading dim: fan_in rows of the (fan_in, -1) delta
    rows_plain = plain.T.reshape(fan_in, -1).abs().sum(1)
    rows_drop = dropped.T.reshape(fan_in, -1).abs().sum(1)
    zeroed = rows_drop == 0
    assert zeroed.any() and (~zeroed).any()
    torch.testing.assert_close(rows_drop[~zeroed], 2.0 * rows_plain[~zeroed], rtol=1e-5, atol=0)
    # no generator (eval): no mask
    assert torch.equal(lora.apply_lora(params, sub, ALPHA, RANK, 0.5)[name], plain + params[name])


def test_dropout_one_mask_a_step_none_in_eval(jax_model, jax_lora):
    port = _port(jax_model, jax_lora)
    batch = _captions(0)
    losses, eval_losses = {}, {}
    for dropout in (0.0, 0.5):
        module = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", lora_config=CONFIG,
                                                 **TINY)
        module.load_jax_params(jax.tree.map(np.asarray, jax_model.params), jax_lora)
        opt = create_optimizer(0.0, TOTAL, WARMUP)  # lr 0: the factors stay, only the masks change
        state = TrainState.create(module.module, opt, lora=module.lora)
        step = make_stage1_train_step(module.module, opt, TEMP, lora=(ALPHA, RANK, dropout))
        losses[dropout] = [float(step(state, batch, 0)[1]["loss"]) for _ in range(2)]
        eval_losses[dropout] = float(make_stage1_eval_step(module.module, TEMP, lora=(ALPHA, RANK, dropout),
                                                           adapters=module.lora)(batch)["loss"])
    assert eval_losses[0.5] == eval_losses[0.0] == pytest.approx(losses[0.0][0], rel=1e-6)
    assert losses[0.0][0] == losses[0.0][1]
    assert losses[0.5][0] != losses[0.0][0] and losses[0.5][0] != losses[0.5][1]  # resampled each step
    gen = torch.Generator().manual_seed(0)
    masks = lora.dropout_masks(port.lora, 0.5, gen)
    assert all(m.shape == (port.lora[p][0].shape[0], 1) and set(m.unique().tolist()) <= {0.0, 2.0}
               for p, m in masks.items())


# ------------------------------------------------------------------ the trainer


def test_trainer_on_lora_config_checkpoints_and_folds(tmp_path):
    """configs/smoke.yaml's tiny model with configs/lora.yaml's adapters through both stages: the base stays
    bit-unchanged until the fold, the adapters move, the checkpoint's effective params equal the folded
    masters, and the reload through the CLIs' restore gives the same."""
    from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import (
        create_loaders_with_fallback,
        create_model,
        create_processors,
        create_tokenizer,
        restore_params,
    )

    raw = yaml.safe_load(open("configs/smoke.yaml"))
    raw["model"]["lora_config"] = yaml.safe_load(open("configs/lora.yaml"))["model"]["lora_config"]
    raw["training"]["load_best_model_at_end"] = False
    raw["paths"] = {**raw.get("paths", {}), "output_dir": str(tmp_path / "out"),
                    "checkpoint_dir": str(tmp_path / "ckpt"), "log_dir": str(tmp_path / "logs")}
    cfg = Config(config_dict=raw)
    tok = create_tokenizer(cfg)
    model = create_model(cfg, tok, device="cpu")
    assert model.lora_config == jl.normalize_lora_config(raw["model"]["lora_config"])
    base = {n: p.detach().clone() for n, p in model.module.named_parameters()}
    start = {p: (a.clone(), b.clone()) for p, (a, b) in model.lora.items()}
    ip, tp = create_processors(cfg, tok)
    train, val, _ = create_loaders_with_fallback(cfg, ip, tp, kind="conceptual")
    ptrain, pval, _ = create_loaders_with_fallback(cfg, ip, tp, kind="ultrafeedback")
    trainer = PreferenceGuidedTrainer(model, cfg, train_loader=train, val_loader=val, preference_train_loader=ptrain,
                                      preference_val_loader=pval, max_steps_per_epoch=2)
    trainer.train_stage1()
    adapters = {p: (a.clone(), b.clone()) for p, (a, b) in model.lora.items()}
    trainer.train_stage2()
    assert all(torch.equal(p, base[n]) for n, p in model.module.named_parameters()), "the base moved"
    assert any(not torch.equal(adapters[p][1], b) for p, (_, b) in model.lora.items())
    assert any(not torch.equal(start[p][1], b) for p, (_, b) in model.lora.items())
    final = {p: (a.clone(), b.clone()) for p, (a, b) in model.lora.items()}
    trainer._fold_lora()
    assert model.lora is None and model.num_parameters()["trainable"] < model.num_parameters()["total"]
    payload = CheckpointManager(tmp_path / "ckpt").restore("checkpoint_stage2_epoch0")
    assert payload["meta"]["lora_config"]["rank"] == 16 and payload["opt_state"]["names"][0].endswith("/a")
    assert all(torch.equal(payload["params"][n], base[n]) for n in base)
    for p, (a, b) in lora.lora_from_tree(payload["lora"]).items():
        assert torch.equal(a, final[p][0]) and torch.equal(b, final[p][1])
    merged = effective_params(payload)
    for n, p in model.module.named_parameters():
        assert torch.equal(merged[n], p), n
    reloaded = create_model(cfg, tok, device="cpu")
    restore_params(reloaded, tmp_path / "ckpt" / "checkpoint_stage2_epoch0")
    assert all(torch.equal(p, q) for p, q in zip(reloaded.module.parameters(), model.module.parameters()))
