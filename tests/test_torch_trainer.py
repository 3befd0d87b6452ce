"""The port's trainer and ``train`` CLI, on the CPU.

First against the JAX package's ``PreferenceGuidedTrainer``: the tiny
presets with dropout 0, the same dummy data (``create_loaders_with_fallback``),
the JAX weights bridged with ``load_jax_params``, stage 1 then stage 2 with
gradient accumulation 2, one epoch each. Augmentation is replaced by the
identity on both sides, in this test only: the two packages draw from
different generators, so augmented images cannot match (the ops are held to
JAX op by op in tests/test_torch_augment.py). The stage-2 reference is kept
in float32 here (``reference_dtype``); the bf16 reference's log-probs are held
in tests/test_torch_stage2.py. Tolerances, as tests/test_torch_train.py and
test_torch_stage2.py: every logged train loss rel 1e-5, validation losses
rel 1e-5; parameters atol 1e-6, except the self-attention key biases and a
share of elements below ``LOOSE_SHARE`` that Adam does not pin down (held
to Adam's bound, 2 lr a update).

Then the port alone, mirroring tests/test_training.py:235-500: checkpoint
round trip, a mid-epoch autosave resume (dropout and augmentation on)
that reproduces the uninterrupted run bit for bit, the epoch checkpoint
resuming the next epoch, the early-stopping counter, stage 2 disabled,
the text tower dropped for stage 2 and merged back, and the parallel
settings and LoRA raising; then the CLI, a dry run and a two-step run.
"""

import jax
import numpy as np
import pytest
import torch
import yaml

from pgica_tpu.training import train_step as jax_train_step
from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
from pgica_tpu.utils import factories as jfactories
from pgica_tpu.utils.config import Config as JaxConfig
from pgica_tpu_torch.scripts import train as cli
from pgica_tpu_torch.training import train_step
from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
from pgica_tpu_torch.utils import factories
from pgica_tpu_torch.utils.config import Config

from conftest import make_config_dict

LOSS_RTOL, PARAM_ATOL, LOOSE_SHARE = 1e-5, 1e-6, 0.02
LR = 1e-3


def _config_dict(tmp_path, name, **overrides):
    cfg = make_config_dict(**{
        "model.dropout": 0.0, "model.projection_dim": 16, "data.dummy_samples": 32,
        "training.stage1.gradient_accumulation_steps": 2, "training.stage2.gradient_accumulation_steps": 2,
        "training.stage2.learning_rate": LR, "training.stage2.reference_dtype": "float32",
        "training.save_steps": 0, "training.load_best_model_at_end": False,
        "paths.output_dir": str(tmp_path / name / "out"), "paths.checkpoint_dir": str(tmp_path / name / "ckpt"),
        "paths.log_dir": str(tmp_path / name / "logs"),
    })
    for path, value in overrides.items():
        node = cfg
        *keys, last = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return cfg


def _port_trainer(cfg_dict, jax_params=None, **kw):
    cfg = Config(config_dict=cfg_dict)
    tok = factories.create_tokenizer(cfg)
    model = factories.create_model(cfg, tok, device="cpu")
    if jax_params is not None:
        model.load_jax_params(jax_params)
    procs = factories.create_processors(cfg, tok)
    s1 = factories.create_loaders_with_fallback(cfg, *procs, kind="conceptual")
    s2 = factories.create_loaders_with_fallback(cfg, *procs, kind="ultrafeedback")
    return PreferenceGuidedTrainer(model, cfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                                   preference_val_loader=s2[1], **kw)


def _record_losses(trainer):
    """(stage, step) -> loss of every logged train step (logging_steps is 1)."""
    seen = {}
    log = trainer._log_metrics

    def capture(metrics, step, prefix="train"):
        if prefix.endswith("/train"):
            seen[(prefix, step)] = float(metrics["loss"])
        return log(metrics, step, prefix)

    trainer._log_metrics = capture
    return seen


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("parity")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_step, "augment_batch", lambda key, images, enabled=True: images)
    mp.setattr(train_step, "augment_batch", lambda images, generator=None, enabled=True, params=None: images)
    try:
        cfg = _config_dict(tmp_path, "jax")
        jcfg = JaxConfig(config_dict=cfg)
        jtok = jfactories.create_tokenizer(jcfg)
        jmodel = jfactories.create_model(jcfg, jtok)
        params = jax.tree.map(np.array, jmodel.params)
        procs = jfactories.create_processors(jcfg, jtok)
        s1 = jfactories.create_loaders_with_fallback(jcfg, *procs, kind="conceptual")
        s2 = jfactories.create_loaders_with_fallback(jcfg, *procs, kind="ultrafeedback")
        jt = JaxTrainer(jmodel, jcfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                        preference_val_loader=s2[1])
        jlosses = _record_losses(jt)
        jt.train()
        pt = _port_trainer(_config_dict(tmp_path, "port"), params)
        plosses = _record_losses(pt)
        pt.train()
    finally:
        mp.undo()
    return dict(jax=jt, port=pt, jlosses=jlosses, plosses=plosses)


def test_trainer_follows_the_jax_trainer_over_both_stages(both_runs):
    jt, pt = both_runs["jax"], both_runs["port"]
    jl, pl = both_runs["jlosses"], both_runs["plosses"]
    assert jl.keys() == pl.keys() and len(pl) == 16  # 8 micro-steps a stage, 4 updates each
    for key in jl:
        np.testing.assert_allclose(pl[key], jl[key], rtol=LOSS_RTOL, err_msg=str(key))
    for stage in ("stage1", "stage2"):
        (jr,), (pr,) = jt.history[stage], pt.history[stage]
        np.testing.assert_allclose(pr["train_loss"], jr["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(pr["val_loss"], jr["val_loss"], rtol=LOSS_RTOL)
    assert pt.global_step == jt.global_step == 16
    ref = factories.create_model(pt.config, device="cpu")
    ref.load_jax_params(jax.tree.map(np.asarray, jt.model.params))
    want = dict(ref.module.named_parameters())
    loose = total = 0
    for name, p in pt.model.module.named_parameters():
        got, exp = p.detach().numpy(), want[name].detach().numpy()
        np.testing.assert_allclose(got, exp, atol=2 * LR * 8, err_msg=name)  # Adam's bound over 8 updates
        if not name.endswith("attn.k_proj.bias"):
            loose += int((np.abs(got - exp) > PARAM_ATOL).sum())
            total += got.size
    assert loose / total < LOOSE_SHARE, f"{loose} of {total} elements beyond {PARAM_ATOL}"


def test_trainer_writes_the_jax_artifacts(both_runs):
    jt, pt = both_runs["jax"], both_runs["port"]
    for name in ("checkpoint_stage1_epoch0", "best_model_stage1", "checkpoint_stage2_epoch0", "best_model_stage2",
                 "stage2_reference"):
        assert (pt.checkpoints.checkpoint_dir / name / "meta.json").exists(), name
        assert (jt.checkpoints.checkpoint_dir / name).exists(), name
    import json

    port, ref = (json.loads((t.output_dir / "results_summary.json").read_text()) for t in (pt, jt))
    assert port.keys() == ref.keys() and port["total_steps"] == ref["total_steps"]
    meta = pt.checkpoints.restore("checkpoint_stage2_epoch0")["meta"]
    assert (meta["stage"], meta["epoch"], meta["global_step"]) == (2, 0, 16)


# ------------------------------------------------------------------ the port alone


def _small(tmp_path, name, **overrides):
    base = {"model.dropout": 0.1, "data.dummy_samples": 16, "training.stage1.num_epochs": 2,
            "training.logging_steps": 100}
    return _config_dict(tmp_path, name, **{**base, **overrides})


def _state(trainer):
    module = trainer.model.module
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def test_checkpoint_round_trip(tmp_path):
    trainer = _port_trainer(_small(tmp_path, "rt", **{"training.stage1.num_epochs": 1}))
    trainer.train_stage1()
    before = _state(trainer)
    with torch.no_grad():
        for p in trainer.model.module.parameters():
            p.zero_()
    meta = trainer.load_checkpoint("best_model_stage1")
    after = _state(trainer)
    assert meta["stage"] == 1 and all(torch.equal(before[k], after[k]) for k in before)
    payload = trainer.checkpoints.restore("checkpoint_stage1_epoch0")
    assert payload["opt_state"]["count"] == 2 and payload["opt_state"]["acc"] is None
    assert trainer.checkpoints.saves and all(s["bytes"] > 0 for s in trainer.checkpoints.saves)


def test_mid_epoch_autosave_resume_reproduces_the_run(tmp_path):
    """Dropout and augmentation on, accumulation 2; the autosave at step 5 is mid-epoch (epoch 1,
    step 1) and mid-accumulation. The resumed run must end with the same bits."""
    full = _port_trainer(_small(tmp_path, "full", **{"training.save_steps": 5}))
    full.train_stage1()
    full.checkpoints.wait()
    auto = full.checkpoints.checkpoint_dir / "autosave_stage1"
    meta = full.checkpoints.restore(auto)["meta"]
    assert (meta["global_step"], meta["epoch"], meta["step_in_epoch"]) == (5, 1, 1)
    assert full.checkpoints.restore(auto)["opt_state"]["mini_step"] == 1
    resumed = _port_trainer(_small(tmp_path, "resumed"))
    resumed.load_checkpoint(auto)
    assert resumed.global_step == 5
    resumed.train_stage1()
    assert resumed.global_step == 8 and resumed.current_epoch == 1
    want, got = _state(full), _state(resumed)
    assert all(torch.equal(want[k], got[k]) for k in want)
    a = full.checkpoints.restore("checkpoint_stage1_epoch1")["opt_state"]
    b = resumed.checkpoints.restore("checkpoint_stage1_epoch1")["opt_state"]
    assert a["count"] == b["count"] == 4
    assert all(torch.equal(a[m][n], b[m][n]) for m in ("mu", "nu") for n in a["names"])


def test_epoch_checkpoint_resumes_the_next_epoch(tmp_path):
    trainer = _port_trainer(_small(tmp_path, "a"))
    trainer.train_stage1()
    again = _port_trainer(_small(tmp_path, "b"))
    again.load_checkpoint(trainer.checkpoints.checkpoint_dir / "checkpoint_stage1_epoch0")
    again.train_stage1()
    assert again.global_step == 4 + 4 and len(again.history["stage1"]) == 1


def test_early_stopping_counter_and_stage2_disabled(tmp_path):
    trainer = _port_trainer(_small(tmp_path, "es"))
    trainer.best_val_loss[1] = 0.1
    assert trainer._check_early_stopping(1, 0.5, 0) == 1
    assert trainer._check_early_stopping(1, 0.5, 1) == 2
    assert trainer._check_early_stopping(1, 0.05, 2) == 0
    trainer.config.set("training.stage2.num_epochs", 0)
    assert trainer.train_stage2().get("skipped") is True


def test_drop_unused_tower_is_loss_identical_and_merged_back(tmp_path):
    runs = {}
    for drop in (False, True):
        trainer = _port_trainer(_small(tmp_path, f"drop{drop}", **{"training.stage2.drop_unused_tower": drop,
                                                                   "model.dropout": 0.0}))
        tower = {k: v.clone() for k, v in trainer.model.module.text_encoder.state_dict().items()}
        trainer.train_stage2()
        runs[drop] = trainer
        for k, v in trainer.model.module.text_encoder.state_dict().items():
            assert torch.equal(v, tower[k]) and v.device.type == "cpu", k
        assert trainer._dropped_tower is None
        saved = trainer.checkpoints.restore("checkpoint_stage2_epoch0")["params"]
        assert all(torch.equal(saved[f"text_encoder.{k}"], tower[k]) for k in tower)
    for key in ("train_loss", "val_loss"):
        assert [r[key] for r in runs[True].history["stage2"]] == [r[key] for r in runs[False].history["stage2"]]


def test_parallel_settings_and_lora_raise(tmp_path):
    """ZeRO without a data axis > 1 raises JAX's ValueError as a stage starts (ZeRO on a mesh:
    tests/test_torch_parallel_trainer.py); a config asking for tensor or context parallelism builds a
    trainer (one process: the mesh is the caller's; the ranks' runs are in
    tests/test_torch_parallel_trainer.py), and a trainer given a mesh with a ``model`` axis of two ranks cuts
    its model to this rank's half; LoRA is ported (tests/test_torch_lora.py): its config builds a trainer."""
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.parallel.sharding import sharded_bytes, tp_axis

    for key, message in (("mesh.zero1", "mesh.zero1 requires a device mesh with data > 1"),
                         ("mesh.zero3", r"mesh.zero3 requires a device mesh with data\*fsdp > 1")):
        trainer = _port_trainer(_small(tmp_path, "z", **{key: True}))
        with pytest.raises(ValueError, match=message):
            trainer.train_stage1()
    for key in ("mesh.seq", "mesh.model"):
        cfg = Config(config_dict=_small(tmp_path, "p", **{key: 2}))
        trainer = PreferenceGuidedTrainer(
            factories.create_model(Config(config_dict=_small(tmp_path, "m")), device="cpu"), cfg)
        assert trainer.mesh is None and tp_axis(trainer.model.module) is None
    cfg = Config(config_dict=_small(tmp_path, "l", **{"model.lora_config": {"r": 4}}))
    trainer = PreferenceGuidedTrainer(factories.create_model(cfg, device="cpu"), cfg)
    assert trainer._lora_static == (32.0, 4, 0.0)
    cfg = Config(config_dict=_small(tmp_path, "m"))
    trainer = PreferenceGuidedTrainer(factories.create_model(cfg, device="cpu"), cfg,
                                      mesh=MeshContext(data=1, model=2, world_size=2, rank=0))
    local, whole = sharded_bytes(trainer.model.module)
    assert tp_axis(trainer.model.module) == "model" and 0 < local and 2 * local == whole


def test_nan_skipped_steps_stay_out_of_the_epoch_mean(tmp_path):
    trainer = _port_trainer(_small(tmp_path, "nan", **{"training.stage1.num_epochs": 1}))
    trainer.train_loader.dataset.images[0] = np.nan
    result = trainer.train_stage1()
    assert np.isfinite(result["history"][0]["train_loss"])


def test_cli_dry_run_and_a_two_step_run(tmp_path):
    cfg = _small(tmp_path, "cli", **{"training.stage1.num_epochs": 1, "hardware.gradient_checkpointing": True,
                                     "training.stage1.gradient_accumulation_steps": 1})
    path = tmp_path / "cli.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert cli.main(["--config", str(path), "--device", "cpu", "--dry-run"]) == 0
    out = tmp_path / "cli_out"
    trainer = cli.run(["--config", str(path), "--device", "cpu", "--max-steps", "3", "--output-dir", str(out),
                       "--profile-dir", str(tmp_path / "prof")])
    assert trainer.global_step == 6 and (out / "results.json").exists() and (out / "config_snapshot.yaml").exists()
    assert (tmp_path / "prof" / "stage1.json").exists() and trainer.profiles[2]["steps"] == 1
    assert trainer.profiles[1]["host_ms"] > 0 and any(name.startswith("aten::") for name, _, _ in
                                                      trainer.profiles[1]["host_top"])
    assert (out / "checkpoints" / "best_model_stage2" / "state.pt").exists()
    assert trainer.model.module.caption_decoder.lm.config.remat
    with pytest.raises(SystemExit):
        cli.parse_args(["--platform", "cpu"])


def test_stage0_warmup_runs_first_and_keeps_no_checkpoint(tmp_path):
    trainer = _port_trainer(_small(tmp_path, "s0", **{"training.stage0.num_epochs": 1,
                                                      "training.stage1.num_epochs": 1,
                                                      "training.stage2.num_epochs": 0}))
    wte = trainer.model.module.caption_decoder.lm.wte.weight.detach().clone()
    results = trainer.train()
    assert [r["epoch"] for r in results["stage0"]["history"]] == [0] and results["stage2"]["skipped"]
    assert trainer.global_step == 4 + 4  # 16 dummy samples, batch 4: 4 steps a stage
    assert not torch.equal(wte, trainer.model.module.caption_decoder.lm.wte.weight)  # the warm-up trains the decoder
    assert not list(trainer.checkpoints.checkpoint_dir.glob("*stage0*"))
