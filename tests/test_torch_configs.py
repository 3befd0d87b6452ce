"""The three configs that no other test trains, through the port's trainer and the JAX package's, on the CPU.

``configs/ablation.yaml`` (stage 2 switched off, gradient accumulation 4),
``configs/learning_curve.yaml`` (the caption cross-entropy warm-up of stage
0, then stage 1 with the vision tower trained, and stage 2 with no
checkpoints written) and ``configs/tpu_demo.yaml`` (activation checkpointing
off) each run a few steps through both trainers, held to each other as
tests/test_torch_trainer.py holds the default config's run: every logged
train loss and every validation loss rel 1e-5, the global step, and every
parameter within Adam's bound (2 lr an update) with fewer than 2% of the
elements beyond 1e-6 (the self-attention key biases, whose gradient is 0 in
exact arithmetic, aside).

Each config is kept as it is except where a CPU test must cut it
(``CUTS``): the tiny presets of both towers in place of ViT-B/32 and GPT-2
Medium (width 16 projection, 32 px images, 16-token captions, the built-in
tokenizer's vocab), the dummy corpus at a few batches of 4, one epoch a
stage, float32 in place of bf16 (the two packages round bf16 at other
places), dropout 0 and augmentation replaced by the identity on both sides
(the two packages draw from different generators; the ops are held op by
op in tests/test_torch_augment.py), every step logged, outputs in the
test's directory. The port trains eagerly here (the graphed step is the
card's route; tests/test_torch_graphed_train.py holds its body to the eager
step).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import yaml

from pgica_tpu.training import train_step as jax_train_step
from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
from pgica_tpu.utils import factories as jfactories
from pgica_tpu.utils.config import Config as JaxConfig
from pgica_tpu_torch.training import train_step
from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
from pgica_tpu_torch.utils import factories
from pgica_tpu_torch.utils.config import Config

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
LOSS_RTOL, PARAM_ATOL, LOOSE_SHARE = 1e-5, 1e-6, 0.02
CUTS = {
    "model.vision_model": "tiny-vit", "model.text_model": "tiny-gpt2", "model.projection_dim": 16,
    "model.dropout": 0.0, "data.image_size": 32, "data.max_caption_length": 16, "data.num_workers": 0,
    "training.logging_steps": 1, "training.save_steps": 0, "hardware.mixed_precision": "no",
}
# per config: the dummy corpus (micro-steps of 4 rows a stage), and one epoch a stage that runs
SIZES = {"ablation": 32, "learning_curve": 16, "tpu_demo": 16}


def _config(name: str, tmp_path: Path) -> dict:
    cfg = yaml.safe_load((CONFIGS / f"{name}.yaml").read_text())
    cfg["model"].pop("vocab_size", None)
    for stage in ("stage0", "stage1", "stage2"):
        if stage in cfg["training"]:
            s = cfg["training"][stage]
            s["batch_size"] = 4
            s["num_epochs"] = min(int(s.get("num_epochs", 1)), 1)
    cuts = dict(CUTS, **{"data.dummy_samples": SIZES[name], "paths.output_dir": str(tmp_path / "out"),
                         "paths.checkpoint_dir": str(tmp_path / "ckpt"), "paths.log_dir": str(tmp_path / "logs"),
                         "paths.cache_dir": str(tmp_path / "cache")})
    for path, value in cuts.items():
        node = cfg
        *keys, last = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return cfg


def _record_losses(trainer) -> dict:
    """(stage, step) -> loss of every logged train step."""
    seen = {}
    log = trainer._log_metrics

    def capture(metrics, step, prefix="train"):
        if prefix.endswith("/train"):
            seen[(prefix, step)] = float(metrics["loss"])
        return log(metrics, step, prefix)

    trainer._log_metrics = capture
    return seen


def _trainer(package, cfg_dict):
    f, config, trainer = ((jfactories, JaxConfig, JaxTrainer) if package == "jax"
                          else (factories, Config, PreferenceGuidedTrainer))
    cfg = config(config_dict=cfg_dict)
    tok = f.create_tokenizer(cfg)
    model = f.create_model(cfg, tok) if package == "jax" else f.create_model(cfg, tok, device="cpu")
    procs = f.create_processors(cfg, tok)
    s1 = f.create_loaders_with_fallback(cfg, *procs, kind="conceptual")
    s2 = f.create_loaders_with_fallback(cfg, *procs, kind="ultrafeedback")
    return model, trainer(model, cfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                          preference_val_loader=s2[1])


@pytest.mark.parametrize("name", sorted(SIZES))
def test_config_trains_as_in_jax(name, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_train_step, "augment_batch", lambda key, images, enabled=True: images)
    monkeypatch.setattr(train_step, "augment_batch", lambda images, generator=None, enabled=True, params=None: images)
    jmodel, jt = _trainer("jax", _config(name, tmp_path / "jax"))
    initial = jax.tree.map(np.array, jmodel.params)
    jlosses = _record_losses(jt)
    jt.train()
    port, pt = _trainer("port", _config(name, tmp_path / "port"))
    port.load_jax_params(initial)
    plosses = _record_losses(pt)
    pt.train()

    assert jlosses.keys() == plosses.keys() and len(plosses) >= 4, (sorted(jlosses), sorted(plosses))
    for key in jlosses:
        np.testing.assert_allclose(plosses[key], jlosses[key], rtol=LOSS_RTOL, err_msg=str(key))
    for stage in ("stage0", "stage1", "stage2"):
        jh, ph = jt.history.get(stage, []), pt.history[stage]
        assert len(jh) == len(ph), stage
        for jr, pr in zip(jh, ph):
            for key in ("train_loss", "val_loss"):
                if key in jr:
                    np.testing.assert_allclose(pr[key], jr[key], rtol=LOSS_RTOL, err_msg=f"{stage} {key}")
    assert pt.global_step == jt.global_step
    ref = factories.create_model(pt.config, device="cpu")
    ref.load_jax_params(jax.tree.map(np.asarray, jt.model.params))
    want = dict(ref.module.named_parameters())
    bound = 2 * 2e-4 * pt.global_step  # Adam's bound at the largest learning rate of the three configs
    loose = total = 0
    for pname, p in pt.model.module.named_parameters():
        got, exp = p.detach().numpy(), want[pname].detach().numpy()
        np.testing.assert_allclose(got, exp, atol=max(bound, PARAM_ATOL), err_msg=pname)
        if not pname.endswith("attn.k_proj.bias"):
            loose += int((np.abs(got - exp) > PARAM_ATOL).sum())
            total += got.size
    assert loose / total < LOOSE_SHARE, f"{loose} of {total} elements beyond {PARAM_ATOL}"
