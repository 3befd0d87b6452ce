"""The graphed eval steps (training/graphs.py:GraphedEvalStep) on the CPU.

First the graphed step's body, run over its static buffers as the card's
replays run it, against the eager eval step from the same weights, bit for
bit: every metric of stage 1 and stage 2, with and without LoRA, over a run
of batches that changes the key (full pad at width 10, bucketed at 6, and a
last partial batch of 2 rows). Under LoRA the adapters are then updated in
place, as the graphed train step updates them, and the same keys must give
the eager step's metrics on the new adapters. The model has dropout 0.1
and every block checkpointed, which the eval steps must ignore. A graphed
eval step refuses a reference other than the one it was captured on.

Then the body under ``FakeTensorMode``, where a data-dependent read raises:
it reads nothing back to the host, and a body with such a read put back
fails there.

Last, the trainer with the graphed steps forced on (the card's route run on
the CPU over static buffers) against the eager trainer, bit for bit in
every validation loss, and both against the JAX trainer at
tests/test_torch_trainer.py's tolerance (rel 1e-5), on the same bridged
weights and dummy data, augmentation replaced by the identity on both sides
as that file does.
"""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import DataDependentOutputException, FakeTensorMode

from pgica_tpu.training import train_step as jax_train_step
from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
from pgica_tpu.utils import factories as jfactories
from pgica_tpu.utils.config import Config as JaxConfig
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.lora import normalize_lora_config
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
from pgica_tpu_torch.training import train_step
from pgica_tpu_torch.training.graphs import GraphedEvalStep
from pgica_tpu_torch.training.train_step import EvalStep, make_stage1_eval_step, make_stage2_eval_step
from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
from pgica_tpu_torch.utils import factories
from pgica_tpu_torch.utils.config import Config

from conftest import make_config_dict

SEQ, IMG, PROJ, VOCAB = 10, 32, 16, 261
TEMP, BETA, LOSS_RTOL = 0.5, 0.1, 1e-5
TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=PROJ, max_caption_length=SEQ,
            image_size=IMG)
LORA = normalize_lora_config({"r": 4, "lora_alpha": 8.0, "target_modules": ["c_attn", "c_proj"],
                              "lora_dropout": 0.1})
RUN = ((3, 10), (3, 6), (3, 6), (3, 10), (2, 6))  # (rows, width): full pad, a bucket, the epoch's partial batch


def _mask(rng, rows: int, width: int) -> np.ndarray:
    return (np.arange(width)[None, :] < rng.integers(2, width + 1, size=rows)[:, None]).astype(np.int32)


def _batch(stage: int, i: int) -> dict:
    rows, width = RUN[i % len(RUN)]
    rng = np.random.default_rng(50 + i)
    images = rng.integers(0, 256, size=(rows, IMG, IMG, 3), dtype=np.uint8)
    if stage == 1:
        return {"image": images, "caption_ids": rng.integers(0, VOCAB, size=(rows, width)).astype(np.int32),
                "caption_mask": _mask(rng, rows, width)}
    return {"image": images,
            "preferred_ids": rng.integers(0, VOCAB, size=(rows, width)).astype(np.int32),
            "preferred_mask": _mask(rng, rows, width),
            "rejected_ids": rng.integers(0, VOCAB, size=(rows, width)).astype(np.int32),
            "rejected_mask": _mask(rng, rows, width)}


def _model(lora: bool) -> PreferenceGuidedCaptioningModel:
    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=0, dropout=0.1,
                                            remat=True, lora_config=LORA if lora else None, **TINY)
    if lora:  # B made nonzero, so that the adapters change the forward
        gen = torch.Generator().manual_seed(1)
        for _, b in model.lora.values():
            b.data.copy_(0.05 * torch.randn(b.shape, generator=gen))
    return model


def _eval_step(model, stage: int, lora: bool) -> EvalStep:
    spec = (model.lora_config["alpha"], model.lora_config["rank"]) if lora else None
    if stage == 1:
        return make_stage1_eval_step(model.module, TEMP, lora=spec, adapters=model.lora)
    return make_stage2_eval_step(model.module, BETA, lora=spec, adapters=model.lora)


def _metrics(step, ref, batch) -> dict:
    out = step(ref, batch) if ref is not None else step(batch)
    return {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("stage,lora", [(1, False), (2, False), (1, True), (2, True)],
                         ids=["stage1", "stage2", "lora-stage1", "lora-stage2"])
def test_graphed_eval_body_is_the_eager_step_bit_for_bit(stage, lora):
    model = _model(lora)
    ref = frozen_copy(model.module, torch.float32) if stage == 2 else None
    eager = _eval_step(model, stage, lora)
    graphed = GraphedEvalStep(_eval_step(model, stage, lora))
    passes = [range(len(RUN))]
    if lora:
        passes.append(range(len(RUN)))  # the same keys again, after an in-place update of the adapters
    for n, run in enumerate(passes):
        if n:
            with torch.no_grad():
                for a, b in model.lora.values():
                    a.mul_(1.25)
                    b.add_(0.01)
        for i in run:
            batch = _batch(stage, i)
            want, got = _metrics(eager, ref, batch), _metrics(graphed, ref, batch)
            assert got.keys() == want.keys() and "loss" in want, (stage, i)
            for k in want:
                assert torch.equal(got[k], want[k]), f"stage {stage} batch {i} pass {n}: {k}"
                assert got[k].dtype == torch.float32 and got[k].dim() == 0
    assert {key[1][1] for key in graphed.graphs} == {(3, 10), (3, 6), (2, 6)}  # (name, shape, dtype) of ids
    assert graphed.eager_steps == 0 and graphed.replays == 0  # nothing to capture on the CPU
    if stage == 2:
        with pytest.raises(ValueError, match="reference"):
            graphed(frozen_copy(model.module, torch.float32), _batch(stage, 0))


def test_graphed_eval_step_refuses_a_mesh():
    model = _model(False)
    step = _eval_step(model, 1, False)
    step.mesh = object()
    with pytest.raises(ValueError, match="mesh"):
        GraphedEvalStep(step)


def _fake_batch(stage: int) -> dict:
    rows, width = RUN[0]
    ids = torch.zeros(rows, width, dtype=torch.int32)
    mask = torch.ones(rows, width, dtype=torch.int32)
    images = torch.zeros(rows, IMG, IMG, 3, dtype=torch.uint8)
    if stage == 1:
        return {"image": images, "caption_ids": ids, "caption_mask": mask}
    return {"image": images, "preferred_ids": ids, "preferred_mask": mask, "rejected_ids": ids + 1,
            "rejected_mask": mask}


@pytest.mark.parametrize("stage,lora", [(1, False), (2, False), (2, True)], ids=["stage1", "stage2", "lora-stage2"])
def test_eval_body_reads_nothing_back_to_the_host(stage, lora):
    """The body under FakeTensorMode: every tensor made inside is fake, and reading one's value on the host
    raises DataDependentOutputException."""
    model = _model(lora)
    ref = frozen_copy(model.module, torch.float32) if stage == 2 else None
    step = _eval_step(model, stage, lora)
    with FakeTensorMode(allow_non_fake_inputs=True):
        metrics = step.body(ref, _fake_batch(stage))
    assert "loss" in metrics

    read_back = EvalStep(step.module, lambda m, r, b: {"loss": torch.tensor(float(step.metrics_fn(m, r, b)["loss"]))},
                         step.keys, step.lora, step.adapters, None, step.takes_ref)
    with pytest.raises(DataDependentOutputException):
        with FakeTensorMode(allow_non_fake_inputs=True):
            read_back.body(ref, _fake_batch(stage))


# ---------------------------------------------------------------- the trainer


def _config_dict(tmp_path, name):
    cfg = make_config_dict(**{})
    cfg["model"].update(dropout=0.0, projection_dim=16)
    cfg["data"]["dummy_samples"] = 32
    cfg["training"]["stage2"].update(learning_rate=1e-3, reference_dtype="float32")
    cfg["training"].update(save_steps=0, load_best_model_at_end=False)
    cfg["paths"].update(output_dir=str(tmp_path / name / "out"), checkpoint_dir=str(tmp_path / name / "ckpt"),
                        log_dir=str(tmp_path / name / "logs"))
    return cfg


def _port_trainer(cfg_dict, jax_params):
    cfg = Config(config_dict=cfg_dict)
    tok = factories.create_tokenizer(cfg)
    model = factories.create_model(cfg, tok, device="cpu")
    model.load_jax_params(jax_params)
    procs = factories.create_processors(cfg, tok)
    s1 = factories.create_loaders_with_fallback(cfg, *procs, kind="conceptual")
    s2 = factories.create_loaders_with_fallback(cfg, *procs, kind="ultrafeedback")
    return PreferenceGuidedTrainer(model, cfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                                   preference_val_loader=s2[1])


def test_trainer_val_loss_with_eval_graphs_matches_eager_and_jax(tmp_path):
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_train_step, "augment_batch", lambda key, images, enabled=True: images)
    mp.setattr(train_step, "augment_batch", lambda images, generator=None, enabled=True, params=None: images)
    try:
        jcfg = JaxConfig(config_dict=_config_dict(tmp_path, "jax"))
        jtok = jfactories.create_tokenizer(jcfg)
        jmodel = jfactories.create_model(jcfg, jtok)
        params = jax.tree.map(np.array, jmodel.params)
        procs = jfactories.create_processors(jcfg, jtok)
        s1 = jfactories.create_loaders_with_fallback(jcfg, *procs, kind="conceptual")
        s2 = jfactories.create_loaders_with_fallback(jcfg, *procs, kind="ultrafeedback")
        jt = JaxTrainer(jmodel, jcfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                        preference_val_loader=s2[1])
        jt.train()
        eager = _port_trainer(_config_dict(tmp_path, "eager"), params)
        eager.train()
        mp.setattr(PreferenceGuidedTrainer, "_graphs_on", lambda self: True)  # the card's route, on the CPU
        graphed = _port_trainer(_config_dict(tmp_path, "graphed"), params)
        graphed.train()
    finally:
        mp.undo()
    for stage in ("stage1", "stage2"):
        want = [r["val_loss"] for r in eager.history[stage]]
        assert want and all(v is not None for v in want), stage
        assert [r["val_loss"] for r in graphed.history[stage]] == want, stage
        np.testing.assert_allclose(want, [r["val_loss"] for r in jt.history[stage]], rtol=LOSS_RTOL)
    for stage in (1, 2):
        record = graphed.graphs[stage]
        assert record["keys"] >= 1 and record["eval"]["keys"] >= 1, record
        assert record["eval"]["eager_steps"] == 0 and not record["eval"]["shares_pool"]  # nothing captured
    assert not eager.graphs
