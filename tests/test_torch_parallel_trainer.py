"""The port's trainer and ``train`` CLI on a device mesh of two gloo ranks, against the JAX trainer.

configs/smoke.yaml's tiny presets with ``mesh.data: 2``, dropout 0, a global
batch of 4 (2 rows a rank), the same dummy data, stage 1 then stage 2, in
five modes (two steps a stage): replicated data parallelism, ZeRO-1 and ZeRO-3
(``model.scan_layers: true``, which the port reads for the check only),
tensor parallelism (``mesh.model: 2``, both ranks on the whole batch) and
context parallelism (``mesh.seq: 2``: stage 1 repeated on both ranks, stage
2 sequence-sharded). The JAX trainer runs each mode on a 2-device CPU mesh,
one spawned JAX process a mode, while the port's two ranks
(tests/_torch_ranks.py; torch and the port only) run all five. Augmentation is the identity on both
sides, as in tests/test_torch_trainer.py. Tolerances: every epoch's train
and validation loss rel 1e-5; the final parameters within Adam's bound (2 lr
an update), all but a share below 2% of the elements (the key biases apart)
within 1e-6, tests/test_torch_trainer.py's rule.

A sixth mode is FSDP at rest (``mesh.fsdp: 2``, ``mesh.data: 1``: the
batch split over fsdp, the parameters and Adam moments cut by the rules).

Then the port alone: a mid-epoch ZeRO-1 autosave resumed ends bit for bit
where the uninterrupted run ends (dropout and augmentation on); the
tensor-parallel and the FSDP run's last checkpoints, loaded by a trainer in
one process, hold the ranks' gathered parameters bit for bit and whole Adam
moments that its optimizer takes; only rank 0 writes; ``scripts.train.run``
in the two ranks, under ZeRO-1, ``mesh.model: 2``, ``mesh.seq: 2`` and
``mesh.fsdp: 2``; and JAX's configuration errors, each raised by both
trainers for the same configuration, the tensor- and context-parallel
refusals among them.

ZeRO checkpoints on another rank count (``zero_resume``): a ZeRO-1 stage-1
epoch checkpoint saved on two ranks (data 2) and loaded on four (data 4),
at projection 16, whose flat buffer (110,496 elements) pads alike at 2 and
4, and at projection 17 (110,666: 110,666 at 2, 110,668 at 4), and a
ZeRO-3 stage-2 one at projection 16 (each block's buffer and the rest's
pad alike). Each side resumes its own checkpoint and takes one more step:
the port's verdict (moments taken, or JAX's "Could not resume optimizer
state ...; starting fresh") is the JAX trainer's, and its losses and
parameters are the JAX trainer's within LOSS_RTOL and the PARAM_ATOL rule.
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import _torch_ranks
from pgica_tpu_torch.parallel.mesh import MeshContext
from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
from pgica_tpu_torch.utils import factories
from pgica_tpu_torch.utils.config import Config

LR, LOSS_RTOL, PARAM_ATOL, LOOSE_SHARE = 1e-3, 1e-5, 1e-6, 0.02
MODES = ("replicated", "zero1", "zero3", "tp", "cp", "fsdp")
SMOKE = Path(__file__).resolve().parent.parent / "configs" / "smoke.yaml"


def _config(tmp_path, name, **overrides):
    cfg = Config(str(SMOKE)).to_dict()
    base = {"model.dropout": 0.0, "model.projection_dim": 16, "data.dummy_samples": 8,
            "training.stage1.batch_size": 4, "training.stage2.batch_size": 4,
            "training.stage1.learning_rate": LR, "training.stage2.learning_rate": LR,
            "training.stage2.reference_dtype": "float32", "training.logging_steps": 1, "training.save_steps": 0,
            "training.load_best_model_at_end": False, "training.save_best_checkpoints": False,
            "mesh.data": 2, "paths.output_dir": str(tmp_path / name / "out"),
            "paths.checkpoint_dir": str(tmp_path / name / "ckpt"), "paths.log_dir": str(tmp_path / name / "logs"),
            "paths.cache_dir": str(tmp_path / "cache")}
    for path, value in {**base, **overrides}.items():
        node = cfg
        *keys, last = path.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return cfg


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _jax_model(cfg):
    from pgica_tpu.utils import factories as jfactories
    from pgica_tpu.utils.config import Config as JaxConfig

    jcfg = JaxConfig(config_dict=cfg)
    return jfactories.create_model(jcfg, jfactories.create_tokenizer(jcfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax = _jax()
    tmp = tmp_path_factory.mktemp("trainer")
    modes = {"replicated": _config(tmp, "replicated"),
             "zero1": _config(tmp, "zero1", **{"mesh.zero1": True}),
             "zero3": _config(tmp, "zero3", **{"mesh.zero3": True, "model.scan_layers": True}),
             "tp": _config(tmp, "tp", **{"mesh.data": 1, "mesh.model": 2}),
             "cp": _config(tmp, "cp", **{"mesh.data": 1, "mesh.seq": 2}),
             "fsdp": _config(tmp, "fsdp", **{"mesh.data": 1, "mesh.fsdp": 2})}
    resume = {"training.stage1.num_epochs": 2, "model.dropout": 0.1, "mesh.zero1": True,
              "training.stage2.num_epochs": 0}
    clis = {"cli": {"mesh.zero1": True}, "cli_tp": {"mesh.data": 1, "mesh.model": 2},
            "cli_cp": {"mesh.data": 1, "mesh.seq": 2}, "cli_fsdp": {"mesh.data": 1, "mesh.fsdp": 2}}
    for name, overrides in clis.items():
        (tmp / f"{name}.yaml").write_text(yaml.safe_dump(_config(tmp, name, **overrides)))
    inputs = {
        "modes": modes,
        "params": jax.tree.map(np.asarray, _jax_model(modes["replicated"]).params),
        "params_scan": jax.tree.map(np.asarray, _jax_model(modes["zero3"]).params),
        "resume": {"full": _config(tmp, "full", **{**resume, "training.save_steps": 3}),
                   "resumed": _config(tmp, "resumed", **resume)},
        **{name: ["--config", str(tmp / f"{name}.yaml"), "--device", "cpu", "--max-steps", "2",
                  "--output-dir", str(tmp / f"{name}_out")] for name in clis},
    }
    torch.save(inputs, tmp / "inputs.pt")
    ranks = _torch_ranks.start("_torch_ranks.trainer_cases", tmp, 2)
    refs = {}
    for mode in MODES:
        (tmp / f"jax_{mode}").mkdir()
        # the JAX trainer writes its outputs and checkpoints apart: the port's TP checkpoint is read back below
        jax_inputs = {**inputs, "modes": {**inputs["modes"], mode: {**inputs["modes"][mode], "paths": {
            key: str(tmp / f"jax_{mode}" / key) for key in inputs["modes"][mode]["paths"]}}}}
        torch.save(jax_inputs, tmp / f"jax_{mode}" / "inputs.pt")
        refs[mode] = _torch_ranks.start_jax("_torch_ranks.jax_trainer_reference", tmp / f"jax_{mode}", (mode,))
    jax_out = {mode: _torch_ranks.finish(handle, timeout=600)[0] for mode, handle in refs.items()}
    return {"ranks": _torch_ranks.finish(ranks, timeout=600), "jax": jax_out, "inputs": inputs}


@pytest.mark.parametrize("mode", MODES)
def test_trainer_on_two_ranks_follows_the_jax_trainer(runs, mode):
    want = runs["jax"][mode]
    for out in runs["ranks"]:
        got = out[mode]
        assert got["global_step"] == want["global_step"] == 4  # 2 steps a stage
        for stage in ("stage1", "stage2"):
            (g,), (w,) = got["history"][stage], want["history"][stage]
            np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=LOSS_RTOL, err_msg=stage)
            np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=LOSS_RTOL, err_msg=stage)
        loose = total = 0
        for name, exp in want["params"].items():
            g, e = got["params"][name].numpy(), exp.numpy()
            np.testing.assert_allclose(g, e, atol=2 * LR * 4, err_msg=name)
            if not name.endswith("attn.k_proj.bias"):
                loose += int((np.abs(g - e) > PARAM_ATOL).sum())
                total += g.size
        assert loose / total < LOOSE_SHARE, f"{loose} of {total} elements beyond {PARAM_ATOL}"
    a, b = (r[mode]["params"] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a), "the ranks end with different parameters"


def test_only_rank_zero_writes(runs):
    for mode in MODES:
        assert "checkpoint_stage2_epoch0" in runs["ranks"][0][mode]["saves"] and runs["ranks"][1][mode]["saves"] == []
    assert runs["ranks"][0]["cli"]["writer"] and not runs["ranks"][1]["cli"]["writer"]


def test_zero1_resume_ends_bit_identical(runs):
    for rank, out in enumerate(runs["ranks"]):
        r = out["resume"]
        assert r["meta"] == {"global_step": 3, "epoch": 1, "step_in_epoch": 1}
        assert r["steps"] == (4, 4)
        assert all(torch.equal(r["full"][k], r["resumed"][k]) for k in r["full"])
        if rank == 0:
            assert r["moments_equal"] and r["count"] == (4, 4)


def test_cli_runs_in_two_ranks(runs):
    for out in runs["ranks"]:
        assert out["cli"]["global_step"] == 4  # --max-steps 2, two stages
    assert runs["ranks"][0]["cli"]["results"] and runs["ranks"][0]["cli"]["snapshot"]


@pytest.mark.parametrize("key, axis", [("cli_tp", "model"), ("cli_cp", "seq"), ("cli_fsdp", "fsdp")])
def test_cli_trains_tensor_and_context_parallel_in_two_ranks(runs, key, axis):
    for out in runs["ranks"]:
        assert out[key]["global_step"] == 4 and out[key]["mesh"][axis] == 2
    assert runs["ranks"][0][key]["results"] and not runs["ranks"][1][key]["writer"]


def _resumes_in_one_process(runs, mode):
    from pgica_tpu_torch.training.train_step import TrainState

    cfg = runs["inputs"]["modes"][mode]
    trainer = _torch_ranks._port_trainer(cfg, None, None)
    meta = trainer.load_checkpoint(Path(cfg["paths"]["checkpoint_dir"]) / "checkpoint_stage2_epoch0")
    assert meta["global_step"] == 4 and trainer.mesh is None
    got = trainer.model.module.state_dict()
    want = runs["ranks"][0][mode]["params"]
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    saved = trainer._restored_opt_state
    state = trainer._maybe_resume_opt_state(
        TrainState.create(trainer.model.module, trainer._make_optimizer(2, len(trainer.preference_train_loader))))
    assert state.step == 4 and state.opt_state.count == saved["count"] > 0
    for name, mu in zip(state.opt_state.names, state.opt_state.mu):
        assert mu.shape == got[name].shape and torch.equal(mu, saved["mu"][name])


def test_tp_checkpoint_resumes_in_one_process(runs):
    """The tensor-parallel run's last checkpoint holds the gathered parameters and whole Adam moments: a
    trainer in one process loads them bit for bit, and its optimizer takes the moments."""
    _resumes_in_one_process(runs, "tp")


def test_fsdp_checkpoint_resumes_in_one_process(runs):
    """The same for the FSDP run's (its parameters and moments gathered over fsdp)."""
    _resumes_in_one_process(runs, "fsdp")


def test_siglip_llama8b_mesh_builds():
    """configs/siglip_llama8b.yaml's own mesh (fsdp 2 x model 4; data -1) on eight ranks."""
    cfg = Config(str(SMOKE.parent / "siglip_llama8b.yaml"))
    mesh = MeshContext.from_config(cfg, world_size=8, rank=5)
    assert mesh.shape == {"dcn": 1, "data": 1, "fsdp": 2, "model": 4, "seq": 1}
    assert (mesh.coords["fsdp"], mesh.coords["model"]) == (1, 1) and mesh.data_parallel_size == 2


def test_the_ranks_import_neither_jax_nor_the_jax_package(runs):
    assert all(out["imported_jax"] == [] for out in runs["ranks"])


# ------------------------------------------------------------------ JAX's configuration errors


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("errors")
    plain, scan = _config(tmp, "m"), _config(tmp, "m", **{"model.scan_layers": True})
    return {False: (_jax_model(plain), factories.create_model(Config(config_dict=plain), device="cpu")),
            True: (_jax_model(scan), factories.create_model(Config(config_dict=scan), device="cpu"))}


ERRORS = [  # (stage, mesh, overrides, JAX's message)
    (1, {"data": 1, "fsdp": 2}, {"mesh.zero1": True}, "mesh.zero1 requires a device mesh with data > 1"),
    (1, {"data": 2, "fsdp": 2}, {"mesh.zero1": True}, "shards the optimizer state over the data axis only"),
    (2, {"data": 2}, {"mesh.zero1": True, "mesh.zero3": True}, "mutually exclusive"),
    (1, {"data": 2}, {"mesh.zero1": True, "training.stage1.gradient_accumulation_steps": 2},
     "does not support gradient_accumulation_steps > 1"),
    (1, {"data": 2}, {"mesh.zero1": True, "training.stage1.batch_size": 3}, "must be divisible by the data"),
    (1, {"data": 2}, {"mesh.zero3": True}, "requires model.scan_layers: true"),
    (1, {"data": 1, "dcn": 2}, {"mesh.zero3": True, "model.scan_layers": True},
     r"requires a device mesh with data\*fsdp > 1"),
    (1, {"data": 2, "dcn": 2}, {"mesh.zero3": True, "model.scan_layers": True}, "runs manual over data/fsdp only"),
    (2, {"data": 2}, {"mesh.zero1": True, "training.stage2.drop_unused_tower": True}, "drop_unused_tower"),
]


TP_CP_ERRORS = [  # the tensor- and context-parallel refusals: (stage, mesh, overrides, JAX's message)
    (1, {"data": 1, "model": 2}, {"mesh.zero1": True}, "mesh.zero1 requires a device mesh with data > 1"),
    (1, {"data": 2, "model": 2}, {"mesh.zero1": True}, "shards the optimizer state over the data axis only"),
    (1, {"data": 2, "seq": 2}, {"mesh.zero3": True, "model.scan_layers": True}, "runs manual over data/fsdp only"),
    (2, {"data": 1, "seq": 2}, {"model.lora_config": {"r": 4, "lora_alpha": 8}}, "but not with LoRA"),
    (2, {"data": 1, "seq": 4}, {"data.max_caption_length": 10}, "not divisible by mesh.seq 4"),
]


@pytest.mark.parametrize("stage, shape, overrides, message", TP_CP_ERRORS)
def test_tp_cp_refusals_match_jax(tmp_path, stage, shape, overrides, message):
    """Each on a model of its own: a trainer given a ``model`` axis cuts its model."""
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
    from pgica_tpu.utils import factories as jfactories
    from pgica_tpu.utils.config import Config as JaxConfig

    cfg = _config(tmp_path, "e", **overrides)
    n = math.prod(shape.values())
    jcfg, pcfg = JaxConfig(config_dict=cfg), Config(config_dict=cfg)
    jtok, ptok = jfactories.create_tokenizer(jcfg), factories.create_tokenizer(pcfg)
    kind = "conceptual" if stage == 1 else "ultrafeedback"
    jl = jfactories.create_loaders_with_fallback(jcfg, *jfactories.create_processors(jcfg, jtok), kind=kind)
    pl = factories.create_loaders_with_fallback(pcfg, *factories.create_processors(pcfg, ptok), kind=kind)
    key = "train_loader" if stage == 1 else "preference_train_loader"
    jt = JaxTrainer(jfactories.create_model(jcfg, jtok), jcfg, **{key: jl[0]},
                    mesh=JaxMesh(devices=jax.devices()[:n], **shape))
    pt = PreferenceGuidedTrainer(factories.create_model(pcfg, ptok, device="cpu"), pcfg, **{key: pl[0]},
                                 mesh=MeshContext(world_size=n, rank=0, **shape))
    for trainer in (jt, pt):
        with pytest.raises(ValueError, match=message):
            trainer.train_stage1() if stage == 1 else trainer.train_stage2()


@pytest.mark.parametrize("stage, shape, overrides, message", ERRORS)
def test_config_errors_match_jax(models, tmp_path, stage, shape, overrides, message):
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
    from pgica_tpu.utils import factories as jfactories
    from pgica_tpu.utils.config import Config as JaxConfig

    cfg = _config(tmp_path, "e", **overrides)
    jmodel, port_model = models[bool(cfg["model"].get("scan_layers"))]
    n = math.prod(shape.values())
    jcfg, pcfg = JaxConfig(config_dict=cfg), Config(config_dict=cfg)
    jprocs = jfactories.create_processors(jcfg, jfactories.create_tokenizer(jcfg))
    pprocs = factories.create_processors(pcfg, factories.create_tokenizer(pcfg))
    kind = "conceptual" if stage == 1 else "ultrafeedback"
    jl = jfactories.create_loaders_with_fallback(jcfg, *jprocs, kind=kind)
    pl = factories.create_loaders_with_fallback(pcfg, *pprocs, kind=kind)
    key = "train_loader" if stage == 1 else "preference_train_loader"
    jt = JaxTrainer(jmodel, jcfg, **{key: jl[0]}, mesh=JaxMesh(devices=jax.devices()[:n], **shape))
    pt = PreferenceGuidedTrainer(port_model, pcfg, **{key: pl[0]}, mesh=MeshContext(world_size=n, rank=0, **shape))
    for trainer in (jt, pt):
        with pytest.raises(ValueError, match=message):
            trainer.train_stage1() if stage == 1 else trainer.train_stage2()


# ------------------------------------------------------------------ ZeRO checkpoints on another rank count

ZERO_RESUME = {  # case: (overrides of the run that saves, of the resume, the checkpoint, its verdict)
    "zero1_p16": ({"mesh.zero1": True, "training.stage2.num_epochs": 0},
                  {"training.stage1.num_epochs": 2}, "checkpoint_stage1_epoch0", "resumed"),
    "zero1_p17": ({"mesh.zero1": True, "training.stage2.num_epochs": 0, "model.projection_dim": 17},
                  {"training.stage1.num_epochs": 2}, "checkpoint_stage1_epoch0", "fresh"),
    "zero3_p16": ({"mesh.zero3": True, "model.scan_layers": True, "training.stage1.num_epochs": 0},
                  {"training.stage2.num_epochs": 2}, "checkpoint_stage2_epoch0", "resumed"),
}


def _resume_case(tmp, name, side):
    """(save config, resume config, checkpoint path) of one side ("port" or "jax"): the resume on data 4 reads
    and writes the first run's checkpoint directory (its stage-2 reference stays the saved one)."""
    save_over, resume_over, ckpt, _ = ZERO_RESUME[name]
    save = _config(tmp, f"{side}_{name}", **save_over)
    resume = _config(tmp, f"{side}_{name}_resumed", **{**save_over, **resume_over, "mesh.data": 4,
                                                       "paths.checkpoint_dir": save["paths"]["checkpoint_dir"]})
    return save, resume, str(Path(save["paths"]["checkpoint_dir"]) / ckpt)


@pytest.fixture(scope="module")
def zero_resume(tmp_path_factory):
    jax = _jax()
    tmp = tmp_path_factory.mktemp("zero_resume")
    port, refs = {}, {}
    for name in ZERO_RESUME:
        save, resume, ckpt = _resume_case(tmp, name, "port")
        port[name] = {"save": save, "resume": resume, "checkpoint": ckpt,
                      "params": jax.tree.map(np.asarray, _jax_model(save).params)}
        save, resume, ckpt = _resume_case(tmp, name, "jax")
        (tmp / f"jax_{name}").mkdir()
        torch.save({"zero_resume": {name: {"save": save, "resume": resume, "checkpoint": ckpt}}},
                   tmp / f"jax_{name}" / "inputs.pt")
        refs[name] = _torch_ranks.start_jax("_torch_ranks.jax_zero_resume_reference", tmp / f"jax_{name}", (name,))
    for world in (2, 4):
        (tmp / f"world{world}").mkdir()
        torch.save({"zero_resume": port}, tmp / f"world{world}" / "inputs.pt")
        ranks = _torch_ranks.finish(_torch_ranks.start("_torch_ranks.zero_resume_cases", tmp / f"world{world}",
                                                       world), timeout=600)
    return {"ranks": ranks, "jax": {name: _torch_ranks.finish(h, timeout=600)[0] for name, h in refs.items()}}


@pytest.mark.parametrize("name", sorted(ZERO_RESUME))
def test_zero_checkpoint_resumes_on_four_ranks_as_jax(zero_resume, name):
    want = zero_resume["jax"][name]
    assert want["verdict"] == ZERO_RESUME[name][3]
    stage = "stage2" if name.startswith("zero3") else "stage1"
    for out in zero_resume["ranks"]:
        got = out[name]
        assert got["verdict"] == want["verdict"] and got["global_step"] == want["global_step"]
        (g,), (w,) = got["history"][stage], want["history"][stage]
        np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=LOSS_RTOL)
        loose = total = 0
        for key, exp in want["params"].items():
            d = np.abs(got["params"][key].numpy() - exp.numpy())
            assert d.max() <= 2 * LR * 3, key  # Adam's bound over the three updates
            loose += int((d > PARAM_ATOL).sum())
            total += d.size
        assert loose / total < LOOSE_SHARE, f"{loose} of {total} elements beyond {PARAM_ATOL}"
