"""Spawned gloo ranks for the port's data-parallel tests (not a test module).

A rank imports this module, torch and the port only: never ``jax`` or the
JAX package (each rank records what it imported). The ranks meet through a
``file://`` store under the test's directory, so parallel test workers never
share a port. ``start`` launches them without waiting, so the parent can
compute its JAX references meanwhile; ``finish`` joins each with a time
limit and fails on a rank that failed or hung.
"""

import importlib
import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

import torch


def _entry(target: str, rank: int, world: int, workdir: str, args: tuple) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.pop("LOCAL_RANK", None)
    try:
        dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank, world_size=world)
        module, name = target.rsplit(".", 1)
        out = getattr(importlib.import_module(module), name)(rank, world, Path(workdir), *args)
        out = dict(out or {})
        out["imported_jax"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "pgica_tpu.")))
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _jax_entry(target: str, workdir: str, args: tuple) -> None:
    try:
        module, name = target.rsplit(".", 1)
        out = getattr(importlib.import_module(module), name)(Path(workdir), *args)
        torch.save(out, Path(workdir) / "jax0.pt")
    except BaseException:
        (Path(workdir) / "jax0.err").write_text(traceback.format_exc())
        raise


def start_jax(target: str, workdir, args: tuple = ()):
    """One spawned process computing a JAX reference (``target(workdir, *args)``, a dict), beside the ranks;
    its result lands in ``workdir/jax0.pt``."""
    Path(workdir).mkdir(parents=True, exist_ok=True)
    proc = mp.get_context("spawn").Process(target=_jax_entry, args=(target, str(workdir), args))
    proc.start()
    return Path(workdir), [proc], "jax"


def start(target: str, workdir, world: int = 2, args: tuple = ()):
    """Launch ``world`` ranks of ``target`` ("module.function", called ``(rank, world, workdir, *args)``
    and returning a dict that lands in ``workdir/rank{r}.pt``)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, world, str(workdir), args)) for r in range(world)]
    for p in procs:
        p.start()
    return workdir, procs, "rank"


def finish(handle, timeout: float = 600.0):
    """Join every rank within ``timeout`` seconds; their results, by rank."""
    workdir, procs, name = handle
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (workdir / f"{name}{r}.err").read_text() for r in range(len(procs))
              if (workdir / f"{name}{r}.err").exists()}
    if hung or errors or any(p.exitcode for p in procs):
        raise AssertionError(f"{name}s hung: {hung}; exit codes {[p.exitcode for p in procs]}; errors: {errors}")
    return [torch.load(workdir / f"{name}{r}.pt", weights_only=False) for r in range(len(procs))]


# ---------------------------------------------------------------- rank programs of the tests

TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, dropout=0.0,
            max_caption_length=10, image_size=32)


def _port_model(params):
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY)
    model.load_jax_params(params)
    return model


def _snapshot(named):
    return {k: v.detach().clone() for k, v in named}


def parallel_cases(rank: int, world: int, workdir: Path):
    """Every case of tests/test_torch_parallel.py that needs ranks, on this rank's rows."""
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.ops.losses import ntxent_loss, ntxent_loss_fused
    from pgica_tpu_torch.parallel import collectives
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.parallel.zero1 import make_zero1_train_step
    from pgica_tpu_torch.parallel.zero3 import make_zero3_train_step
    from pgica_tpu_torch.training import train_step as ts
    from pgica_tpu_torch.training.optim import create_optimizer, warmup_cosine_schedule

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    c = inp["const"]
    mesh = MeshContext(data=world)
    out = {"coords": mesh.coords, "batch_index": mesh.batch_index}

    # all_gather's gradient: loss_r = sum(all_gather(x_r) * w_r)
    x = torch.from_numpy(mesh.shard_batch({"x": inp["x"]})["x"]).requires_grad_()
    with mesh:
        loss = (collectives.all_gather(x, "data") * torch.from_numpy(inp["w"][rank])).sum()
    out["gather_grad"] = torch.autograd.grad(loss, x)[0]

    # NT-Xent with global negatives, both variants: this rank's loss and the gradients of its rows
    local = mesh.shard_batch({"img": inp["img"], "txt": inp["txt"]})
    for name, fn in (("plain", ntxent_loss), ("fused", ntxent_loss_fused)):
        img, txt = (torch.from_numpy(local[k]).requires_grad_() for k in ("img", "txt"))
        with mesh:
            loss, metrics = fn(img, txt, c["temp"], axis_name="data")
        gi, gt = torch.autograd.grad(loss, (img, txt))
        out[f"ntxent_{name}"] = {"loss": loss.detach(), "metrics": {k: v.detach() for k, v in metrics.items()},
                                 "d_img": gi, "d_txt": gt}

    # replicated data parallelism: the standard optimizer, gradients all-reduced
    def replicated(stage):
        model = _port_model(inp["params"])
        opt = create_optimizer(c["lr"], c["total"], c["warmup"], freeze_vision_backbone=True,
                               frozen_prefixes=("caption_decoder",) if stage == 1 else ("text_encoder",))
        state = ts.TrainState.create(model.module, opt)
        if stage == 1:
            step = ts.make_stage1_train_step(model.module, opt, c["temp"], mesh=mesh)
            batches, ref = inp["batches1"], None
        else:
            step = ts.make_stage2_train_step(model.module, opt, beta=c["beta"], mesh=mesh)
            batches, ref = inp["pairs"], frozen_copy(model.module, torch.float32)
        metrics = []
        for b in batches:
            args = (state, mesh.shard_batch(b), 0) if stage == 1 else (state, ref, mesh.shard_batch(b), 0)
            state, m = step(*args)
            metrics.append({k: float(v) for k, v in m.items()})
        return {"metrics": metrics, "params": _snapshot(model.module.named_parameters())}

    out["dp1"], out["dp2"] = replicated(1), replicated(2)

    mask = lambda name: not name.startswith("vision_encoder.backbone.")  # noqa: E731
    sched = warmup_cosine_schedule(c["lr"], 1, 4)

    # ZeRO-1: two stage-1 steps, Adam's eps 1e-3 on both sides, the frozen vision backbone masked
    model = _port_model(inp["params"])
    loss_fn = ts.make_stage1_loss(model.module, c["temp"], mesh=mesh, axis_name="data")
    init_fn, step_fn = make_zero1_train_step(loss_fn, mesh, "data", learning_rate=sched, trainable_mask=mask, eps=1e-3)
    z = init_fn(model.module)
    metrics = []
    for b in inp["batches1"]:
        z, m = step_fn(z, mesh.shard_batch(b), 0)
        metrics.append({k: float(v) for k, v in m.items()})
    out["zero1"] = {"metrics": metrics, "params": step_fn.gather_params(z), "nbytes": z.nbytes(),
                    "padded": [s.padded_size for s in z.params.specs],
                    "empty_at_rest": all(p.numel() == 0 for p in model.module.parameters())}

    # ZeRO-3: three DPO steps with the reference sharded the same way
    model = _port_model(inp["params_scan"])
    ref = frozen_copy(model.module, torch.float32)
    loss_fn = ts.make_stage2_loss(model.module, ref, beta=c["beta"], mesh=mesh)
    init_fn, step_fn = make_zero3_train_step(loss_fn, mesh, "data", learning_rate=sched, trainable_mask=mask,
                                             eps=1e-3, with_ref=True)
    z = init_fn(model.module)
    ref_shards = init_fn.shard_ref(ref)
    metrics = []
    for b in inp["pairs"]:
        z, m = step_fn(z, mesh.shard_batch(b), 0, ref=ref_shards)
        metrics.append({k: float(v) for k, v in m.items()})
    out["zero3"] = {"metrics": metrics, "params": step_fn.gather_params(z), "nbytes": z.nbytes(),
                    "padded": [s.padded_size for s in z.params.specs],
                    "block_shards": [s.numel() for s in z.params.shards[1:]],
                    "empty_at_rest": all(p.numel() == 0 for p in model.module.parameters())}
    z.params.release()
    out["zero3"]["released"] = _snapshot(model.module.named_parameters())
    return out


def jax_replicated_reference(workdir: Path):
    """JAX's GSPMD stage-1 and stage-2 steps on a 2-device mesh, for tests/test_torch_parallel.py (this
    process imports JAX: it is no rank)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pgica_tpu.training import train_step as jts
    from pgica_tpu.training.optim import create_optimizer

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    c, params = inp["const"], inp["params"]
    from pgica_tpu.data.tokenizer import CaptionTokenizer
    from pgica_tpu.models import PreferenceGuidedCaptioningModel

    module = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), seed=0, **TINY).module
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    rep, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    key = jax.random.PRNGKey(0)
    out = {}
    for stage in (1, 2):
        opt = create_optimizer(c["lr"], total_steps=c["total"], warmup_steps=c["warmup"], params_for_freezing=params,
                               freeze_vision_backbone=True,
                               frozen_prefixes=(("caption_decoder",),) if stage == 1 else (("text_encoder",),))
        state = jts.TrainState.create(jax.device_put(params, rep), opt)
        if stage == 1:
            step = jax.jit(jts.make_stage1_train_step(module, opt, c["temp"], augment=False))
            run, batches = (lambda st, b: step(st, b, key)), inp["batches1"]
        else:
            step = jax.jit(jts.make_stage2_train_step(module, opt, c["beta"], augment=False))
            run, batches = (lambda st, b: step(st, params, b, key)), inp["pairs"]
        metrics = []
        for b in batches:
            state, m = run(state, jax.device_put(b, rows))
            metrics.append({k: float(v) for k, v in m.items()})
        out[f"dp{stage}"] = {"metrics": metrics, "params": {
            k: v.detach() for k, v in _port_model(jax.tree.map(np.asarray, state.params)).module.named_parameters()}}
    return out


# ---------------------------------------------------------------- the trainer (tests/test_torch_parallel_trainer.py)


def _identity_augment(images, *args, **kwargs):
    return images


def _port_trainer(cfg_dict, params, mesh, max_steps=None):
    from pgica_tpu_torch.training.trainer import PreferenceGuidedTrainer
    from pgica_tpu_torch.utils import factories
    from pgica_tpu_torch.utils.config import Config

    cfg = Config(config_dict=cfg_dict)
    tok = factories.create_tokenizer(cfg)
    model = factories.create_model(cfg, tok, device="cpu")
    if params is not None:
        model.load_jax_params(params)
    procs = factories.create_processors(cfg, tok)
    s1 = factories.create_loaders_with_fallback(cfg, *procs, kind="conceptual")
    s2 = factories.create_loaders_with_fallback(cfg, *procs, kind="ultrafeedback")
    return PreferenceGuidedTrainer(model, cfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                                   preference_val_loader=s2[1], mesh=mesh, max_steps_per_epoch=max_steps)


def _params_of(trainer):
    """The trainer's parameters by name, whole (gathered from a model cut over ``model`` or ``fsdp``)."""
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, is_sharded

    module = trainer.model.module
    named = {k: v.detach().clone() for k, v in module.named_parameters()}
    return gathered_state_dict(module, trainer.mesh, named) if is_sharded(module) else named


def trainer_cases(rank: int, world: int, workdir: Path):
    """The trainer in the five modes (augmentation the identity, as on the JAX side), a ZeRO-1 resume
    and the CLI, on this rank."""
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.scripts import train as cli
    from pgica_tpu_torch.training import train_step
    from pgica_tpu_torch.utils.config import Config

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    mesh = MeshContext(data=world)
    out = {}
    held = train_step.augment_batch
    train_step.augment_batch = _identity_augment
    try:
        for mode, cfg in inp["modes"].items():
            trainer = _port_trainer(cfg, inp["params_scan" if mode == "zero3" else "params"],
                                    MeshContext.from_config(Config(config_dict=cfg)))
            trainer.train()
            out[mode] = {"history": trainer.history, "global_step": trainer.global_step, "params": _params_of(trainer),
                         "saves": [s["name"] for s in trainer.checkpoints.saves]}
    finally:
        train_step.augment_batch = held

    # a mid-epoch ZeRO-1 autosave (dropout and augmentation on) resumed ends with the uninterrupted run's bits
    full = _port_trainer(inp["resume"]["full"], None, mesh)
    full.train_stage1()
    full.checkpoints.wait()
    mesh.barrier()
    auto = Path(inp["resume"]["full"]["paths"]["checkpoint_dir"]) / "autosave_stage1"
    resumed = _port_trainer(inp["resume"]["resumed"], None, mesh)
    meta = resumed.load_checkpoint(auto)
    resumed.train_stage1()
    resumed.checkpoints.wait()
    mesh.barrier()
    out["resume"] = {"meta": {k: meta[k] for k in ("global_step", "epoch", "step_in_epoch")},
                     "full": _params_of(full), "resumed": _params_of(resumed),
                     "steps": (full.global_step, resumed.global_step)}
    if rank == 0:
        a = full.checkpoints.restore("checkpoint_stage1_epoch1")["opt_state"]["zero"]
        b = resumed.checkpoints.restore("checkpoint_stage1_epoch1")["opt_state"]["zero"]
        out["resume"]["moments_equal"] = all(torch.equal(x, y) for k in ("mu", "nu") for x, y in zip(a[k], b[k]))
        out["resume"]["count"] = (a["count"], b["count"])

    # the CLI, as torchrun would start it (the group is up already): ZeRO-1, then model 2, seq 2 and fsdp 2
    for key in ("cli", "cli_tp", "cli_cp", "cli_fsdp"):
        trainer = cli.run(inp[key])
        out_dir = Path(inp[key][inp[key].index("--output-dir") + 1])
        out[key] = {"global_step": trainer.global_step, "writer": trainer.is_writer, "mesh": trainer.mesh.shape,
                    "results": (out_dir / "results.json").exists(),
                    "snapshot": (out_dir / "config_snapshot.yaml").exists()}
    return out


class _Resumes:
    """A logging handler that keeps whether a trainer resumed its optimizer state or started it fresh."""

    def __init__(self, logger_name: str):
        import logging

        self.said = []
        self.logger = logging.getLogger(logger_name)
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.said.append(record.getMessage())
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)

    def verdict(self) -> str:
        self.logger.removeHandler(self.handler)
        if any(m.startswith("Could not resume optimizer state") for m in self.said):
            return "fresh"
        return "resumed" if any("optimizer state from checkpoint" in m for m in self.said) else "none"


def zero_resume_cases(rank: int, world: int, workdir: Path):
    """The ZeRO checkpoints of tests/test_torch_parallel_trainer.py: on two ranks each case's first run saves
    its epoch checkpoint; on four ranks a trainer loads it and takes one more step (augmentation the identity)."""
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.training import train_step
    from pgica_tpu_torch.utils.config import Config

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {}
    held = train_step.augment_batch
    train_step.augment_batch = _identity_augment
    try:
        for name, case in inp["zero_resume"].items():
            if world == 2:
                trainer = _port_trainer(case["save"], case["params"], MeshContext.from_config(Config(config_dict=case["save"])))
                trainer.train()
                out[name] = {"global_step": trainer.global_step}
                continue
            trainer = _port_trainer(case["resume"], None, MeshContext.from_config(Config(config_dict=case["resume"])),
                                    max_steps=1)
            said = _Resumes("pgica_tpu_torch.training.trainer")
            trainer.load_checkpoint(case["checkpoint"])
            trainer.train()
            out[name] = {"verdict": said.verdict(), "history": trainer.history, "global_step": trainer.global_step,
                         "params": _params_of(trainer)}
    finally:
        train_step.augment_batch = held
    return out


def _jax_trainer(cfg_dict, devices, max_steps=None):
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
    from pgica_tpu.utils import factories as jfactories
    from pgica_tpu.utils.config import Config as JaxConfig

    cfg = JaxConfig(config_dict=cfg_dict)
    tok = jfactories.create_tokenizer(cfg)
    model = jfactories.create_model(cfg, tok)
    procs = jfactories.create_processors(cfg, tok)
    s1 = jfactories.create_loaders_with_fallback(cfg, *procs, kind="conceptual")
    s2 = jfactories.create_loaders_with_fallback(cfg, *procs, kind="ultrafeedback")
    return JaxTrainer(model, cfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                      preference_val_loader=s2[1], mesh=JaxMesh.from_config(cfg, devices=devices),
                      max_steps_per_epoch=max_steps), cfg


def jax_zero_resume_reference(workdir: Path, name: str):
    """The JAX trainer's side of one ZeRO resume case: the first run on two devices, then the resume on four
    (this process imports JAX: it is no rank)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from pgica_tpu.training import train_step as jax_train_step

    jax_train_step.augment_batch = lambda key, images, enabled=True: images
    case = torch.load(workdir / "inputs.pt", weights_only=False)["zero_resume"][name]
    first, _ = _jax_trainer(case["save"], jax.devices()[:2])
    first.train()
    trainer, cfg = _jax_trainer(case["resume"], jax.devices()[:4], max_steps=1)
    said = _Resumes("pgica_tpu.training.trainer")
    trainer.load_checkpoint(case["checkpoint"])
    trainer.train()
    return {"verdict": said.verdict(), "history": trainer.history, "global_step": trainer.global_step,
            "params": _port_model_of(cfg, jax.tree.map(np.asarray, trainer.model.params))}


def jax_trainer_reference(workdir: Path, mode: str):
    """The JAX trainer on a 2-device mesh in one mode, augmentation the identity (this process imports
    JAX: it is no rank)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.training import train_step as jax_train_step
    from pgica_tpu.training.trainer import PreferenceGuidedTrainer as JaxTrainer
    from pgica_tpu.utils import factories as jfactories
    from pgica_tpu.utils.config import Config as JaxConfig

    from pgica_tpu.training import cp_step as jax_cp_step

    jax_train_step.augment_batch = lambda key, images, enabled=True: images
    jax_cp_step.augment_batch = jax_train_step.augment_batch  # the CP step's own import
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    cfg = JaxConfig(config_dict=inp["modes"][mode])
    tok = jfactories.create_tokenizer(cfg)
    model = jfactories.create_model(cfg, tok)
    procs = jfactories.create_processors(cfg, tok)
    s1 = jfactories.create_loaders_with_fallback(cfg, *procs, kind="conceptual")
    s2 = jfactories.create_loaders_with_fallback(cfg, *procs, kind="ultrafeedback")
    trainer = JaxTrainer(model, cfg, train_loader=s1[0], val_loader=s1[1], preference_train_loader=s2[0],
                         preference_val_loader=s2[1], mesh=JaxMesh.from_config(cfg, devices=jax.devices()[:2]))
    trainer.train()
    params = _port_model_of(cfg, jax.tree.map(np.asarray, trainer.model.params))
    return {"history": trainer.history, "global_step": trainer.global_step, "params": params}


def _port_model_of(jcfg, tree):
    from pgica_tpu_torch.utils import factories
    from pgica_tpu_torch.utils.config import Config

    model = factories.create_model(Config(config_dict=jcfg.to_dict()), device="cpu")
    model.load_jax_params(tree)
    return {k: v.detach() for k, v in model.module.named_parameters()}
