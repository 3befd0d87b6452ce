"""Rank programs and JAX references of tests/test_torch_fsdp.py (not a test module).

``fsdp_cases`` runs in each of eight gloo ranks started by ``_torch_ranks.start`` (torch and the port only);
``jax_fsdp_reference`` in spawned JAX processes on ``jax.devices()[:8]`` of the 8-device CPU platform
(tests/conftest.py's ``XLA_FLAGS``), meanwhile. Both read ``workdir/inputs.pt``.
"""

import dataclasses
import math
import re
from pathlib import Path

import numpy as np
import torch

import _torch_tp_ranks as tr

# case: (text model, layers or None for the preset's, scan_layers and remat, mesh)
CASES = {
    "llama_dfm": ("tiny-llama", None, False, {"data": 2, "fsdp": 2, "model": 2}),
    "llama_scan4": ("tiny-llama", 4, True, {"data": 2, "fsdp": 2, "model": 2}),
    "llama_scan3": ("tiny-llama", 3, True, {"data": 2, "fsdp": 2, "model": 2}),
    "gpt2_df4": ("tiny-gpt2", None, False, {"data": 2, "fsdp": 4}),
    "gpt2_cp": ("tiny-gpt2", None, False, {"data": 1, "fsdp": 2, "model": 2, "seq": 2}),
}


def model_name(case: str) -> str:
    text, layers, _, _ = CASES[case]
    return text if layers is None else f"{text}-{layers}"


# ---------------------------------------------------------------- the port's side (a rank)


def port_model(case: str, params):
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
    from pgica_tpu_torch.models.presets import get_text_config

    text, layers, scan, _ = CASES[case]
    config = get_text_config(text) if layers is None else dataclasses.replace(get_text_config(text), num_layers=layers)
    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", text_model=config,
                                            remat=scan, **tr.TINY8)
    if params is not None:
        model.load_jax_params(params)
    return model


def _leaf_bytes(module, named, scanned: bool) -> dict:
    """{JAX path: bytes} of (name, tensor) pairs laid out like ``module``'s parameters; under ``scanned`` the
    LMs' blocks add up under their stacked paths (``blocks/...``)."""
    from pgica_tpu_torch.parallel.zero1 import _lms, jax_path

    stacked = tuple(f"{prefix}.blocks." for prefix, _ in _lms(module)) if scanned else ()
    out = {}
    for name, t in named:
        path = "/".join(jax_path(module, name))
        if stacked and name.startswith(stacked):
            path = re.sub(r"/block_\d+/", "/blocks/", path, count=1)
        out[path] = out.get(path, 0) + t.numel() * t.element_size()
    return out


def _train(case: str, params, mesh, stage: int, batches) -> dict:
    """``len(batches)`` updates of the model cut over ``model`` and ``fsdp``: metrics, the gathered parameters and
    Adam moments, this rank's bytes of parameters, moments and the stage-2 reference's parameters."""
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, shard_fsdp, shard_module, tp_dims
    from pgica_tpu_torch.training import train_step as ts
    from pgica_tpu_torch.training.cp_step import make_stage2_cp_train_step

    module = port_model(case, params).module
    shard_module(module, mesh)
    shard_fsdp(module, mesh, scanned=CASES[case][2])
    opt = tr._optimizer(stage)
    state = ts.TrainState.create(module, opt)
    ref = None
    if stage == 1:
        step = ts.make_stage1_train_step(module, opt, tr.TEMP, mesh=mesh)
    else:
        ref = frozen_copy(module, torch.float32)
        step = (make_stage2_cp_train_step(module, opt, mesh, "seq", beta=tr.BETA, use_fused_ce=True)
                if mesh.shape["seq"] > 1 else ts.make_stage2_train_step(module, opt, tr.BETA, mesh=mesh))
    metrics = []
    for b in batches:
        local = mesh.shard_batch(b)
        state, m = step(state, local, 0) if stage == 1 else step(state, ref, local, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    names, scanned = state.opt_state.names, CASES[case][2]
    moments = list(zip(names, state.opt_state.mu)) + list(zip(names, state.opt_state.nu))
    return {"metrics": metrics, "params": gathered_state_dict(module, mesh),
            "mu": gathered_state_dict(module, mesh, dict(zip(names, state.opt_state.mu))),
            "nu": gathered_state_dict(module, mesh, dict(zip(names, state.opt_state.nu))),
            "bytes": {"params": _leaf_bytes(module, module.named_parameters(), scanned),
                      "adam": _leaf_bytes(module, moments, scanned),
                      "reference": None if ref is None else _leaf_bytes(ref, ref.named_parameters(), scanned),
                      "model_cut": set(_leaf_bytes(module, [(n, p) for n, p in module.named_parameters()
                                                            if n in tp_dims(module)], scanned))},
            "count": state.opt_state.count}


def fsdp_cases(rank, world, workdir: Path):
    """Every case of tests/test_torch_fsdp.py on this rank: two stage-1 and two stage-2 updates of each."""
    from pgica_tpu_torch.parallel.mesh import MeshContext

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {"coords": {}}
    for case, (_, _, _, shape) in CASES.items():
        mesh = MeshContext(**shape)
        out["coords"][case] = mesh.coords
        params = inp["params"][model_name(case)]
        for stage, batches in ((1, inp["batches1"]), (2, inp["pairs"])):
            if stage == 1 and shape.get("seq", 1) > 1:
                continue  # the CP step is stage 2's
            out[f"{case}_s{stage}"] = _train(case, params, mesh, stage, batches)
    return out


# ---------------------------------------------------------------- JAX's side (no rank)


def jax_module(case: str):
    """The JAX module of ``case`` (a cut depth through a preset registered for the call)."""
    from pgica_tpu.models import presets as jax_presets
    from pgica_tpu.models.model import build_module

    text, layers, scan, _ = CASES[case]
    name = model_name(case)
    if layers is not None:
        jax_presets.TEXT_PRESETS[name] = dataclasses.replace(jax_presets.TEXT_PRESETS[text], num_layers=layers)
    try:
        kw = {k: v for k, v in tr.TINY8.items() if k != "image_size"}
        return build_module(text_model=name, vocab_size=261, freeze_vision_backbone=True, scan_layers=scan,
                            remat=scan, **kw)
    finally:
        if layers is not None:
            del jax_presets.TEXT_PRESETS[name]


def jax_params(case: str, seed: int = 0):
    """Numpy parameters of :func:`jax_module` from a jitted ``init``."""
    jax = tr._jax_cpu()
    import jax.numpy as jnp

    module = jax_module(case)
    ids = jnp.zeros((1, tr.TINY8["max_caption_length"]), jnp.int32)
    images = jnp.zeros((1, tr.TINY8["image_size"], tr.TINY8["image_size"], 3), jnp.float32)
    init = jax.jit(lambda key: module.init(key, images, ids, jnp.ones_like(ids), mode="dual")["params"])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def _device_bytes(trees, devices) -> dict:
    """{path: each device's bytes} of trees of sharded arrays laid out like the parameters (their addressable
    shards; a path's bytes summed over the trees)."""
    import jax

    out = {}
    index = {d: i for i, d in enumerate(devices)}
    for tree in trees:
        for key_path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            per = out.setdefault("/".join(str(getattr(k, "key", k)) for k in key_path), [0] * len(devices))
            for shard in leaf.addressable_shards:
                per[index[shard.device]] += shard.data.nbytes
    return out


def _adam_bytes(opt_state, devices) -> dict:
    import jax
    import optax

    found = []
    jax.tree_util.tree_map(lambda x: found.append(x) if isinstance(x, optax.ScaleByAdamState) else None, opt_state,
                           is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return _device_bytes((found[0].mu, found[0].nu), devices)


def _jax_train(jax, case: str, stage: int, batches, params) -> dict:
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.parallel.sharding import shard_params
    from pgica_tpu.training import train_step as jts
    from pgica_tpu.training.optim import create_optimizer

    shape = CASES[case][3]
    devices = jax.devices()[:math.prod(shape.values())]
    module = jax_module(case)
    jm = JaxMesh(devices=devices, **shape)
    sharded = shard_params(params, jm.mesh)
    opt = create_optimizer(tr.LR, total_steps=tr.TOTAL, warmup_steps=tr.WARMUP, params_for_freezing=params,
                           freeze_vision_backbone=True,
                           frozen_prefixes=(("caption_decoder",),) if stage == 1 else (("text_encoder",),))
    state = jts.TrainState.create(sharded, opt)
    key = jax.random.PRNGKey(0)
    # at rest, as the rules lay the state out (a jitted step's outputs may take other shardings)
    nbytes = {"params": _device_bytes([sharded], devices), "adam": _adam_bytes(state.opt_state, devices),
              "reference": None, "whole": sum(leaf.nbytes for leaf in jax.tree.leaves(params))}
    ref = None
    if stage == 1:
        step = jax.jit(jts.make_stage1_train_step(module, opt, tr.TEMP, augment=False))
    else:
        ref = shard_params(params, jm.mesh)
        nbytes["reference"] = _device_bytes([ref], devices)
        step = jax.jit(jts.make_stage2_train_step(module, opt, tr.BETA, augment=False, mesh=jm.mesh))
    metrics = []
    for b in batches:
        local = jm.shard_batch(b)
        state, m = step(state, local, key) if stage == 1 else step(state, ref, local, key)
        metrics.append({k: float(v) for k, v in m.items()})
    host = jax.tree.map(np.asarray, state.params)
    mu, nu = tr._moments(state.opt_state, host)
    named = lambda tree: {k: v.detach().clone() for k, v in  # noqa: E731
                          port_model(case, tree).module.named_parameters()}
    return {"metrics": metrics, "params": named(host), "mu": named(mu), "nu": named(nu), "bytes": nbytes}


def jax_fsdp_reference(workdir: Path, cases: tuple):
    """JAX's GSPMD steps of ``cases`` on the ranks' meshes, with the same weights and batches."""
    jax = tr._jax_cpu()
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {}
    for case in cases:
        params = inp["params"][model_name(case)]
        for stage, batches in ((1, inp["batches1"]), (2, inp["pairs"])):
            if stage == 1 and CASES[case][3].get("seq", 1) > 1:
                continue
            out[f"{case}_s{stage}"] = _jax_train(jax, case, stage, batches, params)
    return out
