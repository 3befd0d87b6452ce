"""Rank programs and JAX references of the port's tensor- and context-parallel tests (not a test module).

A rank program runs in a gloo rank started by ``_torch_ranks.start`` (torch
and the port only; ``_torch_ranks`` records what each rank imported). A
``jax_*`` function runs in the one JAX process of ``_torch_ranks.start_jax``
on ``jax.devices()[:4]`` of the 8-device CPU platform (tests/conftest.py's
``XLA_FLAGS``), meanwhile. Both read ``workdir/inputs.pt``.
"""

import functools
from pathlib import Path

import numpy as np
import torch

TINY8 = dict(vision_model="tiny-vit", projection_dim=16, dropout=0.0, max_caption_length=8, image_size=32)
LR, TOTAL, WARMUP, TEMP, BETA = 1e-3, 10, 2, 0.5, 0.1


# ---------------------------------------------------------------- the port's side (a rank)


def port_model(params, text):
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", text_model=text, **TINY8)
    model.load_jax_params(params)
    return model


def _optimizer(stage):
    from pgica_tpu_torch.training.optim import create_optimizer

    return create_optimizer(LR, TOTAL, WARMUP, freeze_vision_backbone=True,
                            frozen_prefixes=("caption_decoder",) if stage == 1 else ("text_encoder",))


def _train(params, text, mesh, stage, batches):
    """``len(batches)`` updates of a model cut over ``model``: metrics, and the gathered parameters and Adam
    moments, and this rank's bytes of the cut parameters."""
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, shard_module, sharded_bytes
    from pgica_tpu_torch.training import train_step as ts

    module = port_model(params, text).module
    shard_module(module, mesh)
    opt = _optimizer(stage)
    state = ts.TrainState.create(module, opt)
    if stage == 1:
        step = ts.make_stage1_train_step(module, opt, TEMP, mesh=mesh)
    else:
        ref = frozen_copy(module, torch.float32)
        step = ts.make_stage2_train_step(module, opt, BETA, mesh=mesh)
    metrics = []
    for b in batches:
        local = mesh.shard_batch(b)
        state, m = step(state, local, 0) if stage == 1 else step(state, ref, local, 0)
        metrics.append({k: float(v) for k, v in m.items()})
    names = state.opt_state.names
    return {"metrics": metrics, "params": gathered_state_dict(module, mesh),
            "mu": gathered_state_dict(module, mesh, dict(zip(names, state.opt_state.mu))),
            "nu": gathered_state_dict(module, mesh, dict(zip(names, state.opt_state.nu))),
            "bytes": sharded_bytes(module), "count": state.opt_state.count}


def _vocab_parallel_ce(mesh, case):
    """This rank's rows of ``fused_token_logprobs_tp`` and its gradients (the embedding's block, padded by
    zero rows to a multiple of the axis)."""
    from pgica_tpu_torch.ops.fused_ce import fused_token_logprobs_tp

    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    vocab = case["w"].shape[0]
    vloc = -(-vocab // n)
    w = np.concatenate([case["w"], np.zeros((vloc * n - vocab, case["w"].shape[1]), np.float32)])
    rows = mesh.shard_batch({k: case[k] for k in ("h", "y", "g")})
    h = torch.from_numpy(rows["h"]).requires_grad_()
    block = torch.from_numpy(w[r * vloc:(r + 1) * vloc].copy()).requires_grad_()
    with mesh:
        out = fused_token_logprobs_tp(h, block, torch.from_numpy(rows["y"]), "model", true_vocab=vocab)
    (out * torch.from_numpy(rows["g"])).sum().backward()
    return {"out": out.detach(), "dh": h.grad, "dw": block.grad}


def _same_tree(a, b) -> bool:
    if isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in b)
    return type(a) is type(b) and np.array_equal(a, b)


def tp_cases(rank, world, workdir: Path):
    """Every case of tests/test_torch_tensor_parallel.py, on four ranks: data 2 x model 2, then model 4."""
    from pgica_tpu_torch.ops.losses import sequence_logprobs, sequence_logprobs_from_hidden
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.parallel.sharding import gather_params, param_dims, shard_module, shard_params
    from pgica_tpu_torch.training.train_step import decoder_embedding

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    dm = MeshContext(data=2, model=2)
    m4 = MeshContext(model=4)
    out = {"coords": {"dm": dm.coords, "m4": m4.coords}}
    tree = inp["params"]["tiny-llama"]  # gather_params of shard_params over the ranks is the tree, at both degrees
    out["gather"] = {name: _same_tree(gather_params(shard_params(tree, mesh), mesh, param_dims(tree, mesh)), tree)
                     for name, mesh in (("dm", dm), ("m4", m4))}
    out["ce"] = {f"{name}_{mesh_name}": _vocab_parallel_ce(mesh, inp["ce"][name])
                 for name, mesh_name, mesh in (("values", "dm", dm), ("values", "m4", m4), ("neighbour", "dm", dm),
                                               ("padded", "m4", m4), ("padded", "dm", dm))}

    # the forward of a model cut over model 2 on this rank's rows; the vocab-parallel log-probs
    module = port_model(inp["params"]["tiny-gpt2"], "tiny-gpt2").module
    shard_module(module, dm)
    b = dm.shard_batch(inp["forward"])
    with torch.no_grad(), dm:
        fwd = module(torch.from_numpy(b["image"]), torch.from_numpy(b["ids"]), torch.from_numpy(b["mask"]),
                     mode="contrastive")
        vision = module.encode_image(torch.from_numpy(b["image"]))
        ids, mask = torch.from_numpy(b["ids"]), torch.from_numpy(b["mask"])
        dec = module.decode_train(ids, mask, vision["embeddings"])
        fused = sequence_logprobs_from_hidden(dec["hidden_states"], decoder_embedding(module), ids, mask, mesh=dm,
                                              vocab_size=module.caption_decoder.lm.config.vocab_size)
        plain = sequence_logprobs(dec["logits"], ids, mask)
    out["forward"] = {"image_embeddings": fwd["image_embeddings"], "text_embeddings": fwd["text_embeddings"],
                      "fused": fused, "plain": plain, "logits_vocab": dec["logits"].shape[-1]}

    out["gpt2_s1"] = _train(inp["params"]["tiny-gpt2"], "tiny-gpt2", dm, 1, inp["batches1"])
    out["gpt2_s2"] = _train(inp["params"]["tiny-gpt2"], "tiny-gpt2", dm, 2, inp["pairs"])
    out["llama_dm_s2"] = _train(inp["params"]["tiny-llama"], "tiny-llama", dm, 2, inp["pairs"][:1])
    out["llama_m4_s1"] = _train(inp["params"]["tiny-llama"], "tiny-llama", m4, 1, inp["batches1"])
    out["llama_m4_s2"] = _train(inp["params"]["tiny-llama"], "tiny-llama", m4, 2, inp["pairs"])
    return out


# ---------------------------------------------------------------- JAX's side (no rank)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


@functools.lru_cache(maxsize=None)
def jax_module(text):
    """The JAX module that ``PreferenceGuidedCaptioningModel(text_model=text, **TINY8)`` builds (vocab 261)."""
    from pgica_tpu.models.model import build_module

    kw = {k: v for k, v in TINY8.items() if k != "image_size"}
    return build_module(text_model=text, vocab_size=261, freeze_vision_backbone=True, **kw)


def jax_params(text, seed=0):
    """Numpy parameters of :func:`jax_module` from a jitted ``init`` (the wrapper's eager init takes ~20 s)."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    module = jax_module(text)
    ids = jnp.zeros((1, TINY8["max_caption_length"]), jnp.int32)
    images = jnp.zeros((1, TINY8["image_size"], TINY8["image_size"], 3), jnp.float32)
    init = jax.jit(lambda key: module.init(key, images, ids, jnp.ones_like(ids), mode="dual")["params"])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def port_named(tree, text):
    """A JAX-layout tree in the port's names (through the weight bridge)."""
    return {k: v.detach().clone() for k, v in port_model(tree, text).module.named_parameters()}


def _moments(opt_state, params):
    """The Adam moments of an optax state as full parameter trees (masked leaves as zeros)."""
    import jax
    import optax

    found = []
    jax.tree_util.tree_map(lambda x: found.append(x) if isinstance(x, optax.ScaleByAdamState) else None, opt_state,
                           is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    adam = next(x for x in found if isinstance(x, optax.ScaleByAdamState))

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda p, m: np.zeros(p.shape, np.float32) if isinstance(m, optax.MaskedNode) else np.asarray(m),
            params, tree, is_leaf=lambda x: isinstance(x, optax.MaskedNode))

    return fill(adam.mu), fill(adam.nu)


def _jax_train(jax, text, shape, stage, batches, params):
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.parallel.sharding import shard_params
    from pgica_tpu.training import train_step as jts
    from pgica_tpu.training.optim import create_optimizer

    module = jax_module(text)
    jm = JaxMesh(devices=jax.devices()[:4], **shape)
    sharded = shard_params(params, jm.mesh)
    opt = create_optimizer(LR, total_steps=TOTAL, warmup_steps=WARMUP, params_for_freezing=params,
                           freeze_vision_backbone=True,
                           frozen_prefixes=(("caption_decoder",),) if stage == 1 else (("text_encoder",),))
    state = jts.TrainState.create(sharded, opt)
    key = jax.random.PRNGKey(0)
    if stage == 1:
        step = jax.jit(jts.make_stage1_train_step(module, opt, TEMP, augment=False))
    else:
        step = jax.jit(jts.make_stage2_train_step(module, opt, BETA, augment=False, mesh=jm.mesh))
    metrics = []
    for b in batches:
        local = jm.shard_batch(b)
        state, m = step(state, local, key) if stage == 1 else step(state, params, local, key)
        metrics.append({k: float(v) for k, v in m.items()})
    host = jax.tree.map(np.asarray, state.params)
    mu, nu = _moments(state.opt_state, host)
    return {"metrics": metrics, "params": port_named(host, text), "mu": port_named(mu, text),
            "nu": port_named(nu, text)}


def jax_tp_reference(workdir: Path, part: str):
    """JAX's side of tests/test_torch_tensor_parallel.py, in three parts run by three processes: "gpt2"
    (tiny-gpt2's GSPMD steps at data 2 x model 2), "llama_m4" (tiny-llama's at model 4) and "llama_dm"
    (tiny-llama's DPO step at data 2 x model 2, the unsharded fused CE and forward), on the same meshes as
    the ranks'."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    from pgica_tpu.ops.fused_ce import fused_token_logprobs
    from pgica_tpu.ops.losses import sequence_logprobs

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    dm, m4 = {"data": 2, "model": 2}, {"data": 1, "model": 4}
    out = {}
    llama = inp["params"]["tiny-llama"]
    if part == "llama_m4":
        out["llama_m4_s1"] = _jax_train(jax, "tiny-llama", m4, 1, inp["batches1"], llama)
        out["llama_m4_s2"] = _jax_train(jax, "tiny-llama", m4, 2, inp["pairs"], llama)
        return out
    if part == "llama_dm":
        out["llama_dm_s2"] = _jax_train(jax, "tiny-llama", dm, 2, inp["pairs"][:1], llama)
    if part == "gpt2":
        params = inp["params"]["tiny-gpt2"]
        out["gpt2_s1"] = _jax_train(jax, "tiny-gpt2", dm, 1, inp["batches1"], params)
        out["gpt2_s2"] = _jax_train(jax, "tiny-gpt2", dm, 2, inp["pairs"], params)
        return out
    out["ce"] = {}
    for name, case in inp["ce"].items():
        def loss(h, w, case=case):
            return jnp.sum(fused_token_logprobs(h, w, case["y"], impl="xla") * case["g"])

        value = fused_token_logprobs(case["h"], case["w"], case["y"], impl="xla")
        dh, dw = jax.grad(loss, argnums=(0, 1))(case["h"], case["w"])
        out["ce"][name] = {"out": np.asarray(value), "dh": np.asarray(dh), "dw": np.asarray(dw)}

    params = inp["params"]["tiny-gpt2"]
    module = jax_module("tiny-gpt2")
    f = inp["forward"]
    fwd = module.apply({"params": params}, f["image"], f["ids"], f["mask"], mode="contrastive")
    vision = module.apply({"params": params}, f["image"], method="encode_image")
    dec = module.apply({"params": params}, f["ids"], f["mask"], vision["embeddings"], True, method="decode_train")
    out["forward"] = {"image_embeddings": np.asarray(fwd["image_embeddings"]),
                      "text_embeddings": np.asarray(fwd["text_embeddings"]),
                      "logprobs": np.asarray(sequence_logprobs(dec["logits"], f["ids"], f["mask"]))}
    return out


# ---------------------------------------------------------------- context parallelism


def _seq_block(x, mesh, dim):
    n, i = mesh.axis_size("seq"), mesh.axis_index("seq")
    size = x.shape[dim] // n
    return torch.from_numpy(np.ascontiguousarray(np.take(x, range(i * size, (i + 1) * size), axis=dim)))


def _ring_case(mesh, case, causal, with_bias):
    """This rank's block of ring attention over ``seq`` and the gradients of sum(out * g) for its blocks."""
    from pgica_tpu_torch.ops.ring_attention import ring_attention

    q, k, v = (_seq_block(case[x], mesh, 2).requires_grad_() for x in "qkv")
    bias = _seq_block(case["bias"], mesh, 1) if with_bias else None
    with mesh:
        out = ring_attention(q, k, v, "seq", causal=causal, kv_bias=bias)
    (out * _seq_block(case["g"], mesh, 2)).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def _ring_lm(params, arch, mesh, ids, mask):
    """The LM's logits of this rank's sequence block, self-attention over the ring."""
    from pgica_tpu_torch.models.convert import load_jax_params
    from pgica_tpu_torch.models.lm import TransformerLM
    from pgica_tpu_torch.models.presets import get_text_config

    lm = TransformerLM(get_text_config("tiny-gpt2" if arch == "gpt2" else "tiny-llama", vocab_size=64))
    load_jax_params(lm, params)
    lm.ring_axis = "seq"
    for block in lm.blocks:
        block.attn.ring_axis = "seq"
    with torch.no_grad(), mesh:
        return lm(input_ids=_seq_block(ids, mesh, 1), attention_mask=_seq_block(mask, mesh, 1))["logits"]


def _cp_loss_and_grads(params, mesh, batch, length_normalized=False, reference_free=False, use_fused_ce=False,
                       tp=False):
    """The CP DPO loss of this rank's rows and the whole-model gradients (summed over ``seq``, gathered
    over ``model`` when the model is cut)."""
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.parallel import collectives
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, shard_module
    from pgica_tpu_torch.training.cp_step import make_stage2_cp_loss_fn
    from pgica_tpu_torch.training.train_step import PAIR_KEYS, _on_device

    module = port_model(params, "tiny-gpt2").module
    if tp:
        shard_module(module, mesh)
    ref = None if reference_free else frozen_copy(module, torch.float32)
    loss_fn = make_stage2_cp_loss_fn(module, mesh, "seq", BETA, reference_free, length_normalized,
                                     use_fused_ce=use_fused_ce)
    local = _on_device(mesh.shard_batch(batch), torch.device("cpu"), PAIR_KEYS)
    names, params_ = zip(*module.named_parameters())
    with torch.enable_grad():
        loss, metrics = loss_fn(ref, local, None)
        grads = torch.autograd.grad(loss, params_, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params_)]
    with mesh:
        grads = {n: collectives.psum(g, "seq") for n, g in zip(names, grads)}
    if tp:
        grads = gathered_state_dict(module, mesh, grads)
    return {"loss": float(loss.detach()), "metrics": {k: float(v.detach()) for k, v in metrics.items()}, "grads": grads}


def _cp_train_step(params, mesh, batch):
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.training.cp_step import make_stage2_cp_train_step
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState

    module = port_model(params, "tiny-gpt2").module
    opt = create_optimizer(1e-3, 2, 1)
    state = TrainState.create(module, opt)
    step = make_stage2_cp_train_step(module, opt, mesh, "seq", beta=BETA)
    ref = frozen_copy(module, torch.float32)
    for _ in range(2):  # the first update's learning rate is 0 (warmup from 0)
        state, metrics = step(state, ref, mesh.shard_batch(batch), 7)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone() for k, v in module.named_parameters()}}


def cp_cases(rank, world, workdir: Path):
    """Every case of tests/test_torch_context_parallel.py, on four ranks: seq 4, data 2 x seq 2 and
    model 2 x seq 2."""
    from pgica_tpu_torch.parallel.mesh import MeshContext

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    s4, ds, ms = MeshContext(seq=4), MeshContext(data=2, seq=2), MeshContext(model=2, seq=2)
    out = {"coords": {"s4": s4.coords, "ds": ds.coords, "ms": ms.coords}, "ring": {}}
    for name, mesh in (("s4", s4), ("ds", ds)):
        for causal in (False, True):
            for bias in (False, True):
                out["ring"][f"{name}_{causal}_{bias}"] = _ring_case(mesh, inp["qkv"], causal, bias)
    out["lm"] = {arch: _ring_lm(inp["lm_params"][arch], arch, s4, inp["lm_ids"], inp["lm_mask"])
                 for arch in ("gpt2", "llama")}
    params, pairs, pairs2 = inp["params"], inp["pairs"], inp["pairs2"]
    out["loss"] = {ln: _cp_loss_and_grads(params, s4, pairs, length_normalized=ln) for ln in (False, True)}
    out["step"] = _cp_train_step(params, s4, pairs)
    out["fused"] = {f: _cp_loss_and_grads(params, s4, pairs2, reference_free=True, use_fused_ce=f)["loss"]
                    for f in (False, True)}
    out["data"] = _cp_loss_and_grads(params, ds, pairs, reference_free=True)["metrics"]
    out["tp_cp"] = _cp_loss_and_grads(params, ms, pairs, use_fused_ce=True, tp=True)
    return out


def jax_cp_reference(workdir: Path, part: str):
    """JAX's side of tests/test_torch_context_parallel.py, unsharded, in three parts run by three processes:
    "attention" (one-device attention, the LM forwards), "loss" (the stage-2 loss and gradients) and
    "step" (two updates, the reference-free losses)."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    from pgica_tpu.models.lm import TransformerLM as JaxLM
    from pgica_tpu.models.presets import get_text_config as jax_text_config
    from pgica_tpu.ops.attention import _xla_attention
    from pgica_tpu.training import train_step as jts
    from pgica_tpu.training.optim import create_optimizer

    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    out = {}
    if part == "attention":
        c = inp["qkv"]
        keep = c["bias"] == 0.0
        out["ring"] = {}
        for causal in (False, True):
            for bias in (False, True):
                mask = jnp.asarray(keep[:, None, None, :]) if bias else None

                def loss(q, k, v, mask=mask, causal=causal):
                    o = _xla_attention(q, k, v, mask, causal)
                    return jnp.sum(o * c["g"]), o

                (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(c["q"], c["k"], c["v"])
                out["ring"][f"{causal}_{bias}"] = {"out": np.asarray(o),
                                                  **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)}}
        out["lm"] = {}
        for arch in ("gpt2", "llama"):
            lm = JaxLM(jax_text_config("tiny-gpt2" if arch == "gpt2" else "tiny-llama", vocab_size=64),
                       with_lm_head=True)
            out["lm"][arch] = np.asarray(lm.apply({"params": inp["lm_params"][arch]}, input_ids=inp["lm_ids"],
                                                  attention_mask=inp["lm_mask"])["logits"])
        return out

    module, params = jax_module("tiny-gpt2"), inp["params"]
    key = jax.random.PRNGKey(3)

    def dpo(batch, length_norm=False, reference_free=False):
        def fn(p):
            return jts.stage2_loss_fn(p, None if reference_free else params, batch, key, module, BETA, reference_free,
                                      length_norm, 0.0, False)
        return fn

    if part == "loss":
        out["loss"] = {}
        for ln in (False, True):
            (loss, metrics), grads = jax.jit(jax.value_and_grad(dpo(inp["pairs"], ln), has_aux=True))(params)
            out["loss"][ln] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                               "grads": port_named(jax.tree.map(np.asarray, grads), "tiny-gpt2")}
        return out
    opt = create_optimizer(1e-3, total_steps=2, warmup_steps=1)
    step = jax.jit(jts.make_stage2_train_step(module, opt, beta=BETA, augment=False))
    state = jts.TrainState.create(params, opt)
    for _ in range(2):
        state, metrics = step(state, params, inp["pairs"], jax.random.PRNGKey(7))
    out["step"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "params": port_named(jax.tree.map(np.asarray, state.params), "tiny-gpt2")}
    out["free"] = {name: float(jax.jit(dpo(inp[name], reference_free=True))(params)[0]) for name in ("pairs", "pairs2")}
    return out
