"""The port's data-parallel stack against the JAX package, on the CPU.

Two gloo ranks (tests/_torch_ranks.py, spawned once for the module; they
import torch and the port only) hold the port against JAX on a 2-device CPU
mesh (``jax.devices()[:2]``). The JAX side runs while the ranks run, in
this process and (the GSPMD steps) in one spawned JAX process. JAX is
imported inside the functions only.

* ``MeshContext``: shapes, errors, ``dcn`` inference and each rank's
  coordinates, after JAX's ``TestMeshContext`` and ``TestDCNAxis``;
  ``shard_batch``'s rows equal JAX's addressable shards; a batch the ranks
  do not divide raises, as JAX's ``device_put`` does.
* ``all_gather``'s gradient (JAX's transpose: a reduce-scatter sum), and
  NT-Xent with global negatives, plain and fused: loss 1e-6, gradients
  1e-5 against JAX's ``shard_map`` with ``axis_name``.
* Replicated data parallelism, stage 1 and stage 2 (two steps each)
  against JAX's GSPMD step on the mesh: losses rel 1e-5, gradient norms
  rel 1e-4, parameters atol 1e-6 but for a share below 2% of the elements
  (the key biases apart) that Adam does not pin down, every element within
  Adam's bound of 2 lr an update (tests/test_torch_trainer.py's rule;
  tests/test_torch_stage2.py says why).
* ZeRO-1, two stage-1 steps, and ZeRO-3, three DPO steps with the
  reference sharded alike, both with the frozen vision backbone masked,
  against JAX's ``make_zero1_train_step`` / ``make_zero3_train_step``:
  losses rel 1e-5, gathered parameters atol 2e-6 under the same rule, with
  Adam's eps 1e-3 on both sides (JAX TestZero1's setting,
  tests/test_parallel.py:775-778).
  Each rank's moment bytes are 2 x 4 x ``padded_size / n``.
"""

import functools
import math

import numpy as np
import pytest
import torch

import _torch_ranks
from pgica_tpu_torch.parallel.mesh import MeshContext
from pgica_tpu_torch.parallel.zero1 import jax_path
from pgica_tpu_torch.parallel.zero3 import check_divisible

N = 2  # ranks, and JAX devices
LR, TOTAL, WARMUP, TEMP, BETA = 1e-3, 10, 2, 0.5, 0.1
LOSS_RTOL, NORM_RTOL, PARAM_ATOL, ZERO_ATOL, LOOSE_SHARE = 1e-5, 1e-4, 1e-6, 2e-6, 0.02
SEQ, IMG, B = 10, 32, 8


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _batch1(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, SEQ + 1, size=B)
    return {"image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8),
            "caption_ids": rng.integers(0, 261, size=(B, SEQ)).astype(np.int32),
            "caption_mask": (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)}


def _pairs(seed):
    rng = np.random.default_rng(seed)
    out = {"image": rng.integers(0, 256, size=(B, IMG, IMG, 3), dtype=np.uint8)}
    for key in ("preferred", "rejected"):
        lengths = rng.integers(3, SEQ + 1, size=B)
        out[f"{key}_ids"] = rng.integers(0, 261, size=(B, SEQ)).astype(np.int32)
        out[f"{key}_mask"] = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    return out


def _port_params(tree):
    """A JAX tree (unrolled or scanned) in the port's names and layout."""
    return {k: v.detach() for k, v in _torch_ranks._port_model(tree).module.named_parameters()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the ranks, compute JAX's side meanwhile, join."""
    jax = _jax()
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from pgica_tpu.data.tokenizer import CaptionTokenizer
    from pgica_tpu.models import PreferenceGuidedCaptioningModel
    from pgica_tpu.ops.losses import ntxent_loss, ntxent_loss_fused
    from pgica_tpu.parallel.zero1 import make_zero1_train_step
    from pgica_tpu.parallel.zero3 import make_zero3_module, make_zero3_train_step
    from pgica_tpu.training import train_step as jts
    from pgica_tpu.training.optim import freeze_labels, warmup_cosine_schedule

    workdir = tmp_path_factory.mktemp("ranks")
    model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), seed=0, **_torch_ranks.TINY)
    scan = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), seed=1, scan_layers=True, **_torch_ranks.TINY)
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(2, B, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    inputs = {
        "const": {"lr": LR, "total": TOTAL, "warmup": WARMUP, "temp": TEMP, "beta": BETA},
        "params": jax.tree.map(np.asarray, model.params), "params_scan": jax.tree.map(np.asarray, scan.params),
        "x": rng.normal(size=(4, 3)).astype(np.float32), "w": rng.normal(size=(N, 4, 3)).astype(np.float32),
        "img": emb[0], "txt": emb[1], "batches1": [_batch1(s) for s in (1, 2)], "pairs": [_pairs(s) for s in (3, 4, 5)],
    }
    torch.save(inputs, workdir / "inputs.pt")
    handle = _torch_ranks.start("_torch_ranks.parallel_cases", workdir, N)
    jax_dp = _torch_ranks.start_jax("_torch_ranks.jax_replicated_reference", workdir)

    mesh = Mesh(np.asarray(jax.devices()[:N]), ("data",))
    key = jax.random.PRNGKey(0)
    ref = {}

    def per_shard(fn):
        return shard_map(fn, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"), check_vma=False)

    # all_gather's gradient; NT-Xent per shard and the gradients of the sum over the shards
    gather = per_shard(lambda x, w: jnp.sum(jax.lax.all_gather(x, "data", tiled=True) * w[0])[None])
    ref["gather_grad"] = np.asarray(jax.jit(jax.grad(lambda x: gather(x, inputs["w"]).sum()))(inputs["x"]))
    for name, fn in (("plain", ntxent_loss), ("fused", ntxent_loss_fused)):
        def shard_loss(i, t, fn=fn):
            loss, metrics = fn(i, t, TEMP, axis_name="data")
            return loss[None], {k: v[None] for k, v in metrics.items()}

        f = shard_map(shard_loss, mesh=mesh, in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                      check_vma=False)

        def total(i, t, f=f):
            losses, metrics = f(i, t)
            return losses.sum(), (losses, metrics)

        (_, (losses, metrics)), (d_img, d_txt) = jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))(
            inputs["img"], inputs["txt"])
        ref[f"ntxent_{name}"] = {"loss": np.asarray(losses), "metrics": jax.tree.map(np.asarray, metrics),
                                 "d_img": np.asarray(d_img), "d_txt": np.asarray(d_txt)}

    sched = warmup_cosine_schedule(LR, warmup_steps=1, total_steps=4)

    def mask_of(params):
        return jax.tree.map(lambda label: label == "train", freeze_labels(params, True, False))

    loss1 = functools.partial(jts.stage1_loss_fn, module=model.module, temperature=TEMP, augment=False,
                              axis_name="data")
    init_fn, step_fn = make_zero1_train_step(loss1, mesh, "data", learning_rate=sched, weight_decay=0.01,
                                             max_grad_norm=1.0, trainable_mask=mask_of(model.params), eps=1e-3)
    z = init_fn(model.params)
    metrics = []
    for b in inputs["batches1"]:
        z, m = jax.jit(step_fn)(z, b, key)
        metrics.append({k: float(v) for k, v in m.items()})
    ref["zero1"] = {"metrics": metrics, "params": _port_params(jax.tree.map(np.asarray, step_fn.gather_params(z)))}

    module3 = make_zero3_module(scan.module, "data")

    def loss3(params, ref_tree, batch, rng):
        return jts.stage2_loss_fn(params, ref_tree, batch, rng, module3, BETA, False, False, 0.0, False)

    init_fn, step_fn = make_zero3_train_step(loss3, mesh, "data", learning_rate=sched, weight_decay=0.01,
                                             max_grad_norm=1.0, trainable_mask=mask_of(scan.params), eps=1e-3,
                                             with_ref=True)
    z = init_fn(scan.params)
    ref_shards = init_fn.shard_ref(scan.params)
    metrics = []
    jstep = jax.jit(step_fn)
    for b in inputs["pairs"]:
        z, m = jstep(z, b, key, ref=ref_shards)
        metrics.append({k: float(v) for k, v in m.items()})
    ref["zero3"] = {"metrics": metrics, "params": _port_params(jax.tree.map(np.asarray, step_fn.gather_params(z)))}
    ref["inputs"] = inputs
    ref.update(_torch_ranks.finish(jax_dp, timeout=600)[0])
    return {"ranks": _torch_ranks.finish(handle, timeout=600), "jax": ref}


# ------------------------------------------------------------------ the mesh (no ranks)


@pytest.mark.parametrize("n, kw", [
    (8, {}),                                     # TestMeshContext.test_auto_data_axis
    (8, {"data": 2, "model": 4}),                # test_tp_mesh
    (8, {"data": 2, "fsdp": 4}),                 # test_fsdp_mesh
    (8, {"dcn": 2, "data": 2, "fsdp": 2}),       # TestDCNAxis.test_mesh_shapes_and_batch_sharding
    (8, {"dcn": 2}),                             # TestDCNAxis.test_data_axis_inference_with_dcn
    (4, {"data": -1, "seq": 2}),
])
def test_mesh_shapes_and_rank_coordinates_match_jax(n, kw):
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh

    jmesh = JaxMesh(devices=jax.devices()[:n], **kw)
    for rank in range(n):
        port = MeshContext(world_size=n, rank=rank, **kw)
        assert port.shape == jmesh.shape and port.num_devices == jmesh.num_devices
        assert port.data_parallel_size == jmesh.data_parallel_size
        coords = np.argwhere(jmesh.mesh.devices == jax.devices()[rank])[0]
        assert tuple(port.coords.values()) == tuple(int(c) for c in coords)


@pytest.mark.parametrize("n, kw", [(8, {"data": 3}), (8, {"data": -1, "model": 3}), (6, {"data": 2, "fsdp": 2})])
def test_invalid_mesh_raises_as_jax(n, kw):
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh

    with pytest.raises(ValueError) as want:
        JaxMesh(devices=jax.devices()[:n], **kw)
    with pytest.raises(ValueError) as got:
        MeshContext(world_size=n, rank=0, **kw)
    assert str(got.value) == str(want.value)


def test_from_config_and_unbound_axis(config):
    from pgica_tpu_torch.ops.losses import ntxent_loss

    mesh = MeshContext.from_config(config, world_size=8, rank=3)
    assert mesh.shape["data"] == 8 and mesh.batch_index == 3 and mesh.group("model") is None
    with pytest.raises(ValueError, match="unbound axis name"):
        ntxent_loss(torch.zeros(2, 4), torch.zeros(2, 4), axis_name=("data", "fsdp"))
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.group("data")


@pytest.mark.parametrize("kw", [{"data": 2}, {"dcn": 2, "data": 2, "fsdp": 2}, {"data": 2, "model": 2}])
def test_shard_batch_rows_equal_jax_addressable_shards(kw):
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh

    n = math.prod(kw.values())
    jmesh = JaxMesh(devices=jax.devices()[:n], **kw)
    batch = {"image": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "ids": np.arange(8, dtype=np.int32)}
    sharded = jmesh.shard_batch(batch)
    for key, arr in sharded.items():
        for shard in arr.addressable_shards:
            rank = jax.devices().index(shard.device)
            np.testing.assert_array_equal(MeshContext(world_size=n, rank=rank, **kw).shard_batch(batch)[key],
                                          np.asarray(shard.data))


def test_uneven_batch_raises_as_jax():
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh

    batch = {"image": np.zeros((3, 2), np.float32)}
    with pytest.raises(ValueError, match="divisible by 2"):
        JaxMesh(devices=jax.devices()[:2], data=2).shard_batch(batch)
    with pytest.raises(ValueError, match="divisible by the 2 ranks"):
        MeshContext(world_size=2, rank=0, data=2).shard_batch(batch)


def test_flat_buffer_follows_the_jax_leaf_order(runs):
    jax = _jax()
    from pgica_tpu_torch.models.convert import _port_name

    params = runs["jax"]["inputs"]["params"]
    port = _torch_ranks._port_model(params).module
    want = [_port_name(tuple(k.key for k in path)) for path, _ in jax.tree_util.tree_leaves_with_path(params)]
    names = [n for n, _ in port.named_parameters()]
    assert sorted(names, key=lambda n: jax_path(port, n)) == want


def test_zero3_refuses_a_block_leaf_n_does_not_divide(runs):
    _jax()
    from pgica_tpu.parallel.zero3 import ParamLayout

    params = runs["jax"]["inputs"]["params_scan"]
    port = _torch_ranks._port_model(params).module
    for n in (3, 5):
        with pytest.raises(ValueError, match="must be divisible by the axis size"):
            ParamLayout(params, n)
        with pytest.raises(ValueError, match="must be divisible by the axis size"):
            check_divisible(port, n)
    ParamLayout(params, 4)
    check_divisible(port, 4)


# ------------------------------------------------------------------ against JAX, on two ranks


def test_ranks_import_neither_jax_nor_the_jax_package(runs):
    for out in runs["ranks"]:
        assert out["imported_jax"] == []
    assert [r["batch_index"] for r in runs["ranks"]] == [0, 1]


def test_all_gather_gradient_is_jax_transpose(runs):
    got = np.concatenate([r["gather_grad"].numpy() for r in runs["ranks"]])
    np.testing.assert_allclose(got, runs["jax"]["gather_grad"], atol=1e-6)


@pytest.mark.parametrize("variant", ["plain", "fused"])
def test_ntxent_global_negatives_match_jax_shard_map(runs, variant):
    want = runs["jax"][f"ntxent_{variant}"]
    for rank, out in enumerate(runs["ranks"]):
        got = out[f"ntxent_{variant}"]
        np.testing.assert_allclose(float(got["loss"]), want["loss"][rank], atol=1e-6)
        for k, v in got["metrics"].items():
            np.testing.assert_allclose(float(v), want["metrics"][k][rank], atol=1e-6, err_msg=k)
        rows = slice(rank * B // N, (rank + 1) * B // N)
        np.testing.assert_allclose(got["d_img"].numpy(), want["d_img"][rows], atol=1e-5)
        np.testing.assert_allclose(got["d_txt"].numpy(), want["d_txt"][rows], atol=1e-5)


def _assert_params(got, want, atol, steps):
    """Every element within Adam's bound (2 lr an update); all but a share below ``LOOSE_SHARE`` within
    ``atol`` (tests/test_torch_trainer.py's rule), the key biases excepted (module docstring)."""
    loose = total = 0
    for name, exp in want.items():
        g, e = got[name].numpy(), exp.numpy()
        np.testing.assert_allclose(g, e, atol=2 * LR * steps, err_msg=name)
        if not name.endswith("attn.k_proj.bias"):
            loose += int((np.abs(g - e) > atol).sum())
            total += g.size
    assert loose / total < LOOSE_SHARE, f"{loose} of {total} elements beyond {atol}"


def _assert_metrics(got, want, keys):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=NORM_RTOL)
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("stage, keys", [(1, ("loss_i2t", "loss_t2i", "contrastive_accuracy")),
                                         (2, ("reward_margin", "reward_accuracy", "chosen_reward"))])
def test_replicated_data_parallel_steps_match_jax_gspmd(runs, stage, keys):
    want = runs["jax"][f"dp{stage}"]
    for out in runs["ranks"]:
        got = out[f"dp{stage}"]
        _assert_metrics(got["metrics"], want["metrics"], keys)
        _assert_params(got["params"], want["params"], PARAM_ATOL, len(want["metrics"]))
    a, b = (r[f"dp{stage}"]["params"] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a), "the ranks' masters differ"


@pytest.mark.parametrize("zero", [1, 3])
def test_zero_steps_match_jax(runs, zero):
    want = runs["jax"][f"zero{zero}"]
    keys = ("loss_i2t", "contrastive_accuracy") if zero == 1 else ("reward_margin", "chosen_reward")
    for out in runs["ranks"]:
        got = out[f"zero{zero}"]
        _assert_metrics(got["metrics"], want["metrics"], keys)
        _assert_params(got["params"], want["params"], ZERO_ATOL, len(want["metrics"]))
        assert got["empty_at_rest"], "the module keeps no parameter at rest under ZeRO"
    a, b = (r[f"zero{zero}"]["params"] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a), "the ranks' gathered masters differ"


def test_frozen_mask_keeps_the_vision_backbone(runs):
    start = _port_params(runs["jax"]["inputs"]["params"])
    got = runs["ranks"][0]["zero1"]["params"]
    for name, value in start.items():
        if name.startswith("vision_encoder.backbone."):
            assert torch.equal(got[name], value), name
    assert not torch.equal(got["text_encoder.backbone.blocks.0.attn.q_proj.weight"],
                           start["text_encoder.backbone.blocks.0.attn.q_proj.weight"])


@pytest.mark.parametrize("zero", [1, 3])
def test_each_rank_holds_its_share_of_the_state(runs, zero):
    """ZeRO-1: one flat f32 buffer, each rank padded_size / n of it and of each Adam moment. ZeRO-3: the
    LM blocks' buffers too (none needs padding: n divides every block leaf)."""
    for out in runs["ranks"]:
        got = out[f"zero{zero}"]
        shares = [p // N for p in got["padded"]]
        assert got["nbytes"] == {"params": 4 * sum(shares), "optimizer": 2 * 4 * sum(shares)}
        if zero == 3:
            assert len(got["padded"]) == 1 + 2 * 2  # the rest, 2 blocks of the text tower, 2 of the decoder
            assert got["block_shards"] == shares[1:]


def test_zero3_release_gives_back_the_trained_module(runs):
    out = runs["ranks"][0]["zero3"]
    assert all(torch.equal(out["released"][k], v) for k, v in out["params"].items())
