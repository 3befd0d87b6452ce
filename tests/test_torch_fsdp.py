"""The port's FSDP at rest (parallel/fsdp.py, parallel/sharding.py:shard_fsdp) against the JAX package, on
eight gloo ranks.

Eight ranks (tests/_torch_ranks.py, spawned once for the module; torch and the port only, each records what
it imported) run every case; JAX's side runs meanwhile in three spawned JAX processes
(tests/_torch_fsdp_ranks.py:jax_fsdp_reference) on ``jax.devices()[:8]``: the GSPMD steps on the same
meshes, with the same weights and batches, the parameters placed by the rule table (``shard_params``).

* (a) tiny-llama at data 2 x fsdp 2 x model 2, the layout of configs/siglip_llama8b.yaml
  (tests/test_parallel.py:155): two stage-1 and two stage-2 (DPO, frozen reference) updates;
* (b) the same with ``scan_layers`` and remat at 4 layers (``fsdp`` on the stacked layer dimension: each rank
  owns whole layers) and at 3 (the inner-dimension fallback; tests/test_scan_layers.py:98-175);
* (c) tiny-gpt2 at data 2 x fsdp 4, where ``wte`` is cut on its embedding dimension;
* (d) the context-parallel stage-2 step at fsdp 2 x model 2 x seq 2 against JAX's GSPMD step on that mesh.

Tolerances are tests/test_torch_tensor_parallel.py's: losses rel 1e-5, gradient norms rel 1e-4, the gathered
parameters atol 1e-6 but for a share below 2% of the elements, every element within Adam's bound (2 lr an
update); the gathered Adam moments mu atol 1e-6, nu atol 1e-7, the same share rule. Each rank's bytes of every
parameter, of its Adam moments and of the stage-2 reference's parameters equal, leaf by leaf, the bytes of
JAX's shard on the device at the same mesh coordinates, but for the column-parallel biases of a kernel cut
over ``model``, which the port keeps as the rank's slice (models/layers.py, parallel/sharding.py): a
``1 / model`` share of JAX's replicated bias.
"""

import re

import numpy as np
import pytest
import torch

import _torch_fsdp_ranks as fr
import _torch_ranks
import _torch_tp_ranks as tr

LOSS_RTOL, NORM_RTOL, PARAM_ATOL, LOOSE_SHARE = 1e-5, 1e-4, 1e-6, 0.02  # tests/test_torch_tensor_parallel.py:40-41
MU_ATOL, NU_ATOL = 1e-6, 1e-7
SEQ, IMG, B = 8, 32, 8
RUNS = [f"{case}_s{stage}" for case in fr.CASES for stage in (1, 2) if stage == 2 or "seq" not in fr.CASES[case][3]]
COLUMN_BIAS = re.compile(r".*(q_proj|k_proj|v_proj|fc_in|gate_proj|up_proj)/bias$")


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("fsdp")
    params = {fr.model_name(case): fr.jax_params(case) for case in fr.CASES}
    inputs = {"params": params, "batches1": [_batch1(s) for s in (1, 2)], "pairs": [_pairs(s) for s in (4, 5)]}
    torch.save(inputs, workdir / "inputs.pt")
    ranks = _torch_ranks.start("_torch_fsdp_ranks.fsdp_cases", workdir, 8)
    refs = []
    for i, cases in enumerate((("llama_dfm", "gpt2_cp"), ("llama_scan4", "llama_scan3"), ("gpt2_df4",))):
        (workdir / f"jax{i}").mkdir()
        torch.save(inputs, workdir / f"jax{i}" / "inputs.pt")
        refs.append(_torch_ranks.start_jax("_torch_fsdp_ranks.jax_fsdp_reference", workdir / f"jax{i}", (cases,)))
    jax_out = {}
    for handle in refs:
        jax_out.update(_torch_ranks.finish(handle, timeout=600)[0])
    return {"ranks": _torch_ranks.finish(ranks, timeout=600), "jax": jax_out}


def test_ranks_import_neither_jax_nor_the_jax_package(runs):
    assert all(out["imported_jax"] == [] for out in runs["ranks"])
    coords = [out["coords"]["llama_dfm"] for out in runs["ranks"]]
    assert [tuple(c[a] for a in ("data", "fsdp", "model")) for c in coords] == \
        [(d, f, m) for d in range(2) for f in range(2) for m in range(2)]


def _assert_close_share(got, want, atol, bound=None):
    """Every element within ``bound`` (if given); all but a share below LOOSE_SHARE within ``atol``."""
    loose = total = 0
    for name, exp in want.items():
        g, e = got[name].numpy(), exp.numpy()
        if bound is not None:
            np.testing.assert_allclose(g, e, atol=bound, err_msg=name)
        loose += int((np.abs(g - e) > atol).sum())
        total += g.size
    assert loose / total < LOOSE_SHARE, f"{loose} of {total} elements beyond {atol}"


@pytest.mark.parametrize("run", RUNS)
def test_fsdp_updates_match_jax_on_the_mesh(runs, run):
    want = runs["jax"][run]
    for out in runs["ranks"]:
        got = out[run]
        assert len(got["metrics"]) == len(want["metrics"]) == 2 and got["count"] == 2
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=NORM_RTOL)
            assert g["skipped"] == 0
        _assert_close_share(got["params"], want["params"], PARAM_ATOL, bound=2 * tr.LR * 2)
        trained = list(got["mu"])
        _assert_close_share(got["mu"], {k: want["mu"][k] for k in trained}, MU_ATOL)
        _assert_close_share(got["nu"], {k: want["nu"][k] for k in trained}, NU_ATOL)
    first = runs["ranks"][0][run]["params"]
    for out in runs["ranks"][1:]:
        assert all(torch.equal(out[run]["params"][k], first[k]) for k in first), "the ranks gather different parameters"


@pytest.mark.parametrize("run", RUNS)
def test_each_rank_holds_the_jax_shard_of_every_leaf(runs, run):
    """Parameters, Adam moments (the trained leaves') and the stage-2 reference, leaf by leaf, against the bytes
    of JAX's shard on the device of each rank's mesh coordinates."""
    want = runs["jax"][run]["bytes"]
    model = fr.CASES[run.rsplit("_", 1)[0]][3].get("model", 1)
    for rank, out in enumerate(runs["ranks"]):
        got = out[run]["bytes"]
        for kind in ("params", "adam", "reference"):
            if want[kind] is None:
                assert got[kind] is None
                continue
            assert got[kind].keys() == want[kind].keys(), kind
            for path, per_device in want[kind].items():
                expected = per_device[rank]
                if COLUMN_BIAS.match(path) and path[:-len("bias")] + "kernel" in got["model_cut"]:
                    expected //= model  # the rank's slice of the bias of a kernel cut over model
                assert got[kind][path] == expected, (kind, path, rank)
        assert sum(got["params"].values()) < want["whole"]  # the cut leaves are this rank's blocks
