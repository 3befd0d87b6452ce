"""The port's tensor parallelism against the JAX package, on four gloo ranks.

Four ranks (tests/_torch_ranks.py, spawned once for the module; torch and
the port only, each records what it imported) run every case on the meshes
data 2 x model 2 and model 4; JAX's side runs meanwhile in three spawned JAX
processes (tests/_torch_tp_ranks.py:jax_tp_reference) on ``jax.devices()[:4]``,
the GSPMD steps on the same meshes, with the same weights.

* ``TestVocabParallelFusedCE``'s five cases: values (vocab 64, model 2 and
  4), a neighbour shard's targets (vocab 48, model 2, every target in
  shard 1), gradients, a padded vocab (67 rows: one zero row at model 2 and
  4), and the stage-2 log-probs of a model cut over model 2 (fused
  vocab-parallel against the gathered logits' and JAX's): values 1e-5,
  gradients 1e-5 against JAX's unsharded ``fused_token_logprobs``.
* ``TestShardedTraining::test_tp_forward_matches_replicated``: the cut
  model's contrastive embeddings against JAX's unsharded forward, 2e-5.
* Three stage-1 and three stage-2 updates of tiny-gpt2 at data 2 x model 2
  and of tiny-llama at model 4, where the axis does not divide its 2 KV
  heads (k/v stay whole, each rank's q heads meet their own KV heads),
  against JAX on the same mesh: losses rel 1e-5, gradient norms rel 1e-4,
  gathered parameters atol 1e-6 but for a share below 2% of the elements
  that Adam does not pin down, every element within Adam's bound of 2 lr
  an update (tests/test_torch_parallel.py's rule); the gathered Adam
  moments: mu atol 1e-6, nu atol 1e-7 (first moments of gradients of order
  1, second of order 1e-2), the same share rule.
* ``TestScaledConfigShapes`` at data 2 x model 2: tiny-llama's DPO update,
  finite, its loss rel 1e-5 from JAX's on the mesh.
* Each rank holds half (model 2) or a quarter (model 4) of the bytes of the
  cut parameters; ``gather_params`` of the ranks' ``shard_params`` of a JAX
  tree is the tree, bit for bit.
"""

import numpy as np
import pytest
import torch

import _torch_ranks
import _torch_tp_ranks as tr

LOSS_RTOL, NORM_RTOL, PARAM_ATOL, LOOSE_SHARE, CE_ATOL, FWD_ATOL = 1e-5, 1e-4, 1e-6, 0.02, 1e-5, 2e-5
MU_ATOL, NU_ATOL = 1e-6, 1e-7
SEQ, IMG, B = 8, 32, 8


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


def _ce_case(rng, vocab, low=0, high=None, rows=16, d=8):
    return {"h": rng.normal(size=(rows, d)).astype(np.float32), "w": rng.normal(size=(vocab, d)).astype(np.float32),
            "y": rng.integers(low, high or vocab, (rows,)).astype(np.int32),
            "g": rng.normal(size=(rows,)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("tp")
    params = {text: tr.jax_params(text) for text in ("tiny-gpt2", "tiny-llama")}
    rng = np.random.default_rng(0)
    fwd = _batch1(9)
    inputs = {
        "params": params,
        "ce": {"values": _ce_case(rng, 64), "neighbour": _ce_case(rng, 48, 24, 32), "padded": _ce_case(rng, 67)},
        "forward": {"image": rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32), "ids": fwd["caption_ids"],
                    "mask": fwd["caption_mask"]},
        "batches1": [_batch1(s) for s in (1, 2, 3)], "pairs": [_pairs(s) for s in (4, 5, 6)],
    }
    torch.save(inputs, workdir / "inputs.pt")
    ranks = _torch_ranks.start("_torch_tp_ranks.tp_cases", workdir, 4)
    refs = []
    for part in ("gpt2", "llama_m4", "llama_dm"):
        (workdir / part).mkdir()
        torch.save(inputs, workdir / part / "inputs.pt")
        refs.append(_torch_ranks.start_jax("_torch_tp_ranks.jax_tp_reference", workdir / part, (part,)))
    jax_out = {}
    for handle in refs:
        jax_out.update(_torch_ranks.finish(handle, timeout=600)[0])
    return {"ranks": _torch_ranks.finish(ranks, timeout=600), "jax": jax_out, "inputs": inputs}


def test_ranks_import_neither_jax_nor_the_jax_package(runs):
    assert all(out["imported_jax"] == [] for out in runs["ranks"])
    assert [tuple(out["coords"]["dm"][a] for a in ("data", "model")) for out in runs["ranks"]] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_gather_params_inverts_shard_params_on_ranks(runs):
    """``gather_params`` of every rank's ``shard_params`` of tiny-llama's JAX tree (numpy) is the tree, bit for bit,
    at data 2 x model 2 and model 4 (k/v whole at 4)."""
    assert all(out["gather"] == {"dm": True, "m4": True} for out in runs["ranks"])


def _assemble(runs, key, mesh):
    """(rows' values, rows' dh, the whole dW) from every rank's share: rows by batch index, dW blocks by
    model index, each block summed over the batch ranks."""
    per_rank = [(out["coords"][mesh], out["ce"][key]) for out in runs["ranks"]]
    n_model = max(c["model"] for c, _ in per_rank) + 1
    n_data = max(c["data"] for c, _ in per_rank) + 1
    rows = [next(v for c, v in per_rank if c["data"] == d and c["model"] == 0) for d in range(n_data)]
    blocks = [sum(v["dw"] for c, v in per_rank if c["model"] == m) for m in range(n_model)]
    for d in range(n_data):  # the ranks of one batch block agree
        for c, v in per_rank:
            if c["data"] == d:
                assert torch.equal(v["out"], rows[d]["out"]) and torch.equal(v["dh"], rows[d]["dh"])
    return (torch.cat([r["out"] for r in rows]).numpy(), torch.cat([r["dh"] for r in rows]).numpy(),
            torch.cat(blocks).numpy())


@pytest.mark.parametrize("key", ["values_dm", "values_m4", "neighbour_dm", "padded_m4", "padded_dm"])
def test_vocab_parallel_fused_ce_matches_jax(runs, key):
    """Values, the neighbour shard's targets, gradients and the padded vocab (JAX TestVocabParallelFusedCE)."""
    name, mesh = key.rsplit("_", 1)
    want = runs["jax"]["ce"][name]
    out, dh, dw = _assemble(runs, key, mesh)
    vocab = runs["inputs"]["ce"][name]["w"].shape[0]
    n = 2 if mesh == "dm" else 4
    assert dw.shape[0] == -(-vocab // n) * n  # the zero rows' block rows are sliced off, as JAX's pad
    np.testing.assert_allclose(out, want["out"], atol=CE_ATOL, err_msg="values")
    np.testing.assert_allclose(dh, want["dh"], atol=CE_ATOL, err_msg="dh")
    np.testing.assert_allclose(dw[:vocab], want["dw"], atol=CE_ATOL, err_msg="dW")


def test_tp_forward_matches_replicated(runs):
    want = runs["jax"]["forward"]
    for out in runs["ranks"]:
        d = out["coords"]["dm"]["data"]
        rows = slice(d * B // 2, (d + 1) * B // 2)
        for key in ("image_embeddings", "text_embeddings"):
            np.testing.assert_allclose(out["forward"][key].numpy(), want[key][rows], atol=FWD_ATOL, err_msg=key)


def test_stage2_logprobs_under_tp_fused_match_plain(runs):
    """The vocab-parallel fused log-probs of the cut model against its gathered logits' and JAX's (JAX
    test_stage2_step_under_tp_mesh_fused_matches_xla)."""
    want = runs["jax"]["forward"]["logprobs"]
    for out in runs["ranks"]:
        d = out["coords"]["dm"]["data"]
        f = out["forward"]
        assert f["logits_vocab"] == 261  # the head gathers every rank's columns
        np.testing.assert_allclose(f["fused"].numpy(), f["plain"].numpy(), atol=CE_ATOL, rtol=1e-6)
        np.testing.assert_allclose(f["fused"].numpy(), want[d * B // 2:(d + 1) * B // 2], atol=CE_ATOL, rtol=1e-6)


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


@pytest.mark.parametrize("case", ["gpt2_s1", "gpt2_s2", "llama_m4_s1", "llama_m4_s2"])
def test_tp_updates_match_jax_on_the_mesh(runs, case):
    want = runs["jax"][case]
    for out in runs["ranks"]:
        got = out[case]
        assert len(got["metrics"]) == len(want["metrics"]) == 3 and got["count"] == 3
        for g, w in zip(got["metrics"], want["metrics"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=NORM_RTOL)
            assert g["skipped"] == 0
        _assert_close_share(got["params"], want["params"], PARAM_ATOL, bound=2 * tr.LR * 3)
        trained = list(got["mu"])
        _assert_close_share(got["mu"], {k: want["mu"][k] for k in trained}, MU_ATOL)
        _assert_close_share(got["nu"], {k: want["nu"][k] for k in trained}, NU_ATOL)
    a, b = (r[case]["params"] for r in runs["ranks"][:2])
    assert all(torch.equal(a[k], b[k]) for k in a), "the ranks gather different parameters"


def test_scaled_config_shapes_llama_dpo_on_data_model_mesh(runs):
    want = runs["jax"]["llama_dm_s2"]["metrics"][0]
    for out in runs["ranks"]:
        (got,) = out["llama_dm_s2"]["metrics"]
        assert np.isfinite(got["loss"]) and 0.0 <= got["reward_accuracy"] <= 1.0
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("case, n", [("gpt2_s1", 2), ("llama_m4_s1", 4)])
def test_each_rank_holds_its_share_of_the_cut_bytes(runs, case, n):
    for out in runs["ranks"]:
        local, whole = out[case]["bytes"]
        assert local > 0 and local * n == whole
