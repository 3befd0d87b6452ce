"""The port's context parallelism (ring attention, the CP stage-2 step) against the JAX package, on four gloo ranks.

Four ranks (tests/_torch_ranks.py, spawned once for the module; torch and
the port only, each records what it imported) run every case on the meshes
seq 4, data 2 x seq 2 and model 2 x seq 2; JAX's unsharded side runs
meanwhile in three spawned JAX processes (tests/_torch_tp_ranks.py:
jax_cp_reference), with the same weights and batches. Mirrors the JAX
``TestRingAttention``, ``TestContextParallelLM`` and
``TestContextParallelStage2`` (tests/test_parallel.py:448-729):

* ring attention over seq 4 and seq 2, causal and not, with and without a
  key-padding ``kv_bias``, against one-device attention: values 2e-5,
  gradients of sum(out * g) 5e-5;
* the LM forward (GPT-2 and Llama, vocab 64) over seq 4, the shard's
  global positions: logits 3e-5;
* the CP DPO loss (rel 1e-5) and every parameter's gradient (2e-5), with
  and without length normalisation; two CP train updates (params 3e-5); the
  fused-CE path against the logits path (rel 1e-5); CP x data (rel 1e-5);
* TP x CP (model 2 x seq 2, the decoder cut over model with the
  vocab-parallel fused CE on the shard's rows): loss and chosen log-prob
  rel 1e-5, gradients 3e-5.
"""

import numpy as np
import pytest
import torch

import _torch_ranks
import _torch_tp_ranks as tr

LOSS_RTOL, RING_ATOL, RING_GRAD_ATOL, LM_ATOL = 1e-5, 2e-5, 5e-5, 3e-5
GRAD_ATOL, STEP_ATOL, TPCP_ATOL = 2e-5, 3e-5, 3e-5
SEQ, IMG = 8, 32


def _pairs(seed, b):
    rng = np.random.default_rng(seed)
    out = {"image": rng.integers(0, 256, size=(b, IMG, IMG, 3), dtype=np.uint8)}
    for key in ("preferred", "rejected"):
        lengths = rng.integers(3, SEQ + 1, size=b)
        out[f"{key}_ids"] = rng.integers(0, 261, size=(b, SEQ)).astype(np.int32)
        out[f"{key}_mask"] = (np.arange(SEQ)[None, :] < lengths[:, None]).astype(np.int32)
    return out


def _lm_params(arch):
    import jax
    import jax.numpy as jnp

    from pgica_tpu.models.lm import TransformerLM
    from pgica_tpu.models.presets import get_text_config

    lm = TransformerLM(get_text_config("tiny-gpt2" if arch == "gpt2" else "tiny-llama", vocab_size=64),
                       with_lm_head=True)
    ids = jnp.zeros((2, 32), jnp.int32)
    init = jax.jit(lambda key: lm.init(key, input_ids=ids, attention_mask=jnp.ones_like(ids))["params"])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("cp")
    rng = np.random.default_rng(0)
    qkv = {x: rng.normal(size=(2, 4, 32, 8)).astype(np.float32) for x in "qkvg"}
    qkv["bias"] = np.where(np.arange(32)[None, :] < np.array([[32], [21]]), 0.0, -1e9).astype(np.float32)
    lm_mask = (rng.random((2, 32)) > 0.1).astype(np.int32)
    lm_mask[:, 0] = 1  # every query sees a key
    inputs = {"qkv": qkv, "lm_params": {arch: _lm_params(arch) for arch in ("gpt2", "llama")},
              "lm_ids": rng.integers(0, 64, (2, 32)).astype(np.int32), "lm_mask": lm_mask,
              "params": tr.jax_params("tiny-gpt2"), "pairs": _pairs(1, 4), "pairs2": _pairs(2, 2)}
    torch.save(inputs, workdir / "inputs.pt")
    ranks = _torch_ranks.start("_torch_tp_ranks.cp_cases", workdir, 4)
    refs = []
    for part in ("attention", "loss", "step"):
        (workdir / part).mkdir()
        torch.save(inputs, workdir / part / "inputs.pt")
        refs.append(_torch_ranks.start_jax("_torch_tp_ranks.jax_cp_reference", workdir / part, (part,)))
    jax_out = {}
    for handle in refs:
        jax_out.update(_torch_ranks.finish(handle, timeout=600)[0])
    return {"ranks": _torch_ranks.finish(ranks, timeout=600), "jax": jax_out}


def test_ranks_import_neither_jax_nor_the_jax_package(runs):
    assert all(out["imported_jax"] == [] for out in runs["ranks"])


def _by_seq(runs, mesh, get, dim):
    """The blocks of the ranks at data / model index 0, concatenated along ``dim`` in seq order."""
    ranks = [out for out in runs["ranks"] if all(v == 0 for k, v in out["coords"][mesh].items() if k != "seq")]
    ranks.sort(key=lambda out: out["coords"][mesh]["seq"])
    return torch.cat([get(out) for out in ranks], dim).numpy()


@pytest.mark.parametrize("mesh", ["s4", "ds"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_ring_attention_matches_one_device(runs, mesh, causal, bias):
    want = runs["jax"]["ring"][f"{causal}_{bias}"]
    key = f"{mesh}_{causal}_{bias}"
    np.testing.assert_allclose(_by_seq(runs, mesh, lambda o: o["ring"][key]["out"], 2), want["out"], atol=RING_ATOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(_by_seq(runs, mesh, lambda o: o["ring"][key][g], 2), want[g],
                                   atol=RING_GRAD_ATOL, err_msg=g)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_context_parallel_lm_matches_unsharded(runs, arch):
    got = _by_seq(runs, "s4", lambda o: o["lm"][arch], 1)
    np.testing.assert_allclose(got, runs["jax"]["lm"][arch], atol=LM_ATOL)


def _assert_loss_and_grads(got, want, atol):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["metrics"]["policy_chosen_logp"], want["metrics"]["policy_chosen_logp"],
                               rtol=LOSS_RTOL)
    assert got["grads"].keys() == want["grads"].keys()
    for name, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][name].numpy(), w.numpy(), atol=atol, err_msg=name)


@pytest.mark.parametrize("length_norm", [False, True])
def test_cp_loss_and_grads_match_unsharded(runs, length_norm):
    for out in runs["ranks"]:
        _assert_loss_and_grads(out["loss"][length_norm], runs["jax"]["loss"][length_norm], GRAD_ATOL)


def test_cp_train_step_matches_unsharded(runs):
    want = runs["jax"]["step"]
    for out in runs["ranks"]:
        got = out["step"]
        np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"], want["metrics"]["grad_norm"], rtol=1e-4)
        for name, w in want["params"].items():
            np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(), atol=STEP_ATOL, err_msg=name)


def test_cp_fused_ce_path_matches(runs):
    for out in runs["ranks"]:
        np.testing.assert_allclose(out["fused"][True], out["fused"][False], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["fused"][True], runs["jax"]["free"]["pairs2"], rtol=LOSS_RTOL)


def test_cp_composed_with_data_parallelism(runs):
    """Each batch block's loss over its rows; their mean is the global batch's."""
    blocks = {}
    for out in runs["ranks"]:
        blocks.setdefault(out["coords"]["ds"]["data"], set()).add(out["data"]["loss"])
    assert sorted(blocks) == [0, 1] and all(len(v) == 1 for v in blocks.values())  # the seq ranks agree
    got = np.mean([v.pop() for v in blocks.values()])
    np.testing.assert_allclose(got, runs["jax"]["free"]["pairs"], rtol=LOSS_RTOL)


def test_tp_cp_composition_matches_unsharded(runs):
    for out in runs["ranks"]:
        _assert_loss_and_grads(out["tp_cp"], runs["jax"]["loss"][False], TPCP_ATOL)
