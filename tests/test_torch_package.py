"""Package-level properties of the PyTorch port (CPU)."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import pgica_tpu_torch
from pgica_tpu.core.precision import POLICIES as JAX_POLICIES
from pgica_tpu_torch.core.precision import POLICIES, compute_dtype
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models.convert import load_jax_params
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
from pgica_tpu_torch.ops import _kernels
from pgica_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref
from pgica_tpu_torch.ops.layernorm import LayerNorm, layer_norm_fwd, layer_norm_ref

PACKAGE_DIR = Path(pgica_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "flax", "pgica_tpu")

TINY = dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16,
            max_caption_length=8, image_size=32)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PACKAGE_DIR)], "pgica_tpu_torch."))


def test_imports_neither_jax_nor_the_jax_package():
    # A fresh interpreter where importing jax, flax or pgica_tpu fails.
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}: sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r}: importlib.import_module(name)\n"
        f"assert not [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r} and sys.modules[m] is not None]\n"
    )
    result = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            cwd=PACKAGE_DIR.parent, timeout=120)
    assert result.returncode == 0, result.stderr


def test_source_names_no_forbidden_import():
    for path in PACKAGE_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), **TINY)


def test_precision_policy_matches_the_jax_package():
    assert POLICIES.keys() == JAX_POLICIES.keys()
    for name, jax_dtype in JAX_POLICIES.items():
        assert str(compute_dtype(name)).replace("torch.", "") == np.dtype(jax_dtype).name
    with pytest.raises(ValueError, match="mixed_precision"):
        compute_dtype("int8")


def test_kernel_wrappers_run_the_plain_version_on_cpu(rng):
    counts = _kernels.launch_counts()
    x = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    g, b = torch.rand(32), torch.rand(32)
    for got, want in zip(layer_norm_fwd(x, g, b, 1e-5), layer_norm_ref(x, g, b, 1e-5)):
        assert torch.equal(got, want)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 5, 16)).astype(np.float32)) for _ in range(3))
    bias = torch.zeros(2, 5)
    for got, want in zip(flash_attention_fwd(q, k, v, bias, True), flash_attention_ref(q, k, v, bias, True)):
        assert torch.equal(got, want)
    assert _kernels.launch_counts() == counts  # the plain versions launch nothing


def test_bf16_inference_copy_keeps_masters_and_f32_layernorm():
    model = PreferenceGuidedCaptioningModel(
        tokenizer=CaptionTokenizer(), dtype=torch.bfloat16, device="cpu", **TINY)
    copy = model._inference_module()
    assert copy is model._inference_module()  # cast once, cached
    for m in copy.modules():
        for p in m.parameters(recurse=False):
            want = torch.float32 if isinstance(m, LayerNorm) else torch.bfloat16
            assert p.dtype == want
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    captions = model.generate_captions(np.zeros((2, 32, 32, 3), np.uint8), max_length=4)
    assert len(captions) == 2


def test_same_seed_same_weights():
    a = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=3, **TINY)
    b = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", seed=3, **TINY)
    for (name, pa), pb in zip(a.module.named_parameters(), b.module.parameters()):
        assert torch.equal(pa, pb), name


@pytest.fixture(scope="module")
def jax_params(tiny_model):
    return jax.tree.map(np.array, tiny_model.params)


def _port():
    return PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY)


def test_load_jax_params_raises_on_a_missing_key(jax_params):
    params = jax.tree.map(np.array, jax_params)
    del params["caption_decoder"]["lm"]["ln_f"]
    with pytest.raises(KeyError, match="ln_f"):
        load_jax_params(_port().module, params)


def test_load_jax_params_raises_on_a_wrong_shape(jax_params):
    params = jax.tree.map(np.array, jax_params)
    params["vision_encoder"]["backbone"]["pos_embed"] = np.zeros((1, 5, 32), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        load_jax_params(_port().module, params)


def test_load_jax_params_raises_on_an_unknown_key(jax_params):
    params = jax.tree.map(np.array, jax_params)
    params["caption_decoder"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(_port().module, params)


def test_load_jax_params_fills_the_text_tower_and_raises_on_its_bad_keys(jax_params):
    port = _port()
    load_jax_params(port.module, jax_params)
    tower = jax_params["text_encoder"]
    np.testing.assert_array_equal(
        port.module.text_encoder.backbone.wte.weight.detach().numpy(), tower["backbone"]["wte"]["embedding"])
    np.testing.assert_array_equal(
        port.module.text_encoder.projection.fc1.weight.detach().numpy(), tower["projection"]["fc1"]["kernel"].T)
    np.testing.assert_array_equal(
        port.module.caption_decoder.lm.wte.weight.detach().numpy(),
        jax_params["caption_decoder"]["lm"]["wte"]["embedding"],
    )
    unknown = jax.tree.map(np.array, jax_params)
    unknown["text_encoder"]["backbone"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(_port().module, unknown)
    missing = jax.tree.map(np.array, jax_params)
    del missing["text_encoder"]["projection"]["ln"]
    with pytest.raises(KeyError, match="text_encoder.projection.ln"):
        load_jax_params(_port().module, missing)
