"""Offline import of HF checkpoints and of scanned JAX trees into the port, against the JAX
package, on the CPU.

Tiny HF GPT-2, CLIPVision and Llama models are built from configs with
random weights (no download, as tests/test_convert.py builds them) and saved
as ``pytorch_model.bin`` or ``model.safetensors``. Then:

* ``load_pretrained_towers`` in the port against the JAX package's: every
  port parameter bit-equal to the JAX model's after the bridge; the
  contrastive forward and the decoder's logits within 1e-5 (float32); the
  towers' hidden states within 3e-4 of HF's (another implementation,
  another order of sums). With a shared text tower, with the vocab padded
  (the checkpoint's 256 rows against the module's 261: the appended rows
  keep the module's values), and for Llama (RoPE rows permuted).
* The HF converters (``convert_linear``, ``convert_projection_head``,
  ``convert_mha``) give the JAX package's trees exactly.
* A JAX model built with ``scan_layers=True`` (its LM blocks stacked under
  ``blocks``) bridges into the port: parameters bit-equal to those bridged
  from the same weights unrolled, forward and decode logits within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import CLIPVisionConfig, CLIPVisionModel, GPT2Config, GPT2LMHeadModel, LlamaConfig, LlamaModel

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.models import convert as jconvert
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.models import convert
from pgica_tpu_torch.models.lm import init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

FWD_TOL = 1e-5
HF_TOL = 3e-4
HF_VOCAB = 256  # below the tokenizer's 261: the module's 5 special rows stay
B = 2


def _kw(text_model="tiny-gpt2", **extra):
    return dict(vision_model="tiny-vit", text_model=text_model, projection_dim=16, max_caption_length=10,
                image_size=32, seed=0, **extra)


def _save(model, path, fmt):
    model.save_pretrained(path, safe_serialization=fmt == "safetensors")
    assert (path / ("model.safetensors" if fmt == "safetensors" else "pytorch_model.bin")).exists()
    return path


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    gpt2 = GPT2LMHeadModel(GPT2Config(vocab_size=HF_VOCAB, n_positions=64, n_embd=32, n_layer=2, n_head=2,
                                      resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()
    gpt2b = GPT2LMHeadModel(gpt2.config).eval()  # a second decoder checkpoint
    clip = CLIPVisionModel(CLIPVisionConfig(hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                                            num_attention_heads=2, image_size=32, patch_size=8,
                                            attention_dropout=0.0)).eval()
    llama = LlamaModel(LlamaConfig(vocab_size=HF_VOCAB, hidden_size=32, intermediate_size=128, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                                   rope_theta=500000.0, rms_norm_eps=1e-5, attention_dropout=0.0)).eval()
    dirs = {"models": dict(gpt2=gpt2, gpt2b=gpt2b, clip=clip, llama=llama)}
    for fmt in ("bin", "safetensors"):
        dirs[fmt] = {name: _save(m, root / f"{name}_{fmt}", fmt) for name, m in dirs["models"].items()}
    return dirs


def _pair(**kw):
    """A JAX model and the port's, the port's weights bridged from JAX's."""
    jm = JaxModel(tokenizer=JaxTokenizer(), **kw)
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **kw)
    port.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return jm, port


def _bridged(jm, **kw):
    ref = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **kw)
    ref.load_jax_params(jax.tree.map(np.asarray, jm.params))
    return ref


def _assert_params_equal(port, ref):
    diff = [n for (n, a), b in zip(port.module.named_parameters(), ref.module.parameters()) if not torch.equal(a, b)]
    assert not diff, diff[:4]


def _inputs():
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(B, 32, 32, 3), dtype=np.uint8)
    ids = rng.integers(0, 261, size=(B, 10)).astype(np.int32)
    mask = (np.arange(10)[None] < np.array([[7], [10]])).astype(np.int32)
    return images, ids, mask


def _assert_forwards_match(jm, port):
    """The contrastive forward and the decoder's teacher-forced logits, port against JAX."""
    images, ids, mask = _inputs()
    jimages = jax_prepare_images(jnp.asarray(images))
    ref = jm.module.apply({"params": jm.params}, jimages, jnp.asarray(ids), jnp.asarray(mask), mode="dual")
    with torch.no_grad():
        out = port.module(torch.from_numpy(np.array(jimages)), torch.from_numpy(ids).long(),
                          torch.from_numpy(mask), mode="dual")
    for key in ("image_embeddings", "text_embeddings", "logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=FWD_TOL, err_msg=key)


def _hidden(lm, ids):
    with torch.no_grad():
        return lm(input_ids=torch.from_numpy(ids).long(), attention_mask=torch.ones(ids.shape, dtype=torch.long))


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_gpt2_and_clip_towers_load_as_in_jax(hf_dirs, fmt):
    d, hf = hf_dirs[fmt], hf_dirs["models"]
    jm, port = _pair(**_kw())
    before = port.module.caption_decoder.lm.wte.weight.detach().clone()
    jm.load_pretrained_towers(vision_path=d["clip"], text_path=d["gpt2"], decoder_path=d["gpt2b"])
    port.load_pretrained_towers(vision_path=d["clip"], text_path=d["gpt2"], decoder_path=d["gpt2b"])
    _assert_params_equal(port, _bridged(jm, **_kw()))
    _assert_forwards_match(jm, port)

    # the HF towers' own outputs
    sd = hf["gpt2"].state_dict()
    wte = port.module.text_encoder.backbone.wte.weight.detach()
    assert torch.equal(wte[:HF_VOCAB], sd["transformer.wte.weight"])
    dec_wte = port.module.caption_decoder.lm.wte.weight.detach()
    assert torch.equal(dec_wte[:HF_VOCAB], hf["gpt2b"].state_dict()["transformer.wte.weight"])
    assert torch.equal(dec_wte[HF_VOCAB:], before[HF_VOCAB:])  # the specials' rows keep the module's values
    ids = np.random.default_rng(2).integers(0, HF_VOCAB, size=(B, 10)).astype(np.int32)
    with torch.no_grad():
        hf_hidden = hf["gpt2"].transformer(torch.from_numpy(ids).long()).last_hidden_state
        hf_logits = hf["gpt2b"](torch.from_numpy(ids).long()).logits
    np.testing.assert_allclose(_hidden(port.module.text_encoder.backbone, ids)["hidden_states"].numpy(),
                               hf_hidden.numpy(), atol=HF_TOL)
    logits = _hidden(port.module.caption_decoder.lm, ids)["logits"]
    assert logits.shape[-1] == 261
    np.testing.assert_allclose(logits[..., :HF_VOCAB].numpy(), hf_logits.numpy(), atol=HF_TOL)
    pixels = np.random.default_rng(3).normal(size=(B, 3, 32, 32)).astype(np.float32)
    with torch.no_grad():
        hf_vision = hf["clip"](torch.from_numpy(pixels))
        ours = port.module.vision_encoder.backbone(torch.from_numpy(pixels.transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(ours["features"].numpy(), hf_vision.last_hidden_state.numpy(), atol=HF_TOL)
    np.testing.assert_allclose(ours["pooled_output"].numpy(), hf_vision.pooler_output.numpy(), atol=HF_TOL)


def test_shared_text_tower_loads_once(hf_dirs):
    d = hf_dirs["bin"]
    kw = _kw(share_text_tower=True)
    jm, port = _pair(**kw)
    assert hasattr(port.module, "shared_lm")
    decoder_side = port.module.caption_decoder.cross_attention.q_proj.weight.detach().clone()
    jm.load_pretrained_towers(text_path=d["gpt2"], decoder_path=d["gpt2b"])  # the shared LM takes the text path
    port.load_pretrained_towers(text_path=d["gpt2"], decoder_path=d["gpt2b"])
    _assert_params_equal(port, _bridged(jm, **kw))
    assert torch.equal(port.module.shared_lm.wte.weight[:HF_VOCAB].detach(),
                       hf_dirs["models"]["gpt2"].state_dict()["transformer.wte.weight"])
    assert port.module.caption_decoder.lm is port.module.shared_lm
    assert torch.equal(port.module.caption_decoder.cross_attention.q_proj.weight, decoder_side)
    _assert_forwards_match(jm, port)


def test_llama_towers_load_as_in_jax(hf_dirs):
    d = hf_dirs["safetensors"]
    kw = _kw("tiny-llama")
    jm, port = _pair(**kw)
    jm.load_pretrained_towers(text_path=d["llama"])
    port.load_pretrained_towers(text_path=d["llama"])
    _assert_params_equal(port, _bridged(jm, **kw))
    _assert_forwards_match(jm, port)
    ids = np.random.default_rng(4).integers(0, HF_VOCAB, size=(B, 10)).astype(np.int32)
    with torch.no_grad():
        hf_hidden = hf_dirs["models"]["llama"](torch.from_numpy(ids).long()).last_hidden_state
    for lm in (port.module.text_encoder.backbone, port.module.caption_decoder.lm):
        np.testing.assert_allclose(_hidden(lm, ids)["hidden_states"].numpy(), hf_hidden.numpy(), atol=HF_TOL)


def test_a_failed_load_changes_nothing(hf_dirs, tmp_path):
    d = hf_dirs["bin"]
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **_kw())
    before = {n: p.detach().clone() for n, p in port.module.named_parameters()}
    big = GPT2LMHeadModel(GPT2Config(vocab_size=300, n_positions=64, n_embd=32, n_layer=2, n_head=2)).eval()
    big.save_pretrained(tmp_path / "big", safe_serialization=False)
    with pytest.raises(ValueError, match="exceeds module vocab"):  # the vision tower converted first, not written
        port.load_pretrained_towers(vision_path=d["clip"], text_path=tmp_path / "big")
    short = GPT2LMHeadModel(GPT2Config(vocab_size=HF_VOCAB, n_positions=32, n_embd=32, n_layer=2, n_head=2)).eval()
    short.save_pretrained(tmp_path / "short", safe_serialization=False)
    with pytest.raises(ValueError, match="decoder: shape mismatch for wpe"):  # 32 positions, the module's 64
        port.load_pretrained_towers(text_path=d["gpt2"], decoder_path=tmp_path / "short")
    with pytest.raises(FileNotFoundError, match="No torch checkpoint"):
        port.load_pretrained_towers(vision_path=tmp_path)
    assert all(torch.equal(p, before[n]) for n, p in port.module.named_parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_serving_copy_and_a_new_engine_serve_the_loaded_weights(hf_dirs, dtype):
    """The masters change in place: the bf16 serving copy is recast and the decode graphs follow; an
    engine built after the load serves the loaded weights (one built before keeps its own)."""
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine

    d = hf_dirs["bin"]
    images = np.random.default_rng(6).integers(0, 256, size=(4, 32, 32, 3), dtype=np.uint8)
    jm = JaxModel(tokenizer=JaxTokenizer(), **_kw())
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", dtype=dtype, **_kw())
    port.load_jax_params(jax.tree.map(np.asarray, jm.params))
    before = port.generate_captions(images, max_length=8)
    jm.load_pretrained_towers(vision_path=d["clip"], text_path=d["gpt2"])
    port.load_pretrained_towers(vision_path=d["clip"], text_path=d["gpt2"])
    want = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", dtype=dtype, **_kw())
    want.load_jax_params(jax.tree.map(np.asarray, jm.params))
    after = port.generate_captions(images, max_length=8)
    assert after == want.generate_captions(images, max_length=8) != before
    served = port._inference_module().caption_decoder.lm.wte.weight
    assert torch.equal(served, port.module.caption_decoder.lm.wte.weight.to(dtype))
    eng = ContinuousDecodeEngine(port, slots=4, chunk=2, max_length=8)
    eng.start()
    try:
        assert [eng.submit(img, timeout=120)["caption"] for img in images] == after
    finally:
        eng.stop()


def test_hf_converters_give_the_jax_trees():
    torch.manual_seed(1)
    head = torch.nn.Sequential(torch.nn.Linear(12, 8), torch.nn.ReLU(), torch.nn.Dropout(0.1),
                               torch.nn.Linear(8, 8), torch.nn.LayerNorm(8))
    mha = torch.nn.MultiheadAttention(16, 4)
    sd = {**{f"proj.{k}": v for k, v in head.state_dict().items()},
          **{f"cross.{k}": v for k, v in mha.state_dict().items()}}
    cases = [
        (convert.convert_linear(sd, "proj.0"), jconvert.convert_linear(sd, "proj.0")),
        (convert.convert_projection_head(sd, "proj"), jconvert.convert_projection_head(sd, "proj")),
        (convert.convert_mha(sd, "cross", 4), jconvert.convert_mha(sd, "cross", 4)),
    ]
    for got, want in cases:
        flat_got, flat_want = dict(convert._flatten(got)), dict(convert._flatten(want))
        assert flat_got.keys() == flat_want.keys()
        for key in flat_want:
            np.testing.assert_array_equal(flat_got[key], flat_want[key], err_msg=str(key))
    nobias = torch.nn.Linear(4, 3, bias=False)
    assert set(convert.convert_linear({"l.weight": nobias.weight}, "l")) == {"kernel"}


# ------------------------------------------------------------------ scanned JAX trees


@pytest.mark.parametrize("text_model", ["tiny-gpt2", "tiny-llama"])
def test_scanned_jax_tree_bridges_into_the_port(text_model):
    kw = _kw(text_model)
    jm = JaxModel(tokenizer=JaxTokenizer(), scan_layers=True, **kw)
    tree = jax.tree.map(np.asarray, jm.params)
    assert "blocks" in tree["caption_decoder"]["lm"] and "block_0" not in tree["caption_decoder"]["lm"]
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **kw)
    port.load_jax_params(tree)
    unrolled = jax.tree.map(np.asarray, jm.params)
    unrolled["caption_decoder"]["lm"] = jconvert.unstack_scan_params(unrolled["caption_decoder"]["lm"])
    unrolled["text_encoder"]["backbone"] = jconvert.unstack_scan_params(unrolled["text_encoder"]["backbone"])
    ref = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **kw)
    ref.load_jax_params(unrolled)
    _assert_params_equal(port, ref)
    _assert_forwards_match(jm, port)

    images, _, _ = _inputs()
    cfg, cache_len = port.module.decoder_config, 6
    emb_j = jm.module.apply({"params": jm.params}, jax_prepare_images(jnp.asarray(images)),
                            method=jm.module.encode_image)["embeddings"]
    emb_p = port.encode_image(images)["embeddings"]

    def mask_at(pos):
        return (np.arange(cache_len)[None] <= pos).astype(np.int32).repeat(B, 0)

    caches_j = jax_init_kv_cache(jm.module.decoder_config, B, cache_len, jnp.float32)
    caches_p = init_kv_cache(cfg, B, cache_len, torch.float32, torch.device("cpu"))
    apply = lambda method, *a: jm.module.apply({"params": jm.params}, *a, method=method)  # noqa: E731
    with torch.inference_mode():
        logits_j, caches_j = apply("decode_prefix", emb_j, caches_j, jnp.asarray(mask_at(0)))
        logits_p, caches_p = port.module.decode_prefix(emb_p, caches_p, torch.from_numpy(mask_at(0)))
        np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=FWD_TOL)
        for t in (1, 2):
            tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)[:, None]
            logits_j, caches_j = apply("decode_step", jnp.asarray(tok), t, caches_j, jnp.asarray(mask_at(t)))
            logits_p, caches_p = port.module.decode_step(torch.from_numpy(tok).long(), t, caches_p,
                                                         torch.from_numpy(mask_at(t)))
            np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=FWD_TOL, err_msg=f"step {t}")


def test_unstack_scan_params_equals_jax():
    rng = np.random.default_rng(5)
    stacked = {"wte": {"embedding": rng.normal(size=(5, 4))},
               "blocks": {"LayerNorm_0": {"scale": rng.normal(size=(3, 4)), "bias": rng.normal(size=(3, 4))},
                          "attn": {"q_proj": {"kernel": rng.normal(size=(3, 4, 2, 2))}}}}
    got, want = convert.unstack_scan_params(stacked), jconvert.unstack_scan_params(stacked)
    flat_got, flat_want = dict(convert._flatten(got)), dict(convert._flatten(want))
    assert flat_got.keys() == flat_want.keys() and ("block_2", "attn", "q_proj", "kernel") in flat_got
    for key in flat_want:
        np.testing.assert_array_equal(flat_got[key], flat_want[key])
    with pytest.raises(ValueError, match="no stacked"):
        convert.unstack_scan_params({"wte": {}})
