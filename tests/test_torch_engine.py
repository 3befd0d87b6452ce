"""The port's continuous-batching engine and per-row cache positions (CPU, float32).

Mirrors tests/test_engine.py on the port: greedy captions through the
slot-pool engine are token-identical to the port's batch path, whatever the
admission order, slot reuse or chunk boundaries; the engine validates
images, survives a dispatch error and skips a request whose submit timed
out; a per-row cache write equals a scalar one, bit for bit. Against the
JAX package (weights bridged with ``load_jax_params``): the port engine's
greedy captions equal the JAX ``ContinuousDecodeEngine``'s for tiny GPT-2
and tiny Llama; ``decode_step`` at per-row positions (GPT-2's per-row
``wpe`` gather, Llama's per-row RoPE) gives JAX's logits and caches within
1e-5 (float32, sums in another order); a row whose position lies outside
the cache writes nothing. Sampling is held to reproducibility under a seed
and to the top-p nucleus, not to JAX's stream. An admission bucket with
padding slot ids (>= S) leaves the first S rows of every state tensor as
JAX's ``admit_fn`` leaves them (its ``mode="drop"`` scatter); the padding
rows land in the port's scratch row S, which no chunk shows. The admission
reads nothing back to the host (the card captures it as a CUDA graph per
bucket): it runs under ``FakeTensorMode``, and one with a host read fails.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import DataDependentOutputException, FakeTensorMode

from pgica_tpu.data.augment import prepare_images as jax_prepare_images
from pgica_tpu.data.tokenizer import CaptionTokenizer as JaxTokenizer
from pgica_tpu.generation.engine import ContinuousDecodeEngine as JaxEngine
from pgica_tpu.generation.engine import make_engine_fns as jax_make_engine_fns
from pgica_tpu.models import PreferenceGuidedCaptioningModel as JaxModel
from pgica_tpu.models.lm import init_kv_cache as jax_init_kv_cache
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
from pgica_tpu_torch.generation.decode import generate
from pgica_tpu_torch.generation import slots as port_slots
from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine, make_engine_fns
from pgica_tpu_torch.generation.slots import CapturedSteps, Sampler, _top_p_filter, init_slot_state
from pgica_tpu_torch.models.layers import MultiHeadAttention
from pgica_tpu_torch.models.lm import init_kv_cache
from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
from pgica_tpu_torch.ops.attention import key_padding_bias

MAX_LENGTH = 8
ATOL = 1e-5
TINY = {"gpt2": dict(vision_model="tiny-vit", text_model="tiny-gpt2", projection_dim=16, max_caption_length=8,
                     image_size=32),
        "llama": dict(vision_model="tiny-vit", text_model="tiny-llama", projection_dim=16, dropout=0.0,
                      max_caption_length=10, image_size=32)}


@pytest.fixture(scope="module")
def jax_models(tiny_model):
    return {"gpt2": tiny_model, "llama": JaxModel(tokenizer=JaxTokenizer(), seed=0, **TINY["llama"])}


def _port(jm, arch):
    port = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), device="cpu", **TINY[arch])
    port.load_jax_params(jax.tree.map(np.array, jm.params))
    return port


@pytest.fixture(scope="module")
def port_model(jax_models):
    return _port(jax_models["gpt2"], "gpt2")


@pytest.fixture(scope="module")
def engine_images():
    return np.random.default_rng(7).integers(0, 256, (6, 32, 32, 3), np.uint8)


@pytest.fixture(scope="module")
def models(jax_models, port_model, engine_images):
    """"random" weights, and "eos" ones under which EOS outscores the token the greedy captions use
    most (its tied embedding a scaled copy), so that captions end early and free their slots
    mid-chunk."""
    eos_model = _port(jax_models["gpt2"], "gpt2")
    tok = eos_model.tokenizer
    emb = eos_model.encode_image(engine_images)["embeddings"]
    ids = generate(eos_model.module, emb, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                   max_length=MAX_LENGTH)
    wte = eos_model.module.caption_decoder.lm.wte.weight
    with torch.no_grad():
        wte[tok.eos_token_id] = 1.2 * wte[int(torch.bincount(ids.flatten()).argmax())]
    ids = generate(eos_model.module, emb, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                   max_length=MAX_LENGTH)
    ended = (ids[:, :-1] == tok.eos_token_id).any(dim=1)
    assert 0 < int(ended.sum()), "no caption ends early; pick another token"
    return {"random": port_model, "eos": eos_model}


def _submit_all(eng, images, stagger_s=0.0):
    out = [None] * len(images)
    errs = []

    def go(i):
        try:
            if stagger_s:
                time.sleep(i * stagger_s)
            out[i] = eng.submit(images[i], timeout=180)["caption"]
        except Exception as e:  # surfaced by the assert below
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(240)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return out


def _run_engine(engine_cls, model, images, *, slots, chunk, stagger_s=0.0, **kw):
    eng = engine_cls(model, slots=slots, chunk=chunk, max_length=MAX_LENGTH, **kw)
    eng.warmup()
    eng.start()
    try:
        return _submit_all(eng, images, stagger_s)
    finally:
        eng.stop()


@pytest.mark.parametrize("weights", ["random", "eos"])
def test_engine_matches_batch_decode(models, engine_images, weights):
    """A concurrent burst through fewer slots than requests == batch decode."""
    model = models[weights]
    ref = model.generate_captions(engine_images, max_length=MAX_LENGTH)
    assert _run_engine(ContinuousDecodeEngine, model, engine_images, slots=4, chunk=2) == ref


@pytest.mark.parametrize("weights", ["random", "eos"])
def test_engine_staggered_admission(models, engine_images, weights):
    """Requests joining mid-flight keep exact parity."""
    model = models[weights]
    ref = model.generate_captions(engine_images, max_length=MAX_LENGTH)
    got = _run_engine(ContinuousDecodeEngine, model, engine_images, slots=2, chunk=1, stagger_s=0.05)
    assert got == ref


def test_engine_single_slot_reuse(port_model, engine_images):
    """Every request decodes through the same slot, one after another."""
    ref = port_model.generate_captions(engine_images[:3], max_length=MAX_LENGTH)
    assert _run_engine(ContinuousDecodeEngine, port_model, engine_images[:3], slots=1, chunk=4) == ref


def test_engine_non_power_of_two_slots(port_model, engine_images):
    """A pool of 6 admits a full burst in one FIFO bucket."""
    eng = ContinuousDecodeEngine(port_model, slots=6, chunk=2, max_length=MAX_LENGTH)
    assert eng.buckets == [1, 2, 4, 6]  # slots itself is always the top bucket
    eng.stop()
    ref = port_model.generate_captions(engine_images, max_length=MAX_LENGTH)
    got = _run_engine(ContinuousDecodeEngine, port_model, engine_images, slots=6, chunk=2)
    assert got == ref


def test_engine_submit_validates_image(port_model):
    """Malformed direct-API input fails in the caller, not the daemon."""
    eng = ContinuousDecodeEngine(port_model, slots=2, chunk=1, max_length=MAX_LENGTH)
    try:
        with pytest.raises(ValueError, match="image must be"):
            eng.submit(np.zeros((8, 8), np.uint8))  # 2D: wrong ndim
        with pytest.raises(ValueError, match="image must be"):
            eng.submit(np.zeros((16, 16, 3), np.uint8))  # wrong size
    finally:
        eng.stop()


def test_engine_survives_dispatch_error(port_model, engine_images):
    """A dispatch-loop error fails the victim request, and the engine keeps serving."""
    eng = ContinuousDecodeEngine(port_model, slots=2, chunk=2, max_length=MAX_LENGTH)
    eng.warmup()
    real_admit, boom = eng._admit, {"n": 1}

    def flaky_admit(*a, **k):
        if boom["n"]:
            boom["n"] -= 1
            raise RuntimeError("injected device error")
        return real_admit(*a, **k)

    eng._admit = flaky_admit
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="failed in the engine"):
            eng.submit(engine_images[0], timeout=60)
        # the engine recovered: the state reset, the slots free, the next request served
        ref = port_model.generate_captions(engine_images[1:2], max_length=MAX_LENGTH)
        assert eng.submit(engine_images[1], timeout=120)["caption"] == ref[0]
    finally:
        eng.stop()


def test_engine_timeout_cancels_unadmitted(port_model):
    """A timed-out submit marks its request; admission skips it."""
    eng = ContinuousDecodeEngine(port_model, slots=2, chunk=1, max_length=MAX_LENGTH)
    try:
        img = np.zeros((port_model.image_size,) * 2 + (3,), np.uint8)
        # engine not started: the request sits in the queue and times out
        with pytest.raises(TimeoutError):
            eng.submit(img, timeout=0.05)
        assert eng._take_arrivals() == []  # the cancelled request is skipped
    finally:
        eng.stop()


def test_engine_sampling_is_reproducible_under_a_seed(port_model, engine_images):
    """Sampled captions repeat under one seed (requests submitted one at a time)."""
    kw = dict(do_sample=True, temperature=0.8, top_p=0.9, repetition_penalty=1.2)

    def run(seed):
        eng = ContinuousDecodeEngine(port_model, slots=2, chunk=2, max_length=MAX_LENGTH, seed=seed, **kw)
        eng.warmup()
        eng.start()
        try:
            return [eng.submit(img, timeout=120)["caption"] for img in engine_images[:3]]
        finally:
            eng.stop()

    first = run(5)
    assert run(5) == first
    assert all(isinstance(c, str) for c in first)


def test_engine_sampling_does_not_depend_on_chunks_run_between_requests(port_model, engine_images):
    """How many chunks the pipeline runs between two requests is a matter of timing; each
    admission reseeds the stream, so extra chunks before an admission change no caption."""
    kw = dict(do_sample=True, temperature=0.8, top_p=0.9, repetition_penalty=1.2)

    def run(extra_chunks):
        eng = ContinuousDecodeEngine(port_model, slots=2, chunk=2, max_length=MAX_LENGTH, seed=5, **kw)
        eng.warmup()
        take = eng._take_arrivals

        def take_after_extra_chunks():  # on the dispatch thread, just before it admits
            arrivals = take()
            for _ in range(extra_chunks if arrivals else 0):
                eng._run_chunk()
            return arrivals

        eng._take_arrivals = take_after_extra_chunks
        eng.start()
        try:
            return [eng.submit(img, timeout=120)["caption"] for img in engine_images[:3]]
        finally:
            eng.stop()

    assert run(3) == run(0)


def test_sampled_tokens_stay_inside_the_top_p_nucleus():
    """Every Gumbel-max draw lands in the nucleus that ``_top_p_filter`` keeps, and the draws
    spread over it."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(0.0, 2.0, size=(4, 50)).astype(np.float32))
    presence = torch.zeros(4, 50, dtype=torch.int32)
    pick = Sampler(do_sample=True, temperature=0.7, top_p=0.6)
    kept = _top_p_filter(logits / 0.7, 0.6) > -1e8
    generator = torch.Generator().manual_seed(3)
    draws = torch.stack([pick(logits, presence, generator) for _ in range(400)])  # (400, 4)
    assert kept.gather(1, draws.T).all()
    assert all(len(set(draws[:, r].tolist())) > 1 for r in range(4) if kept[r].sum() > 1)


def test_per_row_cache_write_matches_scalar():
    """MultiHeadAttention: (B,) positions == one int position, bit for bit; distinct positions
    write each row at its own slot; a row whose position lies outside the cache writes nothing."""
    torch.manual_seed(0)
    attn = MultiHeadAttention(hidden_size=16, num_heads=2, causal=True).eval()
    x = torch.randn(3, 1, 16)
    bias = key_padding_bias((torch.arange(5)[None, :] <= 2).to(torch.int32).expand(3, 5))

    def run(position):
        cache = (torch.zeros(3, 2, 5, 8), torch.zeros(3, 2, 5, 8))
        with torch.no_grad():
            out = attn(x, bias, cache, position)
        return out, cache

    out_scalar, cache_scalar = run(2)
    out_rows, cache_rows = run(torch.tensor([2, 2, 2]))
    assert torch.equal(out_scalar, out_rows)
    for a, b in zip(cache_scalar, cache_rows):
        assert torch.equal(a, b)

    for positions in ([1, 2, 3], [1, 5, -1]):
        _, (k_mixed, v_mixed) = run(torch.tensor(positions))
        for row, pos in enumerate(positions):
            inside = 0 <= pos < 5
            written = [pos] if inside else []
            untouched = [p for p in range(5) if p not in written]
            for t in (k_mixed, v_mixed):
                assert (t[row][:, written].abs().sum() > 0) == inside
                assert t[row][:, untouched].abs().sum() == 0


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_per_row_decode_step_matches_jax(jax_models, arch):
    """Prefix, then two steps at per-row positions [1, 3, 2] and [2, 4, 3]: logits and caches
    against JAX ``decode_step`` at the same (B,) positions, atol 1e-5."""
    jm = jax_models[arch]
    port = _port(jm, arch)
    images = np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), np.uint8)
    emb = jm.module.apply({"params": jm.params}, jax_prepare_images(jnp.asarray(images)),
                          method="encode_image")["embeddings"]
    cache_len = 6

    def mask_at(pos):
        return (np.arange(cache_len)[None, :] <= np.asarray(pos)[:, None]).astype(np.int32)

    caches_j = jax_init_kv_cache(jm.module.decoder_config, 3, cache_len, jnp.float32)
    caches_p = init_kv_cache(port.module.decoder_config, 3, cache_len, torch.float32, torch.device("cpu"))
    with torch.inference_mode():
        logits_j, caches_j = jm.module.apply({"params": jm.params}, emb, caches_j, jnp.asarray(mask_at([0, 0, 0])),
                                             method="decode_prefix")
        logits_p, _ = port.module.decode_prefix(torch.from_numpy(np.array(emb)), caches_p,
                                                torch.from_numpy(mask_at([0, 0, 0])))
        for positions in ([1, 3, 2], [2, 4, 3]):
            tok = np.asarray(jnp.argmax(logits_j, axis=-1)).astype(np.int32)[:, None]
            logits_j, caches_j = jm.module.apply({"params": jm.params}, jnp.asarray(tok),
                                                 jnp.asarray(positions, jnp.int32), caches_j,
                                                 jnp.asarray(mask_at(positions)), method="decode_step")
            logits_p, _ = port.module.decode_step(torch.from_numpy(tok).long(), torch.tensor(positions), caches_p,
                                                  torch.from_numpy(mask_at(positions)))
            np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_j), atol=ATOL,
                                       err_msg=f"logits at {positions}")
            for layer, ((kj, vj), (kp, vp)) in enumerate(zip(caches_j, caches_p)):
                np.testing.assert_allclose(kp.numpy(), np.asarray(kj), atol=ATOL, err_msg=f"k{layer} {positions}")
                np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, err_msg=f"v{layer} {positions}")


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_engine_captions_equal_the_jax_engine(jax_models, engine_images, arch):
    """Greedy captions of a burst of 3 through 2 slots: the port's engine against JAX's."""
    jm = jax_models[arch]
    images = engine_images[:3]
    want = _run_engine(JaxEngine, jm, images, slots=2, chunk=2)
    got = _run_engine(ContinuousDecodeEngine, _port(jm, arch), images, slots=2, chunk=2)
    assert got == want



def _with_decoder_embedding(params, fn):
    tree = jax.tree.map(np.array, params)
    wte = tree["caption_decoder"]["lm"]["wte"]
    wte["embedding"] = fn(wte["embedding"])
    return tree


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_engine_serves_the_weights_it_was_built_with(jax_models, engine_images, dtype):
    """Updating the masters in place (as a train step and ``load_jax_params`` do) changes nothing the
    engine serves: it keeps the weights it was built with, as the JAX engine keeps the param tree it
    took. ``generate_captions`` serves the new weights: a model built from them gives its captions."""
    params = jax.tree.map(np.array, jax_models["gpt2"].params)

    def port(tree):
        model = PreferenceGuidedCaptioningModel(tokenizer=CaptionTokenizer(), dtype=dtype, device="cpu",
                                                **TINY["gpt2"])
        model.load_jax_params(tree)
        return model

    model, images = port(params), engine_images[:4]
    eng = ContinuousDecodeEngine(model, slots=4, chunk=2, max_length=MAX_LENGTH)
    eng.warmup()
    eng.start()
    try:
        built = _submit_all(eng, images)
        assert built == model.generate_captions(images, max_length=MAX_LENGTH)
        with torch.no_grad():
            model.module.caption_decoder.lm.wte.weight.mul_(-3)
        scaled = port(_with_decoder_embedding(params, lambda w: -3 * w)).generate_captions(images, max_length=MAX_LENGTH)
        assert model.generate_captions(images, max_length=MAX_LENGTH) == scaled != built
        assert _submit_all(eng, images) == built
        reversed_rows = _with_decoder_embedding(params, lambda w: w[::-1].copy())
        model.load_jax_params(reversed_rows)
        assert model.generate_captions(images, max_length=MAX_LENGTH) == port(reversed_rows).generate_captions(
            images, max_length=MAX_LENGTH) != built
        assert _submit_all(eng, images) == built
    finally:
        eng.stop()

def test_slot_state_refuses_unreachable_positions_and_graphs_refuse_the_cpu(port_model):
    """A GPT-2 slot rests at position max_length, whose wpe row must exist (on the card an index
    past the table is a device fault, not an exception); a CUDA graph takes CUDA work only."""
    cfg = port_model.module.decoder_config
    with pytest.raises(ValueError, match="learned positions"):
        init_slot_state(cfg, 2, cfg.max_position_embeddings, torch.float32, torch.device("cpu"),
                        eos_token_id=1, pad_token_id=0)
    init_slot_state(cfg, 2, cfg.max_position_embeddings - 1, torch.float32, torch.device("cpu"),
                    eos_token_id=1, pad_token_id=0)
    with pytest.raises(ValueError, match="CUDA graphs"):
        CapturedSteps(lambda: None, torch.device("cpu"), None)


ADMIT_SLOTS = 4
# two admission buckets of 4: slots 2 and 0, then 3, the rest padding (>= S)
ADMISSIONS = ([2, ADMIT_SLOTS, 0, ADMIT_SLOTS + 3], [ADMIT_SLOTS, 3, ADMIT_SLOTS + 1, ADMIT_SLOTS])


def _port_engine_fns(module, tok, chunk: int = 2):
    return make_engine_fns(module, module, slots=ADMIT_SLOTS, chunk=chunk, max_length=MAX_LENGTH,
                           eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, pick=Sampler(),
                           device=torch.device("cpu"))


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_admission_with_padding_ids_equals_jax_admit_fn(jax_models, engine_images, arch):
    """Two admission buckets with padding ids, then a chunk: after each admission every state
    tensor's first S rows equal JAX ``admit_fn``'s (ids exactly, caches within 1e-5); the padding
    rows went to the scratch row; the chunk's [seqs | active] snapshot has S rows and equals JAX's."""
    jm = jax_models[arch]
    port = _port(jm, arch)
    tok = port.tokenizer
    init_j, admit_j, chunk_j = jax_make_engine_fns(jm.module, jm.module, slots=ADMIT_SLOTS, chunk=2,
                                                   max_length=MAX_LENGTH, eos_token_id=tok.eos_token_id,
                                                   pad_token_id=tok.pad_token_id)
    state_j = init_j(jax.random.PRNGKey(0))
    init_p, admit_p, chunk_p = _port_engine_fns(port.module, tok)
    state_p = init_p(0)
    for i, ids in enumerate(ADMISSIONS):
        images = engine_images[2 * i:2 * i + 4]
        state_j = admit_j(jm.params, jm.params, state_j, jnp.asarray(images), jnp.asarray(ids, jnp.int32),
                          1.0, 1.0, 1.0)
        with torch.inference_mode():
            admit_p(state_p, torch.from_numpy(images), torch.tensor(ids))
        for name in state_p.padded:
            got = getattr(state_p, name)
            assert got.shape[0] == ADMIT_SLOTS
            np.testing.assert_array_equal(got.numpy(), np.asarray(state_j[name]), err_msg=f"{name}, admission {i}")
        for layer, ((kj, vj), (kp, vp)) in enumerate(zip(state_j["caches"], state_p.caches)):
            np.testing.assert_allclose(kp.numpy(), np.asarray(kj), atol=ATOL, err_msg=f"k{layer}, admission {i}")
            np.testing.assert_allclose(vp.numpy(), np.asarray(vj), atol=ATOL, err_msg=f"v{layer}, admission {i}")
        assert int(state_p.padded["pos"][ADMIT_SLOTS]) == 1, "no padding row reached the scratch row"
    state_j, snap_j = chunk_j(jm.params, state_j, 1.0, 1.0, 1.0)
    with torch.inference_mode():
        snap_p, _ = chunk_p(state_p)
    assert snap_p.shape == (ADMIT_SLOTS, MAX_LENGTH + 1)
    np.testing.assert_array_equal(snap_p.numpy(), np.asarray(snap_j))


def _fake_admission(module, tok, ids) -> None:
    """An admission bucket of 4 with padding ids, then a chunk, under FakeTensorMode: a host read of a
    fake tensor's value raises DataDependentOutputException."""
    init_state, admit_fn, chunk_fn = _port_engine_fns(module, tok)
    prepare_images(torch.zeros(1, 1, 1, 3, dtype=torch.uint8))  # makes the ImageNet stats, as an eager run before a capture
    with torch.inference_mode(), FakeTensorMode(allow_non_fake_inputs=True):
        state = init_state(0)
        admit_fn(state, torch.zeros(4, 32, 32, 3, dtype=torch.uint8), torch.tensor(ids))
        chunk_fn(state)


def test_admission_reads_nothing_back_to_the_host(port_model):
    _fake_admission(port_model.module, port_model.tokenizer, ADMISSIONS[0])


def test_a_host_read_in_the_admission_fails_the_check(port_model, monkeypatch):
    """The check catches a read: the padding ids dropped through a host list, as the port once did."""
    admit = port_slots.admit

    def admit_with_host_ids(module, state, embeddings, slot_ids, pick):
        keep = [i for i, slot in enumerate(slot_ids) if 0 <= int(slot) < state.slots]
        admit(module, state, embeddings[keep], slot_ids[keep], pick)

    monkeypatch.setattr("pgica_tpu_torch.generation.engine.admit", admit_with_host_ids)
    with pytest.raises(DataDependentOutputException):
        _fake_admission(port_model.module, port_model.tokenizer, ADMISSIONS[0])
