"""The port's partition rules (pgica_tpu_torch/parallel/sharding.py) against the JAX package's, in one process.

* ``infer_param_spec`` equals JAX's for every leaf path and shape of the
  tiny-gpt2, tiny-llama and tiny-vit models and of the full-width
  ``scaled_vitl_gpt2large`` (CLIP ViT-L/14 + GPT-2 Large, vocab 50,262) and
  ``siglip_llama8b`` (SigLIP so400m + Llama-3-8B, vocab 128,256) trees, each
  unrolled and scanned (``blocks/`` leaves with a leading layer dimension),
  their shapes from JAX ``eval_shape``, on the meshes (model 2), (model 4),
  (fsdp 2 x model 4), (data 2 x model 2 x seq 2), (data 2 x fsdp 4) and
  (data 2 x fsdp 2 x model 2). A JAX spec is compared
  padded with ``None`` to the leaf's rank.
* ``jax_leaf`` (the port parameter's JAX path and shape) gives the JAX tree
  exactly, for the unrolled trees (full width on the ``meta`` device).
* The JAX ``TestShardingRules`` cases, and ``join_params`` of every rank's
  ``shard_params`` is the tree (numpy and torch leaves); a module cut by
  ``shard_module`` holds what ``load_jax_params`` writes from
  ``shard_params`` of the tree, bit for bit, and ``local_state`` of its
  whole state is its state.
* A module cut over ``model`` then ``fsdp`` (``shard_fsdp``) holds, on each
  rank of the fsdp meshes, what ``load_jax_params`` writes from the JAX
  arrays' shards on that rank's device (JAX's ``shard_params``; a column
  bias of a kernel cut over ``model`` is the rank's slice, as
  ``shard_module`` keeps it), bit for bit; ``local_state`` of the whole
  state is its state and ``sharded_bytes`` counts both axes.

Exact comparisons throughout (specs, shapes, bits). No ranks: the meshes are
``MeshContext(world_size=n, rank=r)`` without a process group.
"""

import functools

import numpy as np
import pytest
import torch

from pgica_tpu_torch.models.model import build_module
from pgica_tpu_torch.parallel.mesh import MeshContext
from pgica_tpu_torch.parallel.sharding import (
    infer_param_spec,
    jax_leaf,
    join_params,
    local_state,
    module_tp_dims,
    param_dims,
    shard_fsdp,
    shard_module,
    shard_params,
    sharded_bytes,
)

MESHES = {  # name: axis sizes
    "model2": {"model": 2},
    "model4": {"model": 4},
    "fsdp2_model4": {"fsdp": 2, "model": 4},
    "data2_model2_seq2": {"data": 2, "model": 2, "seq": 2},
    "fsdp4": {"data": 2, "fsdp": 4},
    "data2_fsdp2_model2": {"data": 2, "fsdp": 2, "model": 2},
}
TREES = {  # name: (vision, text, vocab, projection_dim)
    "tiny_gpt2": ("tiny-vit", "tiny-gpt2", 261, 16),
    "tiny_llama": ("tiny-vit", "tiny-llama", 261, 16),
    "scaled_vitl_gpt2large": ("openai/clip-vit-large-patch14", "gpt2-large", 50262, 512),
    "siglip_llama8b": ("google/siglip-so400m-patch14-384", "meta-llama/Meta-Llama-3-8B", 128256, 512),
}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _port_mesh(shape, rank=0):
    n = int(np.prod(list(shape.values())))
    return MeshContext(data=shape.get("data", 1), world_size=n, rank=rank,
                       **{k: v for k, v in shape.items() if k != "data"})


@functools.lru_cache(maxsize=None)
def _jax_tree(name, scan):
    """{path: shape} of the JAX model's parameters, from eval_shape (no weights are made)."""
    jax = _jax()
    import jax.numpy as jnp

    from pgica_tpu.models.model import build_module as jax_build

    vision, text, vocab, proj = TREES[name]
    module = jax_build(vision, text, projection_dim=proj, vocab_size=vocab, max_caption_length=8, scan_layers=scan)
    size = module.vision_config.image_size
    ids = jnp.zeros((1, 8), jnp.int32)
    tree = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), ids,
                                              jnp.ones_like(ids), mode="dual"))["params"]
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape) for path, leaf in flat}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("scan", [False, True], ids=["unrolled", "scanned"])
@pytest.mark.parametrize("tree_name", sorted(TREES))
def test_specs_equal_jax(tree_name, scan, mesh_name):
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.parallel.sharding import infer_param_spec as jax_spec

    shape = MESHES[mesh_name]
    n = int(np.prod(list(shape.values())))
    jmesh = JaxMesh(devices=jax.devices()[:n], **{"data": 1, **shape}).mesh
    pmesh = _port_mesh(shape)
    tree = _jax_tree(tree_name, scan)
    assert any("blocks" in p.split("/") for p in tree) == scan
    split, cut_by = 0, "model" if "model" in shape else "fsdp"
    for path, leaf_shape in tree.items():
        want = tuple(jax_spec(path, leaf_shape, jmesh))
        want += (None,) * (len(leaf_shape) - len(want))
        got = infer_param_spec(path, leaf_shape, pmesh)
        assert got == want, path
        split += cut_by in got
    assert split > 0  # the rules cut something on every mesh


@pytest.mark.parametrize("tree_name", sorted(TREES))
def test_jax_leaf_inverts_the_bridge(tree_name):
    vision, text, vocab, proj = TREES[tree_name]
    with torch.device("meta"):
        module = build_module(vision, text, projection_dim=proj, vocab_size=vocab, max_caption_length=8)
    tree = _jax_tree(tree_name, False)
    got = dict(jax_leaf(module, name, p) for name, p in module.named_parameters())
    assert got == tree


@pytest.mark.parametrize("path, shape, mesh, want", [
    ("text_encoder/backbone/block_0/attn/q_proj/kernel", (32, 4, 8), {"model": 2}, (None, "model", None)),
    ("x/attn/out_proj/kernel", (4, 8, 32), {"model": 2}, ("model", None, None)),
    ("x/mlp/fc_in/kernel", (32, 128), {"model": 2}, (None, "model")),
    ("x/mlp/fc_out/kernel", (128, 32), {"model": 2}, ("model", None)),
    ("x/attn/q_proj/kernel", (32, 3, 8), {"model": 2}, (None, None, None)),  # 3 heads: replicated
    ("x/ln_f/scale", (32,), {"model": 2}, (None,)),
    ("x/mlp/fc_in/kernel", (32, 128), {"fsdp": 2}, ("fsdp", None)),
    ("x/lm/wte/embedding", (64, 32), {"model": 2, "fsdp": 2}, ("model", None)),
    ("x/lm/wte/embedding", (64, 32), {"fsdp": 2}, (None, "fsdp")),  # pure FSDP: emb over fsdp
])
def test_sharding_rules(path, shape, mesh, want):
    """The JAX TestShardingRules cases (tests/test_parallel.py:43-84)."""
    assert infer_param_spec(path, shape, _port_mesh(mesh)) == want


def _tiny_jax_params(text):
    """A JAX tree of the tiny model's paths and shapes (``eval_shape``), filled from a seeded numpy generator."""
    rng = np.random.default_rng(0)
    tree = {}
    for path, shape in _jax_tree("tiny_gpt2" if text == "tiny-gpt2" else "tiny_llama", False).items():
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = rng.normal(size=shape).astype(np.float32)
    return tree


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("mesh_name", ["model2", "model4"])
@pytest.mark.parametrize("text", ["tiny-gpt2", "tiny-llama"])
def test_gather_of_shards_is_the_tree(text, mesh_name):
    tree = _tiny_jax_params(text)
    shape = MESHES[mesh_name]
    n = shape["model"]
    meshes = [_port_mesh(shape, rank=r) for r in range(n)]
    dims = param_dims(tree, meshes[0])
    for as_torch in (False, True):
        whole = _map_tree(tree, lambda x: torch.from_numpy(np.array(x))) if as_torch else tree
        shards = [shard_params(whole, m) for m in meshes]
        first = dict(_leaves(shards[0]))
        assert any(tuple(leaf.shape) != tuple(first[p].shape) for p, leaf in _leaves(whole)), "nothing was cut"
        joined = dict(_leaves(join_params(shards, dims)))
        for p, leaf in _leaves(whole):
            assert type(joined[p]) is type(leaf) and np.array_equal(np.asarray(joined[p]), np.asarray(leaf)), p


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("text, model", [("tiny-gpt2", 2), ("tiny-llama", 4)])
def test_shard_module_holds_the_shard_of_the_tree(text, model):
    """A cut module = the module loaded from ``shard_params`` of the JAX tree; k/v stay whole where the axis
    does not divide tiny-llama's 2 KV heads."""
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

    tree = _tiny_jax_params(text)
    for rank in range(model):
        mesh = _port_mesh({"model": model}, rank)
        full = PreferenceGuidedCaptioningModel(vision_model="tiny-vit", text_model=text, projection_dim=16,
                                               tokenizer=CaptionTokenizer(), max_caption_length=8, device="cpu")
        full.load_jax_params(tree)
        whole = {k: v.clone() for k, v in full.module.state_dict().items()}
        dims = module_tp_dims(full.module, mesh)
        cut = PreferenceGuidedCaptioningModel(vision_model="tiny-vit", text_model=text, projection_dim=16,
                                              tokenizer=CaptionTokenizer(), max_caption_length=8, device="cpu")
        assert shard_module(cut.module, mesh) == dims
        cut.load_jax_params(shard_params(tree, mesh))
        shard_module(full.module, mesh)
        a, b = full.module.state_dict(), cut.module.state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(v, b[k]) for k, v in local_state(cut.module, mesh, whole).items())
        local, total = sharded_bytes(cut.module)
        assert local * model == total > 0
        kv = [k for k in dims if "caption_decoder.lm" in k and "k_proj" in k]
        assert bool(kv) == (text == "tiny-gpt2" or model == 2), kv  # tiny-llama: 2 KV heads
        assert "caption_decoder.lm.wte.weight" not in dims  # 261 rows: no model degree > 1 divides them


def _jax_shards(tree, shape, rank):
    """The JAX arrays' shards of a numpy tree on the device of ``rank`` under JAX's ``shard_params``."""
    jax = _jax()
    from pgica_tpu.parallel.mesh import MeshContext as JaxMesh
    from pgica_tpu.parallel.sharding import shard_params as jax_shard_params

    n = int(np.prod(list(shape.values())))
    sharded = jax_shard_params(tree, JaxMesh(devices=jax.devices()[:n], **{"data": 1, **shape}).mesh)
    device = jax.devices()[rank]
    return _map_tree(sharded, lambda leaf: next(np.asarray(s.data) for s in leaf.addressable_shards
                                                if s.device == device))


@pytest.mark.parametrize("mesh_name", ["fsdp4", "fsdp2_model4", "data2_fsdp2_model2"])
@pytest.mark.parametrize("text", ["tiny-gpt2", "tiny-llama"])
def test_fsdp_cut_holds_the_jax_shard(text, mesh_name):
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel

    tree = _tiny_jax_params(text)
    shape = MESHES[mesh_name]
    n = int(np.prod(list(shape.values())))

    def model():
        return PreferenceGuidedCaptioningModel(vision_model="tiny-vit", text_model=text, projection_dim=16,
                                               tokenizer=CaptionTokenizer(), max_caption_length=8, device="cpu")

    for rank in range(n):
        mesh = _port_mesh(shape, rank)
        full = model()
        full.load_jax_params(tree)
        whole = {k: v.clone() for k, v in full.module.state_dict().items()}
        shard_module(full.module, mesh)
        cut = shard_fsdp(full.module, mesh)
        assert cut and all(leaf.dim is not None for leaf in cut.values())
        shards = _jax_shards(tree, shape, rank)
        tp = shard_params(tree, mesh)  # the column biases as shard_module keeps them
        for path, leaf in _leaves(tp):
            if path[-1] == "bias" and path[-2] in ("q_proj", "k_proj", "v_proj", "fc_in", "gate_proj", "up_proj"):
                node = shards
                for key in path[:-1]:
                    node = node[key]
                node["bias"] = leaf
        other = model()
        shard_module(other.module, mesh)
        shard_fsdp(other.module, mesh)
        other.load_jax_params(shards)
        a, b = full.module.state_dict(), other.module.state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
        assert all(torch.equal(v, a[k]) for k, v in local_state(full.module, mesh, whole).items())
        local, total = sharded_bytes(full.module)
        assert 0 < local < total and total == sum(whole[k].numel() * 4 for k in set(cut) | set(module_tp_dims(
            model().module, mesh)))
