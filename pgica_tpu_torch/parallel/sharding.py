"""Parameter partition rules and tensor parallelism over ``model`` (port of pgica_tpu/parallel/sharding.py).

The rule table maps a JAX parameter path to a spec, one entry per
dimension: ``None``, an axis name, or a tuple of them (JAX's
``PartitionSpec``):

* attention q/k/v kernels (embed, heads, head_dim): heads over ``model``,
  embed over ``fsdp``; out_proj (heads, head_dim, embed): heads over
  ``model``;
* MLP in/gate/up (embed, intermediate) and out/down (intermediate, embed):
  intermediate over ``model``;
* token embedding (vocab, embed): vocab over ``model`` (on a mesh whose
  ``model`` axis has one rank, embed over ``fsdp`` instead);
* the patch embedding's output channels over ``model``;
* norms, biases and small heads replicated;
* a scanned ``blocks/`` leaf (leading layer dimension): ``fsdp`` moves to
  the layer dimension when it divides it.

A dimension that an axis does not divide drops that axis (replicated), so
tiny models run on any mesh. :func:`infer_param_spec` is the JAX
function's copy; the JAX package hands the specs to GSPMD, which inserts
the collectives. The port makes them explicit, in the Megatron way:

* :func:`shard_module` keeps, of each parameter whose spec splits a
  dimension over ``model``, this rank's block (the rank's ``model`` index
  along that dimension), and tells the layers (models/layers.py,
  models/vit.py): a column-parallel product (q/k/v, fc_in, gate/up, the
  patch embedding) keeps its local heads or columns, and its bias,
  replicated in the rules, is kept as the same local slice (its gradient is
  then that slice of the whole one); a row-parallel product (out_proj,
  fc_out, down) sums its partial outputs over ``model``
  (``collectives.reduce_from``) and adds its replicated bias once, after
  the sum; the vocab-parallel ``wte`` looks up the ids of its rows, gives
  zero rows for the others and sums over ``model``.
* :func:`shard_fsdp` then keeps, of each parameter whose spec splits a
  dimension over ``fsdp``, this rank's block of the model-local block (the
  rank's ``fsdp`` index; for a stacked ``scan_layers`` leaf whose layer count
  the axis divides, whole layers: the layers of this rank's index), so a
  rank holds JAX's shard on the device at its mesh coordinates, leaf by leaf;
  parallel/fsdp.py gathers a block's weights at its entry and the other cut
  leaves where their module runs. A leaf the spec replicates stays whole.
* :func:`shard_params` / :func:`gather_params` do the same on a JAX tree
  (nested dicts of numpy or torch leaves), by the JAX dims
  (:func:`param_dims`, the column biases included):
  ``load_jax_params(module, shard_params(tree, mesh))`` loads a rank's
  share into a module that :func:`shard_module` has cut.
* :func:`gathered_state_dict` gathers a sharded module's parameters (or any
  tensors laid out like them, the Adam moments) into whole tensors by name,
  over ``fsdp`` then ``model``, which is what a sharded checkpoint holds;
  :func:`local_state` cuts a whole state dict back to this rank's blocks, for
  any ``fsdp`` x ``model`` degree, one process included.
"""

from __future__ import annotations

import logging
import math
import re
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from pgica_tpu_torch.parallel import collectives, fsdp
from pgica_tpu_torch.parallel.mesh import MeshContext
from pgica_tpu_torch.parallel.zero1 import _lms, jax_path

logger = logging.getLogger(__name__)

Spec = Tuple[Any, ...]  # one entry per dimension: None, an axis name, or a tuple of axis names

# (path regex, spec per dimension): the first match wins (JAX sharding.py:35-62).
_RULES: Tuple[Tuple[str, Tuple], ...] = (
    (r".*(q_proj|k_proj|v_proj)/kernel$", ("fsdp", "model", None)),
    (r".*out_proj/kernel$", ("model", None, "fsdp")),
    (r".*(fc_in|gate_proj|up_proj)/kernel$", ("fsdp", "model")),
    (r".*(fc_out|down_proj)/kernel$", ("model", "fsdp")),
    (r".*wte/embedding$", ("model", None)),
    (r".*wpe/embedding$", (None, "fsdp")),
    (r".*patch_embed/kernel$", (None, None, None, "model")),
    (r".*projection/(fc1|fc2)/kernel$", ("fsdp", None)),
    (r".*vision_projection.*kernel$", ("fsdp", None)),
)

# The torch dimension of each JAX dimension that ``model`` or ``fsdp`` may split, rule by rule as _RULES:
# nn.Linear weights are (out, in), q/k/v rows head-major (models/convert.py), the patch weight (width, P*P*C).
_TORCH_DIM: Tuple[Tuple[str, Dict[int, int]], ...] = (
    (r".*(q_proj|k_proj|v_proj)/kernel$", {0: 1, 1: 0}),
    (r".*out_proj/kernel$", {0: 1, 2: 0}),
    (r".*(fc_in|gate_proj|up_proj)/kernel$", {0: 1, 1: 0}),
    (r".*(fc_out|down_proj)/kernel$", {0: 1, 1: 0}),
    (r".*wte/embedding$", {0: 0, 1: 1}),
    (r".*wpe/embedding$", {1: 1}),
    (r".*patch_embed/kernel$", {3: 0}),
    (r".*projection/(fc1|fc2)/kernel$", {0: 1}),
    (r".*vision_projection.*kernel$", {0: 1}),
)
_COLUMN = ("q_proj", "k_proj", "v_proj", "fc_in", "gate_proj", "up_proj")  # their biases follow the kernel


def _shape_of(mesh) -> Mapping[str, int]:
    return mesh.shape if hasattr(mesh, "shape") else mesh


def _axis_size(mesh, axis) -> int:
    """Axes absent from the mesh count as size 1 (the rule drops to replicated)."""
    if axis is None:
        return 1
    shape = _shape_of(mesh)
    if isinstance(axis, tuple):
        size = 1
        for a in axis:
            size *= shape.get(a, 1)
        return size
    return shape.get(axis, 1)


def _apply_dims(dims, shape, mesh) -> Spec:
    spec = []
    for i, axis in enumerate(dims[: len(shape)]):
        size = _axis_size(mesh, axis)
        spec.append(axis if axis is not None and shape[i] % size == 0 and size > 1 else None)
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def infer_param_spec(path: str, shape: Sequence[int], mesh) -> Spec:
    """The spec of one parameter (JAX ``infer_param_spec``), with the divisibility fallback; ``mesh`` is a
    :class:`MeshContext` or a mapping of axis sizes. A replicated leaf gets ``(None,) * len(shape)``."""
    shape = tuple(shape)
    scanned = "blocks" in path.split("/")
    for pattern, dims in _RULES:
        if re.match(pattern, path):
            if dims == ("model", None) and _axis_size(mesh, "model") == 1:
                dims = (None, "fsdp")  # wte on a pure-FSDP mesh
            if scanned:
                layer_dims = ("fsdp",) + tuple(None if a == "fsdp" else a for a in dims)
                if shape[0] % _axis_size(mesh, "fsdp") == 0:
                    return _apply_dims(layer_dims, shape, mesh)
                dims = (None,) + tuple(dims)
            return _apply_dims(dims, shape, mesh)
    return (None,) * len(shape)


def split_dim(spec: Spec, axis: str = "model") -> Optional[int]:
    """The dimension that ``spec`` splits over ``axis`` (alone or in a tuple), or None."""
    for i, entry in enumerate(spec):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


# ------------------------------------------------------------------ JAX trees


def _items(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _items(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def _map(tree: Mapping, fn, prefix: Tuple[str, ...] = ()) -> Dict:
    return {k: _map(v, fn, prefix + (str(k),)) if isinstance(v, Mapping) else fn(prefix + (str(k),), v)
            for k, v in tree.items()}


def param_specs(tree: Mapping, mesh) -> Dict:
    """The spec of every leaf of a JAX tree (leaves with a ``.shape``: numpy, torch, ``jax.ShapeDtypeStruct``)."""
    return _map(tree, lambda path, leaf: infer_param_spec("/".join(path), tuple(leaf.shape), mesh))


def _column_bias(path: Tuple[str, ...]) -> bool:
    return path[-1] == "bias" and len(path) > 1 and path[-2] in _COLUMN


def param_dims(tree: Mapping, mesh, axis: str = "model") -> Dict:
    """The dimension of every leaf of a JAX tree that a rank holds a block of along ``axis`` (None: whole):
    the spec's, and for a column-parallel bias (replicated in the rules) its kernel's output dimension."""
    specs = dict(_items(param_specs(tree, mesh)))

    def dim(path, leaf):
        if _column_bias(path):
            kernel = specs.get(path[:-1] + ("kernel",))
            return 0 if kernel is not None and split_dim(kernel, axis) is not None else None
        return split_dim(specs[path], axis)

    return _map(tree, dim)


def _block(x, dim: int, index: int, n: int):
    size = x.shape[dim] // n
    if isinstance(x, torch.Tensor):
        return x.narrow(dim, index * size, size).clone()
    return x.take(range(index * size, (index + 1) * size), axis=dim)


def shard_params(tree: Mapping, mesh: MeshContext, axis: str = "model", index: Optional[int] = None) -> Dict:
    """This rank's share (``index``: its ``axis`` index) of a full JAX tree, as :func:`shard_module` holds it:
    each leaf cut along its :func:`param_dims` dimension; the other leaves as they are."""
    n = mesh.axis_size(axis)
    index = mesh.axis_index(axis) if index is None else index
    dims = dict(_items(param_dims(tree, mesh, axis)))
    return _map(tree, lambda path, leaf: leaf if dims[path] is None or n == 1 else _block(leaf, dims[path], index, n))


def join_params(shards: Sequence[Mapping], dims: Mapping) -> Dict:
    """The full tree from every rank's share (in axis-index order) and the full tree's :func:`param_dims`."""
    flat = [dict(_items(s)) for s in shards]
    flat_dims = dict(_items(dims))

    def join(path, _leaf):
        leaves = [f[path] for f in flat]
        dim = flat_dims[path]
        if dim is None:
            return leaves[0]
        if isinstance(leaves[0], torch.Tensor):
            return torch.cat(leaves, dim)
        import numpy as np

        return np.concatenate(leaves, axis=dim)

    return _map(shards[0], join)


def gather_params(tree: Mapping, mesh: MeshContext, dims: Mapping, axis: str = "model") -> Dict:
    """The inverse of :func:`shard_params` over the ranks: every rank's share of a JAX tree (torch or numpy
    leaves) gathered into the full tree, on every rank; ``dims`` is the full tree's :func:`param_dims`."""
    flat_dims = dict(_items(dims))

    def gather(path, leaf):
        dim = flat_dims[path]
        if dim is None or mesh.axis_size(axis) == 1:
            return leaf
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(leaf)
        whole = collectives.gather_from(t.detach(), axis, dim, mesh)
        return whole if isinstance(leaf, torch.Tensor) else whole.numpy()

    return _map(tree, gather)


# ------------------------------------------------------------------ the port's modules


def jax_leaf(module: nn.Module, name: str, param) -> Tuple[str, Tuple[int, ...]]:
    """The JAX path and shape of the port's parameter ``name`` (the inverse of models/convert.py's layout);
    ``param`` is the parameter or its shape."""
    path = jax_path(module, name)
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    shape = tuple(getattr(param, "shape", param))
    proj = owner_name.rsplit(".", 1)[-1]
    if proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        head_dim = module.get_submodule(owner_name.rsplit(".", 1)[0]).head_dim
        if leaf == "weight" and proj == "out_proj":
            shape = (shape[1] // head_dim, head_dim, shape[0])
        elif leaf == "weight":
            shape = (shape[1], shape[0] // head_dim, head_dim)
        elif leaf == "bias" and proj != "out_proj":
            shape = (shape[0] // head_dim, head_dim)
    elif leaf == "weight" and type(owner).__name__ == "PatchEmbed":
        p = owner.patch_size
        shape = (p, p, shape[1] // (p * p), shape[0])
    elif path[-1] == "kernel":
        shape = shape[::-1]
    return "/".join(path), shape


def torch_dim(path: str, jax_dim: int) -> int:
    """The port's dimension of the JAX leaf ``path``'s dimension ``jax_dim`` (which a rule splits)."""
    return next(m[jax_dim] for pattern, m in _TORCH_DIM if re.match(pattern, path))


def module_tp_dims(module: nn.Module, mesh, axis: str = "model") -> Dict[str, int]:
    """{parameter name: the torch dimension split over ``axis``} of a full module under the rules; the
    column-parallel biases follow their kernels."""
    dims: Dict[str, int] = {}
    for name, p in module.named_parameters():
        path, shape = jax_leaf(module, name, p)
        jax_dim = split_dim(infer_param_spec(path, shape, mesh), axis)
        if jax_dim is None:
            continue
        dims[name] = torch_dim(path, jax_dim)
    for name, _ in module.named_parameters():
        owner, leaf = name.rsplit(".", 1)
        if leaf == "bias" and owner.rsplit(".", 1)[-1] in _COLUMN and dims.get(owner + ".weight") == 0:
            dims[name] = 0
    return dims


def tp_axis(module: nn.Module) -> Optional[str]:
    """The axis a module was cut over by :func:`shard_module`, else None."""
    return getattr(module, "tp_axis", None)


def tp_dims(module: nn.Module) -> Dict[str, int]:
    """{parameter name: split torch dimension} of a module cut by :func:`shard_module` (else empty)."""
    return dict(getattr(module, "tp_dims", {}))


def shard_module(module: nn.Module, mesh: MeshContext, axis: str = "model") -> Dict[str, int]:
    """Cut ``module``'s parameters to this rank's blocks along ``axis``, in place, and switch its layers to
    the tensor-parallel forward; returns :func:`module_tp_dims`. A no-op on an axis of one rank.

    Build any optimizer state after this: the cut parameters are new ``nn.Parameter`` objects.
    """
    n = mesh.axis_size(axis)
    if n == 1:
        return {}
    if tp_axis(module) is not None:
        raise ValueError(f"module is already sharded over {tp_axis(module)!r}")
    from pgica_tpu_torch.models.layers import MLP, Embedding, MultiHeadAttention
    from pgica_tpu_torch.models.vit import PatchEmbed

    dims = module_tp_dims(module, mesh, axis)
    index = mesh.axis_index(axis)
    with torch.no_grad():
        for name, dim in dims.items():
            owner_name, leaf = name.rsplit(".", 1)
            owner = module.get_submodule(owner_name)
            old = getattr(owner, leaf)
            local = _block(old.detach(), dim, index, n)
            setattr(owner, leaf, nn.Parameter(local, requires_grad=old.requires_grad))
    for prefix, m in module.named_modules():
        if isinstance(m, MultiHeadAttention) and f"{prefix}.q_proj.weight" in dims:
            m.tp_axis, m.kv_sharded = axis, f"{prefix}.k_proj.weight" in dims
        elif isinstance(m, MLP) and (f"{prefix}.fc_in.weight" in dims or f"{prefix}.gate_proj.weight" in dims):
            m.tp_axis = axis
        elif isinstance(m, (Embedding, PatchEmbed)) and f"{prefix}.weight" in dims:
            m.tp_axis = axis
    module.tp_axis, module.tp_dims, module.tp_size = axis, dims, n
    logger.info("Tensor parallel over %s (%d ranks, this rank %d): %d parameters cut", axis, n, index, len(dims))
    return dims


def module_fsdp_leaves(module: nn.Module, mesh, scanned: bool = False) -> Dict[str, fsdp.Leaf]:
    """{parameter name: how it is cut over ``fsdp``} under the rules, for ``module`` whole or already cut over
    ``model`` (the specs come from the whole leaves' shapes). ``scanned``: the LMs' blocks are the JAX
    package's ``scan_layers`` stacks, whose leaves' layer dimension takes ``fsdp`` where it divides the layer
    count (each rank then owns whole layers); else, and for the ViT, ``fsdp`` is on an inner dimension."""
    if _axis_size(mesh, "fsdp") == 1:
        return {}
    dims, tp = tp_dims(module), getattr(module, "tp_size", 1)
    blocks = {f"{prefix}.blocks.{j}.": (j, len(lm.blocks)) for prefix, lm in _lms(module)
              for j in range(len(lm.blocks))} if scanned else {}
    cut: Dict[str, fsdp.Leaf] = {}
    for name, p in module.named_parameters():
        shape = list(p.shape)
        if name in dims:
            shape[dims[name]] *= tp
        path, jshape = jax_leaf(module, name, shape)
        layer = next((v for k, v in blocks.items() if name.startswith(k)), None)
        if layer is None:
            spec = infer_param_spec(path, jshape, mesh)
        else:  # the stacked leaf's spec, layer dimension first
            j, n_layers = layer
            spec = infer_param_spec(re.sub(r"/block_\d+/", "/blocks/", path, count=1), (n_layers,) + jshape, mesh)
            if spec[0] == "fsdp":
                cut[name] = fsdp.Leaf(None, j // (n_layers // _axis_size(mesh, "fsdp")), tuple(p.shape))
                continue
            spec = spec[1:]
        jax_dim = split_dim(spec, "fsdp")
        if jax_dim is not None:
            cut[name] = fsdp.Leaf(torch_dim(path, jax_dim), None, tuple(p.shape))
    return cut


def shard_fsdp(module: nn.Module, mesh: MeshContext, scanned: bool = False) -> Dict[str, fsdp.Leaf]:
    """Cut ``module``'s parameters to this rank's blocks over ``fsdp``, in place (after :func:`shard_module`,
    if the module is cut over ``model``), and set up their gathers (parallel/fsdp.py); returns
    :func:`module_fsdp_leaves`. A no-op on an axis of one rank. Build any optimizer state after this."""
    cut = module_fsdp_leaves(module, mesh, scanned)
    if not cut:
        return {}
    if fsdp.leaves(module):
        raise ValueError("module is already sharded over fsdp")
    n, index = mesh.axis_size("fsdp"), mesh.axis_index("fsdp")
    params = dict(module.named_parameters())
    for name, leaf in cut.items():
        owner_name, leaf_name = name.rsplit(".", 1)
        old = params[name]
        setattr(module.get_submodule(owner_name), leaf_name,
                nn.Parameter(fsdp.local(old, leaf, index, n), requires_grad=old.requires_grad))
    fsdp.install(module, cut)
    logger.info("Fully sharded over fsdp (%d ranks, this rank %d): %d parameters cut (%d of them whole layers)",
                n, index, len(cut), sum(leaf.dim is None for leaf in cut.values()))
    return cut


def param_axes(module: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """{parameter name: the mesh axes its blocks are cut over} (``fsdp``, the tensor-parallel axis or both)."""
    axes: Dict[str, Tuple[str, ...]] = {name: ("fsdp",) for name in fsdp.leaves(module)}
    for name in tp_dims(module):
        axes[name] = axes.get(name, ()) + (tp_axis(module),)
    return axes


def is_sharded(module: nn.Module) -> bool:
    """Whether ``module`` holds blocks of its parameters (cut over ``model`` or ``fsdp``)."""
    return bool(tp_dims(module) or fsdp.leaves(module))


def gathered_state_dict(module: nn.Module, mesh: MeshContext, tensors: Optional[Mapping[str, torch.Tensor]] = None,
                        ) -> Dict[str, torch.Tensor]:
    """Whole tensors by name from every rank's blocks (every rank calls it): the module's parameters, or
    ``tensors`` laid out like them (by parameter name; the Adam moments), gathered over ``fsdp`` and then
    ``model``. Unsharded entries as they are."""
    dims, axis, cut = tp_dims(module), tp_axis(module), fsdp.leaves(module)
    if tensors is None:
        tensors = module.state_dict()
    out = {}
    for name, t in tensors.items():
        t = t.detach()
        if name in cut:
            t = fsdp.gather(t, cut[name], mesh)
        if name in dims:
            t = collectives.gather_from(t, axis, dims[name], mesh)
        out[name] = t
    return out


def local_state(module: nn.Module, mesh: Optional[MeshContext], state: Mapping[str, torch.Tensor],
                ) -> Dict[str, torch.Tensor]:
    """This rank's blocks of a whole state dict (a sharded checkpoint's, or one process's) for a module cut by
    :func:`shard_module` and :func:`shard_fsdp`; as it is for an unsharded module."""
    dims, axis, cut = tp_dims(module), tp_axis(module), fsdp.leaves(module)
    if not dims and not cut:
        return dict(state)
    out = {}
    for k, v in state.items():
        if k in dims:
            v = _block(v, dims[k], mesh.axis_index(axis), mesh.axis_size(axis))
        if k in cut:
            v = fsdp.local(v, cut[k], mesh.axis_index("fsdp"), mesh.axis_size("fsdp"))
        out[k] = v
    return out


def sharded_bytes(module: nn.Module) -> Tuple[int, int]:
    """(this rank's bytes, the whole model's bytes) of the parameters cut over ``model`` or ``fsdp``."""
    params = dict(module.named_parameters())
    dims, cut = tp_dims(module), fsdp.leaves(module)
    local = whole = 0
    for name in set(dims) | set(cut):
        if name in params:
            p = params[name]
            size = math.prod(cut[name].shape) if name in cut else p.numel()
            local += p.numel() * p.element_size()
            whole += size * (module.tp_size if name in dims else 1) * p.element_size()
    return local, whole
