"""FSDP at rest: the gathers of parameters cut over ``fsdp`` (the JAX package's GSPMD parameter shardings,
pgica_tpu/training/trainer.py:256-261, with pgica_tpu/parallel/sharding.py's rules).

The JAX trainer puts every parameter on the mesh under the rule table's spec, and GSPMD gathers a cut weight
where a computation reads it and reduce-scatters its gradient. The port keeps, of each parameter whose spec
splits a dimension over ``fsdp``, this rank's block (parallel/sharding.py:shard_fsdp, after the ``model`` cut:
the Adam moments, made from the parameters, follow) and makes the gathers explicit:

* a transformer block (the LMs' and the ViT's) gathers its cut weights at its entry and drops them after it
  (``TransformerLM.sharded``, ``VisionTransformer.sharded``: :class:`BlockGather`); under activation
  checkpointing the gather sits inside the checkpointed function, so the backward pass gathers again and a
  rank holds its shards plus one block;
* a cut leaf outside the blocks (the embeddings, the projection heads, the decoder's cross-attention) is
  gathered for the forward of the module that owns it (a forward pre-hook; the hook after the forward puts
  the shard back), and by :func:`full` where it is read outside that forward (the tied head, the fused CE's
  embedding).

A gather is differentiable: its backward sums the gradient over ``fsdp`` and leaves this rank its block, so a
cut leaf's gradient comes out of the backward pass summed over the axis (the train steps then average it over
the other batch axes). A leaf is cut one of two ways (:class:`Leaf`):

* a dimension (``dim``): each rank holds 1/f of it; the gather is ``all_gather`` (backward: reduce-scatter);
* whole layers (``owner``): under ``model.scan_layers`` the rules put ``fsdp`` on a stacked LM leaf's layer
  dimension where the axis divides the layer count (JAX's whole-layer ownership); the rank of fsdp index
  ``owner`` holds the layer whole, the others an empty tensor; the gather is a broadcast from the owner
  (backward: the sum, which the owner keeps).

The gathers read the bound mesh (``with mesh:``), as the tensor-parallel layers do, so a copy of a cut module
(the stage-2 reference, ``models/model.py:frozen_copy``) gathers its own shards.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from pgica_tpu_torch.parallel import collectives

AXIS = "fsdp"


class Leaf(NamedTuple):
    """How one parameter is held over ``fsdp``."""

    dim: Optional[int]  # the torch dimension cut over the axis; None: whole layers
    owner: Optional[int]  # with ``dim`` None, the fsdp index that holds the layer
    shape: Tuple[int, ...]  # the parameter's shape before the cut (after the ``model`` cut)


def gather(x: torch.Tensor, leaf: Leaf, mesh=None) -> torch.Tensor:
    """The whole (model-local) tensor from this rank's ``x``; differentiable (see the module docstring)."""
    if leaf.dim is None:
        return collectives.broadcast(x, AXIS, leaf.owner, leaf.shape, mesh)
    return collectives.all_gather(x.movedim(leaf.dim, 0), AXIS, mesh).movedim(0, leaf.dim).contiguous()


def local(x: torch.Tensor, leaf: Leaf, index: int, n: int) -> torch.Tensor:
    """The block of a whole tensor that the rank of fsdp ``index`` holds (a copy)."""
    if leaf.dim is None:
        return x.detach().clone() if index == leaf.owner else x.new_empty(0)
    size = x.shape[leaf.dim] // n
    return x.detach().narrow(leaf.dim, index * size, size).clone()


def leaves(module: nn.Module) -> Dict[str, Leaf]:
    """{parameter name: :class:`Leaf`} of a module cut by ``shard_fsdp`` (else empty)."""
    return dict(getattr(module, "fsdp_leaves", {}))


def _slot(module: nn.Module, name: str) -> Tuple[nn.Module, str]:
    owner, _, leaf = name.rpartition(".")
    return (module.get_submodule(owner) if owner else module), leaf


def _gather_own(module: nn.Module, args) -> None:
    """Forward pre-hook of a module using cut leaves outside the blocks: the gathered tensors in their place."""
    held = module._fsdp_held = []
    for name, leaf in module._fsdp_own.items():
        owner, key = _slot(module, name)
        held.append((owner, key, owner._parameters[key]))
        owner._parameters[key] = gather(owner._parameters[key], leaf)


def _restore_own(module: nn.Module, args, output) -> None:
    for owner, key, param in module._fsdp_held:
        owner._parameters[key] = param
    module._fsdp_held = []


def _user(module: nn.Module, owner_name: str) -> str:
    """The module whose forward uses a cut leaf of ``owner_name``: the attention or MLP around a projection
    (its tensor-parallel branches read their projections' weights directly), else the owner."""
    parent = owner_name.rpartition(".")[0]
    if parent and type(module.get_submodule(parent)).__name__ in ("MultiHeadAttention", "MLP"):
        return parent
    return owner_name


def full(owner: nn.Module, name: str) -> torch.Tensor:
    """``owner``'s parameter ``name`` whole: gathered (differentiably) where it is cut, outside its forward."""
    t = owner._parameters[name]
    leaf = getattr(owner, "_fsdp_own", {}).get(name)
    return t if leaf is None or not isinstance(t, nn.Parameter) else gather(t, leaf)


class BlockGather:
    """A tower's hook (``sharded``): block ``j`` runs on its cut weights gathered at its entry, dropped after it.

    ``cuts[j]`` maps the block's parameter names (within the block) to their :class:`Leaf`. It holds no tensor
    and no process group, so it survives a deep copy of the module.
    """

    def __init__(self, cuts: List[Dict[str, Leaf]]):
        self.cuts = cuts

    def block(self, tower: nn.Module, j: int) -> Callable:
        block, cuts = tower.blocks[j], self.cuts[j]

        def run(*args, **kwargs):
            weights = {k: gather(block.get_parameter(k), leaf) for k, leaf in cuts.items()}
            return torch.func.functional_call(block, weights, args, kwargs)

        return run


def _towers(module: nn.Module) -> List[Tuple[str, nn.Module]]:
    """The module's block stacks (its LMs and ViT backbones), each once, with their names."""
    seen, out = set(), []
    for name, child in module.named_modules():
        if type(child).__name__ in ("TransformerLM", "VisionTransformer") and id(child) not in seen:
            seen.add(id(child))
            out.append((name, child))
    return out


def install(module: nn.Module, cut: Dict[str, Leaf]) -> None:
    """Record ``cut`` on ``module`` and set up its gathers: each tower's :class:`BlockGather`, and the hooks of
    the modules owning cut leaves outside the blocks."""
    module.fsdp_leaves = dict(cut)
    towers = _towers(module)
    for prefix, tower in towers:
        blocks = [{k[len(f"{prefix}.blocks.{j}."):]: leaf for k, leaf in cut.items()
                   if k.startswith(f"{prefix}.blocks.{j}.")} for j in range(len(tower.blocks))]
        if any(blocks):
            tower.sharded = BlockGather(blocks)
    in_blocks = tuple(f"{prefix}.blocks." for prefix, _ in towers)
    users: Dict[str, Dict[str, Leaf]] = {}
    for name, leaf in cut.items():
        if not name.startswith(in_blocks):
            user = _user(module, name.rsplit(".", 1)[0])
            users.setdefault(user, {})[name[len(user) + 1:]] = leaf
    for user_name, own in users.items():
        user = module.get_submodule(user_name)
        user._fsdp_own = own
        user.register_forward_pre_hook(_gather_own)
        user.register_forward_hook(_restore_own)


@torch.no_grad()
def uninstall(module: nn.Module, mesh) -> None:
    """Gather every cut parameter back into the module (every rank calls it) and drop the gathers: the module
    is as before ``shard_fsdp`` (still cut over ``model``, if it was)."""
    cut = leaves(module)
    if not cut:
        return
    with mesh:
        for name, param in list(module.named_parameters()):
            if name in cut:
                owner_name, leaf_name = name.rsplit(".", 1)
                whole = gather(param.detach(), cut[name])
                setattr(module.get_submodule(owner_name), leaf_name,
                        nn.Parameter(whole, requires_grad=param.requires_grad))
    for _, tower in _towers(module):
        tower.sharded = None
    for m in module.modules():
        if m.__dict__.pop("_fsdp_own", None) is not None:
            for hooks, fn in ((m._forward_pre_hooks, _gather_own), (m._forward_hooks, _restore_own)):
                for key in [k for k, h in hooks.items() if h is fn]:
                    del hooks[key]
    del module.fsdp_leaves
