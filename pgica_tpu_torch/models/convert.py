"""Weight bridge: the JAX package's parameter tree -> the port's modules.

``load_jax_params(module, params)`` takes the JAX tree as nested dicts of
numpy arrays, as ``jax.tree.map(np.asarray, model.params)`` gives it (the
port never imports JAX, so it takes numpy only), and copies every leaf under
``vision_encoder/...`` and ``caption_decoder/...`` into the port's module:

* Dense ``kernel`` (in, out) -> ``nn.Linear`` weight (out, in).
* ``q_proj``/``k_proj``/``v_proj`` kernel (hidden, H, D) -> weight (H*D, hidden),
  bias (H, D) -> (H*D,).
* ``out_proj`` kernel (H, D, hidden) -> weight (hidden, H*D).
* ``patch_embed/kernel`` (P, P, 3, width), HWIO -> weight (width, P*P*3) in
  (h, w, c) order, matching the port's patchify (models/vit.py).
* LayerNorm and RMSNorm ``scale`` (and LayerNorm ``bias``) -> ``weight``
  (``bias``); ``embedding`` -> ``weight``; ``cls_token`` and ``pos_embed`` as
  they are.
* ``block_i`` -> ``blocks.i``, ``LayerNorm_0/1`` and ``RMSNorm_0/1`` ->
  ``ln_0/1``, ``vision_projection/layers_0`` -> ``vision_projection``.
* Llama blocks: q/k/v/o without biases, k and v of ``num_kv_heads * D``
  columns, and the SwiGLU ``gate_proj``/``up_proj``/``down_proj`` kernels.

Every subtree is filled: ``vision_encoder``, ``text_encoder`` and
``caption_decoder``, and ``shared_lm`` for a model built with
``share_text_tower``. A tree of a JAX model built with ``scan_layers`` holds
each LM's blocks stacked under ``blocks`` (one leading layer axis); it is
split into ``block_i`` first (:func:`unstack_scan_params`). An unknown key, a
parameter left unfilled, or a shape mismatch raises before any parameter is
written. A JAX LoRA factor dict needs no conversion: the port keys its
factors by the same paths, in the same layout (models/lora.py;
``PreferenceGuidedCaptioningModel.load_jax_params(params, lora=...)``).

Offline import of Hugging Face checkpoints (the port's copy of the JAX
package's converters, pgica_tpu/models/convert.py:67-316): each converter
turns an HF state dict into the JAX package's numpy tree for one tower,
which :func:`load_jax_params` then loads into that tower's module.

* :func:`convert_gpt2` — ``GPT2Model``/``GPT2LMHeadModel`` (Conv1D weights
  stored (in, out); the fused ``c_attn`` split into q/k/v).
* :func:`convert_clip_vision` — ``CLIPVisionModel`` (the torch OIHW patch
  conv to HWIO; HF's ``pre_layrnorm`` spelling).
* :func:`convert_llama` — ``LlamaModel`` (q/k rows permuted from HF's
  split-half RoPE layout to the interleaved pairs the port rotates).
* :func:`convert_linear`, :func:`convert_projection_head`,
  :func:`convert_mha` — ``nn.Linear``, the reference's projection head and
  a packed ``nn.MultiheadAttention``.
* :func:`pad_vocab_rows` — HF's 50,257 GPT-2 rows padded to the module's
  vocab with the module's own rows (the tokenizer's appended specials).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def unstack_scan_params(backbone: Mapping) -> Dict:
    """The stacked ``blocks`` of a ``scan_layers`` LM tree -> ``block_0..block_{L-1}`` (JAX convert.py:53-64)."""
    if "blocks" not in backbone:
        raise ValueError("no stacked 'blocks' entry to unstack")
    out = {k: v for k, v in backbone.items() if k != "blocks"}
    leaves = list(_flatten(backbone["blocks"]))
    for i in range(leaves[0][1].shape[0]):
        block: Dict = {}
        for path, x in leaves:
            node = block
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = x[i]
        out[f"block_{i}"] = block
    return out


def _unrolled(tree: Mapping) -> Dict:
    """``tree`` with every LM's stacked ``blocks`` split into ``block_i`` (the JAX tree's unrolled layout)."""
    if "blocks" in tree and isinstance(tree["blocks"], Mapping):
        tree = unstack_scan_params(tree)
    return {k: _unrolled(v) if isinstance(v, Mapping) else v for k, v in tree.items()}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _port_name(path: Tuple[str, ...]) -> str:
    parts = []
    for p in path[:-1]:
        m = re.fullmatch(r"block_(\d+)", p)
        if m:
            parts += ["blocks", m.group(1)]
        elif re.fullmatch(r"(LayerNorm|RMSNorm)_(\d+)", p):
            parts.append("ln_" + p.rsplit("_", 1)[1])
        elif p != "layers_0":  # nn.Sequential([Dense, tanh]) -> the Linear itself
            parts.append(p)
    leaf = {"scale": "weight", "kernel": "weight", "embedding": "weight"}.get(path[-1], path[-1])
    return ".".join(parts + [leaf])


def _port_value(path: Tuple[str, ...], x: np.ndarray) -> np.ndarray:
    owner, leaf = (path[-2] if len(path) > 1 else ""), path[-1]
    if leaf == "kernel":
        if x.ndim == 4:  # patch conv (P, P, C, width)
            return x.reshape(-1, x.shape[-1]).T
        if x.ndim == 3 and owner == "out_proj":  # (H, D, hidden)
            return x.reshape(-1, x.shape[-1]).T
        if x.ndim == 3:  # q/k/v (hidden, H, D)
            return x.reshape(x.shape[0], -1).T
        return x.T
    if leaf == "bias" and x.ndim == 2:  # q/k/v (H, D)
        return x.reshape(-1)
    return x


Plan = List[Tuple[nn.Parameter, np.ndarray]]


def plan_jax_params(module: nn.Module, params: Mapping, name: str = "") -> Plan:
    """Check the JAX tree ``params`` against ``module`` and pair each parameter with its value in the
    port's layout, writing nothing. Raises on an unknown key, a parameter left unfilled, or a shape
    mismatch (``name`` prefixes the message): the JAX package's ``assert_tree_shapes`` for a
    converted HF tower, and the bridge's own check."""
    prefix = f"{name}: " if name else ""
    targets: Dict[str, nn.Parameter] = dict(module.named_parameters())
    plan: Plan = []
    filled = set()
    for path, value in _flatten(_unrolled(params)):
        port = _port_name(path)
        if port not in targets:
            raise KeyError(f"{prefix}JAX parameter {'/'.join(path)} has no counterpart ({port}) in the port")
        value = _port_value(path, value)
        if tuple(value.shape) != tuple(targets[port].shape):
            raise ValueError(
                f"{prefix}shape mismatch for {'/'.join(path)}: JAX {tuple(value.shape)} -> "
                f"port {port} {tuple(targets[port].shape)}"
            )
        plan.append((targets[port], value))
        filled.add(port)
    missing = sorted(set(targets) - filled)
    if missing:
        raise KeyError(f"{prefix}port parameters missing from the JAX tree: {missing}")
    return plan


@torch.no_grad()
def write_plan(plan: Plan) -> None:
    """Copy each planned value into its parameter, in place (each master's version moves)."""
    for target, value in plan:
        target.copy_(torch.from_numpy(np.array(value)))  # np.array: a writable copy


def load_jax_params(module: nn.Module, params: Mapping) -> None:
    """Fill ``module``'s parameters in place from the JAX tree ``params`` (unrolled or scanned)."""
    write_plan(plan_jax_params(module, params))


# ------------------------------------------------------------------ HF checkpoints


def pad_vocab_rows(converted: Dict, lm: nn.Module, name: str = "lm") -> Dict:
    """Pad the converted ``wte`` rows up to ``lm``'s vocab with ``lm``'s own rows (JAX convert.py:67-93).

    HF GPT-2 artifacts carry 50,257 embedding rows; the module's tokenizer
    appends the special tokens, so its vocab is a few ids larger. The
    appended rows keep the module's values (the reference resizes its
    embeddings the same way). A checkpoint with more rows than the module raises.
    """
    wte = converted.get("wte", {}).get("embedding")
    if wte is None:
        return converted
    target = lm.wte.weight
    have, want = wte.shape[0], target.shape[0]
    if have > want:
        raise ValueError(f"{name}: converted vocab {have} exceeds module vocab {want}; "
                         "rebuild the module with the checkpoint's tokenizer")
    if have < want:
        rows = target[have:].detach().to("cpu", torch.float32).numpy()
        converted = {**converted, "wte": {"embedding": np.concatenate([np.asarray(wte), rows], axis=0)}}
    return converted


def _np(tensor) -> np.ndarray:
    try:
        return tensor.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(tensor)


def _ln(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


def convert_gpt2(state_dict: Mapping, config) -> Dict:
    """GPT-2 (Conv1D layout) -> the JAX TransformerLM tree; ``config`` an ``LMConfig``."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    h, n_head = config.hidden_size, config.num_heads
    d = h // n_head
    params: Dict = {
        "wte": {"embedding": _np(sd["wte.weight"])},
        "wpe": {"embedding": _np(sd["wpe.weight"])},
        "ln_f": _ln(sd, "ln_f"),
    }
    for i in range(config.num_layers):
        p = f"h.{i}"
        # Conv1D stores (in, out): c_attn (h, 3h) -> q/k/v (h, h)
        qw, kw, vw = np.split(_np(sd[f"{p}.attn.c_attn.weight"]), 3, axis=1)
        qb, kb, vb = np.split(_np(sd[f"{p}.attn.c_attn.bias"]), 3, axis=0)
        params[f"block_{i}"] = {
            "LayerNorm_0": _ln(sd, f"{p}.ln_1"),
            "LayerNorm_1": _ln(sd, f"{p}.ln_2"),
            "attn": {
                "q_proj": {"kernel": qw.reshape(h, n_head, d), "bias": qb.reshape(n_head, d)},
                "k_proj": {"kernel": kw.reshape(h, n_head, d), "bias": kb.reshape(n_head, d)},
                "v_proj": {"kernel": vw.reshape(h, n_head, d), "bias": vb.reshape(n_head, d)},
                "out_proj": {"kernel": _np(sd[f"{p}.attn.c_proj.weight"]).reshape(n_head, d, h),
                             "bias": _np(sd[f"{p}.attn.c_proj.bias"])},
            },
            "mlp": {
                "fc_in": {"kernel": _np(sd[f"{p}.mlp.c_fc.weight"]), "bias": _np(sd[f"{p}.mlp.c_fc.bias"])},
                "fc_out": {"kernel": _np(sd[f"{p}.mlp.c_proj.weight"]), "bias": _np(sd[f"{p}.mlp.c_proj.bias"])},
            },
        }
    return params


def convert_clip_vision(state_dict: Mapping, config) -> Dict:
    """CLIPVisionModel -> the JAX VisionTransformer tree; ``config`` a ``ViTConfig``."""
    sd = {k.removeprefix("vision_model."): v for k, v in state_dict.items()}
    h, n_head = config.hidden_size, config.num_heads
    d = h // n_head

    def linear(prefix: str, heads: str = ""):
        w = _np(sd[f"{prefix}.weight"]).T  # torch Linear (out, in) -> (in, out)
        b = _np(sd[f"{prefix}.bias"])
        if heads == "qkv":  # (h, h) -> (h, heads, d)
            return {"kernel": w.reshape(h, n_head, d), "bias": b.reshape(n_head, d)}
        if heads == "out":  # heads on the input side -> (heads, d, h)
            return {"kernel": w.reshape(n_head, d, h), "bias": b}
        return {"kernel": w, "bias": b}

    params: Dict = {
        "cls_token": _np(sd["embeddings.class_embedding"]).reshape(1, 1, h),
        "pos_embed": _np(sd["embeddings.position_embedding.weight"])[None],
        "patch_embed": {"kernel": _np(sd["embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)},  # OIHW -> HWIO
        "pre_ln": _ln(sd, "pre_layrnorm"),  # (sic) HF's attribute name
        "post_ln": _ln(sd, "post_layernorm"),
    }
    for i in range(config.num_layers):
        p = f"encoder.layers.{i}"
        params[f"block_{i}"] = {
            "LayerNorm_0": _ln(sd, f"{p}.layer_norm1"),
            "LayerNorm_1": _ln(sd, f"{p}.layer_norm2"),
            "attn": {
                "q_proj": linear(f"{p}.self_attn.q_proj", "qkv"),
                "k_proj": linear(f"{p}.self_attn.k_proj", "qkv"),
                "v_proj": linear(f"{p}.self_attn.v_proj", "qkv"),
                "out_proj": linear(f"{p}.self_attn.out_proj", "out"),
            },
            "mlp": {"fc_in": linear(f"{p}.mlp.fc1"), "fc_out": linear(f"{p}.mlp.fc2")},
        }
    return params


def convert_linear(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    """torch ``nn.Linear`` -> a Dense tree: the (out, in) weight transposed."""
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T}
    bias = sd.get(f"{prefix}.bias")
    if bias is not None:
        out["bias"] = _np(bias)
    return out


def convert_projection_head(sd: Mapping, prefix: str = "") -> Dict:
    """The reference's projection head (``nn.Sequential`` Linear(0)-ReLU-Dropout-Linear(3)-LayerNorm(4))
    -> the ``fc1``/``fc2``/``ln`` tree."""
    p = f"{prefix}." if prefix else ""
    return {"fc1": convert_linear(sd, f"{p}0"), "fc2": convert_linear(sd, f"{p}3"), "ln": _ln(sd, f"{p}4")}


def convert_mha(sd: Mapping, prefix: str, num_heads: int) -> Dict:
    """torch ``nn.MultiheadAttention`` (q/k/v packed in ``in_proj``, head-major) -> the attention tree
    (the decoder's cross-attention, reference model.py:528-533)."""
    p = f"{prefix}." if prefix else ""
    w = _np(sd[f"{p}in_proj_weight"])  # (3h, h)
    b = _np(sd[f"{p}in_proj_bias"])
    h = w.shape[1]
    d = h // num_heads
    qw, kw, vw = np.split(w, 3, axis=0)
    qb, kb, vb = np.split(b, 3, axis=0)

    def proj(wi, bi):
        return {"kernel": wi.T.reshape(h, num_heads, d), "bias": bi.reshape(num_heads, d)}

    return {
        "q_proj": proj(qw, qb),
        "k_proj": proj(kw, kb),
        "v_proj": proj(vw, vb),
        "out_proj": {"kernel": _np(sd[f"{p}out_proj.weight"]).T.reshape(num_heads, d, h),
                     "bias": _np(sd[f"{p}out_proj.bias"])},
    }


def _rope_permute(w: np.ndarray, n_head: int, d: int) -> np.ndarray:
    """HF's split-half RoPE rows -> interleaved pairs: each head's rows reordered [0, d/2, 1, d/2+1, ...]."""
    w = w.reshape(n_head, d, -1)
    perm = np.empty((d,), np.int64)
    perm[0::2] = np.arange(d // 2)
    perm[1::2] = np.arange(d // 2) + d // 2
    return w[:, perm, :].reshape(n_head * d, -1)


def convert_llama(state_dict: Mapping, config) -> Dict:
    """Llama (RoPE, RMSNorm, SwiGLU, GQA) -> the JAX TransformerLM (arch 'llama') tree."""
    sd = {k.removeprefix("model."): v for k, v in state_dict.items()}
    h = config.hidden_size
    n_head, n_kv = config.num_heads, config.kv_heads
    d = config.head_dim
    params: Dict = {
        "wte": {"embedding": _np(sd["embed_tokens.weight"])},
        "ln_f": {"scale": _np(sd["norm.weight"])},
    }
    for i in range(config.num_layers):
        p = f"layers.{i}"

        def proj(name: str, heads: int, rope: bool):
            w = _np(sd[f"{p}.self_attn.{name}.weight"])  # (heads * d, h)
            if rope:
                w = _rope_permute(w, heads, d)
            return {"kernel": w.T.reshape(h, heads, d)}

        params[f"block_{i}"] = {
            "RMSNorm_0": {"scale": _np(sd[f"{p}.input_layernorm.weight"])},
            "RMSNorm_1": {"scale": _np(sd[f"{p}.post_attention_layernorm.weight"])},
            "attn": {
                "q_proj": proj("q_proj", n_head, rope=True),
                "k_proj": proj("k_proj", n_kv, rope=True),
                "v_proj": proj("v_proj", n_kv, rope=False),
                "out_proj": {"kernel": _np(sd[f"{p}.self_attn.o_proj.weight"]).T.reshape(n_head, d, h)},
            },
            "mlp": {
                "gate_proj": {"kernel": _np(sd[f"{p}.mlp.gate_proj.weight"]).T},
                "up_proj": {"kernel": _np(sd[f"{p}.mlp.up_proj.weight"]).T},
                "down_proj": {"kernel": _np(sd[f"{p}.mlp.down_proj.weight"]).T},
            },
        }
    return params


def read_state_dict(path) -> Dict[str, torch.Tensor]:
    """An HF checkpoint directory's weights: ``pytorch_model.bin`` (``torch.load``, tensors only) or
    ``model.safetensors`` (the ``safetensors`` package, imported only then)."""
    directory = Path(path)
    if (directory / "pytorch_model.bin").exists():
        return torch.load(directory / "pytorch_model.bin", map_location="cpu", weights_only=True)
    if (directory / "model.safetensors").exists():
        from safetensors.torch import load_file

        return load_file(str(directory / "model.safetensors"))
    raise FileNotFoundError(f"No torch checkpoint (pytorch_model.bin or model.safetensors) in {path}")
