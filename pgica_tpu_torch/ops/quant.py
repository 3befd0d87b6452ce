"""Int8 weight quantization for the decode path (port of pgica_tpu/ops/quant.py:41-182).

Two modes (``inference.quantization`` in the config, ``--quant`` on the
serve CLI):

* ``int8`` — W8A8: symmetric per-output-channel int8 weights and per-row
  (per-token) dynamic activation quantization; the product is summed in
  int32, exactly, and rescaled in float32.
* ``int8_weight_only`` — W8: the int8 weight is dequantized to the compute
  dtype inside the matmul; activations stay as they are.

Training is never quantized: :func:`quantize_like` fills an inference-only
twin of the model from the float32 masters (models/model.py).

Weights keep the port's ``nn.Linear`` layout, (out, in): the JAX kernel's
(contracting dims..., feature dims...) becomes (feature, contracting), so
one scale per row of the weight. For the attention ``out_proj``, whose JAX
kernel (H, D, hidden) contracts over heads x head_dim, the port's
(hidden, H*D) weight takes its amax over the flattened H*D: the same scales.

:func:`q8_matmul` launches ``csrc/q8_matmul.cu`` on a CUDA tensor (or
raises) and runs :func:`q8_matmul_ref` on a CPU tensor. The plain version
sums the int8 products in float64, which holds every such sum exactly
(|sum| <= 127**2 * K < 2**53), so it equals the kernel's int32 sums on both
devices.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import nn

from pgica_tpu_torch.ops import _kernels
from pgica_tpu_torch.ops.layernorm import LayerNorm
from pgica_tpu_torch.ops.rmsnorm import RMSNorm

INT8_MODES = ("int8", "int8_weight_only")


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 by IEEE division. A tensor divisor: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which differs from the quotient in the last bit for some values."""
    return torch.clamp_min(amax, 1e-12) / torch.full_like(amax, 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an (out, in) weight: (int8 q, float32 scale (out,)), w ~= q * scale.

    scale = max(amax over ``in``, 1e-12) / 127; q = round(w / scale) (half to
    even) clipped to +-127, as the JAX ``quantize_weight``.
    """
    w = w.to(torch.float32)
    scale = _div127(w.abs().amax(dim=1))
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of activations (rows, K): (int8 (rows, K), float32 (rows,)), JAX ``_quantize_rows``."""
    xf = x.to(torch.float32)
    sx = _div127(xf.abs().amax(dim=1))
    xq = torch.clamp(torch.round(xf / sx[:, None]), -127, 127).to(torch.int8)
    return xq, sx


def int8_products(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (M, K) @ wq (N, K).T summed exactly: int32 (M, N)."""
    return (xq.to(torch.float64) @ wq.to(torch.float64).T).to(torch.int32)


def q8_matmul_ref(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  weight_only: bool = False) -> torch.Tensor:
    """Plain version: (M, K) x int8 (N, K) -> (M, N) in x's dtype, then + bias rounded to that dtype."""
    dtype = x.dtype
    if weight_only:
        w = wq.to(dtype) * scale.to(dtype)[:, None]
        y = (x @ w.T).to(dtype)
    else:
        xq, sx = quantize_rows(x)
        y = ((int8_products(xq, wq).to(torch.float32) * sx[:, None]) * scale[None, :]).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def _check(name: str, x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    if x.dtype not in _kernels.DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous (M, K) tensor, got {tuple(x.shape)}")
    n, k = wq.shape
    if wq.dtype != torch.int8 or k != x.shape[1] or not wq.is_contiguous() or wq.device != x.device:
        raise ValueError(f"{name}: the weight must be contiguous int8 (N, {x.shape[1]}) on {x.device}")
    for what, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError(f"{name}: {what} must be contiguous float32 ({n},) on {x.device}")


def q8_matmul(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              weight_only: bool = False) -> torch.Tensor:
    """Kernel wrapper: what :func:`q8_matmul_ref` gives, through ``csrc/q8_matmul.cu`` on the card.

    One launch either way. W8A8 quantizes x's rows inside the product and
    writes their float32 scales to a (M,) buffer this wrapper allocates;
    weight-only reads x as it is. Both capture into a CUDA graph.
    """
    if x.device.type == "cpu":
        return q8_matmul_ref(x, wq, scale, bias, weight_only)
    if x.device.type != "cuda":
        raise ValueError(f"q8_matmul: unsupported device {x.device}")
    _check("q8_matmul", x, wq, scale, bias)
    m, k = x.shape
    n = wq.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out
    bias_ptr = None if bias is None else bias.data_ptr()
    code, stream = _kernels.DTYPE_CODES[x.dtype], _kernels.stream_handle(x)
    if weight_only:
        _kernels.launch("q8_matmul_w8", x.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias_ptr, out.data_ptr(),
                        m, n, k, code, stream)
        return out
    sx = torch.empty(m, dtype=torch.float32, device=x.device)
    _kernels.launch("q8_matmul_w8a8", x.data_ptr(), sx.data_ptr(), wq.data_ptr(), scale.data_ptr(), bias_ptr,
                    out.data_ptr(), m, n, k, code, stream)
    return out


PLAN_KEYS = ("rows", "cols", "split", "chunks_per_rank", "smem", "blocks", "clusters")


def q8_plan(m: int, n: int, k: int, dtype: torch.dtype, weight_only: bool) -> dict:
    """The tiling ``csrc/q8_matmul.cu`` launches at (M, K) x (N, K) (needs the built kernels): x rows a block
    holds, its output columns, the cluster's split of K, 128-wide k chunks a block takes, dynamic shared memory,
    blocks and the clusters the card holds at once."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    fn = _kernels.c_function("q8_matmul.cu", "pgica_q8_matmul_plan", (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
    rc = fn(m, n, k, _kernels.DTYPE_CODES[dtype], int(weight_only), ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"q8_plan: no tiling for ({m}, {k}) x ({n}, {k}) (error {rc})")
    return dict(zip(PLAN_KEYS, out))


class QuantDense(nn.Module):
    """Inference-only drop-in for :class:`~pgica_tpu_torch.models.layers.Dense` (JAX ``QuantDenseGeneral``).

    Buffers: ``weight_q`` int8 (out, in), ``scale`` float32 (out,) and, with
    a bias, ``bias`` float32 (out,); :func:`quantize_like` fills them from a
    trained Dense's float32 master. The output is in ``dtype``, the bias added
    after the product in that dtype.
    """

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, bias: bool = True,
                 weight_only: bool = False):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        self.weight_only = weight_only
        self.register_buffer("weight_q", torch.zeros((out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features, dtype=torch.float32))
        self.register_buffer("bias", torch.zeros(out_features, dtype=torch.float32) if bias else None)

    @torch.no_grad()
    def load_from(self, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
        """Quantize a float32 master (out, in) weight (and take its bias, float32) onto this module's device."""
        q, scale = quantize_weight(weight)
        self.weight_q = q.to(self.weight_q.device)
        self.scale = scale.to(self.weight_q.device)
        if self.bias is not None:
            self.bias = bias.detach().to(self.weight_q.device, torch.float32, copy=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        y = q8_matmul(x.reshape(-1, self.in_features).to(self.dtype).contiguous(), self.weight_q, self.scale,
                      self.bias, self.weight_only)
        return y.view(*lead, self.out_features)


@torch.no_grad()
def quantize_like(template: nn.Module, source: nn.Module, cast_rest: Optional[torch.dtype] = None) -> nn.Module:
    """Fill a quantized ``template`` (built with ``decoder_quant``) from the float32 masters of ``source``, in place.

    Every :class:`QuantDense` takes the int8 of the source Dense at its path,
    quantized from the float32 master (never from a rounded copy); every other
    parameter is copied from the source, floating ones rounded to
    ``cast_rest`` (LayerNorm and RMSNorm weights then kept float32 holding the
    rounded values, as ``frozen_copy`` keeps them for their kernels). Scales
    and biases of the quantized layers stay float32. Returns ``template``,
    frozen.
    """
    masters = dict(source.named_parameters())
    for name, p in template.named_parameters():
        if name not in masters or masters[name].shape != p.shape:
            raise ValueError(f"{name}: the source has no parameter of shape {tuple(p.shape)}")
        value = masters[name].detach()
        if cast_rest is not None and value.is_floating_point():
            value = value.to(cast_rest)
        p.copy_(value)
    for name, m in template.named_modules():
        if isinstance(m, QuantDense):
            weight = masters.get(f"{name}.weight")
            if weight is None or weight.shape != m.weight_q.shape:
                raise ValueError(f"{name}: the source has no Dense weight of shape {tuple(m.weight_q.shape)}")
            m.load_from(weight, masters.get(f"{name}.bias"))
    return template.requires_grad_(False)


def cast_for_twin(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast a twin's parameters to ``dtype`` before :func:`quantize_like`, norm weights kept float32.

    The quantized layers' buffers are set anew by ``quantize_like``, so their
    cast here does not matter.
    """
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (LayerNorm, RMSNorm)):
            m.float()
    return module
