#!/usr/bin/env python3
"""Drive the PyTorch port (pgica_tpu_torch) on one NVIDIA H100 and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints lines of its own; any failure raises and the script
exits non-zero):

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: the hand-written CUDA kernels from pgica_tpu_torch/csrc/ into the
   git-ignored build/pgica_tpu_torch/ (one nvcc per source, in parallel).
3. Kernels vs plain: each of the ten kernels against its plain PyTorch
   version on the card at the shapes the GPT-2 flagship's and the Llama
   slice's serving, stage-1 and stage-2 paths give it, bf16 and f32, with
   its time (CUDA events, median of 21 bursts, on input sets that rotate
   through more than twice the L2, so they come from HBM; the fused
   linear-CE kernels, tens to hundreds of ms a call over a W larger than the
   L2: median of 5 single calls), the plain version's, one PyTorch call's
   as a yardstick (never used by the port; for fused CE two calls, F.linear
   and F.cross_entropy) and the bound from the bytes and flops that the
   inputs need at HBM rate and peak rate (fused CE: the bf16 tensor-core peak,
   one pass per product, for every type pair), and the launches one
   LayerNorm call makes with the gaps between them. It first reports the
   tensor-core kernels' registers and spills (ptxas) and their HMMA/HGMMA,
   and times both flash forward kernels at Sq 1-64, where the dispatch
   threshold lies.
4. Full path vs plain, for each architecture at full width, 2 layers per
   tower, f32 — ViT-B/32 + GPT-2 Medium, then SigLIP so400m + Llama-3-8B
   (RoPE, GQA, SwiGLU, RMSNorm; vocab 128,256): the same seeded model on
   the card (kernels) and on the CPU (plain versions): embeddings, prefix
   and step logits, 16 greedy tokens; then two stage-1 and two stage-2
   (DPO) train steps (dropout 0): the gradients, loss, reward metrics,
   gradient norm and every trained parameter.
5. Serving: the flagship (ViT-B/32 + GPT-2 Medium, 24 layers, vocab 50,262)
   in bf16 with random seeded weights answers caption requests through
   ``generate_captions`` — batch 1, 8 and 32 with max_length 32 and
   early_stop (as the caption service calls it), then the batch 32 x 64
   fixed-length greedy decode of the eval benchmark (median of 5 after a
   warm-up).
6. Stage 1, the slice: the same flagship (bf16 over f32 masters, frozen
   ViT, dropout 0.1) takes stage-1 steps through ``make_stage1_train_step``
   at bench.py's shapes: batch 128 x seq 128 with every token kept, and
   caption lengths 8-28 cut to bucket 32 by ``bucket_batch``. Two warm-up
   steps, then the median of three 5-step windows; one profiled step.
7. Stage 2, the slice: the same flagship takes DPO steps through
   ``make_stage2_train_step`` against a frozen bf16 copy of itself (the
   trainer's reference), with bench.py's stage-2 optimizer, at batch 32
   pairs x 128 with every token kept, and with chosen and rejected lengths
   8-28 cut to bucket 32; the chosen and rejected captions differ. Timing
   and profile as in phase 6, and the launches of one step are asserted.
8. The Llama slice: the GPT-2 flagship is freed, then the SigLIP so400m +
   Llama-3-8B configuration of configs/siglip_llama8b.yaml is built once at
   full width in bf16 over f32 masters, with 4 of each Llama tower's 32
   layers (``LLAMA_REDUCED`` says why) and random seeded weights. It serves
   sampled caption requests through ``generate_captions`` at batch 1 and 8
   (max_length 128, top-p 0.9, temperature 0.8, repetition penalty 1.1,
   one beam), takes stage-1 steps at 4 x 512 and DPO steps at 2 pairs x 512
   under the JAX trainer's partitions, timed and profiled as in phase 6,
   with every request's and step's launches asserted.

Launch counts are reset just before the main path of phases 5, 6, 7 and of
each of phase 8's three paths, and read just after. The second-to-last line
is the kernel summary as JSON; the last line is ``{"ok": true, "device":
{...}}``. Without a card, or without the package beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 1e-2)}  # (atol, rtol) on y / o / dx
ATTN_F32_ATOL = 2e-5
ATTN_BWD_F32_TOL = (2e-5, 1e-5)  # dk/dv sum up to 128 rows' terms of size ~10: f32 rounding grows with both
SUM_TOL = (1e-3, 1e-4)  # (atol, rtol) on LN's dgamma/dbeta: f32 sums over up to 16,384 rows
GPT2_VOCAB = 50257 + 5  # GPT-2's vocab plus the five specials, as bench.py
LLAMA_VOCAB = 128_256  # configs/siglip_llama8b.yaml model.vocab_size
SIGLIP, LLAMA = "google/siglip-so400m-patch14-384", "meta-llama/Meta-Llama-3-8B"
SLEEP_CYCLES = 20_000_000  # ~10 ms: keeps the card busy while the host queues a burst
SERVING_KERNELS = ("layernorm_fwd", "flash_attn_fwd")  # serving runs no backward
LLAMA_SERVING_KERNELS = SERVING_KERNELS + ("rmsnorm_fwd",)


def log(msg: str) -> None:
    print(msg, flush=True)


def dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def time_ms(fn, arg_sets, reps: int = 20, trials: int = 21) -> float:
    """Median over ``trials`` of the mean device time of ``reps`` back-to-back calls.

    A sleep kernel runs first so the host queues the whole burst before the
    card reaches it: the events then time the card, not the Python launch
    path. ``arg_sets`` rotate across bursts, each used once before any is
    used again, so sets larger in total than the 50 MB L2 arrive cold, as
    the KV caches of 24 layers do in the real decode.
    """
    fn(*arg_sets[0])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    calls = 1
    for _ in range(trials):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn(*arg_sets[calls % len(arg_sets)])
            calls += 1
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    max_err = float(err.max())
    if bool(bad.any()) or not math.isfinite(max_err):
        raise AssertionError(f"{name}: max abs err {max_err:.3e} beyond atol {atol} rtol {rtol}")
    return max_err


# ------------------------------------------------------------------ phase 3


def layernorm_case(rows: int, hidden: int, dtype: torch.dtype, gen: torch.Generator, timed=True) -> dict:
    from pgica_tpu_torch.ops.layernorm import layer_norm_fwd, layer_norm_ref

    x = (3 * torch.randn(rows, hidden, device="cuda", generator=gen)).to(dtype)
    w = 1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    b = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    got, again = layer_norm_fwd(x, w, b, 1e-5), layer_norm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    y, mu, rstd = got
    ry, rmu, rrstd = layer_norm_ref(x, w, b, 1e-5)
    atol, rtol = TOL[dtype]
    label = f"layernorm {rows}x{hidden} {dname(dtype)}"
    err = check_close(f"{label} y", y, ry, atol, rtol)
    check_close(f"{label} mu", mu, rmu, 1e-5, 0.0)
    check_close(f"{label} rstd", rstd, rrstd, 0.0, 1e-5)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    if not timed:
        return dict(max_abs_err=err)
    esize = x.element_size()
    nbytes = 2 * rows * hidden * esize + 2 * hidden * 4 + 2 * rows * 4
    flops = 8 * rows * hidden
    # cold inputs, as the bound assumes: rotating sets of x, w and b, > 2x L2
    n_sets = max(1, math.ceil(100e6 / nbytes))
    xs = (3 * torch.randn(n_sets, rows, hidden, device="cuda", generator=gen)).to(dtype)
    ws = 1 + 0.1 * torch.randn(n_sets, hidden, device="cuda", generator=gen)
    bs = 0.1 * torch.randn(n_sets, hidden, device="cuda", generator=gen)
    sets = [(xs[i], ws[i], bs[i], 1e-5) for i in range(n_sets)]
    lib_sets = [(xs[i], ws[i].to(dtype), bs[i].to(dtype)) for i in range(n_sets)]
    return dict(
        shape=f"({rows}, {hidden})", dtype=dname(dtype), max_abs_err=err, atol=atol, rtol=rtol,
        ms=time_ms(layer_norm_fwd, sets),
        plain_ms=time_ms(layer_norm_ref, sets),
        library_ms=time_ms(lambda t, wl, bl: F.layer_norm(t, (hidden,), wl, bl, 1e-5), lib_sets),
        input_sets=n_sets,
        **bound(nbytes, flops, dtype),
    )


def bound(nbytes: float, flops: float, dtype: torch.dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


def attention_inputs(b, h, sq, sk, d, dtype, valid, gen):
    q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dtype)
    k = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dtype)
    bias = None
    if valid is not None:
        keep = torch.arange(sk, device="cuda")[None, :] < valid[:, None]
        bias = torch.where(keep, 0.0, -1e9)
    return q, k, v, bias


def kept_pairs(b, sq, sk, causal, valid) -> torch.Tensor:
    """(b, sq, sk) bool: the (row, key) pairs whose p is not 0 (the key is kept and visible)."""
    keep = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    keep = keep[None].expand(b, sq, sk).clone()
    if valid is not None:
        keep &= (torch.arange(sk, device="cuda")[None, :] < valid[:, None])[:, None, :]
    return keep


def sdpa_mask(bias, b, sq, sk, causal, dtype):
    """The key bias (+ causal) as one float mask for the SDPA yardstick."""
    if bias is None and not causal:
        return None
    mask = torch.zeros(b, 1, sq, sk, device="cuda") if bias is None else bias[:, None, None, :].expand(b, 1, sq, sk).clone()
    if causal:
        mask = mask.masked_fill(~torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(), -1e9)
    return mask.to(dtype)


def attention_case(name, b, h, sq, sk, d, causal, valid, dtype, gen, timed=True) -> dict:
    from pgica_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref

    q, k, v, bias = attention_inputs(b, h, sq, sk, d, dtype, valid, gen)
    o, lse = flash_attention_fwd(q, k, v, bias, causal)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_ref(q, k, v, bias, causal)
    atol, rtol = (ATTN_F32_ATOL, 0.0) if dtype == torch.float32 else TOL[dtype]
    label = f"flash {name} ({b * h}, {sq}, {sk}, {d}) {dname(dtype)}"
    err = check_close(label + " o", o, ro, atol, rtol)
    check_close(label + " lse", lse, rlse, 1e-4, 1e-6)
    out = dict(case=name, shape=f"({b * h}, {sq}, {sk}, {d})", dtype=dname(dtype), causal=causal,
               max_abs_err=err, atol=atol, rtol=rtol)
    if not timed:
        return out
    # What this data needs: the (row, key) pairs it keeps, and the K/V rows of
    # the keys that some row keeps (a masked key's p is 0; the bias says
    # which) or that a row with no kept key averages over (all Sk of them).
    keep = kept_pairs(b, sq, sk, causal, valid)
    need = keep | ~keep.any(dim=2, keepdim=True)
    kv_rows = int(need.any(dim=1).sum())  # over batch rows; every head reads them
    esize = q.element_size()
    nbytes = esize * (2 * b * h * sq * d + 2 * h * kv_rows * d) + 4 * b * h * sq
    nbytes += 0 if bias is None else 4 * b * sk
    flops = 4 * d * h * int(keep.sum())  # QK^T and PV, 2 flops per MAC
    n_sets = max(1, math.ceil(100e6 / nbytes))  # > 2x L2: inputs arrive from HBM
    sets = [attention_inputs(b, h, sq, sk, d, dtype, valid, gen) for _ in range(n_sets)]
    # the yardstick: one SDPA call with the same key bias (+ causal) as a float mask
    lib_sets = [(sq_, sk_, sv_, sdpa_mask(sb_, b, sq, sk, causal, dtype)) for sq_, sk_, sv_, sb_ in sets]
    out.update(
        ms=time_ms(lambda *a: flash_attention_fwd(*a, causal), sets),
        plain_ms=time_ms(lambda *a: flash_attention_ref(*a, causal), sets),
        library_ms=time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_), lib_sets),
        input_sets=n_sets,
        **bound(nbytes, flops, dtype),
    )
    return out


def flash_crossover(gen: torch.Generator) -> None:
    """Both bf16 forward kernels (CUDA cores, tensor cores) at small Sq, where the dispatch threshold
    TC_MIN_SQ lies: GPT-2's decoder heads (32 x 16, D 64) and Llama's (8 x 32, D 128) over a cache of
    129 slots with ragged kept keys. Logs the times; the threshold in ops/flash_attention.py is set
    from them."""
    from pgica_tpu_torch.ops.flash_attention import flash_attention_fwd

    for b, h, d in ((32, 16, 64), (8, 32, 128)):
        valid = torch.randint(1, 130, (b,), device="cuda", generator=gen)
        row = []
        for sq in (1, 2, 3, 4, 8, 16, 32, 64):
            sets = [attention_inputs(b, h, sq, 129, d, torch.bfloat16, valid, gen) for _ in range(8)]
            ms = [time_ms(lambda *a: flash_attention_fwd(*a, tensor_cores=tc), sets) for tc in (False, True)]
            row.append(f"Sq {sq}: {ms[0]:.5f} / {ms[1]:.5f}")
        log(f"  flash forward crossover ({b * h}, Sq, 129, {d}) bf16, ms CUDA cores / tensor cores: " + "; ".join(row))


def library_time(fn, arg_sets) -> float | None:
    """A yardstick's time, or None where PyTorch refuses the call on these inputs."""
    try:
        return time_ms(fn, arg_sets)
    except RuntimeError as err:
        log(f"    (library call refused: {str(err).splitlines()[0][:120]})")
        return None


def layernorm_bwd_case(rows: int, hidden: int, dtype: torch.dtype, gen: torch.Generator, timed=True) -> dict:
    from pgica_tpu_torch.ops.layernorm import layer_norm_bwd, layer_norm_bwd_ref, layer_norm_fwd

    def inputs():
        x = (3 * torch.randn(rows, hidden, device="cuda", generator=gen)).to(dtype)
        w = 1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)
        b = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
        dy = torch.randn(rows, hidden, device="cuda", generator=gen).to(dtype)
        _, mu, rstd = layer_norm_fwd(x, w, b, 1e-5)
        return x, w, dy, mu, rstd

    args = inputs()
    got, again = layer_norm_bwd(*args), layer_norm_bwd(*args)
    torch.cuda.synchronize()
    want = layer_norm_bwd_ref(*args)
    atol, rtol = TOL[dtype]
    label = f"layernorm_bwd {rows}x{hidden} {dname(dtype)}"
    err = check_close(label + " dx", got[0], want[0], atol, rtol)
    sum_err = max(check_close(f"{label} {name}", got[i], want[i], *SUM_TOL)
                  for i, name in ((1, "dweight"), (2, "dbias")))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    out = dict(shape=f"({rows}, {hidden})", dtype=dname(dtype), max_abs_err=err, sum_max_abs_err=sum_err,
               atol=atol, rtol=rtol)
    if not timed:
        return out
    esize = args[0].element_size()
    nbytes = 3 * rows * hidden * esize + 12 * hidden + 8 * rows  # x, dy, dx; gamma, dgamma, dbeta; mu, rstd
    flops = 12 * rows * hidden
    n_sets = max(1, math.ceil(100e6 / nbytes))
    sets = [args] + [inputs() for _ in range(n_sets - 1)]
    lib_sets = [(dy, x, mu[:, None], rstd[:, None], w.to(dtype)) for x, w, dy, mu, rstd in sets]
    out.update(
        ms=time_ms(layer_norm_bwd, sets),
        plain_ms=time_ms(layer_norm_bwd_ref, sets),
        library_ms=library_time(lambda dy, x, mu, rs, w: torch.ops.aten.native_layer_norm_backward(
            dy, x, [hidden], mu, rs, w, w, [True, True, True]), lib_sets),
        input_sets=n_sets,
        **bound(nbytes, flops, dtype),
    )
    return out


def rmsnorm_case(rows: int, hidden: int, dtype: torch.dtype, gen: torch.Generator, timed=True) -> dict:
    from pgica_tpu_torch.ops.rmsnorm import rms_norm_fwd, rms_norm_ref

    def inputs():
        return ((3 * torch.randn(rows, hidden, device="cuda", generator=gen)).to(dtype),
                1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen), 1e-5)

    args = inputs()
    y, rstd = rms_norm_fwd(*args)
    torch.cuda.synchronize()
    ry, rrstd = rms_norm_ref(*args)
    atol, rtol = TOL[dtype]
    err = check_close(f"rmsnorm {rows}x{hidden} {dname(dtype)} y", y, ry, atol, rtol)
    check_close("rmsnorm rstd", rstd, rrstd, 0.0, 1e-5)
    if not timed:
        return dict(max_abs_err=err)
    nbytes = 2 * rows * hidden * args[0].element_size() + 4 * hidden + 4 * rows  # x, y; g; rstd
    n_sets = max(1, math.ceil(100e6 / nbytes))
    sets = [args] + [inputs() for _ in range(n_sets - 1)]
    lib_sets = [(x, w.to(dtype)) for x, w, _ in sets]
    return dict(
        shape=f"({rows}, {hidden})", dtype=dname(dtype), max_abs_err=err, atol=atol, rtol=rtol,
        ms=time_ms(rms_norm_fwd, sets), plain_ms=time_ms(rms_norm_ref, sets),
        library_ms=time_ms(lambda t, wl: F.rms_norm(t, (hidden,), wl, 1e-5), lib_sets),
        input_sets=n_sets, **bound(nbytes, 4 * rows * hidden, dtype),
    )


def rmsnorm_bwd_case(rows: int, hidden: int, dtype: torch.dtype, gen: torch.Generator, timed=True) -> dict:
    """The backward kernel against its plain version; dweight bit-identical over two runs, and rows
    whose dy is 0 give dx = 0 and leave dweight bit-identical."""
    from pgica_tpu_torch.ops.rmsnorm import rms_norm_bwd, rms_norm_bwd_ref, rms_norm_fwd

    def inputs():
        x = (3 * torch.randn(rows, hidden, device="cuda", generator=gen)).to(dtype)
        w = 1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)
        dy = torch.randn(rows, hidden, device="cuda", generator=gen).to(dtype)
        return x, w, dy, rms_norm_fwd(x, w, 1e-5)[1]

    x, w, dy, rstd = args = inputs()
    got, again = rms_norm_bwd(*args), rms_norm_bwd(*args)
    torch.cuda.synchronize()
    want = rms_norm_bwd_ref(*args)
    atol, rtol = TOL[dtype]
    label = f"rmsnorm_bwd {rows}x{hidden} {dname(dtype)}"
    err = check_close(label + " dx", got[0], want[0], atol, rtol)
    sum_err = check_close(label + " dweight", got[1], want[1], *SUM_TOL)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    if rows > 1:  # the second half of the rows with dy = 0
        dead = torch.arange(rows, device="cuda") >= rows // 2
        dx, dw = rms_norm_bwd(x, w, dy.masked_fill(dead[:, None], 0), rstd)
        live = rms_norm_bwd(x[~dead].contiguous(), w, dy[~dead].contiguous(), rstd[~dead].contiguous())
        if bool(dx[dead].any()) or not torch.equal(dw, live[1]):
            raise AssertionError(f"{label}: rows with dy = 0 gave dx != 0 or changed dweight")
    out = dict(shape=f"({rows}, {hidden})", dtype=dname(dtype), max_abs_err=err, sum_max_abs_err=sum_err,
               atol=atol, rtol=rtol)
    if not timed:
        return out
    nbytes = 3 * rows * hidden * x.element_size() + 8 * hidden + 4 * rows  # x, dy, dx; g, dg; rstd
    n_sets = max(1, math.ceil(100e6 / nbytes))
    sets = [args] + [inputs() for _ in range(n_sets - 1)]
    # the yardstick: the autograd backward of one F.rms_norm call (dx and dweight)
    lib_sets = []
    for x_, w_, dy_, _ in sets:
        leaves = [x_.detach().clone().requires_grad_(), w_.detach().to(dtype, copy=True).requires_grad_()]
        lib_sets.append((F.rms_norm(leaves[0], (hidden,), leaves[1], 1e-5), leaves, dy_))
    out.update(
        ms=time_ms(rms_norm_bwd, sets), plain_ms=time_ms(rms_norm_bwd_ref, sets),
        library_ms=library_time(lambda o, leaves, dy_: torch.autograd.grad(o, leaves, dy_, retain_graph=True),
                                lib_sets),
        input_sets=n_sets, **bound(nbytes, 8 * rows * hidden, dtype),
    )
    return out


def attention_bwd_case(name, b, h, s, d, causal, valid, dtype, gen, timed=True):
    """The dQ and the dK/dV kernels against the plain backward; one result dict for each."""
    from pgica_tpu_torch.ops.flash_attention import (
        NEG_INF,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        flash_attention_bwd_ref,
        flash_attention_fwd,
    )

    def inputs():
        q, k, v, bias = attention_inputs(b, h, s, s, d, dtype, valid, gen)
        do = torch.randn(b, h, s, d, device="cuda", generator=gen).to(dtype)
        o, lse = flash_attention_fwd(q, k, v, bias, causal)
        return q, k, v, bias, o, lse, do

    q, k, v, bias, o, lse, do = args = inputs()
    dq, delta = flash_attention_bwd_dq(q, k, v, bias, causal, o, lse, do)
    dq2, delta2 = flash_attention_bwd_dq(q, k, v, bias, causal, o, lse, do)
    dk, dv = flash_attention_bwd_dkv(q, k, v, bias, causal, lse, delta, do)
    dk2, dv2 = flash_attention_bwd_dkv(q, k, v, bias, causal, lse, delta, do)
    torch.cuda.synchronize()
    rdq, rdk, rdv, rdelta = flash_attention_bwd_ref(q, k, v, bias, causal, o, lse, do)
    atol, rtol = ATTN_BWD_F32_TOL if dtype == torch.float32 else TOL[dtype]
    label = f"flash bwd {name} ({b * h}, {s}, {s}, {d}) {dname(dtype)}"
    check_close(label + " delta", delta, rdelta, 1e-4, 1e-5)
    err_dq = check_close(label + " dq", dq, rdq, atol, rtol)
    err_dkv = max(check_close(label + " dk", dk, rdk, atol, rtol), check_close(label + " dv", dv, rdv, atol, rtol))
    if not (torch.equal(dq, dq2) and torch.equal(delta, delta2)):
        raise AssertionError(f"{label}: two runs of the dQ kernel differ")
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError(f"{label}: two runs of the dK/dV kernel differ")
    if bool((dq[lse <= 0.5 * NEG_INF] != 0).any()):
        raise AssertionError(f"{label}: a row that keeps no key got a nonzero dq")
    common = dict(case=name, shape=f"({b * h}, {s}, {s}, {d})", dtype=dname(dtype), causal=causal, atol=atol, rtol=rtol)
    res_dq, res_dkv = dict(common, max_abs_err=err_dq), dict(common, max_abs_err=err_dkv)
    if not timed:
        return res_dq, res_dkv
    keep = kept_pairs(b, s, s, causal, valid)
    kv_rows = int(keep.any(dim=1).sum())  # keys some row keeps: the only K/V rows either kernel reads
    pairs = h * int(keep.sum())
    esize = q.element_size()
    rows = b * h * s * d
    masks = 0 if bias is None else 4 * b * s
    dq_bytes = esize * (3 * rows + 2 * h * kv_rows * d + rows) + 8 * b * h * s + masks  # q, do, o, k, v; dq; lse, delta
    dkv_bytes = esize * (2 * rows + 2 * h * kv_rows * d + 2 * rows) + 8 * b * h * s + masks  # q, do, k, v; dk, dv
    n_sets = max(1, math.ceil(100e6 / dkv_bytes))
    sets = [args] + [inputs() for _ in range(n_sets - 1)]
    dkv_sets = []
    for q_, k_, v_, b_, o_, l_, do_ in sets:
        dkv_sets.append((q_, k_, v_, b_, l_, flash_attention_bwd_dq(q_, k_, v_, b_, causal, o_, l_, do_)[1], do_))
    plain_ms = time_ms(lambda q_, k_, v_, b_, o_, l_, do_: flash_attention_bwd_ref(q_, k_, v_, b_, causal, o_, l_, do_), sets)
    # the yardstick: the backward of one SDPA call with the same mask, all three gradients
    lib_sets = []
    for q_, k_, v_, b_, _, _, do_ in sets:
        leaves = [t.detach().clone().requires_grad_() for t in (q_, k_, v_)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=sdpa_mask(b_, b, s, s, causal, dtype))
        lib_sets.append((out, leaves, do_))
    library_ms = library_time(lambda out, leaves, do_: torch.autograd.grad(out, leaves, do_, retain_graph=True), lib_sets)
    res_dq.update(
        ms=time_ms(lambda q_, k_, v_, b_, o_, l_, do_: flash_attention_bwd_dq(q_, k_, v_, b_, causal, o_, l_, do_), sets),
        plain_ms=plain_ms, library_ms=library_ms, input_sets=n_sets,
        **bound(dq_bytes, 6 * d * pairs, dtype),
    )
    res_dkv.update(
        ms=time_ms(lambda q_, k_, v_, b_, l_, de_, do_: flash_attention_bwd_dkv(q_, k_, v_, b_, causal, l_, de_, do_), dkv_sets),
        plain_ms=plain_ms, library_ms=library_ms, input_sets=n_sets,
        **bound(dkv_bytes, 8 * d * pairs, dtype),
    )
    return res_dq, res_dkv


FCE_LOGP_TOL = (1e-4, 1e-5)  # logp, lse: sums over d products and V exponentials, in another order
# dh and dW sum K products (K = V for dh, N for dW) of coefficients (onehot - p) g, each from a score
# summed over d. Taken in another order, a score moves by ~u sqrt(d) sum|h||w| (~2.5e-5 here) and
# so does its coefficient, relatively; the sum moves by ~u sqrt(K) sum|terms| (~1.3e-5 at
# K = 50,262). So each element is held to FCE_SCALE_RTOL of its own sum|terms|, the plain
# |coeff| @ |W| or |coeff|^T @ |h| on the same inputs: an error of one term stands out.
FCE_SCALE_RTOL = 1e-4
FCE_BF16_RTOL = 2.0**-7  # dh (bf16 h): then one rounding of a value that may straddle a bf16 boundary


def time_single(fn, args, trials: int = 5) -> float:
    """Median device time of ``trials`` single calls (CUDA events), after one warm-up call.

    For the fused-CE kernels: one call takes milliseconds (launch overhead is
    noise), and W alone (206 MB at the flagship in f32) is four times the L2,
    so every call reads it from HBM.
    """
    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def caption_rows_mask(n_seq: int, seq: int, lengths, gen) -> torch.Tensor:
    """(n_seq * (seq - 1),) float mask of the rows the stage-2 path gives the fused-CE kernels: the
    [:, :-1] shift of captions whose lengths are drawn from ``lengths``; g is 0 on the others."""
    lens = torch.randint(lengths[0], lengths[1] + 1, (n_seq,), device="cuda", generator=gen)
    return (torch.arange(1, seq, device="cuda")[None, :] < lens[:, None]).float().reshape(-1)


def fused_ce_inputs(rows, vocab, d, h_dtype, w_dtype, gen, valid_rows=None):
    """Hidden rows ~ LN outputs, W ~ the 0.02-normal init, targets anywhere (some in the last, partial
    vocab tile), cotangents g ~ N(0, 1) with 0 at the rows ``valid_rows`` masks out."""
    h = torch.randn(rows, d, device="cuda", generator=gen).to(h_dtype)
    w = (0.02 * torch.randn(vocab, d, device="cuda", generator=gen)).to(w_dtype)
    y = torch.randint(0, vocab, (rows,), device="cuda", generator=gen)
    y[: max(1, rows // 50)] = vocab - 1
    g = torch.randn(rows, device="cuda", generator=gen)
    if valid_rows is not None:
        g = g * valid_rows
    return h, w, y, g


def check_scaled(name: str, got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor, rtol: float) -> float:
    """|got - want| <= FCE_SCALE_RTOL * scale + rtol * |want|, element by element; returns the max error."""
    err = (got.float() - want.float()).abs()
    bad = err > FCE_SCALE_RTOL * scale + rtol * want.float().abs()
    max_err = float(err.max())
    if bool(bad.any()) or not math.isfinite(max_err):
        i = int(bad.flatten().float().argmax())
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond the bound; max abs err {max_err:.3e}; "
                             f"e.g. element {i}: got {float(got.flatten()[i]):.6e} want {float(want.flatten()[i]):.6e} "
                             f"sum|terms| {float(scale.flatten()[i]):.3e}")
    return max_err


def fused_ce_case(name, rows, vocab, d, h_dtype, w_dtype, gen, valid_rows=None, timed=True) -> dict:
    """The three fused-CE kernels against their plain versions; one result dict for each.

    dh and dW take the kernel forward's lse, as the path does. Each kernel runs
    twice and must give the same bits; with masked
    rows, dh is exactly 0 on them and dW is bit-identical to dW over the
    live rows alone (a row with g = 0 adds exactly nothing).
    """
    from pgica_tpu_torch.ops.fused_ce import (
        _coeff_ref,
        fused_ce_bwd_dh,
        fused_ce_bwd_dh_ref,
        fused_ce_bwd_dw,
        fused_ce_bwd_dw_ref,
        fused_ce_fwd,
        fused_ce_fwd_ref,
    )

    h, w, y, g = fused_ce_inputs(rows, vocab, d, h_dtype, w_dtype, gen, valid_rows)
    logp, lse = fused_ce_fwd(h, w, y)
    logp2, lse2 = fused_ce_fwd(h, w, y)
    dh, dh2 = fused_ce_bwd_dh(h, w, y, lse, g), fused_ce_bwd_dh(h, w, y, lse, g)
    dw, dw2 = fused_ce_bwd_dw(h, w, y, lse, g), fused_ce_bwd_dw(h, w, y, lse, g)
    torch.cuda.synchronize()
    label = f"fused_ce {name} ({rows}, {d}) x ({vocab}, {d}) h {dname(h_dtype)} W {dname(w_dtype)}"
    rlogp, rlse = fused_ce_fwd_ref(h, w, y)
    err_fwd = check_close(label + " logp", logp, rlogp, *FCE_LOGP_TOL)
    check_close(label + " lse", lse, rlse, *FCE_LOGP_TOL)
    if not (torch.equal(logp, logp2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{label}: two runs of fused_ce_fwd differ")
    del rlogp, logp2, lse2
    coeff = _coeff_ref(h, w, y, rlse, g).abs_()
    outs = {}
    for kernel, got, again, ref_fn, scale_of in (
            ("fused_ce_bwd_dh", dh, dh2, fused_ce_bwd_dh_ref, lambda: coeff @ w.float().abs()),
            ("fused_ce_bwd_dw", dw, dw2, fused_ce_bwd_dw_ref, lambda: coeff.T @ h.float().abs())):
        want = ref_fn(h, w, y, rlse, g)
        rtol = FCE_BF16_RTOL if got.dtype == torch.bfloat16 else 0.0
        outs[kernel] = (check_scaled(f"{label} {kernel}", got, want, scale_of(), rtol), rtol)
        if not torch.equal(got, again):
            raise AssertionError(f"{label}: two runs of {kernel} differ")
        del want
    del coeff
    if valid_rows is not None:
        live = valid_rows != 0
        if bool((dh[~live] != 0).any()):
            raise AssertionError(f"{label}: a row with g = 0 got a nonzero dh")
        if not torch.equal(dw, fused_ce_bwd_dw(h[live].contiguous(), w, y[live], lse[live], g[live])):
            raise AssertionError(f"{label}: the rows with g = 0 changed dW")
    common = dict(case=name, shape=f"({rows}, {d}) x ({vocab}, {d})", dtype=f"h {dname(h_dtype)}, W {dname(w_dtype)}")
    res = {"fused_ce_fwd": dict(common, max_abs_err=err_fwd, atol=FCE_LOGP_TOL[0], rtol=FCE_LOGP_TOL[1])}
    for kernel, (err, rtol) in outs.items():
        res[kernel] = dict(common, max_abs_err=err, atol=f"{FCE_SCALE_RTOL} x sum|terms|", rtol=rtol)
    del dh, dh2, dw, dw2
    if not timed:
        return res
    # bounds: each input read once, each output written once; the products at the bf16 tensor-core
    # peak with one pass per product, whatever the type pair (the same work gets the same bound,
    # whatever implements it); the backward needs only the rows whose g is not 0
    peak_dtype = torch.bfloat16
    eh, ew = h.element_size(), w.element_size()
    live = int((g != 0).sum())
    fwd_bytes = rows * d * eh + vocab * d * ew + 4 * rows + 8 * rows  # h, W, y; logp, lse
    bwd_in = rows * d * eh + vocab * d * ew + 12 * rows  # h, W, y, lse, g
    bounds = {
        "fused_ce_fwd": bound(fwd_bytes, 2 * rows * vocab * d, peak_dtype),
        "fused_ce_bwd_dh": bound(bwd_in + rows * d * eh, 4 * live * vocab * d, peak_dtype),  # scores + product
        "fused_ce_bwd_dw": bound(bwd_in + vocab * d * ew, 4 * live * vocab * d, peak_dtype),
    }
    times = {
        "fused_ce_fwd": (time_single(fused_ce_fwd, (h, w, y)), time_single(fused_ce_fwd_ref, (h, w, y))),
        "fused_ce_bwd_dh": (time_single(fused_ce_bwd_dh, (h, w, y, lse, g)),
                            time_single(fused_ce_bwd_dh_ref, (h, w, y, lse, g))),
        "fused_ce_bwd_dw": (time_single(fused_ce_bwd_dw, (h, w, y, lse, g)),
                            time_single(fused_ce_bwd_dw_ref, (h, w, y, lse, g))),
    }
    # the yardstick, two PyTorch calls never used by the port: F.linear then F.cross_entropy on bf16
    # h and W (the logits materialized), and that pair's autograd backward (dh and dW together)
    hb, wb = h.to(torch.bfloat16), w.to(torch.bfloat16)
    lib_fwd = time_single(lambda: F.cross_entropy(F.linear(hb, wb), y, reduction="none"), ())
    leaves = [hb.detach().clone().requires_grad_(), wb.detach().clone().requires_grad_()]
    out = F.cross_entropy(F.linear(*leaves), y, reduction="none")
    lib_bwd = time_single(lambda: torch.autograd.grad(out, leaves, g.to(out.dtype), retain_graph=True), ())
    del out, leaves
    for kernel, (ms, plain_ms) in times.items():
        res[kernel].update(ms=ms, plain_ms=plain_ms, library_ms=lib_fwd if kernel == "fused_ce_fwd" else lib_bwd,
                           library="F.linear + F.cross_entropy, bf16 (two calls)" if kernel == "fused_ce_fwd"
                           else "autograd backward of F.linear + F.cross_entropy, bf16 (dh and dW together)",
                           input_sets="1 (median of 5 single calls)", live_rows=live, **bounds[kernel])
    torch.cuda.empty_cache()
    return res


def show_timed(kernel: str, r: dict) -> None:
    lib = "refused" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
    log(f"  {kernel} {r.get('case', r.get('where', ''))} {r['shape']} {r['dtype']}: max_abs_err "
        f"{r['max_abs_err']:.3e} (atol {r['atol']}, rtol {r['rtol']}); kernel_ms {r['ms']:.5f} plain_ms "
        f"{r['plain_ms']:.5f} library_ms {lib} bound_ms {r['bound_ms']:.6f} ({r['bound_by']}; "
        f"{r['input_sets']} input sets)")


# the tensor-core kernels, by source: phase 3 reports their registers and spills from the build's
# -Xptxas -v log and whether their SASS holds tensor-core instructions
TC_KERNELS = {"flash_attn_fwd.cu": ("flash_attn_fwd_tc",),
              "flash_attn_bwd.cu": ("flash_attn_bwd_dkv_tc", "flash_attn_bwd_dq_tc"),
              "fused_ce.cu": ("fused_ce_fwd_tiles",),
              "fused_ce_bwd.cu": ("fused_ce_dh_coeff", "fused_ce_dh_product", "fused_ce_dw_coeff",
                                  "fused_ce_dw_product")}


def _demangle(names: list) -> list:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def tensor_core_report() -> None:
    """Logs each tensor-core kernel instance's registers and spill bytes (ptxas) and HMMA/HGMMA in its
    SASS. Raises if an instance has no tensor-core instruction: these kernels exist to use them."""
    from pgica_tpu_torch.ops import _kernels

    tool = shutil.which("cuobjdump") or str(Path(_kernels._nvcc()).parent / "cuobjdump")
    for source, names in TC_KERNELS.items():
        lib = _kernels.library_path(source)
        entries = {}
        for part in lib.with_suffix(".log").read_text().split("Compiling entry function '")[1:]:
            name = part.split("'", 1)[0]
            if any(n in name for n in names):
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
                regs = re.search(r"Used (\d+) registers", part)
                entries[name] = dict(registers=int(regs.group(1)), spill_stores=int(spill.group(1)),
                                     spill_loads=int(spill.group(2)))
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
        for part in sass.split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            if name in entries:
                entries[name]["sass"] = sorted({op for op in ("HGMMA", "HMMA") if op in part})
        for (name, e), pretty in zip(entries.items(), _demangle(list(entries))):
            log(f"  {pretty}: {e['registers']} registers, spill stores {e['spill_stores']} B, spill loads "
                f"{e['spill_loads']} B; tensor-core SASS: {', '.join(e.get('sass', [])) or 'none'}")
            if not e.get("sass"):
                raise AssertionError(f"{pretty}: no HMMA/HGMMA in its SASS ({lib.name})")


# LayerNorm shapes of the main paths, (rows, H, where): phase 3 times each, forward and backward
LN_FWD_SHAPES = ((32 * 50, 768, "ViT blocks"), (32, 512, "projection ln"), (32, 1024, "decoder, per step"),
                 (128 * 50, 768, "ViT blocks, stage 1"), (128, 768, "ViT post_ln, stage 1"),
                 (128, 512, "projection ln, stage 1"), (128 * 32, 1024, "text tower, bucketed"),
                 (128 * 128, 1024, "text tower, stage 1"), (64 * 128, 1024, "decoder, stage 2"),
                 (64 * 32, 1024, "decoder, stage 2 bucketed"))
LN_FWD_LLAMA_SHAPES = ((2 * 730, 1152, "SigLIP, Llama stage 2"), (4 * 730, 1152, "SigLIP, Llama stage 1"),
                       (8 * 730, 1152, "SigLIP, Llama serving batch 8"),
                       (2048, 4096, "decoder cross_ln, Llama stage 2"))
LN_BWD_SHAPES = ((128 * 128, 1024, "text tower, stage 1"), (128 * 32, 1024, "text tower, bucketed"),
                 (128, 512, "projection ln, stage 1"), (64 * 128, 1024, "decoder, stage 2"),
                 (64 * 32, 1024, "decoder, stage 2 bucketed"))
LN_BWD_LLAMA_SHAPES = ((2048, 4096, "decoder cross_ln, Llama stage 2"),)
# checked, not timed: an H that is no multiple of the 16-byte slot (the element-by-element instance),
# ragged row counts, and one the backward's row partition does not divide (4,099 = 227 x 18 + 13)
LN_FWD_UNTIMED = ((7, 2000), (5, 1001))
LN_BWD_UNTIMED = ((7, 2000), (37, 768), (5, 1001), (4099, 1024))
# (kernel, rows, H): the launches one call makes on the card, with the gaps between them
LN_BREAKDOWN = (("layernorm_bwd", 128, 512), ("layernorm_bwd", 2048, 4096), ("layernorm_bwd", 16384, 1024),
                ("layernorm_fwd", 32, 1024))
RMS_SHAPES = ((2048, 4096, "Llama blocks, stage 1 and 2"), (8, 4096, "Llama decode, batch 8"))


def layernorm_cases(fwd_shapes, bwd_shapes, dtype: torch.dtype, gen: torch.Generator, results: dict,
                    untimed: bool = False) -> None:
    """Times the LayerNorm kernels at the given shapes into ``results``; with ``untimed``, then checks
    both kernels at the untimed shapes."""
    for rows, hidden, where in fwd_shapes:
        r = layernorm_case(rows, hidden, dtype, gen)
        r["where"] = where
        results["layernorm_fwd"].append(r)
        show_timed("layernorm", r)
    for rows, hidden in LN_FWD_UNTIMED if untimed else ():
        r = layernorm_case(rows, hidden, dtype, gen, timed=False)
        log(f"  layernorm ({rows}, {hidden}) {dname(dtype)}: max_abs_err {r['max_abs_err']:.3e}, identical over two "
            "runs")
    for rows, hidden, where in bwd_shapes:
        r = layernorm_bwd_case(rows, hidden, dtype, gen)
        r["where"] = where
        results["layernorm_bwd"].append(r)
        show_timed("layernorm_bwd", r)
        log(f"    dweight/dbias max abs err {r['sum_max_abs_err']:.3e} (atol {SUM_TOL[0]}, rtol {SUM_TOL[1]}); "
            f"identical over two runs")
    for rows, hidden in LN_BWD_UNTIMED if untimed else ():
        r = layernorm_bwd_case(rows, hidden, dtype, gen, timed=False)
        log(f"  layernorm_bwd ({rows}, {hidden}) {dname(dtype)}: max_abs_err {r['max_abs_err']:.3e}, "
            f"sums {r['sum_max_abs_err']:.3e}, identical over two runs")


def rmsnorm_cases(dtype: torch.dtype, gen: torch.Generator, results: dict) -> None:
    for rows, hidden, where in RMS_SHAPES:
        r = rmsnorm_case(rows, hidden, dtype, gen)
        r["where"] = where
        results["rmsnorm_fwd"].append(r)
        show_timed("rmsnorm", r)
        r = rmsnorm_bwd_case(rows, hidden, dtype, gen)
        r["where"] = where
        results["rmsnorm_bwd"].append(r)
        show_timed("rmsnorm_bwd", r)
        log(f"    dweight max abs err {r['sum_max_abs_err']:.3e} (atol {SUM_TOL[0]}, rtol {SUM_TOL[1]}); identical "
            f"over two runs; rows with dy = 0 give dx 0 and leave dweight bit-identical")
    for rows, hidden in ((37, 32), (5, 8200), (3, 16392)):  # ragged; the loop kernels (wide rows)
        r, r_bwd = rmsnorm_case(rows, hidden, dtype, gen, timed=False), rmsnorm_bwd_case(rows, hidden, dtype, gen,
                                                                                      timed=False)
        log(f"  rmsnorm ({rows}, {hidden}) {dname(dtype)}: max_abs_err y {r['max_abs_err']:.3e}, dx "
            f"{r_bwd['max_abs_err']:.3e}, dweight {r_bwd['sum_max_abs_err']:.3e}")


def launch_breakdown(kernel: str, rows: int, hidden: int, calls: int = 10) -> dict | None:
    """The device time of each launch one bf16 LayerNorm call makes, and the gaps between them.

    torch.profiler over ``calls`` calls on one input set (warm in the L2 where it fits), queued behind
    a sleep kernel so the gaps are the card's, not the host's. Returns the means in microseconds, or
    None where the profiler recorded no device time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pgica_tpu_torch.ops.layernorm import layer_norm_bwd, layer_norm_fwd

    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (3 * torch.randn(rows, hidden, device="cuda", generator=gen)).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    b = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    _, mu, rstd = layer_norm_fwd(x, w, b, 1e-5)
    if kernel == "layernorm_fwd":
        fn, args = layer_norm_fwd, (x, w, b, 1e-5)
    else:
        fn, args = layer_norm_bwd, (x, w, torch.randn_like(x), mu, rstd)
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and not re.search(
        "sleep|spin", e.name, re.IGNORECASE)), key=lambda e: e.time_range.start)
    label = f"{kernel} ({rows}, {hidden}) bfloat16"
    if not events or len(events) % calls:
        log(f"  launches of one {label} call: not measured ({len(events)} device events for {calls} calls: "
            f"{sorted({e.name[:60] for e in events})})")
        return None
    per = len(events) // calls
    names = [re.sub(r"[<(].*", "", e.name.replace("(anonymous namespace)::", "")).split()[-1] for e in events[:per]]
    us = [statistics.mean(events[c * per + k].time_range.elapsed_us() for c in range(calls)) for k in range(per)]
    gaps = [statistics.mean(events[c * per + k + 1].time_range.start - events[c * per + k].time_range.end
                            for c in range(calls)) for k in range(per - 1)]
    span = statistics.mean(events[c * per + per - 1].time_range.end - events[c * per].time_range.start
                           for c in range(calls))
    parts = [f"{names[0]} {us[0]:.2f} us"] + [f"gap {g:.2f} us, {n} {t:.2f} us"
                                              for n, t, g in zip(names[1:], us[1:], gaps)]
    log(f"  launches of one {label} call (profiler, mean of {calls}): {'; '.join(parts)}; first start to last end "
        f"{span:.2f} us")
    return dict(kernel=kernel, shape=f"({rows}, {hidden})", launches=names, us=us, gaps_us=gaps, span_us=span)


def norm_kernel_times() -> None:
    """Phase 3's LayerNorm and RMSNorm timings and the LayerNorm launch breakdowns alone, one JSON line
    each (``NORM {...}``), through whichever ``pgica_tpu_torch`` is first on ``sys.path``: run once per
    checkout, in turns, in one call, it compares two trees on one card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: [] for name in KERNEL_META}
    for dtype in (torch.bfloat16, torch.float32):
        layernorm_cases(LN_FWD_SHAPES + LN_FWD_LLAMA_SHAPES, LN_BWD_SHAPES + LN_BWD_LLAMA_SHAPES, dtype, gen,
                        results)
        rmsnorm_cases(dtype, gen, results)
    for kernel, rows in results.items():
        for r in rows:
            print("NORM " + json.dumps(dict(kernel=kernel, **{k: r[k] for k in ("shape", "dtype", "ms", "plain_ms",
                                                                              "library_ms", "bound_ms")})))
    for kernel, rows, hidden in LN_BREAKDOWN:
        print("NORM " + json.dumps(launch_breakdown(kernel, rows, hidden)))


def phase_kernels() -> dict:
    from pgica_tpu_torch.ops.flash_attention import TC_MIN_SQ

    tensor_core_report()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: [] for name in KERNEL_META}
    stage1_valid = {s: torch.randint(1, s + 1, (128,), device="cuda", generator=gen) for s in (128, 32)}
    # stage 2 at batch 32: 64 caption rows (chosen and rejected), every token kept, or 8-28 of 32
    stage2_valid = {128: torch.full((64,), 128, device="cuda"),
                    32: torch.randint(8, 29, (64,), device="cuda", generator=gen)}
    for dtype in (torch.bfloat16, torch.float32):
        layernorm_cases(LN_FWD_SHAPES, (), dtype, gen, results)
        decode_valid = torch.full((32,), 41, device="cuda")  # step 40 of 64: keys 0..40 kept
        ragged = torch.tensor([77, 50], device="cuda")
        for name, shape, causal, valid in (
            ("vit", (32, 12, 50, 50, 64), False, None),
            ("decode", (32, 16, 1, 65, 64), False, decode_valid),
            ("causal_ragged", (2, 16, 77, 77, 64), True, ragged),
            ("vit_stage1", (128, 12, 50, 50, 64), False, None),
            ("stage1", (128, 16, 128, 128, 64), True, stage1_valid[128]),
            ("stage1_bucketed", (128, 16, 32, 32, 64), True, stage1_valid[32]),
            ("stage2", (64, 16, 128, 128, 64), True, stage2_valid[128]),
            ("stage2_bucketed", (64, 16, 32, 32, 64), True, stage2_valid[32]),
        ):
            r = attention_case(name, *shape, causal, valid, dtype, gen)
            results["flash_attn_fwd"].append(r)
            show_timed("flash", r)
        # the Llama slice (phase 8): SigLIP's 730 tokens at D = 72 (batch 2 in stage 2, 8 serving), the
        # Llama towers' 4 x 32 heads of 128 over 512 tokens, every one kept, and decode at batch 8 over a
        # cache of max_length 128 + 1 slots, step 64 (keys 0..64 kept)
        for name, shape, causal, valid in (
            ("siglip_stage2", (2, 16, 730, 730, 72), False, None),
            ("siglip_serving", (8, 16, 730, 730, 72), False, None),
            ("llama", (4, 32, 512, 512, 128), True, torch.full((4,), 512, device="cuda")),
            ("llama_decode", (8, 32, 1, 129, 128), False, torch.full((8,), 65, device="cuda")),
        ):
            r = attention_case(name, *shape, causal, valid, dtype, gen)
            results["flash_attn_fwd"].append(r)
            show_timed("flash", r)
        for d in (16, 32, 72, 128):  # the other head dims, a fully masked batch row, ragged edges
            r = attention_case(f"d{d}", 2, 2, 33, 40, d, d == 32, torch.tensor([0, 29], device="cuda"),
                               dtype, gen, timed=False)
            log(f"  flash d={d} (4, 33, 40, {d}) {dname(dtype)} masked row: max_abs_err {r['max_abs_err']:.3e}")
        # either side of the Sq at which bf16 moves to the tensor-core kernel (ops/flash_attention.py:
        # TC_MIN_SQ), ragged keys over a cache of 129
        for name, sq_ in (("below_tc_min_sq", TC_MIN_SQ - 1), ("at_tc_min_sq", TC_MIN_SQ)):
            r = attention_case(name, 32, 16, sq_, 129, 64, False,
                               torch.randint(1, 130, (32,), device="cuda", generator=gen), dtype, gen)
            results["flash_attn_fwd"].append(r)
            show_timed("flash", r)
        layernorm_cases(LN_FWD_LLAMA_SHAPES, (), dtype, gen, results)
        rmsnorm_cases(dtype, gen, results)
        layernorm_cases((), LN_BWD_SHAPES, dtype, gen, results, untimed=True)
        for name, b, s_, valid in (("stage1_full", 128, 128, stage1_valid[128]),
                                   ("stage1_bucketed", 128, 32, stage1_valid[32]),
                                   ("stage2_full", 64, 128, stage2_valid[128]),
                                   ("stage2_bucketed", 64, 32, stage2_valid[32])):
            r_dq, r_dkv = attention_bwd_case(name, b, 16, s_, 64, True, valid, dtype, gen)
            results["flash_attn_bwd_dq"].append(r_dq)
            results["flash_attn_bwd_dkv"].append(r_dkv)
            show_timed("flash_bwd_dq", r_dq)
            show_timed("flash_bwd_dkv", r_dkv)
        layernorm_cases((), LN_BWD_LLAMA_SHAPES, dtype, gen, results)
        r_dq, r_dkv = attention_bwd_case("llama", 4, 32, 512, 128, True, torch.full((4,), 512, device="cuda"), dtype,
                                         gen)
        results["flash_attn_bwd_dq"].append(r_dq)
        results["flash_attn_bwd_dkv"].append(r_dkv)
        show_timed("flash_bwd_dq", r_dq)
        show_timed("flash_bwd_dkv", r_dkv)
        for d in (16, 32, 72, 128):  # other head dims; batch row 0 keeps no key; ragged edges
            r_dq, r_dkv = attention_bwd_case(f"d{d}", 2, 2, 33, d, d != 32, torch.tensor([0, 29], device="cuda"),
                                             dtype, gen, timed=False)
            log(f"  flash bwd d={d} (4, 33, 33, {d}) {dname(dtype)} causal={d != 32}, a row without keys: "
                f"max_abs_err dq {r_dq['max_abs_err']:.3e}, dk/dv {r_dkv['max_abs_err']:.3e}")

    for kernel, rows, hidden in LN_BREAKDOWN:
        launch_breakdown(kernel, rows, hidden)
    flash_crossover(gen)
    # fused linear-CE at the stage-2 shapes (batch 32: 64 caption rows of 127 or 31 targets): bf16
    # hidden states with the policy's f32 W and with the reference's bf16 W; bucketed rows past a
    # caption's end have g = 0, as the path gives them
    bucketed_rows = caption_rows_mask(64, 32, (8, 28), gen)
    for name, rows, valid in (("full-pad", 64 * 127, None), ("bucketed", 64 * 31, bucketed_rows)):
        for w_dtype in (torch.float32, torch.bfloat16):
            res = fused_ce_case(name, rows, GPT2_VOCAB, 1024, torch.bfloat16, w_dtype, gen, valid)
            for kernel, r in res.items():
                results[kernel].append(r)
                show_timed(kernel, r)
    res = fused_ce_case("bucketed", 64 * 31, GPT2_VOCAB, 1024, torch.float32, torch.float32, gen, bucketed_rows,
                        timed=False)
    log(f"  fused_ce bucketed h float32, W float32: max_abs_err {fce_errs(res)}")
    # ragged edges (rows not a multiple of 8, V not of 128, targets in the last vocab tile, g = 0 on
    # every 4th row) in all four type pairs; d = 1,040: a k tile of the score GEMMs that ends 8
    # columns in
    ragged = (torch.arange(37, device="cuda") % 4 != 0).float()
    for h_dtype, w_dtype in itertools.product((torch.float32, torch.bfloat16), repeat=2):
        res = fused_ce_case("ragged", 37, 261, 32, h_dtype, w_dtype, gen, ragged, timed=False)
        log(f"  fused_ce ragged (37, 32) x (261, 32) h {dname(h_dtype)} W {dname(w_dtype)}: max_abs_err "
            f"{fce_errs(res)}")
    res = fused_ce_case("d1040", 300, 1000, 1040, torch.bfloat16, torch.float32, gen, timed=False)
    log(f"  fused_ce (300, 1040) x (1000, 1040) h bfloat16 W float32: max_abs_err {fce_errs(res)}")
    # the Llama slice's stage 2 (phase 8): 2 pairs x 2 captions x 511 targets, every one kept, d = 4,096
    # (dh and dW four vocab chunks each), V = 128,256; the policy's W f32 and the
    # reference's W bf16; then the same with the captions' tails masked (g = 0), untimed
    for w_dtype in (torch.float32, torch.bfloat16):
        res = fused_ce_case("llama", 4 * 511, LLAMA_VOCAB, 4096, torch.bfloat16, w_dtype, gen)
        for kernel, r in res.items():
            results[kernel].append(r)
            show_timed(kernel, r)
    res = fused_ce_case("llama masked", 4 * 511, LLAMA_VOCAB, 4096, torch.bfloat16, torch.float32, gen,
                        caption_rows_mask(4, 512, (256, 512), gen), timed=False)
    log(f"  fused_ce llama masked (2044, 4096) x ({LLAMA_VOCAB}, 4096) h bfloat16 W float32, lengths 256-512: "
        f"max_abs_err {fce_errs(res)}")
    log("  fused_ce: the forward, dh and dW identical over two runs everywhere; rows with g = 0 give dh 0 and "
        "leave dW bit-identical")
    return results


def fce_errs(res: dict) -> str:
    return ", ".join(f"{k.removeprefix('fused_ce_')} {r['max_abs_err']:.3e}" for k, r in res.items())


# ------------------------------------------------------------------ phase 4


def decode_logits(model, images, steps: int = 3):
    from pgica_tpu_torch.models.lm import init_kv_cache

    module = model.module
    cache_len = 17
    with torch.inference_mode():
        emb = model.encode_image(images)["embeddings"]
        caches = init_kv_cache(module.decoder_config, emb.shape[0], cache_len, torch.float32, model.device)
        slots = torch.arange(cache_len, device=model.device)
        mask_at = lambda t: (slots[None, :] <= t).to(torch.int32).expand(emb.shape[0], cache_len)  # noqa: E731
        logits, caches = module.decode_prefix(emb, caches, mask_at(0))
        out = [logits.cpu()]
        for t in range(1, steps + 1):
            tok = logits.argmax(-1)[:, None]
            logits, caches = module.decode_step(tok, t, caches, mask_at(t))
            out.append(logits.cpu())
    return emb.cpu(), out


def phase_full_width(tokenizer, arch: str) -> None:
    """Phase 4 for one architecture of ``FULL_WIDTH``."""
    from pgica_tpu_torch.generation.decode import generate
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
    from pgica_tpu_torch.models.presets import get_text_config, get_vision_config
    from pgica_tpu_torch.ops import _kernels

    spec = FULL_WIDTH[arch]
    t0 = time.perf_counter()
    kwargs = dict(
        vision_model=dataclasses.replace(get_vision_config(spec["vision"]), num_layers=2),
        text_model=dataclasses.replace(get_text_config(spec["text"]), num_layers=2),
        projection_dim=512, tokenizer=tokenizer, max_caption_length=128, vocab_size=spec["vocab"],
        dtype=torch.float32, seed=0, dropout=0.0,  # dropout 0: the card's and the CPU's streams differ
    )
    cuda, cpu = (PreferenceGuidedCaptioningModel(device=dev, **kwargs) for dev in ("cuda", "cpu"))
    log(f"  the card's and the CPU's models built in {time.perf_counter() - t0:.1f} s")
    size = cuda.image_size
    images = np.random.default_rng(1).integers(0, 256, size=(2, size, size, 3), dtype=np.uint8)
    _kernels.reset_launch_counts()
    emb_g, logits_g = decode_logits(cuda, images)
    counts = {k: v for k, v in _kernels.launch_counts().items() if k in spec["serving"]}
    emb_c, logits_c = decode_logits(cpu, images)
    err = check_close("full width: embeddings", emb_g, emb_c, 1e-3, 0.0)
    log(f"  encode_image embeddings (2, 512): max_abs_err {err:.3e} (atol 1e-3)")
    for i, (g, c) in enumerate(zip(logits_g, logits_c)):
        name = "prefix" if i == 0 else f"step {i}"
        err = check_close(f"full width: {name} logits", g, c, 1e-3, 0.0)
        log(f"  {name} logits (2, {spec['vocab']}): max_abs_err {err:.3e} (atol 1e-3)")
    if min(counts.values()) == 0:
        raise AssertionError(f"full width: a kernel was not launched on the card: {counts}")
    log(f"  kernel launches on the card: {counts}")
    ids = []
    for model, emb in ((cuda, emb_g.cuda()), (cpu, emb_c)):
        ids.append(generate(model.module, emb, eos_token_id=tokenizer.eos_token_id,
                            pad_token_id=tokenizer.pad_token_id, max_length=16).cpu())
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError(f"full width: greedy tokens differ:\n{ids[0]}\n{ids[1]}")
    log(f"  greedy tokens, 16 steps: identical on card and CPU ({ids[0].tolist()}); {time.perf_counter() - t0:.1f} s")
    full_width_train(cuda, cpu, spec)
    log(f"  stage 1 checked; {time.perf_counter() - t0:.1f} s")
    # the stage-2 check's reference: a frozen f32 model of another seed, so that the rewards are
    # far from 0 (a copy of the policy would make them exactly 0 at the first step)
    other = PreferenceGuidedCaptioningModel(device="cpu", **{**kwargs, "seed": 1})
    ref = frozen_copy(other.module, torch.float32)
    del other
    log(f"  reference built; {time.perf_counter() - t0:.1f} s")
    full_width_stage2(cuda, cpu, ref, spec)
    log(f"  stage 2 checked; {time.perf_counter() - t0:.1f} s")


def stage1_batch(rng, batch: int, seq: int, lengths=None, image: int = 224, vocab: int = GPT2_VOCAB) -> dict:
    """bench.py's stage-1 batch: normalized float images, random ids; every token kept, or
    lengths drawn from ``lengths`` and the columns cut to their bucket by ``bucket_batch``."""
    from pgica_tpu_torch.training.packing import bucket_batch, default_buckets

    images = rng.normal(size=(batch, image, image, 3)).astype(np.float32)
    ids = rng.integers(0, vocab, (batch, seq)).astype(np.int64)
    if lengths is None:
        return {"image": images, "caption_ids": ids, "caption_mask": np.ones((batch, seq), np.int32)}
    lens = rng.integers(lengths[0], lengths[1] + 1, batch)
    mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
    cut = bucket_batch({"caption_ids": ids * mask, "caption_mask": mask}, default_buckets(seq))
    return {"image": images, **cut}


def stage1_trainer(module, lr: float = 1e-3, warmup: int = 1, total: int = 10):
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState, make_stage1_train_step

    opt = create_optimizer(lr, total, warmup, freeze_vision_backbone=True, frozen_prefixes=("caption_decoder",))
    return TrainState.create(module, opt), make_stage1_train_step(module, opt, temperature=0.5), opt


# Phase 4 holds each gradient leaf to GRAD_RTOL (relative L2, and every element within that share
# of the leaf's largest |g|), the self-attention q and k projections to QK_GRAD_RTOL: their
# gradient comes through the softmax backward P * (dP - rowsum(dP * P)), which at near-uniform
# attention cancels terms far larger than its result, and the card and the CPU take those sums in
# another order.
GRAD_RTOL = 1e-3
QK_GRAD_RTOL = 1e-2
PARAM_ATOL = 1e-5


def grad_rtol(name: str) -> float:
    return QK_GRAD_RTOL if re.search(r"\.attn\.[qk]_proj\.", name) else GRAD_RTOL


def train_on_both(cuda, cpu, make, batches, loss_of) -> dict:
    """The same train steps on the card (kernels) and on the CPU (plain versions).

    ``make(module) -> (state, step, optimizer, extra)``; ``loss_of(module,
    extra, batch)`` is the step's loss without dropout, whose gradient is
    taken before each step and kept (on its side's device). Returns the
    metrics of every step, the final states, the gradients, the card's
    initial parameters (on the CPU), the optimizer and the card's launch
    counts over the steps and gradients.
    """
    from pgica_tpu_torch.ops import _kernels

    runs = {}
    for name, model in (("card", cuda), ("cpu", cpu)):
        t0 = time.perf_counter()
        state, step, opt, extra = make(model.module)
        params = state.opt_state.params
        if name == "card":
            initial = [p.detach().cpu().clone() for p in params]
            _kernels.reset_launch_counts()
        metrics, grads = [], []
        for batch in batches:
            loss = loss_of(model.module, extra, batch)
            grads.append([torch.zeros_like(p) if g is None else g.detach()
                          for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))])
            state, m = step(state, extra, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        if name == "card":
            counts = _kernels.launch_counts()
        runs[name] = (metrics, state, grads)
        log(f"  {len(batches)} gradients and steps on the {name}: {time.perf_counter() - t0:.1f} s")
    return dict(runs=runs, initial=initial, opt=opt, counts=counts)


def compare_training(label: str, run: dict, metric_tols: dict) -> None:
    """Phase 4's standard for card-vs-CPU training.

    The gradients of every batch agree leaf by leaf (relative L2 and every
    element within ``grad_rtol`` of the leaf's largest |g|; the
    self-attention key biases, 0 in exact arithmetic, ~0 on both sides); the
    metrics within ``metric_tols`` (name -> (atol, rtol)); the card's
    parameters match, element by element, the CPU optimizer fed the card's
    own gradients; and they agree with the CPU run to ``PARAM_ATOL``, except
    where Adam cannot pin the update down: Adam's step is lr * m / (sqrt(v)
    + eps), so an element whose card and CPU gradients differ by a relative
    r moves by up to about lr * r more on one side. Where 4 lr r exceeds
    ``PARAM_ATOL`` in some step the element is loose: counted, and held to
    Adam's own bound, lr per update on each side. The gradient check above
    bounds every element's difference, so a loose element cannot hide a
    wrong gradient. The comparisons run on the card (the CPU side's tensors
    are copied there); the replay of the optimizer runs on the CPU.
    """
    from pgica_tpu_torch.training.optim import OptState

    runs, steps = run["runs"], len(run["runs"]["card"][0])
    names = runs["card"][1].opt_state.names
    state_g, state_c = runs["card"][1], runs["cpu"][1]
    lr = max(run["opt"].schedule(c) for c in range(state_g.opt_state.count))
    worst = (0.0, "")
    loose, loose_g = [], 0.0  # the largest |g| of a loose element, as a share of its leaf's largest
    for i, name in enumerate(names):
        loose.append(torch.zeros(state_c.opt_state.params[i].shape, dtype=torch.bool, device="cuda"))
        for gg, gc in ((runs["card"][2][s][i], runs["cpu"][2][s][i].cuda()) for s in range(steps)):
            if name.endswith("attn.k_proj.bias"):  # 0 in exact arithmetic: both sides must be tiny
                if max(float(gg.abs().max()), float(gc.abs().max())) > 1e-6:
                    raise AssertionError(f"{label}: {name} gradient is not ~0: {gg.abs().max()} {gc.abs().max()}")
                loose[i][:] = True
                continue
            diff = (gg - gc).abs()
            rel = float(diff.norm() / gc.norm().clamp_min(1e-30))
            top = float(diff.max()) / max(float(gc.abs().max()), 1e-30)
            if max(rel, top) > grad_rtol(name):
                raise AssertionError(f"{label}: gradient of {name} differs by {rel:.3e} (relative L2), "
                                     f"{top:.3e} of its largest element (limit {grad_rtol(name)})")
            worst = max(worst, (rel, name))
            now = 4 * lr * diff / gc.abs() > PARAM_ATOL  # 0 / 0 is nan: not loose
            if now.any():
                loose_g = max(loose_g, float(gc.abs()[now].max()) / float(gc.abs().max()))
            loose[i] |= now
    log(f"  gradients of {len(names)} trained parameters on all {steps} batches, card vs CPU: worst relative L2 "
        f"difference {worst[0]:.3e} ({worst[1]}; limit {GRAD_RTOL}, self-attention q/k {QK_GRAD_RTOL}); "
        f"key-projection biases ~0 on both")
    for i, (mg, mc) in enumerate(zip(runs["card"][0], runs["cpu"][0])):
        for key, (atol, rtol) in metric_tols.items():
            if not abs(mg[key] - mc[key]) <= atol + rtol * abs(mc[key]):
                raise AssertionError(f"{label} step {i}: {key} card {mg[key]} cpu {mc[key]} (atol {atol}, rtol {rtol})")
        log(f"  step {i}: " + ", ".join(f"{k} card {mg[k]:.7g} cpu {mc[k]:.7g}" for k in metric_tols)
            + " (" + ", ".join(f"{k} atol {a:g} rtol {r:g}" for k, (a, r) in metric_tols.items()) + ")")
    # the card's optimizer against the CPU's, both fed the card's gradients: exact, no element excused
    initial = run["initial"]
    replay = OptState(list(names), initial, 0, [torch.zeros_like(p) for p in initial],
                      [torch.zeros_like(p) for p in initial])
    for grads in runs["card"][2]:
        run["opt"].update([g.cpu() for g in grads], replay)
    replay_err = max(check_close(f"{label}: {name} against the CPU optimizer on the card's gradients",
                                 pg.detach(), pr.cuda(), 1e-6, 0.0)
                     for name, pg, pr in zip(names, state_g.opt_state.params, replay.params))
    log(f"  the card's parameters after {steps} steps against the CPU optimizer fed the card's gradients: max abs "
        f"diff {replay_err:.3e} (atol 1e-6, every element)")
    adam_bound = 2 * lr * state_g.opt_state.count  # at most lr per update, each side
    total = n_loose = 0
    held_err = loose_err = 0.0
    by_leaf = {}
    for name, pg, pc, lo in zip(names, state_g.opt_state.params, state_c.opt_state.params, loose):
        diff = (pg.detach() - pc.detach().cuda()).abs()
        total += diff.numel()
        n_loose += int(lo.sum())
        by_leaf[name] = int(lo.sum())
        if not lo.all():
            held_err = max(held_err, check_close(f"{label}: {name}, elements held to {PARAM_ATOL}", diff[~lo],
                                                 torch.zeros(()), PARAM_ATOL, 0.0))
        if lo.any():
            loose_err = max(loose_err, check_close(f"{label}: {name}, loose elements", diff[lo], torch.zeros(()),
                                                   adam_bound, 0.0))
    log(f"  {len(names)} trained parameters ({total:,} elements) after {steps} steps: all but {n_loose:,} "
        f"({100 * n_loose / total:.3f}%) within {PARAM_ATOL} (max abs diff {held_err:.3e}); those are loose (4 lr "
        f"times their gradient's relative card-vs-CPU difference > {PARAM_ATOL}, or a key-projection bias; their "
        f"|g| at most {loose_g:.2e} of their leaf's largest): max abs diff {loose_err:.3e} (Adam's bound "
        f"{adam_bound:.0e}); most in " + ", ".join(
            f"{k} ({v:,} of {state_c.opt_state.params[names.index(k)].numel():,})"
            for k, v in sorted(by_leaf.items(), key=lambda kv: -kv[1])[:4]))
    counts = run["counts"]
    if min(counts.values()) == 0:
        raise AssertionError(f"{label}: a kernel was not launched on the card: {counts}")
    log(f"  kernel launches on the card, the train steps and the gradients beside them: {counts}")


def full_width_train(cuda, cpu, spec: dict) -> None:
    """Stage 1 at full width, f32, dropout 0: two train steps (the first has lr 0) on both sides."""
    from pgica_tpu_torch.training.train_step import _on_device, stage1_loss_fn

    def make(module):
        state, step, opt = stage1_trainer(module)
        return state, lambda st, _, batch: step(st, batch, 0), opt, None

    def loss_of(module, _, batch):
        return stage1_loss_fn(module, _on_device(batch, next(module.parameters()).device), None, 0.5)[0]

    rng = np.random.default_rng(2)
    n = spec["stage1_batch"]
    batches = [stage1_batch(rng, n, 32, (5, 32), cuda.image_size, spec["vocab"]) for _ in range(2)]
    run = train_on_both(cuda, cpu, make, batches, loss_of)
    run["counts"] = {k: v for k, v in run["counts"].items() if k in spec["stage1"]}
    log(f"  stage 1, batch {n} x 32 (ragged):")
    compare_training("full width stage 1", run, {"loss": (0.0, 1e-4), "grad_norm": (0.0, 1e-3)})


def stage2_batch(rng, batch: int, seq: int, lengths=None, image: int = 224, vocab: int = GPT2_VOCAB) -> dict:
    """A preference batch: bench.py's normalized float images; chosen and rejected captions of
    their own random ids (identical pairs would make every DPO logit exactly 0); every token kept,
    or lengths drawn from ``lengths`` and both sides cut to the bucket of the longest."""
    from pgica_tpu_torch.training.packing import default_buckets, pick_bucket

    out = {"image": rng.normal(size=(batch, image, image, 3)).astype(np.float32)}
    width = seq
    for side in ("preferred", "rejected"):
        ids = rng.integers(0, vocab, (batch, seq)).astype(np.int64)
        mask = np.ones((batch, seq), np.int32)
        if lengths is not None:
            lens = rng.integers(lengths[0], lengths[1] + 1, batch)
            mask = (np.arange(seq)[None, :] < lens[:, None]).astype(np.int32)
        out[f"{side}_ids"], out[f"{side}_mask"] = ids * mask, mask
    if lengths is not None:
        width = pick_bucket(int(max(out["preferred_mask"].sum(1).max(), out["rejected_mask"].sum(1).max())),
                            default_buckets(seq))
        for key in ("preferred_ids", "preferred_mask", "rejected_ids", "rejected_mask"):
            out[key] = np.ascontiguousarray(out[key][:, :width])
    return out


def stage2_trainer(module, ref, lr: float = 1e-3, warmup: int = 1, total: int = 10, frozen=None):
    """``make`` for train_on_both: the stage-2 step against the frozen reference ``ref``.

    ``frozen=None`` is bench.py's stage-2 optimizer, which holds every parameter; ``"text_encoder"``
    the JAX trainer's partition (trainer.py:232-237): the vision backbone and the text tower frozen.
    """
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState, make_stage2_train_step

    partition = {} if frozen is None else dict(freeze_vision_backbone=True, frozen_prefixes=(frozen,))
    opt = create_optimizer(lr, total, warmup, **partition)
    step = make_stage2_train_step(module, opt, beta=0.1)
    return TrainState.create(module, opt), lambda st, ref_, batch: step(st, ref_, batch, 0), opt, ref


def full_width_stage2(cuda, cpu, ref, spec: dict) -> None:
    """Stage 2 at full width, f32, dropout 0: two steps (the first has lr 0) on both sides, from the
    same parameters, against the frozen float32 reference ``ref`` (on the CPU; copied to the card)."""
    import copy

    from pgica_tpu_torch.training.train_step import PAIR_KEYS, _on_device, stage2_loss_fn

    cuda.module.load_state_dict(cpu.module.state_dict())  # stage 1 left the two a rounding apart
    refs = {cpu.module: ref, cuda.module: copy.deepcopy(ref).to(cuda.device)}

    def loss_of(module, ref_, batch):
        return stage2_loss_fn(module, ref_, _on_device(batch, next(module.parameters()).device, PAIR_KEYS), None,
                              0.1, False, False, 0.0)[0]

    rng = np.random.default_rng(3)
    batches = [stage2_batch(rng, 4, 32, (5, 32), cuda.image_size, spec["vocab"]) for _ in range(2)]
    run = train_on_both(cuda, cpu, lambda m: stage2_trainer(m, refs[m], frozen=spec["stage2_frozen"]), batches,
                        loss_of)
    run["counts"] = {k: v for k, v in run["counts"].items() if k in spec["stage2"]}
    log(f"  stage 2, batch 4 pairs x {batches[0]['preferred_ids'].shape[1]} (ragged), f32 reference:")
    # both steps see the same parameters on both sides (the first update has lr 0). A sequence's
    # log-prob sums <= 31 token log-probs of ~-11, each within ~1e-5 between the two sides; a reward
    # is beta = 0.1 times a difference of two such sums; a pair's margin within that of 0 may flip
    # the accuracy by 1 / 4
    compare_training("full width stage 2", run, {
        "loss": (0.0, 1e-4), "grad_norm": (0.0, 1e-3), "policy_chosen_logp": (1e-3, 1e-5),
        "policy_rejected_logp": (1e-3, 1e-5), "chosen_reward": (2e-4, 0.0), "rejected_reward": (2e-4, 0.0),
        "reward_margin": (4e-4, 0.0), "reward_accuracy": (0.25, 0.0)})


# ------------------------------------------------------------------ phase 5


def phase_slice(tokenizer) -> dict:
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
    from pgica_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    model = PreferenceGuidedCaptioningModel(
        vision_model="openai/clip-vit-base-patch32", text_model="gpt2-medium", projection_dim=512,
        tokenizer=tokenizer, max_caption_length=128, dtype=torch.bfloat16, seed=0,
        vocab_size=GPT2_VOCAB, device="cuda",
    )
    images = np.random.default_rng(0).integers(0, 256, size=(32, 224, 224, 3), dtype=np.uint8)
    model.generate_captions(images[:1], max_length=4)  # bf16 copy, cuBLAS handles
    torch.cuda.synchronize()
    log(f"  flagship built (random weights, seed 0) and warmed in {time.perf_counter() - t0:.1f} s; "
        f"params {sum(p.numel() for p in model.module.parameters()):,}")

    def request(batch: int, max_length: int, early_stop: bool) -> dict:
        before = _kernels.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        captions = model.generate_captions(images[:batch], max_length=max_length, early_stop=early_stop)
        seconds = time.perf_counter() - t  # ends in a device->host copy of the ids
        if len(captions) != batch or not all(isinstance(c, str) for c in captions):
            raise AssertionError(f"generate_captions returned {captions!r}")
        after = _kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in SERVING_KERNELS}
        forwards = (launches["flash_attn_fwd"] - 12) // 24  # prefix + steps run
        return dict(batch=batch, max_length=max_length, early_stop=early_stop, seconds=seconds,
                    captions_per_s=batch / seconds, launches=launches, decoder_forwards=forwards,
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)

    def show(tag: str, r: dict) -> None:
        log(f"  {tag} batch {r['batch']} x max_length {r['max_length']} early_stop={r['early_stop']}: "
            f"{r['seconds'] * 1e3:.1f} ms, {r['captions_per_s']:.1f} captions/s, decoder forwards "
            f"{r['decoder_forwards']}, launches {r['launches']}, peak {r['peak_mem_gib']:.2f} GiB")

    _kernels.reset_launch_counts()  # ---- the main path starts here
    served = []
    for batch in (1, 8, 32):
        r = request(batch, 32, True)
        served.append(r)
        show("request", r)
    model.generate_captions(images, max_length=64)  # warm-up of the benchmark shape
    bench = [request(32, 64, False) for _ in range(5)]
    for r in bench:
        show("eval greedy", r)
    main_counts = {k: v for k, v in _kernels.launch_counts().items() if k in SERVING_KERNELS}  # ---- and ends here
    if min(main_counts.values()) == 0:
        raise AssertionError(f"the serving path did not launch every kernel: {main_counts}")
    want = {"layernorm_fwd": 27 + 64 * 49, "flash_attn_fwd": 12 + 64 * 24}
    if bench[0]["launches"] != want:
        raise AssertionError(f"one 32 x 64 greedy call launched {bench[0]['launches']}, expected {want}")
    median_s = statistics.median(r["seconds"] for r in bench)
    log(f"  eval greedy 32 x 64: median {median_s * 1e3:.1f} ms -> {32 / median_s:.1f} captions/s "
        f"(median of 5 after one warm-up); launches per call {bench[0]['launches']} (expected {want})")
    log(f"  main-path launch counts (all requests above): {main_counts}")

    # The early_stop loop syncs the host on every step (finished.all()); with
    # random weights no row emits EOS, so both loops run every step and the
    # difference is the cost of that sync.
    sync = {True: [], False: []}
    for _ in range(3):
        for early in (True, False):
            sync[early].append(request(32, 32, early)["seconds"])
    es, fl = statistics.median(sync[True]), statistics.median(sync[False])
    log(f"  early_stop host-sync cost, batch 32 x 32, both running all 31 steps: early_stop "
        f"{es * 1e3:.1f} ms vs fixed {fl * 1e3:.1f} ms (median of 3 each, alternating): "
        f"{(es - fl) / 31 * 1e3:+.3f} ms per step")

    # outputs: finite logits of the expected shape
    from pgica_tpu_torch.models.lm import init_kv_cache

    module = model._inference_module()
    with torch.inference_mode():
        emb = model.encode_image(images)["embeddings"]
        caches = init_kv_cache(module.decoder_config, 32, 3, module.compute_dtype, model.device)
        mask = torch.ones(32, 3, dtype=torch.int32, device="cuda")
        mask[:, 1:] = 0
        first, caches = module.decode_prefix(emb, caches, mask)
        mask[:, 1] = 1
        second, _ = module.decode_step(first.argmax(-1)[:, None], 1, caches, mask)
    for name, t in (("prefix", first), ("step 1", second)):
        if t.shape != (32, GPT2_VOCAB) or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"flagship {name} logits: shape {tuple(t.shape)}, finite {bool(torch.isfinite(t).all())}")
    log(f"  flagship logits (32, {GPT2_VOCAB}) bf16 at prefix and step 1: all finite (no NaN)")

    profile = profiled(lambda: model.generate_captions(images, max_length=64), "32 x 64 greedy call",
                       median_s * 1e3)
    return dict(main_counts=main_counts, served=served, bench=bench, median_s=median_s,
                sync_ms_per_step=(es - fl) / 31 * 1e3, profile=profile, model=model)


def profiled(fn, label: str, unprofiled_ms: float) -> dict:
    """Kernel time of one call of ``fn`` (which ends in a host sync) from torch.profiler, and the
    device busy share: that kernel time over the call's wall time measured without the profiler
    (which slows the host, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    if device_ms <= 0:
        log(f"  profiler, {label}: no device time recorded (busy share not measured)")
        return {"device_ms": None}
    launches = sum(e.count for e in kernels)
    busy = device_ms / unprofiled_ms
    log(f"  profiler, one {label}: {launches} kernel launches, kernel time {device_ms:.1f} ms of {unprofiled_ms:.1f} "
        f"ms (unprofiled median) -> device busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%")
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    for e in top:
        log(f"    {_device_us(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:100]}")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    log("    host side, by self CPU time under the profiler (which inflates it):")
    for e in host:
        log(f"    {e.self_cpu_time_total / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:100]}")
    return {"device_ms": device_ms, "launches": launches, "busy": busy,
            "top": [(e.key, _device_us(e) / 1e3, e.count) for e in top]}


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def on_card(batch: dict, label: str) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()}
    log(f"  {label} batch: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in out.items())
        + ", tokens kept " + " + ".join(str(int(v.sum())) for k, v in out.items() if k.endswith("mask")))
    return out


def timed_steps(step, state, expected: dict, label: str, rows: int, seq: int):
    """Two warm-up steps, one step whose launches must be ``expected`` (every other kernel 0), then
    three windows of 5 steps with a host sync per step, as bench.py. ``step(state) -> (state,
    metrics)``. Returns the state and the result: the median ms per step and pairs/s (``rows``
    pairs a step), the windows, losses, the last step's metrics, the launches per step and the
    peak memory over all of it."""
    from pgica_tpu_torch.ops import _kernels

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, m = step(state)
    before = _kernels.launch_counts()
    state, m = step(state)
    after = _kernels.launch_counts()
    per_step = {k: after[k] - before[k] for k in after}
    if per_step != {**dict.fromkeys(per_step, 0), **expected}:
        raise AssertionError(f"{label}: one step launched {per_step}, expected {expected}")
    losses, windows = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(5):
            state, m = step(state)
            losses.append(float(m["loss"]))
        windows.append((time.perf_counter() - t) / 5)
    last = {k: float(v) for k, v in m.items()}
    if not all(math.isfinite(x) for x in losses + list(last.values())) or state.skipped:
        raise AssertionError(f"{label}: losses {losses}, last metrics {last}, skipped {state.skipped}")
    step_s = statistics.median(windows)
    r = dict(batch=rows, seq=seq, ms_per_step=step_s * 1e3, pairs_per_s=rows / step_s,
             windows_ms=[w * 1e3 for w in windows], losses=losses, metrics=last, launches_per_step=per_step,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"  {label} {rows} x {seq}: median {r['ms_per_step']:.1f} ms/step -> {r['pairs_per_s']:.1f} pairs/s (windows "
        f"of 5 steps: {', '.join(f'{w:.1f}' for w in r['windows_ms'])} ms/step); losses {losses[0]:.4f} .. "
        f"{losses[-1]:.4f} (all finite, 0 skipped); last step: " + ", ".join(f"{k} {v:.4g}" for k, v in last.items())
        + f"; peak {r['peak_mem_gib']:.2f} GiB; launches per step {per_step}")
    return state, r


def check_main_path(label: str, counts: dict, kernels) -> None:
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"the {label} path did not launch {missing}: {counts}")
    log(f"  {label} main-path launch counts: {counts}")


# ------------------------------------------------------------------ phase 6

# launches of one flagship stage-1 step: ViT (frozen, forward only) pre_ln + 12 x 2 + post_ln and
# its projection ln; text tower 24 x 2 + ln_f and its projection ln; the backward of every LN
# that trains; 12 + 24 attention forwards, 24 backwards
STAGE1_STEP_LAUNCHES = {"layernorm_fwd": 27 + 50, "flash_attn_fwd": 12 + 24, "layernorm_bwd": 51,
                        "flash_attn_bwd_dq": 24, "flash_attn_bwd_dkv": 24}


def phase_stage1(model) -> dict:
    from pgica_tpu_torch.ops import _kernels

    model._inference_cache = None  # frees serving's bf16 copy for training (a later request would recast it)
    torch.cuda.empty_cache()
    state, step, _ = stage1_trainer(model.module, lr=5e-5, warmup=10, total=1000)  # bench.py's optimizer
    rng = np.random.default_rng(0)
    batches = {name: on_card(b, name) for name, b in (("full-pad", stage1_batch(rng, 128, 128)),
                                                      ("bucketed", stage1_batch(rng, 128, 128, (8, 28))))}
    results = {}
    _kernels.reset_launch_counts()  # ---- the main path starts here
    for name, batch in batches.items():
        state, results[name] = timed_steps(lambda st: step(st, batch, 0), state, STAGE1_STEP_LAUNCHES,
                                           f"stage 1 {name}", *batch["caption_ids"].shape)
    main_counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("stage-1 (2 x (2 + 1 + 15) steps)", main_counts, STAGE1_STEP_LAUNCHES)
    for name, batch in batches.items():
        results[name]["profile"] = profiled(lambda: float(step(state, batch, 0)[1]["loss"]), f"stage-1 step {name}",
                                            results[name]["ms_per_step"])
    return dict(main_counts=main_counts, shapes=results)


# ------------------------------------------------------------------ phase 7

# launches of one flagship stage-2 step: policy and reference each run the ViT (pre_ln + 12 x 2 +
# post_ln, the projection ln; 12 attentions) and the decoder (cross_ln + 24 x 2 + ln_f; 24
# self-attentions; the cross-attention to the one vision token is plain PyTorch, as in JAX), and
# one fused-CE forward; the policy's backward runs the decoder's 50 LN and 24 attention
# backwards, the vision head's LN backward (the ViT backbone is frozen) and dh and dW
STAGE2_STEP_LAUNCHES = {"layernorm_fwd": 2 * (27 + 50), "flash_attn_fwd": 2 * (12 + 24), "layernorm_bwd": 51,
                        "flash_attn_bwd_dq": 24, "flash_attn_bwd_dkv": 24, "fused_ce_fwd": 2,
                        "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}


def check_dpo(label: str, r: dict) -> None:
    if not all(x > 0 for x in r["losses"]) or not r["metrics"]["policy_chosen_logp"] < 0:
        raise AssertionError(f"{label}: losses {r['losses']}, metrics {r['metrics']}")


def phase_stage2(model) -> dict:
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.ops import _kernels

    torch.cuda.empty_cache()
    ref = frozen_copy(model.module, torch.bfloat16)  # the trainer's default: the policy at stage-2 start, bf16
    state, step, _, _ = stage2_trainer(model.module, ref, lr=1e-5, warmup=10, total=1000)  # bench.py's optimizer
    rng = np.random.default_rng(0)
    batches = {name: on_card(b, name) for name, b in (("full-pad", stage2_batch(rng, 32, 128)),
                                                      ("bucketed", stage2_batch(rng, 32, 128, (8, 28))))}
    results = {}
    _kernels.reset_launch_counts()  # ---- the main path starts here
    for name, batch in batches.items():
        state, results[name] = timed_steps(lambda st: step(st, ref, batch), state, STAGE2_STEP_LAUNCHES,
                                           f"stage 2 {name}", *batch["preferred_ids"].shape)
        check_dpo(f"stage 2 {name}", results[name])
    main_counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("stage-2 (2 x (2 + 1 + 15) steps)", main_counts, STAGE2_STEP_LAUNCHES)
    for name, batch in batches.items():
        results[name]["profile"] = profiled(lambda: float(step(state, ref, batch)[1]["loss"]), f"stage-2 step {name}",
                                            results[name]["ms_per_step"])
    return dict(main_counts=main_counts, shapes=results)


# ------------------------------------------------------------------ phase 8

LLAMA_LAYERS = 4
# What phase 8 cuts from configs/siglip_llama8b.yaml, and why (PERF.md §4 has the arithmetic)
LLAMA_REDUCED = (
    f"each Llama-3-8B tower (text tower and caption decoder) runs {LLAMA_LAYERS} of its 32 layers at full width: "
    "stage 2 under the trainer's partition then holds the trained decoder (1.47 B parameters x 16 B of f32 "
    "master, gradient and two Adam moments = 23.5 GB), the frozen text tower and SigLIP in f32 (1.81 B x 4 B = "
    "7.2 GB) and the bf16 reference (3.28 B x 2 B = 6.6 GB), ~37 GB before activations and AdamW's temporaries; "
    "8 layers would hold ~58 GB, and the full 32-layer decoder's training state alone ~120 GB, past one 80 GB card",
    "serving samples with 1 beam where the config asks for 4: beam search is not ported",
    "every train step is an update (gradient accumulation 1 where the config has 4); warmup 500 of 1,000 steps",
)
# launches of one image encode (SigLIP pre_ln + 27 x 2 + post_ln and the projection ln; 27
# attentions) and of one decoder forward at decode (2 RMSNorms per block and ln_f; one attention
# per block; the cross-attention does not run at decode, decoder.py:16-21)
SIGLIP_ENCODE = {"layernorm_fwd": 1 + 2 * 27 + 1 + 1, "flash_attn_fwd": 27}
LLAMA_FORWARD = {"rmsnorm_fwd": 2 * LLAMA_LAYERS + 1, "flash_attn_fwd": LLAMA_LAYERS}
# one stage-1 step: the encode (frozen backbone, forward only), the text tower forward and
# backward, the text projection's ln, and both projection lns' backward
LLAMA_STAGE1_LAUNCHES = {"layernorm_fwd": SIGLIP_ENCODE["layernorm_fwd"] + 1,
                         "flash_attn_fwd": SIGLIP_ENCODE["flash_attn_fwd"] + LLAMA_LAYERS, "layernorm_bwd": 2,
                         "flash_attn_bwd_dq": LLAMA_LAYERS, "flash_attn_bwd_dkv": LLAMA_LAYERS,
                         "rmsnorm_fwd": LLAMA_FORWARD["rmsnorm_fwd"], "rmsnorm_bwd": LLAMA_FORWARD["rmsnorm_fwd"]}
# one stage-2 step: policy and reference each encode and run the decoder (cross_ln, the blocks,
# ln_f) and one fused-CE forward; the policy's backward runs the blocks' and ln_f's RMSNorm and
# attention backwards, cross_ln's and the vision projection ln's, and dh and dW
LLAMA_STAGE2_LAUNCHES = {"layernorm_fwd": 2 * (SIGLIP_ENCODE["layernorm_fwd"] + 1),
                         "flash_attn_fwd": 2 * (SIGLIP_ENCODE["flash_attn_fwd"] + LLAMA_LAYERS), "layernorm_bwd": 2,
                         "flash_attn_bwd_dq": LLAMA_LAYERS, "flash_attn_bwd_dkv": LLAMA_LAYERS, "fused_ce_fwd": 2,
                         "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1, "rmsnorm_fwd": 2 * LLAMA_FORWARD["rmsnorm_fwd"],
                         "rmsnorm_bwd": LLAMA_FORWARD["rmsnorm_fwd"]}
# phase 4's two architectures (2 layers per tower there)
FULL_WIDTH = {
    "gpt2": dict(vision="openai/clip-vit-base-patch32", text="gpt2-medium", vocab=GPT2_VOCAB, stage1_batch=8,
                 serving=SERVING_KERNELS, stage1=STAGE1_STEP_LAUNCHES, stage2=STAGE2_STEP_LAUNCHES,
                 stage2_frozen=None),
    "llama": dict(vision=SIGLIP, text=LLAMA, vocab=LLAMA_VOCAB, stage1_batch=4, serving=LLAMA_SERVING_KERNELS,
                  stage1=LLAMA_STAGE1_LAUNCHES, stage2=LLAMA_STAGE2_LAUNCHES, stage2_frozen="text_encoder"),
}


def phase_llama(tokenizer) -> dict:
    from pgica_tpu_torch.models.lm import init_kv_cache
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
    from pgica_tpu_torch.models.presets import get_text_config
    from pgica_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    model = PreferenceGuidedCaptioningModel(
        vision_model=SIGLIP, text_model=dataclasses.replace(get_text_config(LLAMA), num_layers=LLAMA_LAYERS),
        projection_dim=512, tokenizer=tokenizer, max_caption_length=512, vocab_size=LLAMA_VOCAB,
        dtype=torch.bfloat16, seed=0, dropout=0.1, device="cuda",
    )
    size = model.image_size
    images = np.random.default_rng(0).integers(0, 256, size=(8, size, size, 3), dtype=np.uint8)
    sample = dict(max_length=128, do_sample=True, top_p=0.9, temperature=0.8, repetition_penalty=1.1, early_stop=True)
    model.generate_captions(images[:1], **{**sample, "max_length": 4})  # the bf16 copy, cuBLAS handles
    torch.cuda.synchronize()
    log(f"  built (random weights, seed 0, f32 masters and a bf16 copy) and warmed in {time.perf_counter() - t0:.1f} "
        f"s: {sum(p.numel() for p in model.module.parameters()):,} parameters, image {size} px; reduced: "
        + "; ".join(LLAMA_REDUCED))

    def request(batch: int, seed: int) -> dict:
        before = _kernels.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        captions = model.generate_captions(images[:batch], seed=seed, **sample)
        seconds = time.perf_counter() - t  # ends in a device->host copy of the ids
        if len(captions) != batch or not all(isinstance(c, str) for c in captions):
            raise AssertionError(f"generate_captions returned {captions!r}")
        after = _kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        forwards = (launches.get("flash_attn_fwd", 0) - SIGLIP_ENCODE["flash_attn_fwd"]) // LLAMA_LAYERS
        want = {"layernorm_fwd": SIGLIP_ENCODE["layernorm_fwd"],
                "flash_attn_fwd": SIGLIP_ENCODE["flash_attn_fwd"] + LLAMA_FORWARD["flash_attn_fwd"] * forwards,
                "rmsnorm_fwd": LLAMA_FORWARD["rmsnorm_fwd"] * forwards}
        if launches != want or not 1 <= forwards <= sample["max_length"]:
            raise AssertionError(f"llama request, batch {batch}: launched {launches}, expected {want}")
        r = dict(batch=batch, seconds=seconds, decoder_forwards=forwards, ms_per_forward=seconds * 1e3 / forwards,
                 launches=launches, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  request batch {batch} x max_length {sample['max_length']} (sampled, early_stop): {seconds * 1e3:.1f} ms, "
            f"{batch / seconds:.2f} captions/s, {forwards} decoder forwards ({r['ms_per_forward']:.2f} ms each "
            f"with the encode spread over them), launches {launches} (as expected), peak {r['peak_mem_gib']:.2f} GiB")
        return r

    _kernels.reset_launch_counts()  # ---- the serving path starts here
    served = [request(batch, seed) for seed, batch in enumerate((1, 8, 1, 8))]  # the second of each is warm
    serving_counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("Llama serving", serving_counts, LLAMA_SERVING_KERNELS)
    module = model._inference_module()
    with torch.inference_mode():  # outputs: finite first-token logits of the expected shape
        emb = model.encode_image(images)["embeddings"]
        mask = torch.zeros(8, 2, dtype=torch.int32, device="cuda")
        mask[:, 0] = 1
        first, _ = module.decode_prefix(emb, init_kv_cache(module.decoder_config, 8, 2, torch.bfloat16, "cuda"), mask)
    if first.shape != (8, LLAMA_VOCAB) or not bool(torch.isfinite(first).all()):
        raise AssertionError(f"llama prefix logits: shape {tuple(first.shape)}, finite {bool(torch.isfinite(first).all())}")
    log(f"  prefix logits (8, {LLAMA_VOCAB}) bf16: all finite")
    serving_profile = profiled(lambda: model.generate_captions(images, seed=9, **sample), "batch-8 sampled request",
                               served[-1]["seconds"] * 1e3)

    model._inference_cache = None  # frees serving's bf16 copy for training (a later request would recast it)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    state, step, _ = stage1_trainer(model.module, lr=5e-5, warmup=500, total=1000)
    batch = on_card(stage1_batch(rng, 4, 512, image=size, vocab=LLAMA_VOCAB), "Llama stage-1")
    _kernels.reset_launch_counts()  # ---- the stage-1 path starts here
    state, stage1 = timed_steps(lambda st: step(st, batch, 0), state, LLAMA_STAGE1_LAUNCHES, "Llama stage 1", 4, 512)
    stage1_counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("Llama stage-1 (2 + 1 + 15 steps)", stage1_counts, LLAMA_STAGE1_LAUNCHES)
    stage1["profile"] = profiled(lambda: float(step(state, batch, 0)[1]["loss"]), "Llama stage-1 step",
                                 stage1["ms_per_step"])
    del state, step
    gc.collect()
    torch.cuda.empty_cache()

    ref = frozen_copy(model.module, torch.bfloat16)  # the trainer's reference: the policy at stage-2 start, bf16
    state, step, _, _ = stage2_trainer(model.module, ref, lr=1e-5, warmup=500, total=1000, frozen="text_encoder")
    batch = on_card(stage2_batch(rng, 2, 512, image=size, vocab=LLAMA_VOCAB), "Llama stage-2")
    _kernels.reset_launch_counts()  # ---- the stage-2 path starts here
    state, stage2 = timed_steps(lambda st: step(st, ref, batch), state, LLAMA_STAGE2_LAUNCHES, "Llama stage 2", 2, 512)
    stage2_counts = _kernels.launch_counts()  # ---- and ends here
    check_dpo("Llama stage 2", stage2)
    check_main_path("Llama stage-2 (2 + 1 + 15 steps)", stage2_counts, LLAMA_STAGE2_LAUNCHES)
    stage2["profile"] = profiled(lambda: float(step(state, ref, batch)[1]["loss"]), "Llama stage-2 step",
                                 stage2["ms_per_step"])
    return dict(served=served, serving_profile=serving_profile, stage1=stage1, stage2=stage2,
                counts={"llama_serving": serving_counts, "llama_stage1": stage1_counts, "llama_stage2": stage2_counts})


# ------------------------------------------------------------------ main


FCE_SHAPE = f"({4 * 511}, 4096) x ({LLAMA_VOCAB}, 4096)"
# name -> (source, the TPU kernel it replaces, the shape and type of the Llama stage-2 step (phase 8)
# that its summary row reports: the one most of that step's launches take)
KERNEL_META = {
    "layernorm_fwd": ("pgica_tpu_torch/csrc/layernorm_fwd.cu", "pgica_tpu/ops/layernorm.py:75", "(1460, 1152)",
                      "bfloat16"),
    "flash_attn_fwd": ("pgica_tpu_torch/csrc/flash_attn_fwd.cu", "pgica_tpu/ops/flash_attention.py:34",
                       "(32, 730, 730, 72)", "bfloat16"),
    "layernorm_bwd": ("pgica_tpu_torch/csrc/layernorm_bwd.cu", "pgica_tpu/ops/layernorm.py:88", "(2048, 4096)",
                      "bfloat16"),
    "flash_attn_bwd_dq": ("pgica_tpu_torch/csrc/flash_attn_bwd.cu", "pgica_tpu/ops/flash_attention.py:130",
                          "(128, 512, 512, 128)", "bfloat16"),
    "flash_attn_bwd_dkv": ("pgica_tpu_torch/csrc/flash_attn_bwd.cu", "pgica_tpu/ops/flash_attention.py:81",
                           "(128, 512, 512, 128)", "bfloat16"),
    "fused_ce_fwd": ("pgica_tpu_torch/csrc/fused_ce.cu", "pgica_tpu/ops/fused_ce.py:60", FCE_SHAPE,
                     "h bfloat16, W float32"),
    "fused_ce_bwd_dh": ("pgica_tpu_torch/csrc/fused_ce_bwd.cu", "pgica_tpu/ops/fused_ce.py:108", FCE_SHAPE,
                        "h bfloat16, W float32"),
    "fused_ce_bwd_dw": ("pgica_tpu_torch/csrc/fused_ce_bwd.cu", "pgica_tpu/ops/fused_ce.py:134", FCE_SHAPE,
                        "h bfloat16, W float32"),
    "rmsnorm_fwd": ("pgica_tpu_torch/csrc/rmsnorm_fwd.cu", "pgica_tpu/ops/layernorm.py:119", "(2048, 4096)",
                    "bfloat16"),
    "rmsnorm_bwd": ("pgica_tpu_torch/csrc/rmsnorm_bwd.cu", "pgica_tpu/ops/layernorm.py:127", "(2048, 4096)",
                    "bfloat16"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only", file=sys.stderr)
        return 2
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.ops import _kernels

    t_start = time.perf_counter()
    log("== phase 1: device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible; {smi}")

    log("== phase 2: build")
    t = time.perf_counter()
    built = _kernels.build()
    log(f"  built {sorted(built) or 'nothing (already built)'} in {time.perf_counter() - t:.1f} s "
        f"(per library: {', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or '-'})")

    tokenizer = CaptionTokenizer()
    phases = {}

    def phase(name: str, fn, *args):
        t = time.perf_counter()
        log(f"== {name}")
        out = fn(*args)
        phases[name.split(":")[0]] = time.perf_counter() - t
        return out

    kernels = phase("phase 3: kernels vs plain on the card", phase_kernels)
    for arch in FULL_WIDTH:
        phase(f"phase 4 ({arch}): full width, 2 layers, f32: card (kernels) vs CPU (plain)", phase_full_width,
              tokenizer, arch)
        gc.collect()
    served = phase("phase 5: serving (flagship, bf16, caption requests)", phase_slice, tokenizer)
    trained = phase("phase 6: the slice, stage-1 training (flagship, bf16 over f32 masters)", phase_stage1,
                    served["model"])
    dpo = phase("phase 7: the slice, stage-2 DPO training (flagship, bf16 over f32 masters, bf16 reference)",
                phase_stage2, served.pop("model"))
    gc.collect()  # the GPT-2 flagship is free now
    torch.cuda.empty_cache()
    llama = phase(f"phase 8: the Llama slice (SigLIP so400m + Llama-3-8B, {LLAMA_LAYERS} of 32 layers, bf16 over f32 "
                  "masters): serving, stage 1, stage 2", phase_llama, tokenizer)
    log(f"  total {time.perf_counter() - t_start:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items())
        + ")")

    paths = {"serving": served["main_counts"], "stage1": trained["main_counts"], "stage2": dpo["main_counts"],
             **llama["counts"]}
    summary = []
    for name, (source, replaces, shape, dtype) in KERNEL_META.items():
        # times at the Llama stage-2 shape in the type the path gives it; the error is the worst over
        # the bf16 shapes timed
        bf16 = [r for r in kernels[name] if r["dtype"].startswith(dtype.split(",")[0]) and "ms" in r]
        at = next(r for r in bf16 if r["shape"] == shape and r["dtype"] == dtype)
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": llama["counts"]["llama_stage2"][name],
            "launches_by_path": {path: counts.get(name, 0) for path, counts in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in bf16),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"], "shape": shape, "dtype": dtype,
            "inputs": at["input_sets"] if isinstance(at["input_sets"], str)
            else f"{at['input_sets']} input sets rotating through > 2x L2 (cold), median of 21 bursts of 20",
        })
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
