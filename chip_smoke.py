#!/usr/bin/env python3
"""Drive the PyTorch port (pgica_tpu_torch) on one NVIDIA H100 and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (each prints lines of its own; any failure raises and the script
exits non-zero):

1. Device: the card's name and power limit; TF32 off for matmuls and cuDNN.
2. Build: the hand-written CUDA kernels from pgica_tpu_torch/csrc/ into the
   git-ignored build/pgica_tpu_torch/ (one nvcc per source, in parallel).
3. Kernels vs plain: each kernel against its plain PyTorch version on the
   card at the serving shapes, bf16 and f32, with its time (CUDA events,
   median of 21 bursts, on input sets that rotate through more than twice
   the L2, so they come from HBM), the plain version's, one PyTorch call's
   as a yardstick (never used by the port) and the bound from the bytes and
   flops that the inputs need at HBM rate and peak rate.
4. Full path vs plain: ViT-B/32 and GPT-2 Medium at full width, 2 layers
   each, batch 2, f32 — the same seeded model on the card (kernels) and on
   the CPU (plain versions): embeddings, prefix and step logits, 16 greedy
   tokens.
5. The slice: the flagship (ViT-B/32 + GPT-2 Medium, 24 layers, vocab
   50,262) in bf16 with random seeded weights answers caption requests
   through ``generate_captions`` — batch 1, 8 and 32 with max_length 32 and
   early_stop (as the caption service calls it), then the batch 32 x 64
   fixed-length greedy decode of the eval benchmark (median of 5 after a
   warm-up). Launch counts are reset just before and read just after.

The second-to-last line is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``. Without a card, or without the package
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense; f32 off the tensor cores
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 1e-2)}  # (atol, rtol) on y / o
ATTN_F32_ATOL = 2e-5
GPT2_VOCAB = 50257 + 5  # GPT-2's vocab plus the five specials, as bench.py
SLEEP_CYCLES = 20_000_000  # ~10 ms: keeps the card busy while the host queues a burst


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
    y, mu, rstd = layer_norm_fwd(x, w, b, 1e-5)
    torch.cuda.synchronize()
    ry, rmu, rrstd = layer_norm_ref(x, w, b, 1e-5)
    atol, rtol = TOL[dtype]
    err = check_close(f"layernorm {rows}x{hidden} {dname(dtype)} y", y, ry, atol, rtol)
    check_close("layernorm mu", mu, rmu, 1e-5, 0.0)
    check_close("layernorm rstd", rstd, rrstd, 0.0, 1e-5)
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
    # which) or that a row with no kept key averages over.
    visible = torch.ones(sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        visible = visible.tril()
    keep = visible[None].expand(b, sq, sk).clone()
    if valid is not None:
        keep &= (torch.arange(sk, device="cuda")[None, :] < valid[:, None])[:, None, :]
    need = keep | (visible[None] & ~keep.any(dim=2, keepdim=True))
    kv_rows = int(need.any(dim=1).sum())  # over batch rows; every head reads them
    esize = q.element_size()
    nbytes = esize * (2 * b * h * sq * d + 2 * h * kv_rows * d) + 4 * b * h * sq
    nbytes += 0 if bias is None else 4 * b * sk
    flops = 4 * d * h * int(keep.sum())  # QK^T and PV, 2 flops per MAC
    n_sets = max(1, math.ceil(100e6 / nbytes))  # > 2x L2: inputs arrive from HBM
    sets = [attention_inputs(b, h, sq, sk, d, dtype, valid, gen) for _ in range(n_sets)]
    # the yardstick: one SDPA call with the same key bias (+ causal) as a float mask
    lib_sets = []
    for sq_, sk_, sv_, sb_ in sets:
        mask = None
        if sb_ is not None or causal:
            mask = torch.zeros(b, 1, sq, sk, device="cuda") if sb_ is None else sb_[:, None, None, :].expand(b, 1, sq, sk).clone()
            if causal:
                mask = mask.masked_fill(~torch.ones(sq, sk, dtype=torch.bool, device="cuda").tril(), -1e9)
            mask = mask.to(dtype)
        lib_sets.append((sq_, sk_, sv_, mask))
    out.update(
        ms=time_ms(lambda *a: flash_attention_fwd(*a, causal), sets),
        plain_ms=time_ms(lambda *a: flash_attention_ref(*a, causal), sets),
        library_ms=time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_), lib_sets),
        input_sets=n_sets,
        **bound(nbytes, flops, dtype),
    )
    return out


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"layernorm_fwd": [], "flash_attn_fwd": []}
    for dtype in (torch.bfloat16, torch.float32):
        for rows, hidden, where in ((32 * 50, 768, "ViT blocks"), (32, 512, "projection ln"),
                                    (32, 1024, "decoder, per step")):
            r = layernorm_case(rows, hidden, dtype, gen)
            r["where"] = where
            results["layernorm_fwd"].append(r)
            log(f"  layernorm {r['shape']} {r['dtype']} ({where}): max_abs_err {r['max_abs_err']:.3e} "
                f"(atol {r['atol']}, rtol {r['rtol']}); kernel_ms {r['ms']:.5f} plain_ms {r['plain_ms']:.5f} "
                f"library_ms {r['library_ms']:.5f} bound_ms {r['bound_ms']:.6f} ({r['bound_by']}; "
                f"{r['input_sets']} input sets)")
        # ragged and general cases for coverage of every template (not timed)
        r = layernorm_case(7, 2000, dtype, gen, timed=False)
        log(f"  layernorm (7, 2000) {dname(dtype)} loop path: max_abs_err {r['max_abs_err']:.3e}")
        decode_valid = torch.full((32,), 41, device="cuda")  # step 40 of 64: keys 0..40 kept
        ragged = torch.tensor([77, 50], device="cuda")
        for name, shape, causal, valid in (
            ("vit", (32, 12, 50, 50, 64), False, None),
            ("decode", (32, 16, 1, 65, 64), False, decode_valid),
            ("causal_ragged", (2, 16, 77, 77, 64), True, ragged),
        ):
            r = attention_case(name, *shape, causal, valid, dtype, gen)
            results["flash_attn_fwd"].append(r)
            log(f"  flash {name} {r['shape']} {r['dtype']}: max_abs_err {r['max_abs_err']:.3e} "
                f"(atol {r['atol']}, rtol {r['rtol']}); kernel_ms {r['ms']:.5f} plain_ms {r['plain_ms']:.5f} "
                f"library_ms {r['library_ms']:.5f} bound_ms {r['bound_ms']:.6f} ({r['bound_by']}; "
                f"{r['input_sets']} input sets)")
        for d in (16, 32, 128):  # the other head dims, a fully masked batch row, ragged edges
            r = attention_case(f"d{d}", 2, 2, 33, 40, d, d == 32, torch.tensor([0, 29], device="cuda"),
                               dtype, gen, timed=False)
            log(f"  flash d={d} (4, 33, 40, {d}) {dname(dtype)} masked row: max_abs_err {r['max_abs_err']:.3e}")
    return results


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


def phase_full_width(tokenizer) -> None:
    from pgica_tpu_torch.generation.decode import generate
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
    from pgica_tpu_torch.models.presets import get_text_config, get_vision_config
    from pgica_tpu_torch.ops import _kernels

    kwargs = dict(
        vision_model=dataclasses.replace(get_vision_config("openai/clip-vit-base-patch32"), num_layers=2),
        text_model=dataclasses.replace(get_text_config("gpt2-medium"), num_layers=2),
        projection_dim=512, tokenizer=tokenizer, max_caption_length=128, vocab_size=GPT2_VOCAB,
        dtype=torch.float32, seed=0,
    )
    cuda, cpu = (PreferenceGuidedCaptioningModel(device=dev, **kwargs) for dev in ("cuda", "cpu"))
    images = np.random.default_rng(1).integers(0, 256, size=(2, 224, 224, 3), dtype=np.uint8)
    _kernels.reset_launch_counts()
    emb_g, logits_g = decode_logits(cuda, images)
    counts = _kernels.launch_counts()
    emb_c, logits_c = decode_logits(cpu, images)
    err = check_close("full width: embeddings", emb_g, emb_c, 1e-3, 0.0)
    log(f"  encode_image embeddings (2, 512): max_abs_err {err:.3e} (atol 1e-3)")
    for i, (g, c) in enumerate(zip(logits_g, logits_c)):
        name = "prefix" if i == 0 else f"step {i}"
        err = check_close(f"full width: {name} logits", g, c, 1e-3, 0.0)
        log(f"  {name} logits (2, {GPT2_VOCAB}): max_abs_err {err:.3e} (atol 1e-3)")
    if min(counts.values()) == 0:
        raise AssertionError(f"full width: a kernel was not launched on the card: {counts}")
    log(f"  kernel launches on the card: {counts}")
    ids = []
    for model, emb in ((cuda, emb_g.cuda()), (cpu, emb_c)):
        ids.append(generate(model.module, emb, eos_token_id=tokenizer.eos_token_id,
                            pad_token_id=tokenizer.pad_token_id, max_length=16).cpu())
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError(f"full width: greedy tokens differ:\n{ids[0]}\n{ids[1]}")
    log(f"  greedy tokens, 16 steps: identical on card and CPU ({ids[0].tolist()})")


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
        launches = {k: after[k] - before[k] for k in after}
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
    main_counts = _kernels.launch_counts()  # ---- and ends here
    if min(main_counts.values()) == 0:
        raise AssertionError(f"the main path did not launch every kernel: {main_counts}")
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

    profile = profile_decode(model, images, median_s * 1e3)
    return dict(main_counts=main_counts, served=served, bench=bench, median_s=median_s,
                sync_ms_per_step=(es - fl) / 31 * 1e3, profile=profile)


def _device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)


def profile_decode(model, images, unprofiled_ms: float) -> dict:
    """Kernel time of one 32 x 64 greedy call from torch.profiler, and the busy share.

    The busy share divides the kernels' device time by the call's wall time
    measured without the profiler (the profiler slows the host, not the
    kernels).
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.generate_captions(images, max_length=64)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(_device_us(e) for e in kernels) / 1e3
    if device_ms <= 0:
        log("  profiler: no device time recorded (device busy share not measured)")
        return {"device_ms": None}
    launches = sum(e.count for e in kernels)
    busy = device_ms / unprofiled_ms
    log(f"  profiler, one 32 x 64 greedy call: {launches} kernel launches, kernel time {device_ms:.1f} ms "
        f"of {unprofiled_ms:.1f} ms wall (unprofiled median) -> device busy {100 * busy:.1f}%, "
        f"idle {100 * (1 - busy):.1f}%")
    top = sorted(kernels, key=_device_us, reverse=True)[:10]
    for e in top:
        log(f"    {_device_us(e) / 1e3:9.2f} ms  {e.count:6d} x  {e.key[:100]}")
    return {"device_ms": device_ms, "launches": launches, "busy": busy,
            "top": [(e.key, _device_us(e) / 1e3, e.count) for e in top]}


# ------------------------------------------------------------------ main


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
        f"{torch.cuda.device_count()} visible")

    log("== phase 2: build")
    t = time.perf_counter()
    built = _kernels.build()
    log(f"  built {sorted(built) or 'nothing (already built)'} in {time.perf_counter() - t:.1f} s "
        f"(per library: {', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or '-'})")

    log("== phase 3: kernels vs plain on the card")
    kernels = phase_kernels()

    tokenizer = CaptionTokenizer()
    log("== phase 4: full width, 2 layers, f32: card (kernels) vs CPU (plain)")
    phase_full_width(tokenizer)

    log("== phase 5: the slice (flagship, bf16, caption requests)")
    served = phase_slice(tokenizer)

    meta = {
        "layernorm_fwd": ("pgica_tpu_torch/csrc/layernorm_fwd.cu", "pgica_tpu/ops/layernorm.py:75",
                          "(32, 1024)"),
        "flash_attn_fwd": ("pgica_tpu_torch/csrc/flash_attn_fwd.cu", "pgica_tpu/ops/flash_attention.py:34",
                           "(512, 1, 65, 64)"),
    }
    summary = []
    for name, (source, replaces, main_shape) in meta.items():
        # times at the shape the main path launches most (the decoder's, per
        # step) in bf16; the error is the worst over the bf16 serving shapes
        bf16 = [r for r in kernels[name] if r["dtype"] == "bfloat16"]
        at = next(r for r in bf16 if r["shape"] == main_shape)
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": served["main_counts"][name],
            "max_abs_err": max(r["max_abs_err"] for r in bf16),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"],
            "inputs": "cold: rotating sets > 2x L2, bound at HBM rate",
        })
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
