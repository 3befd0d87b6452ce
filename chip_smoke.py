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
   its time (CUDA events, median of 5 bursts, on input sets that rotate
   through more than twice the L2, so they come from HBM; the fused
   linear-CE kernels, tens to hundreds of ms a call over a W larger than the
   L2: median of 5 single calls; the flash decode forward also at the
   4-beam shapes of phases 5 and 8), the plain version's, one PyTorch call's
   as a yardstick (never used by the port; for fused CE two calls, F.linear
   and F.cross_entropy) and the bound from the bytes and flops that the
   inputs need at HBM rate and peak rate (fused CE: the bf16 tensor-core peak,
   one pass per product, for every type pair), and the launches one
   LayerNorm call makes with the gaps between them. It first reports the
   tensor-core kernels' registers and spills (ptxas) and their HMMA/HGMMA/
   IMMA, and the f32 register-tiled instances' (flash_attn_fwd_f32 and the
   f32 backward; a spill fails), and times the flash forward kernels either
   side of each dispatch threshold; its float32 pass times 5 bursts of 5
   (bf16: 7 of 20), the f32 forward's register-tiled kernel in turns with
   the CUDA-core kernel it replaced (CUDA cores, tiled, tiled, CUDA cores),
   and checks both at every head dim with a batch row that keeps no key.
   Each flash forward is held bit-equal over two runs.
4. Full path vs plain, for each architecture at full width, f32 — 2 layers
   a tower for ViT-B/32 + GPT-2 Medium, then 1 for SigLIP so400m + Llama-3-8B
   (RoPE, GQA, SwiGLU, RMSNorm; vocab 128,256): the same seeded model on
   the card (kernels) and on the CPU (plain versions): embeddings, prefix
   and step logits, 16 greedy tokens and 16 tokens of 4-beam search; then
   two stage-1 and two stage-2 (DPO) train steps (dropout 0): the
   gradients, loss, reward metrics, gradient norm and every trained
   parameter; a stage-1 gradient with augmentation and activation
   checkpointing on (card vs CPU), and on the card with dropout, with
   checkpointing off against on (bit for bit). For GPT-2 also the two
   metrics that run the model, on 8 seeded images and caption pairs:
   BERTScore's text-tower route and CLIP-Score (card vs CPU, 1e-4).
   Beside phase 4 a process of its own shows that a graphed eval step
   whose body reads a value back to the host raises at its capture, at
   each call, with no eager fall-back (``failed_capture``).
5. Serving: the flagship (ViT-B/32 + GPT-2 Medium, 24 layers, vocab 50,262)
   in bf16 with random seeded weights answers caption requests through
   ``generate_captions`` — batch 1, 8 and 32 with max_length 32 and
   early_stop (as the caption service calls it), the configs'
   generate_config (4 beams, length penalty 1, repetition penalty 1.1,
   max_length 128, early_stop) at batch 8 and 32, then the batch 32 x 64
   fixed-length greedy decode of the eval benchmark (median of 5 after a
   warm-up). Every step replays a CUDA graph, so the host counts the
   encode and the prefix (plus, at a shape's first call, a warm-up step and
   the capture, or for beams two of each: the odd- and the even-step graph),
   and the profiler counts the replays' kernels; the eager step times the
   same eval call beside it, with the same ids. Each 4-beam batch is also
   searched eagerly (``graphs=None``), timed beside a graphed search, with
   the same ids, and the first replayed beam step's logits are held
   bit-equal to the eager step's. The encode of a request replays its batch
   shape's graph (captured at the shape's first call). Then the wrapper's
   three entry points at batch 16 (x 32 tokens), each a CUDA graph per
   shape as JAX jits them: ``__call__`` in each mode (generation with
   labels), ``encode_image`` and ``compute_similarity``, a new key's first
   call and a replay bit-equal to the same function run eagerly, the graph
   holding the eager run's launches, ms graphed and eager.
6. Stage 1, the slice: the same flagship (bf16 over f32 masters, frozen
   ViT, dropout 0.1) takes stage-1 steps through ``make_stage1_train_step``
   at bench.py's shapes: batch 128 x seq 128 with every token kept, and
   caption lengths 8-28 cut to bucket 32 by ``bucket_batch``. For each
   shape, three steps of the eager step and three of its CUDA graphs
   (``training/graphs.py:GraphedTrainStep``, the trainer's route on the
   card: the first step eager and captured, then replays) from one
   starting state must leave every trained leaf, Adam moment and counter
   with the same bits; then ms a step graphed (the median of three 5-step
   windows) and eager (of two 3-step windows), each graph's capture
   seconds and pool, and the busy share of one profiled step of each. A
   NaN batch through a replay must add one to ``skipped`` and keep every
   other bit; gradient accumulation 4 with a NaN batch at micro-step 2
   must give the eager step's bits through both graphs (accumulate,
   update). At each shape the stage's eval step through ``GraphedEvalStep``
   (the trainer's validation: its graphs in the train graphs' pool) gives
   the eager eval step's metrics bit for bit, its graph holding the eager
   step's forward launches; ms an eval call graphed and eager and the busy
   share of each; then a train replay after the eval replays is bit-equal
   to the eager step (the eval graphs overwrote nothing it keeps).
7. Stage 2, the slice: the same flagship takes DPO steps through
   ``make_stage2_train_step`` against a frozen bf16 copy of itself (the
   trainer's reference), with bench.py's stage-2 optimizer, at batch 32
   pairs x 128 with every token kept, and with chosen and rejected lengths
   8-28 cut to bucket 32; the chosen and rejected captions differ. Graphed
   against eager, timing and profiles as in phase 6; the launches of one
   eager step and the kernels each graph holds are asserted. The eval
   steps as in phase 6 (2 fused-CE forwards a call), and a reference-free
   one (1).
8. The Llama slice: the GPT-2 flagship is freed, then the SigLIP so400m +
   Llama-3-8B configuration of configs/siglip_llama8b.yaml is built once at
   full width in bf16 over f32 masters, with 4 of each Llama tower's 32
   layers (``LLAMA_REDUCED`` says why) and random seeded weights. It serves
   caption requests through ``generate_captions`` at batch 1 and 8 with the
   config's generate_config (4 beams, max_length 128, repetition penalty
   1.1; the beam graphs checked against the eager search as in phase 5),
   takes stage-1 steps at 4 x 512 and DPO steps at 2 pairs x 512
   under the JAX trainer's partitions, graphed against eager, timed and
   profiled as in phase 6 (the graphs hold the RMSNorm backward), with
   every request's and step's launches asserted, and each stage's eval step
   graphed against eager as in phase 6.
9. The training entry point: ``pgica_tpu_torch.scripts.train.run`` on
   configs/default.yaml (the GPT-2 flagship at full width and vocab, bf16,
   activation checkpointing, gradient accumulation 4, augmentation), on
   seeded JPEG files read through the config's datasets (uint8 batches,
   normalized on the card), changed as ``PHASE9_REDUCED`` says: stage 1,
   stage 2 with its bf16 reference, validation, checkpoints and the best
   model's reload; every train step runs as CUDA graphs (the trainer's
   route on the card), an eager step only at each key's first sighting
   and at least one replay a stage, and so does each stage's validation
   (its eval graphs in the train graphs' pool; 16 validation images, two
   batches of one key); a second trainer resumes stage 1 from
   its mid-epoch autosave through ``run`` and must end bit-identical to the
   uninterrupted run; then ``generate_captions`` must serve the trained
   masters. Per stage: ms per micro-step (CUDA events around each step) and
   per update, device busy share (kernel time over the profiled window's
   wall, synchronized at both ends, the autosave left out), peak memory,
   the host's time inside the profiled steps by operator, the graphs'
   captures and pool; per checkpoint bytes and seconds. Phase 11b runs on
   its files before they are deleted.

10. Serving with CUDA graphs. 10a, right after phase 7: generate_captions
   on the trained flagship recasts the bf16 copy, captures its graph anew
   and equals the eager step. In phase 8, on the Llama slice (slots 8), and
   at the end on configs/default.yaml's GPT-2 flagship through
   ``scripts/serve.py``'s services (slots 16, chunk 8, max_length 32): the
   graphed chunk against the eager one (first-chunk logits bit-equal, ids
   equal), the batch path's graphed step against the eager one (greedy
   logits bit-equal, sampled ids equal), the kernels each graph holds (its
   wrappers' launches under capture) and those one replay runs (the
   profiler's device kernel names, which may fall short by a record the
   tracer lost, never above), the engine's
   captions equal generate_captions' for requests in staggered bursts; for
   GPT-2 both services answer /healthz and a JPEG /caption over HTTP on
   127.0.0.1, and a seeded Poisson arrival of 128 requests at 100/s runs
   through the continuous (graphed) and the batch schedulers: latency
   p50/p95, captions/s (not profiled: one profiled run hung), each
   graph's capture time and pool. Each engine's admission buckets are
   graphs too: each is held against the eager admission (every state
   tensor's first S rows bit-equal, padding ids in the bucket), and for
   GPT-2 sampled requests sent one at a time through a graphed and an eager
   engine under one seed give the same token ids. For GPT-2 also: ``CapturedSteps``
   captures while the cyclic collector, set to run inside the capture,
   frees a dead graph (a bare ``torch.cuda.graph`` there, in a process of
   its own, is voided: information).

11. Evaluation. 11a, right after 10a, on the trained flagship:
   ``EvaluationRunner`` with configs/default.yaml's evaluation section (4
   beams, max_length 128, no early_stop) and targets over 256 dummy
   captioned images at batch 32 (8 timed requests after an untimed
   warm-up, which captures the beam graphs): every metric finite, the
   captions equal ``generate_captions``' own on the same batches, the
   launches equal those reckoned from the requests (each encode after the
   batch shape's first a graph replay), BERTScore's eager text-tower
   forwards and CLIP-Score's similarity graph (no backward kernel); captions/s, latency, generation against metric seconds, the
   busy share of one profiled request (whose 127 steps the profiler
   counts as graph replays), and which optional packages the metrics found. 11b, inside phase 9: ``run_evaluation.main`` (both
   datasets, phase 9's stage-1 best model as the CLIP judge, the restored
   masters bit-equal to the checkpoint), ``evaluate.main`` (test split)
   and ``predict.main`` (one JPEG, then a folder of 16), each's wall time.

12. Int8 decode and LoRA. 12a, right after phase 3: both int8 entry points
   of csrc/q8_matmul.cu (W8A8: one launch, the row quantizer fused into the
   int8 tensor-core product; weight-only: bf16 dequantized in registers,
   tensor cores, and f32 on CUDA cores) against their plain versions at the
   decode paths' shapes (GPT-2 Medium at 1, 8, 16, 32 and 128 rows,
   Llama-3-8B at 8) and ragged tails: the row scales and the f32 W8A8 output
   bit-equal (its epilogue is exact arithmetic on the int32 sums), the bf16
   output 0 ulp from the plain one, weight-only within the bf16 tolerance; each bf16
   shape timed with its bound and tiling, at 16, 32 and 128 rows and Llama's
   also the plain version,
   torch._int_mm (where its shape rules allow it) and F.linear on the bf16
   dequantized weight. 12b: the int8 twin of phase 4's 2-layer f32 GPT-2
   flagship, card against CPU (1e-4, inside phase 4); after 11a, on the
   trained flagship in both modes, greedy requests at batch 1, 8 and 32 and
   a 4-beam batch 8 through generate_captions, the engine's chunk replay,
   each graph holding the int8 kernels (the beam and admission graphs too;
   each admission bucket held against the eager one), beside the bf16
   figures; in phase 8
   a greedy batch-8 request on the Llama slice in bf16 and both modes. 12c,
   inside phase 9 on its JPEGs: the training CLI on configs/lora.yaml at
   full width, 4 layers a tower (``LORA_REDUCED``): adapters only, the base
   bit-unchanged, fused-CE dW never launched, the best checkpoint merged at
   the end and served through predict.main.

13. The host data path's rest, offline import, fused NT-Xent, cross-attention
   at decode. 13a, inside phase 9 after 12c, on its JPEGs and captions: the
   dataset BPE of ``create_tokenizer`` (trained, saved, read back from its
   cache), the native encoder's ids against the Python path's over the
   captions and a non-ASCII set, the grain loader (4 spawned workers)
   against the thread loader over 2 epochs and after ``iter_batches(3)``
   with one pool, then the training CLI with both at 4 layers a tower
   (``PHASE13_REDUCED``):
   finite losses, the backward launches its steps need, ms per micro-step
   and the input-wait share. 13b, after phase 10: seeded HF-layout
   checkpoints of CLIP ViT-B/32's vision tower and GPT-2 Medium (50,257
   rows) through ``load_pretrained_towers`` into the bf16 flagship: every
   parameter bit-equal to its HF tensor, the appended rows kept, the serving
   copy recast, greedy ids equal to a second model's loaded through
   ``load_jax_params``; the load's GB/s. 13c: ``ntxent_loss_fused`` at
   (128, 512) f32 and ragged 100 and 37 rows against ``ntxent_loss`` on the
   card (2 launches of each fused-CE kernel a forward and backward), timed
   against it; the fused-CE kernels at that shape, the flash forward at
   cross-attention's decode shape and the LN forward at ``cross_ln``'s,
   each against its plain version and timed. 13d, inside phase 4's GPT-2:
   ``cross_attend_at_decode`` card against CPU, its launches a step.
14. Data parallelism on torch.distributed, after 13c (the parent holds no
   model then). NCCL refuses two ranks on one device, so 14a and 14b spawn
   two gloo ranks (``spawn``, a file store, each joined with a time limit)
   that share the card. 14a: phase 4's GPT-2 flagship (f32, 2 layers a
   tower, dropout 0) takes two stage-1 and two stage-2 steps of a global
   batch of 8 (4 a rank) in each mode (replicated, ZeRO-1, ZeRO-3 with the
   reference sharded), held to the same steps of one process on the whole
   batch: metrics at rtol 1e-5 (atol 1e-5), parameters by the loose-share
   rule, the masters bit-identical over the ranks after every step, each
   rank's shard and Adam bytes equal to those reckoned from the parameter
   count; then ``ntxent_loss_fused`` with global negatives ((128, 512) a
   rank against (256, 512) gathered) against ``ntxent_loss`` with them, and
   the fused-CE kernels timed at that shape. 14b: ``scripts.train.run`` on
   configs/default.yaml at full width and vocab, 2 layers a tower, bf16,
   ``mesh.data: 2``,
   ZeRO-1 (stage 1) and ZeRO-3 with ``model.scan_layers`` (stage 2) in one
   pair of ranks (``PHASE14_REDUCED``): step walls, peaks, checkpoint and
   write-call bytes a rank, rank 0's busy share, rank 0's checkpoint
   against the gathered parameters. 14c, beside them: ``python -m
   torch.distributed.run --nproc_per_node=1 -m pgica_tpu_torch.scripts.train``
   on configs/smoke.yaml for 2 steps, the process group NCCL.
15. Tensor and context parallelism, after phase 14, in two gloo ranks that
   share the card. 15a: ``ppermute`` (value and the inverse permutation's
   gradient), ``copy_to``, ``reduce_from`` and ``gather_from`` on CUDA
   tensors. 15b: configs/scaled_vitl_gpt2large.yaml's towers at full
   width (ViT-L/14, GPT-2 Large, vocab 50,262), 2 layers a tower, f32, cut
   over model 2, take two stage-1 and two stage-2 updates of the whole
   batch (8, and 8 pairs, x 128) held to one process as 14a's are; each
   rank's heads (8, 10, cross 4), its 25,131 rows of ``wte``, the fused-CE
   launches of a stage-2 step (2, 1, 1) and half the cut bytes asserted.
   15c: the fused-CE kernels on a model-2 rank's (25,131, 1,280) block of
   the vocab and a model-4 rank's padded (12,566, 1,280) block, targets
   of the whole vocab (most outside the block), the backward on the global
   lse, against their plain versions, timed. 15d: the flagship (2 layers,
   f32) sequence-sharded over seq 2, two DPO updates against one process;
   ``ring_attention`` forward and backward against plain attention. 15e:
   ``scripts.train.run`` on configs/default.yaml (stage 2, seq 2), 2
   layers a tower (``PHASE15_REDUCED``): step walls, peaks, rank 0's busy
   share.
16. FSDP at rest, after phase 15, in four gloo ranks that share the card.
   16a: configs/scaled_vitl_gpt2large.yaml's towers as 15b has them, cut
   over model 2 and then fsdp 2 (``shard_fsdp``: every leaf the rules cut
   over fsdp is the rank's block, gathered a block at a time), two stage-1
   and two stage-2 updates on each rank's rows (4 of the 8), held to 15b's
   one process: metrics within 1e-5 relative (+1e-5), fewer than 0.01% of
   the parameters beyond 1e-5; each rank's parameter and Adam bytes
   asserted equal to the rule table's reckoning (``spec_bytes``); each
   step's flash, LN and fused-CE launches against one process's; step ms,
   peak and rank 0's busy share. 16b: ``scripts.train.run`` on that config
   with ``mesh.fsdp: 2`` over its own model 2, 2 layers a tower, both
   stages (``PHASE16_REDUCED``), its checkpoint loaded into one process
   bit-equal to the ranks' gathered parameters. Then one line, nothing
   allocated: configs/siglip_llama8b.yaml at full depth on its own fsdp 2 x
   model 4, a rank's parameter and Adam bytes from the rule table beside
   the card's 80 GB.

Cut to keep the run inside its limit: phase 4's Llama slice runs 1 layer a
tower, 2-row stage-1 and 1-pair stage-2 steps against a rolled copy of the
CPU model as the reference, and replays its optimizer without the token
embedding and the MLP matrices (``PHASE4_REDUCED``), phase 11a 4 timed requests (8 before),
phase 9 one autosave a stage (``PHASE9_SAVE_STEPS``) and, with 11b, 4
layers a tower (``PHASE9_LAYERS``; 12, then 6 before), 13a 2 grain
workers a loader (``GRAIN_WORKERS``; the config's 4), phase 3 times 5
bursts (21, 11, then 7 before: phases 14 and 15 need the time; its float32
pass 5 of 5), phase 12c's and 13a's CLI runs 4 layers a tower
(``LORA_REDUCED``, ``PHASE13_REDUCED``), phase 14b one stage of each ZeRO
mode at 2 layers a tower (``PHASE14_REDUCED``: at full depth it took
137-181 s), phase 15e 2 layers a tower and configs/default.yaml's CP run
only (``PHASE15_REDUCED``; 16b runs the scaled config's CLI); every
profile is read off the trace's raw events
(``pgica_tpu_torch/utils/trace.py``): ``key_averages`` took up to 46 s to
parse one. Phase 5 no longer profiles a 4-beam request
(phase 11a profiles the same 127 replayed steps), phase 10 no longer runs the
eager chunk under Poisson load (it times the eager chunk against the
graphed one) nor profiles a Poisson run (one hung), and phase 3 no longer
sweeps the flash crossover (``flash_crossover`` stays, to call from a
script). Phases 14, 15 and 16 each spawn their ranks once and run the
parity checks and then the CLI in them (``chain``): a spawned rank's start,
imports and first model took 8-30 s. A run still going after
``STACKS_AFTER_S`` dumps every thread's stack to stderr.

Launch counts are reset just before the main path of phases 5, 6, 7, 9,
10, 11a, 12b, 12c, 13a, 13b, 13c, of each of phase 8's paths, of each of
13d's decode steps and, in each rank, of each of phase 14's, 15's and 16's paths, and read
just after; a graph replay
adds nothing to them (serving's are counted by the profiler; a training path's
launches are its host counts less each capture's recording plus each graph's
kernels times its replays, ``executed_launches``, and so are the Llama
engine path's, whose batch-path encodes replay the wrapper's graphs). The second-to-last line
is the kernel summary as JSON; the last line is ``{"ok": true, "device":
{...}}``. Without a card, or without the package beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import gc
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}  # dense; f32 off the tensor cores
TOL = {torch.float32: (1e-5, 0.0), torch.bfloat16: (2e-2, 1e-2)}  # (atol, rtol) on y / o / dx
ATTN_F32_ATOL = 2e-5
ATTN_BWD_F32_TOL = (2e-5, 1e-5)  # dk/dv sum up to 128 rows' terms of size ~10: f32 rounding grows with both
SUM_TOL = (1e-3, 1e-4)  # (atol, rtol) on LN's dgamma/dbeta: f32 sums over up to 16,384 rows
GPT2_VOCAB = 50257 + 5  # GPT-2's vocab plus the five specials, as bench.py
LLAMA_VOCAB = 128_256  # configs/siglip_llama8b.yaml model.vocab_size
SIGLIP, LLAMA = "google/siglip-so400m-patch14-384", "meta-llama/Meta-Llama-3-8B"
SLEEP_CYCLES = 20_000_000  # ~10 ms: keeps the card busy while the host queues a burst
SERVING_KERNELS = ("layernorm_fwd", "flash_attn_fwd")  # serving runs no backward
# the configs' evaluation.generate_config with beams (configs/default.yaml:138-145, siglip_llama8b.yaml):
# 4 beams, length penalty 1, repetition penalty 1.1; the sampling flags it also sets are ignored with beams
BEAMS = dict(num_beams=4, length_penalty=1.0, repetition_penalty=1.1)
LLAMA_SERVING_KERNELS = SERVING_KERNELS + ("rmsnorm_fwd",)


STACKS_AFTER_S = 1_080  # faulthandler's dump of every thread's stack, if the run is still going
T_START = time.perf_counter()  # every log line carries the seconds since the script started


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:6.1f}] {msg}", flush=True)


def dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


BF16_TIMING = {"reps": 20, "trials": 5}  # time_ms's depth (21, 11, then 7 trials before: the limit; phases 14-15)
TIMING = dict(BF16_TIMING)  # phase 3 times its float32 pass at F32_TIMING
# phase 3's float32 pass: a shallower timing keeps the limit. A training step at `mixed_precision: "no"`
# (configs/smoke.yaml; phases 4, 14a, 15b and 16a) launches those kernels too
F32_TIMING = {"reps": 5, "trials": 5}


def time_ms(fn, arg_sets, reps: int | None = None, trials: int | None = None) -> float:
    """Median over ``trials`` of the mean device time of ``reps`` back-to-back calls (TIMING's by default).

    A sleep kernel runs first so the host queues the whole burst before the
    card reaches it: the events then time the card, not the Python launch
    path. ``arg_sets`` rotate across bursts, each used once before any is
    used again, so sets larger in total than the 50 MB L2 arrive cold, as
    the KV caches of 24 layers do in the real decode.
    """
    reps, trials = reps or TIMING["reps"], trials or TIMING["trials"]
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


def attention_case(name, b, h, sq, sk, d, causal, valid, dtype, gen, timed=True, route=None) -> dict:
    """The forward kernel that ``route`` names (None: the dispatch's) against the plain version, the same
    bits over two runs; timed, with the f32 register-tiled kernel in turns with the CUDA-core one
    (``cuda_cores_ms``: turns CUDA cores, tiled, tiled, CUDA cores)."""
    from pgica_tpu_torch.ops.flash_attention import flash_attention_fwd, flash_attention_ref, fwd_route

    route = route or fwd_route(dtype, sq)
    q, k, v, bias = attention_inputs(b, h, sq, sk, d, dtype, valid, gen)
    o, lse = flash_attention_fwd(q, k, v, bias, causal, route)
    o2, lse2 = flash_attention_fwd(q, k, v, bias, causal, route)
    torch.cuda.synchronize()
    ro, rlse = flash_attention_ref(q, k, v, bias, causal)
    atol, rtol = (ATTN_F32_ATOL, 0.0) if dtype == torch.float32 else TOL[dtype]
    label = f"flash {name} ({b * h}, {sq}, {sk}, {d}) {dname(dtype)} [{route}]"
    err = check_close(label + " o", o, ro, atol, rtol)
    check_close(label + " lse", lse, rlse, 1e-4, 1e-6)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    out = dict(case=name, shape=f"({b * h}, {sq}, {sk}, {d})", dtype=dname(dtype), causal=causal,
               max_abs_err=err, atol=atol, rtol=rtol, route=route)
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
    fwd = lambda *a: flash_attention_fwd(*a, causal, route)  # noqa: E731
    if route == "f32_tiled":  # in turns with the kernel it replaced: CUDA cores, tiled, tiled, CUDA cores
        old = lambda *a: flash_attention_fwd(*a, causal, "cuda_cores")  # noqa: E731
        turns = [time_ms(fn, sets) for fn in (old, fwd, fwd, old)]
        out.update(ms=(turns[1] + turns[2]) / 2, cuda_cores_ms=(turns[0] + turns[3]) / 2, turns_ms=turns)
    else:
        out.update(ms=time_ms(fwd, sets))
    out.update(
        plain_ms=time_ms(lambda *a: flash_attention_ref(*a, causal), sets),
        library_ms=time_ms(lambda q_, k_, v_, m_: F.scaled_dot_product_attention(q_, k_, v_, attn_mask=m_), lib_sets),
        input_sets=n_sets,
        **bound(nbytes, flops, dtype),
    )
    return out


def flash_crossover(gen: torch.Generator) -> dict:
    """Each pair of forward kernels at small Sq, where a dispatch threshold lies. bf16, CUDA cores
    against tensor cores (TC_MIN_SQ): GPT-2's decoder heads (32 x 16, D 64) and Llama's (8 x 32, D 128)
    over a cache of 129 slots with ragged kept keys. f32, CUDA cores against register-tiled
    (F32_TILED_MIN_SQ): the same caches, and causal self-attention over Sq keys at GPT-2's stage-1 heads
    (128 x 16, D 64) with ragged kept keys. Logs the times and returns them by (dtype, shape); the
    thresholds in ops/flash_attention.py were set from them. Not part of the run (phase 3 times the rows
    either side of each threshold): call it from a script to measure the sweep again."""
    from pgica_tpu_torch.ops.flash_attention import flash_attention_fwd

    pairs = {torch.bfloat16: ("cuda_cores", "tensor_cores"), torch.float32: ("cuda_cores", "f32_tiled")}
    out = {}
    for dtype, routes in pairs.items():
        shapes = [(32, 16, 64, None, False), (8, 32, 128, None, False)]
        if dtype == torch.float32:
            shapes.append((128, 16, 64, "self", True))
        for b, h, d, sk, causal in shapes:
            row, times = [], {}
            for sq in (1, 2, 3, 4, 8, 16, 24, 32, 40, 48, 64):
                keys = sq if sk == "self" else 129
                valid = torch.randint(1, keys + 1, (b,), device="cuda", generator=gen)
                sets = [attention_inputs(b, h, sq, keys, d, dtype, valid, gen) for _ in range(8)]
                ms = [time_ms(lambda *a, r=r: flash_attention_fwd(*a, causal, r), sets) for r in routes]
                times[sq] = ms
                row.append(f"Sq {sq}: {ms[0]:.5f} / {ms[1]:.5f}")
            where = "Sq" if sk == "self" else "129"
            key = f"{dname(dtype)} ({b * h}, Sq, {where}, {d}){' causal' if causal else ''}"
            out[key] = times
            log(f"  flash forward crossover {key}, ms {' / '.join(routes)}: " + "; ".join(row))
    return out


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


def fused_ce_case(name, rows, vocab, d, h_dtype, w_dtype, gen, valid_rows=None, timed=True, shard=None) -> dict:
    """The three fused-CE kernels against their plain versions; one result dict for each.

    dh and dW take the kernel forward's lse, as the path does. Each kernel runs
    twice and must give the same bits; with masked
    rows, dh is exactly 0 on them and dW is bit-identical to dW over the
    live rows alone (a row with g = 0 adds exactly nothing).

    ``shard = (offset, full_vocab, zero_rows)``: W is a rank's block of the
    vocab under vocab parallelism (``fused_token_logprobs_tp``), its last
    ``zero_rows`` rows the zero padding; the targets are global ids of the
    full vocab shifted by ``offset`` (most lie outside the block: no
    target), and dh and dW take the GLOBAL lse, the block's combined with
    another block's (a second random W of the block's size), as the
    vocab-parallel backward does.
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
    if shard is not None:
        offset, full_vocab, zero_rows = shard
        y = torch.randint(0, full_vocab, (rows,), device="cuda", generator=gen) - offset
        if zero_rows:
            w[-zero_rows:] = 0
    logp, lse = fused_ce_fwd(h, w, y)
    logp2, lse2 = fused_ce_fwd(h, w, y)
    lse_bwd = lse  # the lse dh and dW take
    if shard is not None:  # the global lse: this block's with another block's
        other = (0.02 * torch.randn(vocab, d, device="cuda", generator=gen)).to(w_dtype)
        lse_bwd = torch.logaddexp(lse, fused_ce_fwd_ref(h, other, y)[1]).contiguous()
        del other
    dh, dh2 = fused_ce_bwd_dh(h, w, y, lse_bwd, g), fused_ce_bwd_dh(h, w, y, lse_bwd, g)
    dw, dw2 = fused_ce_bwd_dw(h, w, y, lse_bwd, g), fused_ce_bwd_dw(h, w, y, lse_bwd, g)
    torch.cuda.synchronize()
    label = f"fused_ce {name} ({rows}, {d}) x ({vocab}, {d}) h {dname(h_dtype)} W {dname(w_dtype)}"
    rlogp, rlse = fused_ce_fwd_ref(h, w, y)
    err_fwd = check_close(label + " logp", logp, rlogp, *FCE_LOGP_TOL)
    check_close(label + " lse", lse, rlse, *FCE_LOGP_TOL)
    if not (torch.equal(logp, logp2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{label}: two runs of fused_ce_fwd differ")
    del rlogp, logp2, lse2
    if shard is not None:
        rlse = lse_bwd  # the backward's plain version takes the global lse too
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
        if not torch.equal(dw, fused_ce_bwd_dw(h[live].contiguous(), w, y[live], lse_bwd[live], g[live])):
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
        "fused_ce_bwd_dh": (time_single(fused_ce_bwd_dh, (h, w, y, lse_bwd, g)),
                            time_single(fused_ce_bwd_dh_ref, (h, w, y, lse_bwd, g))),
        "fused_ce_bwd_dw": (time_single(fused_ce_bwd_dw, (h, w, y, lse_bwd, g)),
                            time_single(fused_ce_bwd_dw_ref, (h, w, y, lse_bwd, g))),
    }
    # the yardstick, two PyTorch calls never used by the port: F.linear then F.cross_entropy on bf16
    # h and W (the logits materialized), and that pair's autograd backward (dh and dW together)
    # (a vocab block's targets clamped into it: F.cross_entropy takes no target outside the logits)
    hb, wb, y_lib = h.to(torch.bfloat16), w.to(torch.bfloat16), y.clamp(0, vocab - 1)
    lib_fwd = time_single(lambda: F.cross_entropy(F.linear(hb, wb), y_lib, reduction="none"), ())
    leaves = [hb.detach().clone().requires_grad_(), wb.detach().clone().requires_grad_()]
    out = F.cross_entropy(F.linear(*leaves), y_lib, reduction="none")
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
                                  "fused_ce_dw_product"),
              "q8_matmul.cu": ("gemm_w8a8_fused", "gemm_w8_bf16_tiled")}
TC_OPS = ("HGMMA", "HMMA", "IMMA")  # bf16 and int8 tensor-core instructions in SASS
# the int8 decode kernels: the instruction each must hold (int8 products; bf16 after the dequantization), and a
# spill fails the phase (their accumulators, up to 64 a thread, are sized to stay in registers)
TC_REQUIRED_OP = {"gemm_w8a8_fused": "IMMA", "gemm_w8_bf16_tiled": "HMMA"}
# the float32 register-tiled kernels (CUDA cores): their registers and spills are reported too, one instance a
# head dim, and a spill fails the phase (their accumulators are sized to stay in registers)
F32_KERNELS = {"flash_attn_fwd.cu": ("flash_attn_fwd_f32",),
               "flash_attn_bwd.cu": ("flash_attn_bwd_dq_f32", "flash_attn_bwd_dkv_f32")}


def _demangle(names: list) -> list:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def tensor_core_report() -> None:
    """Logs each tensor-core kernel instance's registers, shared memory and spill bytes (ptxas) and
    HMMA/HGMMA/IMMA in its SASS, and each f32 register-tiled instance's registers and spills. Raises if a
    tensor-core instance has no tensor-core instruction (these kernels exist to use them), an int8 decode
    instance lacks its own (TC_REQUIRED_OP) or spills, or an f32 instance (F32_KERNELS) spills or is
    missing."""
    from pgica_tpu_torch.ops.flash_attention import HEAD_DIMS
    from pgica_tpu_torch.ops import _kernels

    from concurrent.futures import ThreadPoolExecutor

    tool = shutil.which("cuobjdump") or str(Path(_kernels._nvcc()).parent / "cuobjdump")
    libs = {source: _kernels.library_path(source) for source in TC_KERNELS}
    with ThreadPoolExecutor(len(libs)) as pool:  # one cuobjdump a library, all at once
        dumps = dict(zip(libs, pool.map(lambda lib: subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                                                                   text=True, check=True).stdout, libs.values())))
    for source, names in TC_KERNELS.items():
        lib = libs[source]
        entries = {}
        f32_names = F32_KERNELS.get(source, ())
        for part in lib.with_suffix(".log").read_text().split("Compiling entry function '")[1:]:
            name = part.split("'", 1)[0]
            if any(n in name for n in names + f32_names):
                spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
                regs = re.search(r"Used (\d+) registers", part)
                smem = re.search(r"(\d+) bytes smem", part)
                entries[name] = dict(registers=int(regs.group(1)), spill_stores=int(spill.group(1)),
                                     spill_loads=int(spill.group(2)), smem=int(smem.group(1)) if smem else 0)
        for part in dumps[source].split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            if name in entries:
                entries[name]["sass"] = sorted({op for op in TC_OPS if op in part})
        for (name, e), pretty in zip(entries.items(), _demangle(list(entries))):
            if any(n in name for n in f32_names):
                log(f"  {pretty} (CUDA cores): {e['registers']} registers, spill stores {e['spill_stores']} B, "
                    f"spill loads {e['spill_loads']} B")
                if e["spill_stores"] or e["spill_loads"]:
                    raise AssertionError(f"{pretty}: spills ({lib.name})")
                continue
            log(f"  {pretty}: {e['registers']} registers, {e['smem']} B static shared memory, spill stores "
                f"{e['spill_stores']} B, spill loads {e['spill_loads']} B; tensor-core SASS: "
                f"{', '.join(e.get('sass', [])) or 'none'}")
            if not e.get("sass"):
                raise AssertionError(f"{pretty}: no HMMA/HGMMA/IMMA in its SASS ({lib.name})")
            for kernel, op in TC_REQUIRED_OP.items():
                if kernel in name and (op not in e["sass"] or e["spill_stores"] or e["spill_loads"]):
                    raise AssertionError(f"{pretty}: no {op} in its SASS, or it spills ({lib.name})")
        for kernel in TC_REQUIRED_OP if source == "q8_matmul.cu" else ():
            if not any(kernel in name for name in entries):
                raise AssertionError(f"{kernel}: no instance in {lib.name}'s ptxas log")
        for n in f32_names:
            found = sum(n in name for name in entries)
            if found != len(HEAD_DIMS):
                raise AssertionError(f"{n}: {found} instances in {lib.name}'s ptxas log, {len(HEAD_DIMS)} expected")


# the RMSNorm kernels (CUDA cores): phase 3 reports every instance's registers and spills from the build's
# -Xptxas -v log, and a spill fails the phase (each instance keeps a thread's slots in registers)
RMS_SOURCES = ("rmsnorm_fwd.cu", "rmsnorm_bwd.cu")


def rmsnorm_register_report() -> None:
    from pgica_tpu_torch.ops import _kernels

    for source in RMS_SOURCES:
        lib = _kernels.library_path(source)
        names, counts = [], []
        for part in lib.with_suffix(".log").read_text().split("Compiling entry function '")[1:]:
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
            names.append(part.split("'", 1)[0])
            counts.append((int(re.search(r"Used (\d+) registers", part).group(1)),
                           int(spill.group(1)) + int(spill.group(2))))
        if not names:
            raise AssertionError(f"{source}: no kernel in {lib.name}'s ptxas log")
        short = [re.sub(r"^void |\(anonymous namespace\)::|\(.*$|__nv_", "", n) for n in _demangle(names)]
        log(f"  {source}: {len(names)} instances, registers (spill bytes): "
            + ", ".join(f"{n} {r} ({b})" for n, (r, b) in zip(short, counts)))
        spilled = [n for n, (_, b) in zip(short, counts) if b]
        if spilled:
            raise AssertionError(f"{source}: {', '.join(spilled)} spill ({lib.name})")


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
# RMSNorm shapes of the Llama paths (rows, H, where, the forward's launches there): phase 3 times both kernels at
# each; the decode rows are a decoder forward's (9 RMSNorms at LLAMA_LAYERS = 4; a request of max_length 128 runs
# at most 128 forwards), the backward runs at none of them
RMS_SHAPES = ((2048, 4096, "Llama blocks, stage 1 and 2", "9 / stage-1, 18 / stage-2 step (backward 9 / step)"),
              (32, 4096, "Llama 4-beam decode, batch 8", "9 a decoder forward, <= 1,152 / request"),
              (8, 4096, "Llama engine decode, 8 slots", "9 a decoder forward (graph replays)"),
              (4, 4096, "Llama 4-beam decode, batch 1", "9 a decoder forward, <= 1,152 / request"))
RMS_FLOOR = (1, 8)  # rms_norm_fwd on one row of one 16-byte slot: what a launch costs, the decode rows' yardstick
RMS_FLOOR_SETS = 64  # warm: the floor is a launch, not a read from memory


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


def rmsnorm_floor(dtype: torch.dtype, gen: torch.Generator) -> dict:
    """rms_norm_fwd at RMS_FLOOR, checked against its plain version, then timed through time_ms's burst on
    RMS_FLOOR_SETS input sets (warm in the L2)."""
    from pgica_tpu_torch.ops.rmsnorm import rms_norm_fwd, rms_norm_ref

    rows, hidden = RMS_FLOOR
    sets = [((3 * torch.randn(rows, hidden, device="cuda", generator=gen)).to(dtype),
             1 + 0.1 * torch.randn(hidden, device="cuda", generator=gen), 1e-5) for _ in range(RMS_FLOOR_SETS)]
    err = check_close(f"rmsnorm {RMS_FLOOR} {dname(dtype)} y", rms_norm_fwd(*sets[0])[0], rms_norm_ref(*sets[0])[0],
                      *TOL[dtype])
    return dict(shape=str(RMS_FLOOR), dtype=dname(dtype), where="launch floor", max_abs_err=err,
                ms=time_ms(rms_norm_fwd, sets), input_sets=RMS_FLOOR_SETS)


def rmsnorm_cases(dtype: torch.dtype, gen: torch.Generator, results: dict) -> None:
    floor = rmsnorm_floor(dtype, gen)
    log(f"  rmsnorm launch floor {RMS_FLOOR} {dname(dtype)}: max_abs_err {floor['max_abs_err']:.3e}; kernel_ms "
        f"{floor['ms']:.5f} ({RMS_FLOOR_SETS} input sets, warm)")
    results["rmsnorm_fwd"].append(floor)
    floor = floor["ms"]
    for rows, hidden, where, launches in RMS_SHAPES:
        r = rmsnorm_case(rows, hidden, dtype, gen)
        r.update(where=where, launches=launches, floor_ms=floor)
        results["rmsnorm_fwd"].append(r)
        show_timed("rmsnorm", r)
        log(f"    {launches}; {r['ms'] / floor:.2f}x the launch floor")
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


def norm_kernel_times(layernorm: bool = True) -> None:
    """Phase 3's LayerNorm and RMSNorm timings and the LayerNorm launch breakdowns alone (``layernorm=False``:
    the RMSNorm rows alone), one JSON line each (``NORM {...}``), through whichever ``pgica_tpu_torch`` is first
    on ``sys.path``: run once per checkout, in turns, in one call, it compares two trees on one card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: [] for name in KERNEL_META}
    for dtype in (torch.bfloat16, torch.float32):
        if layernorm:
            layernorm_cases(LN_FWD_SHAPES + LN_FWD_LLAMA_SHAPES, LN_BWD_SHAPES + LN_BWD_LLAMA_SHAPES, dtype, gen,
                            results)
        rmsnorm_cases(dtype, gen, results)
    for kernel, rows in results.items():
        for r in rows:
            print("NORM " + json.dumps(dict(kernel=kernel, **{k: r.get(k) for k in ("shape", "dtype", "where", "ms",
                                                                                  "plain_ms", "library_ms",
                                                                                  "bound_ms")})))
    for kernel, rows, hidden in LN_BREAKDOWN if layernorm else ():
        print("NORM " + json.dumps(launch_breakdown(kernel, rows, hidden)))


def norm_kernel_turns(other: str, layernorm: bool = True) -> None:
    """norm_kernel_times for the checkout at ``other`` (the root of a tree with a ``pgica_tpu_torch``) and
    this one in turns, other, this, this, other, each in a process of its own with its tree first on
    ``sys.path`` (each tree builds its kernels into its own build/). Prints every turn's ``NORM`` lines
    prefixed by the turn and its tree, then ``NORM_TURNS {...}``: each row's two times a tree and their
    means. Not part of the run: call it to compare two trees on one card."""
    code = ("import sys; sys.path.insert(0, {tree!r}); import importlib.util; "
            "spec = importlib.util.spec_from_file_location('chip_smoke', {me!r}); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "m.norm_kernel_times(layernorm={ln!r})")
    times: dict = {}
    for turn, tree in enumerate((other, str(ROOT), str(ROOT), other)):
        t = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", code.format(tree=str(Path(tree).resolve()), me=__file__,
                                                                   ln=layernorm)],
                             capture_output=True, text=True, check=True).stdout
        log(f"  turn {turn} ({tree}): {time.perf_counter() - t:.1f} s")
        side = "this" if tree == str(ROOT) else "other"
        for line in out.splitlines():
            if line.startswith("NORM {"):
                print(f"TURN {turn} {side} {line}", flush=True)
                r = json.loads(line[len("NORM "):])
                if r.get("ms") is not None:
                    times.setdefault(f"{r['kernel']} {r['shape']} {r['dtype']}", {}).setdefault(side, []).append(
                        r["ms"])
    print("NORM_TURNS " + json.dumps({k: dict(v, **{f"{s}_mean": statistics.mean(v[s]) for s in v})
                                      for k, v in times.items()}), flush=True)


def phase_kernels() -> dict:
    from pgica_tpu_torch.ops.flash_attention import F32_TILED_MIN_SQ, TC_MIN_SQ

    tensor_core_report()
    rmsnorm_register_report()
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {name: [] for name in KERNEL_META}
    stage1_valid = {s: torch.randint(1, s + 1, (128,), device="cuda", generator=gen) for s in (128, 32)}
    # stage 2 at batch 32: 64 caption rows (chosen and rejected), every token kept, or 8-28 of 32
    stage2_valid = {128: torch.full((64,), 128, device="cuda"),
                    32: torch.randint(8, 29, (64,), device="cuda", generator=gen)}
    for dtype in (torch.bfloat16, torch.float32):
        TIMING.update(BF16_TIMING if dtype == torch.bfloat16 else F32_TIMING)
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
            flash_case(attention_case(name, *shape, causal, valid, dtype, gen), results)
        # the Llama slice (phase 8): SigLIP's 730 tokens at D = 72 (batch 2 in stage 2, 8 serving), the
        # Llama towers' 4 x 32 heads of 128 over 512 tokens, every one kept, and decode at batch 8 over a
        # cache of max_length 128 + 1 slots, step 64 (keys 0..64 kept)
        for name, shape, causal, valid in (
            ("siglip_stage2", (2, 16, 730, 730, 72), False, None),
            ("siglip_serving", (8, 16, 730, 730, 72), False, None),
            ("llama", (4, 32, 512, 512, 128), True, torch.full((4,), 512, device="cuda")),
            ("llama_decode", (8, 32, 1, 129, 128), False, torch.full((8,), 65, device="cuda")),
            # 4-beam decode (phases 5 and 8): GPT-2 at batch 32 and Llama at batch 8, 4 rows an image
            ("beam_decode", (128, 16, 1, 129, 64), False, torch.full((128,), 65, device="cuda")),
            ("llama_beam_decode", (32, 32, 1, 129, 128), False, torch.full((32,), 65, device="cuda")),
        ):
            flash_case(attention_case(name, *shape, causal, valid, dtype, gen), results)
        for d in (16, 32, 72, 128):  # the other head dims, a fully masked batch row, ragged edges
            # f32: both kernels, the register-tiled one and the CUDA-core one that shorter Sq takes
            for route in ("f32_tiled", "cuda_cores") if dtype == torch.float32 else (None,):
                r = attention_case(f"d{d}", 2, 2, 33, 40, d, d == 32, torch.tensor([0, 29], device="cuda"),
                                   dtype, gen, timed=False, route=route)
                log(f"  flash d={d} (4, 33, 40, {d}) {dname(dtype)} [{r['route']}] masked row: max_abs_err "
                    f"{r['max_abs_err']:.3e}; identical over two runs")
        # either side of the Sq at which bf16 moves to the tensor-core kernel (ops/flash_attention.py:
        # TC_MIN_SQ) and f32 to the register-tiled one (F32_TILED_MIN_SQ), ragged keys over a cache of 129
        edges = (("below_tc_min_sq", TC_MIN_SQ - 1), ("at_tc_min_sq", TC_MIN_SQ))
        if dtype == torch.float32:
            edges += (("below_f32_tiled_min_sq", F32_TILED_MIN_SQ - 1), ("at_f32_tiled_min_sq", F32_TILED_MIN_SQ))
        for name, sq_ in edges:
            flash_case(attention_case(name, 32, 16, sq_, 129, 64, False,
                                      torch.randint(1, 130, (32,), device="cuda", generator=gen), dtype, gen), results)
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
    TIMING.update(BF16_TIMING)
    log(f"  (the float32 pass above timed {F32_TIMING['trials']} bursts of {F32_TIMING['reps']}; bf16 and everything "
        f"below, {TIMING['trials']} bursts of {TIMING['reps']})")

    for kernel, rows, hidden in LN_BREAKDOWN:
        launch_breakdown(kernel, rows, hidden)
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


def flash_case(r: dict, results: dict) -> None:
    """A timed flash forward row into ``results`` (the f32 register-tiled route's also under its own name)."""
    results["flash_attn_fwd"].append(r)
    if r["route"] == "f32_tiled":
        results["flash_attn_fwd_f32"].append(r)
        log(f"  flash {r['case']} {r['shape']} float32 [f32_tiled]: kernel_ms {r['ms']:.5f} against the CUDA-core "
            f"kernel's {r['cuda_cores_ms']:.5f} in turns (" + ", ".join(f"{t:.5f}" for t in r["turns_ms"]) + ")")
    show_timed("flash", r)


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


def phase_full_width(tokenizer, arch: str) -> dict | None:
    """Phase 4 for one architecture of ``FULL_WIDTH``; for GPT-2, phase 13d's launches a decode step."""
    from concurrent.futures import ThreadPoolExecutor

    from pgica_tpu_torch.generation.decode import generate
    from pgica_tpu_torch.generation.slots import DecodeGraphs
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
    from pgica_tpu_torch.models.presets import get_text_config, get_vision_config
    from pgica_tpu_torch.ops import _kernels

    spec = FULL_WIDTH[arch]
    if arch == "llama":
        log("  reduced: " + "; ".join(PHASE4_REDUCED))
    t0 = time.perf_counter()
    kwargs = dict(
        vision_model=dataclasses.replace(get_vision_config(spec["vision"]), num_layers=spec["layers"]),
        text_model=dataclasses.replace(get_text_config(spec["text"]), num_layers=spec["layers"]),
        projection_dim=512, tokenizer=tokenizer, max_caption_length=128, vocab_size=spec["vocab"],
        dtype=torch.float32, seed=0, dropout=0.0,  # dropout 0: the card's and the CPU's streams differ
    )
    # both draw the same seeded weights on the host, one sample at a time: built side by side
    with ThreadPoolExecutor(2) as pool:
        cuda, cpu = pool.map(lambda dev: PreferenceGuidedCaptioningModel(device=dev, **kwargs), ("cuda", "cpu"))
    log(f"  the card's and the CPU's models built side by side in {time.perf_counter() - t0:.1f} s")
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
    cross = None
    if arch == "gpt2":
        quant_full_width(cuda, cpu, images)
        cross = cross_attend_decode(cuda, cpu, images)
    ids = []
    for model, emb in ((cuda, emb_g.cuda()), (cpu, emb_c)):
        ids.append(generate(model.module, emb, eos_token_id=tokenizer.eos_token_id,
                            pad_token_id=tokenizer.pad_token_id, max_length=16).cpu())
    if not torch.equal(ids[0], ids[1]):
        raise AssertionError(f"full width: greedy tokens differ:\n{ids[0]}\n{ids[1]}")
    graphs = DecodeGraphs(cuda.module, cuda.device)
    graphed = generate(cuda.module, emb_g.cuda(), eos_token_id=tokenizer.eos_token_id,
                       pad_token_id=tokenizer.pad_token_id, max_length=16, graphs=graphs).cpu()
    if not torch.equal(graphed, ids[1]):
        raise AssertionError(f"full width: the CUDA-graph greedy tokens differ from the CPU's:\n{graphed}\n{ids[1]}")
    capture = next(iter(graphs.captured.values()))[1]
    log(f"  greedy tokens, 16 steps: identical on card (eager, and each step a CUDA-graph replay: captured in "
        f"{capture.capture_s * 1e3:.1f} ms, pool {capture.pool_bytes / 2**20:.1f} MiB) and CPU ({ids[0].tolist()}); "
        f"{time.perf_counter() - t0:.1f} s")
    beams = []
    for model, emb in ((cuda, emb_g.cuda()), (cpu, emb_c)):
        beams.append(generate(model.module, emb, eos_token_id=tokenizer.eos_token_id,
                              pad_token_id=tokenizer.pad_token_id, max_length=16, **BEAMS).cpu())
    if not torch.equal(beams[0], beams[1]):
        raise AssertionError(f"full width: 4-beam tokens differ:\n{beams[0]}\n{beams[1]}")
    graphed = generate(cuda.module, emb_g.cuda(), eos_token_id=tokenizer.eos_token_id,
                       pad_token_id=tokenizer.pad_token_id, max_length=16, graphs=graphs, **BEAMS).cpu()
    if not torch.equal(graphed, beams[1]):
        raise AssertionError(f"full width: the graphed 4-beam tokens differ from the CPU's:\n{graphed}\n{beams[1]}")
    log(f"  4-beam tokens ({BEAMS}), 16 steps: identical on card (eager, and steps 3-15 replays of the two beam "
        f"graphs) and CPU ({beams[0].tolist()}); {time.perf_counter() - t0:.1f} s")
    if arch == "gpt2":
        full_width_metrics(cuda, cpu)
        log(f"  model-route metrics checked; {time.perf_counter() - t0:.1f} s")
    full_width_train(cuda, cpu, spec)
    log(f"  stage 1 checked; {time.perf_counter() - t0:.1f} s")
    full_width_augmented_remat(cuda, cpu, spec)
    log(f"  stage 1 with augmentation and activation checkpointing checked; {time.perf_counter() - t0:.1f} s")
    # the stage-2 check's reference: a frozen f32 copy of the CPU model with the rows of every matrix rolled
    # by one, another model, so that the rewards are far from 0 (a copy of the policy would make them exactly
    # 0 at the first step); PHASE4_REDUCED says why not a model of another seed
    ref = frozen_copy(cpu.module, torch.float32)
    with torch.no_grad():
        for p in ref.parameters():
            if p.dim() > 1:
                p.copy_(p.roll(1, 0))
    log(f"  reference built; {time.perf_counter() - t0:.1f} s")
    full_width_stage2(cuda, cpu, ref, spec)
    log(f"  stage 2 checked; {time.perf_counter() - t0:.1f} s")
    return cross


METRIC_ATOL = 1e-4  # BERTScore P/R/F1 and CLIP-Score (100 x cosine), card (f32 kernels) against CPU


def full_width_metrics(cuda, cpu) -> None:
    """The two metrics that run the model, on 8 seeded images and caption pairs: BERTScore's text-tower
    route and the self-judged CLIP-Score, on the card (kernels) and on the CPU (plain versions)."""
    from pgica_tpu_torch.evaluation.metrics import CaptioningMetrics
    from pgica_tpu_torch.utils.factories import _dummy_caption

    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)
    preds = [_dummy_caption(rng) for _ in range(8)]
    refs = [[_dummy_caption(rng), p.rsplit(" ", 2)[0]] for p in preds]
    out = []
    for model in (cuda, cpu):
        metrics = CaptioningMetrics(model=model)
        out.append({**metrics.compute_bert_score(preds, refs), **metrics.compute_clip_score(images, preds)})
    errs = {k: abs(out[0][k] - out[1][k]) for k in out[1]}
    if out[0].keys() != out[1].keys() or max(errs.values()) > METRIC_ATOL or not all(map(math.isfinite, out[0].values())):
        raise AssertionError(f"full width: model-route metrics, card {out[0]} against CPU {out[1]}")
    log(f"  BERTScore (text tower) and CLIP-Score of 8 images and caption pairs, card against CPU: "
        + ", ".join(f"{k} {v:.6f} (err {errs[k]:.1e})" for k, v in out[0].items()) + f" (atol {METRIC_ATOL})")


PHASE4_SEQ = 32  # phase 4's train steps: captions of 5-32 tokens in rows of 32


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
            check_f32_route("phase 4 train steps and gradients (f32)", counts, PHASE4_SEQ - 1)
        runs[name] = (metrics, state, grads)
        log(f"  {len(batches)} gradients and steps on the {name}: {time.perf_counter() - t0:.1f} s")
    return dict(runs=runs, initial=initial, opt=opt, counts=counts)


def compare_training(label: str, run: dict, metric_tols: dict, replay_max: int | None = None) -> None:
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
    from pgica_tpu_torch.training.optim import OptState, global_norm

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
    # the card's optimizer against the CPU's, both fed the card's gradients: exact, no element excused. With
    # replay_max the replay leaves out the leaves larger than that (Adam is elementwise once the clip's norm,
    # taken over every leaf, is given)
    kept = [i for i, p in enumerate(run["initial"]) if replay_max is None or p.numel() <= replay_max]
    initial = [run["initial"][i] for i in kept]
    replay = OptState([names[i] for i in kept], initial, 0, [torch.zeros_like(p) for p in initial],
                      [torch.zeros_like(p) for p in initial])
    for grads in runs["card"][2]:
        on_cpu = [g.cpu() for g in grads]
        run["opt"].update([on_cpu[i] for i in kept], replay, grad_norm=float(global_norm(on_cpu)))
    replay_err = max(check_close(f"{label}: {names[i]} against the CPU optimizer on the card's gradients",
                                 state_g.opt_state.params[i].detach(), pr.cuda(), 1e-6, 0.0)
                     for i, pr in zip(kept, replay.params))
    log(f"  the card's parameters after {steps} steps against the CPU optimizer fed the card's gradients: max abs "
        f"diff {replay_err:.3e} (atol 1e-6, every element" + (
            f" of the {len(kept)} of {len(names)} leaves of at most {replay_max:,} elements)" if len(kept) < len(names)
            else ")"))
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
    batches = [stage1_batch(rng, n, PHASE4_SEQ, (5, PHASE4_SEQ), cuda.image_size, spec["vocab"]) for _ in range(2)]
    run = train_on_both(cuda, cpu, make, batches, loss_of)
    run["counts"] = {k: v for k, v in run["counts"].items() if k in spec["stage1"]}
    log(f"  stage 1, batch {n} x 32 (ragged):")
    compare_training("full width stage 1", run, {"loss": (0.0, 1e-4), "grad_norm": (0.0, 1e-3)},
                     spec.get("replay_max"))


def set_remat(module, on: bool) -> None:
    """Turn activation checkpointing of every tower's blocks on or off (the towers' ``config.remat``)."""
    from pgica_tpu_torch.models.lm import TransformerLM
    from pgica_tpu_torch.models.vit import VisionTransformer

    for m in module.modules():
        if isinstance(m, (TransformerLM, VisionTransformer)):
            m.config = dataclasses.replace(m.config, remat=on)


def set_dropout(module, rate: float) -> None:
    from pgica_tpu_torch.ops.dropout import FastDropout

    for m in module.modules():
        if isinstance(m, FastDropout):
            m.rate = rate


def stage1_grads(model, batch: dict, generator=None) -> dict:
    """Name -> gradient of the augmented stage-1 loss (the trainer's partition: the decoder frozen),
    the augmentation drawn from one seed (a CPU generator: the same parameters on both sides)."""
    from pgica_tpu_torch.training.train_step import _augmented, _on_device, stage1_loss_fn

    _, _, opt = stage1_trainer(model.module)  # sets requires_grad as the trainer's stage 1
    named = [(n, p) for n, p in model.module.named_parameters() if p.requires_grad]
    b = _augmented(_on_device(batch, model.device), True, seed=7, step=3)
    loss = stage1_loss_fn(model.module, b, generator, 0.5)[0]
    return dict(zip((n for n, _ in named), torch.autograd.grad(loss, [p for _, p in named])))


def full_width_augmented_remat(cuda, cpu, spec: dict) -> None:
    """A stage-1 gradient with augmentation on and every block checkpointed, card vs CPU (dropout
    0); then on the card with dropout 0.1, checkpointing off against on: bit for bit."""
    rng = np.random.default_rng(5)
    batch = stage1_batch(rng, spec["stage1_batch"], 32, (5, 32), cuda.image_size, spec["vocab"])
    cuda.module.load_state_dict(cpu.module.state_dict())  # stage 1 left the two a rounding apart
    for model in (cuda, cpu):
        set_remat(model.module, True)
    got, want = stage1_grads(cuda, batch), stage1_grads(cpu, batch)
    worst = (0.0, "")
    for name, gc in want.items():
        gg, gc = got[name], gc.cuda()
        if name.endswith("attn.k_proj.bias"):  # 0 in exact arithmetic
            if max(float(gg.abs().max()), float(gc.abs().max())) > 1e-6:
                raise AssertionError(f"augmented remat: {name} gradient is not ~0")
            continue
        diff = (gg - gc).abs()
        rel = float(diff.norm() / gc.norm().clamp_min(1e-30))
        top = float(diff.max()) / max(float(gc.abs().max()), 1e-30)
        if max(rel, top) > grad_rtol(name):
            raise AssertionError(f"augmented remat: gradient of {name} differs by {rel:.3e} / {top:.3e}")
        worst = max(worst, (rel, name))
    log(f"  stage 1 with augmentation (seed 7) and checkpointing on, {len(want)} gradients, card vs CPU: worst "
        f"relative L2 difference {worst[0]:.3e} ({worst[1]}; limits as above)")
    set_dropout(cuda.module, 0.1)
    runs = {}
    for on in (True, False):
        set_remat(cuda.module, on)
        runs[on] = stage1_grads(cuda, batch, torch.Generator(device="cuda").manual_seed(11))
    set_dropout(cuda.module, 0.0)
    for model in (cuda, cpu):
        set_remat(model.module, False)
    differ = [n for n in runs[True] if not torch.equal(runs[True][n], runs[False][n])]
    if differ:
        raise AssertionError(f"checkpointing changed the gradients of {differ[:5]} ({len(differ)} leaves)")
    log(f"  the same gradient on the card with dropout 0.1, checkpointing on and off: all {len(runs[True])} leaves "
        "bit-identical")


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
    batches = [stage2_batch(rng, spec["stage2_batch"], PHASE4_SEQ, (5, PHASE4_SEQ), cuda.image_size, spec["vocab"])
               for _ in range(2)]
    run = train_on_both(cuda, cpu, lambda m: stage2_trainer(m, refs[m], frozen=spec["stage2_frozen"]), batches,
                        loss_of)
    run["counts"] = {k: v for k, v in run["counts"].items() if k in spec["stage2"]}
    log(f"  stage 2, batch {spec['stage2_batch']} pairs x {batches[0]['preferred_ids'].shape[1]} (ragged), f32 "
        "reference:")
    # both steps see the same parameters on both sides (the first update has lr 0). A sequence's
    # log-prob sums <= 31 token log-probs of ~-11, each within ~1e-5 between the two sides; a reward
    # is beta = 0.1 times a difference of two such sums; a pair's margin within that of 0 may flip
    # the accuracy by 1 / 4
    compare_training("full width stage 2", run, {
        "loss": (0.0, 1e-4), "grad_norm": (0.0, 1e-3), "policy_chosen_logp": (1e-3, 1e-5),
        "policy_rejected_logp": (1e-3, 1e-5), "chosen_reward": (2e-4, 0.0), "rejected_reward": (2e-4, 0.0),
        "reward_margin": (4e-4, 0.0), "reward_accuracy": (0.25, 0.0)}, spec.get("replay_max"))


# ------------------------------------------------------------------ phase 5


# a beam shape's first search runs steps 1 and 2 eagerly, each as the warm-up of its graph's capture, and the
# wrappers count the capture's launches too: 4 decoder forwards from the host besides the prefix
BEAM_CAPTURE_FORWARDS = 4
ENTRY_CAPTURE_CALLS = 2  # a wrapper entry's new key runs its function eagerly, then records it in the capture
ENTRY_BATCH, ENTRY_SEQ = 16, 32  # phase 5's wrapper entries: 16 images (a batch no request encodes), captions of 4-32 tokens


def entry_state(model) -> dict:
    """The wrapper entries' graphs (models/model.py, training/graphs.py:GraphedCalls) with each one's replays,
    to diff a call against (the graphs held, so that none is freed meanwhile)."""
    graphs = model._entry_graphs
    return {} if graphs is None else {id(g): (g, g.replays) for g in graphs.graphs.values()}


def entry_launches(model, before: dict, per_graph: dict, label: str) -> dict:
    """The host launches of the one entry graph that a call since ``before`` (:func:`entry_state`) went
    through: a graph it captured launched ENTRY_CAPTURE_CALLS times what it holds (``per_graph``, checked),
    a replay nothing."""
    now = entry_state(model)
    new = [g for k, (g, _) in now.items() if k not in before or before[k][0] is not g]
    replays = sum(g.replays - before[k][1] for k, (g, _) in now.items() if k in before and before[k][0] is g)
    held = [g.captured.kernels for g in new]
    if any(h != per_graph for h in held) or len(new) + replays != 1:
        raise AssertionError(f"{label}: {len(new)} entry graphs captured (holding {held}, expected {per_graph}) and "
                             f"{replays} replayed, expected one call")
    return {k: ENTRY_CAPTURE_CALLS * len(new) * v for k, v in per_graph.items()}


def entry_executed(model, host: dict, before: dict) -> dict:
    """A path's launches that ran on the card, the wrapper's entry graphs included (:func:`executed_launches`):
    the host's counts less each entry graph's recording at its capture in the path, plus each graph's
    kernels times its replays in the path (``before``: :func:`entry_state` at the path's start)."""
    pairs = [(g.captured.kernels, g.replays - before[k][1] + 1 if k in before and before[k][0] is g else g.replays)
             for k, (g, _) in entry_state(model).items()]
    return executed_launches(host, pairs)


def eager_encode(model, images) -> dict:
    """``encode_image``'s function run eagerly on the inference module (the plain version of its graph)."""
    from pgica_tpu_torch.data.augment import prepare_images

    with torch.inference_mode():
        return model._inference_module().encode_image(prepare_images(torch.from_numpy(images).to(model.device)))


def beam_key(tok, batch: int, max_length: int = 128) -> tuple:
    """The key of ``DecodeGraphs.beams`` for a BEAMS request."""
    return (batch, max_length, BEAMS["num_beams"], BEAMS["length_penalty"], BEAMS["repetition_penalty"],
            tok.eos_token_id, tok.pad_token_id)


def beam_graph_checks(model, images, per_forward: dict, label: str, max_length: int = 128) -> dict:
    """For the 4-beam shape (BEAMS, batch len(images)) whose two step graphs generate_captions already
    captured on ``model``'s decode module: one graphed and one eager search (``graphs=None``: the same
    step, launched op by op, after the eager encode), each timed from the encode to the ids on the host, must
    give the same ids;
    from the same initial beams, the odd-step graph's first replay gives the eager step's logits bit for
    bit; each graph holds ``per_forward`` (its wrappers' launches under capture). The graphs' capture
    seconds and pools."""
    from pgica_tpu_torch.generation.decode import _beam_init, beam_step, generate, init_beam_state

    tok, module, batch = model.tokenizer, model._decode_module(), len(images)
    kw = dict(eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, max_length=max_length, early_stop=True,
              **BEAMS)
    captured = model._decode_graphs.beams[beam_key(tok, batch, max_length)]
    ms, ids = {}, {}
    with torch.inference_mode():
        for name, graphs in (("graphed", model._decode_graphs), ("eager", None)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            emb = (model.encode_image(images) if graphs else eager_encode(model, images))["embeddings"]
            ids[name] = generate(module, emb, graphs=graphs, **kw).cpu()
            ms[name] = (time.perf_counter() - t) * 1e3
        if not torch.equal(ids["graphed"], ids["eager"]):
            raise AssertionError(f"{label}: the graphed beam search's ids differ from the eager one's")
        state = init_beam_state(module.decoder_config, batch, BEAMS["num_beams"], max_length, module.compute_dtype,
                                model.device, length_penalty=BEAMS["length_penalty"],
                                repetition_penalty=BEAMS["repetition_penalty"], eos_token_id=tok.eos_token_id,
                                pad_token_id=tok.pad_token_id)
        _beam_init(module, state, emb)
        eager_logits = beam_step(module, state, True)
        _beam_init(module, captured.state, emb)
        captured.graphs[0].replay()
        if not torch.equal(captured.graphs[0].out, eager_logits):
            raise AssertionError(f"{label}: the first replayed beam step's logits differ from the eager step's")
    del state, eager_logits
    want = {k: v for k, v in per_forward.items() if v}
    held = [g.kernels for g in captured.graphs]
    if held != [want, want]:
        raise AssertionError(f"{label}: the beam graphs hold {held}, expected {want} each")
    r = dict(ms=ms, capture_s=[g.capture_s for g in captured.graphs], pool_bytes=[g.pool_bytes for g in captured.graphs])
    log(f"  {label}, 4 beams x {max_length} (early_stop): graphed {ms['graphed']:.1f} ms, eager {ms['eager']:.1f} ms "
        f"(one call each, encode to ids on the host), the same ids; the first replayed step's logits bit-equal to the "
        f"eager step's; the odd- and even-step graphs each hold {want}, captured in "
        + " and ".join(f"{c * 1e3:.1f}" for c in r["capture_s"]) + " ms, pools "
        + " and ".join(f"{b / 2**20:.1f}" for b in r["pool_bytes"]) + f" MiB (one pool, shared) [{card()}]")
    return r


def beam_memory_checks(model, images, label: str) -> dict:
    """The beam graphs' memory on ``model``'s decode module, whose graphs hold the 4-beam shapes of batch 8
    and 32: a second scoring of batch 8 (repetition penalty 1, which makes batch 8 the most recently used)
    shares that shape's caches, presence and beams, and adds no more than its scoring and its graphs'
    outputs (a tenth of the shape's caches at most); a
    third shape (batch 1) drops the least recently used one (batch 32, DecodeGraphs.beam_shapes 2), and
    the memory allocated falls by at least 90% of that shape's caches. The new scoring's ids equal the
    eager search's."""
    from pgica_tpu_torch.generation.decode import generate

    tok, module, graphs = model.tokenizer, model._decode_module(), model._decode_graphs
    kw = dict(max_length=128, early_stop=True, **BEAMS)
    other = {**kw, "repetition_penalty": 1.0}
    shared = graphs.beams[beam_key(tok, 8)].state
    shape_bytes = {b: sum(x.numel() * x.element_size() for x in graphs.beams[beam_key(tok, b)].state.cache_buffers)
                   for b in (8, 32)}
    kw_ids = dict(eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id, **other)
    with torch.inference_mode():
        emb = model.encode_image(images[:8])["embeddings"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        graphed = generate(module, emb, graphs=graphs, **kw_ids).cpu()
        torch.cuda.synchronize()
        added = torch.cuda.memory_allocated() - before
        eager = generate(module, emb, **kw_ids).cpu()
    new = graphs.beams[(8, 128, BEAMS["num_beams"], BEAMS["length_penalty"], 1.0, tok.eos_token_id, tok.pad_token_id)]
    if new.state.cache_buffers[0] is not shared.cache_buffers[0] or new.state.presence[1] is not shared.presence[1]:
        raise AssertionError(f"{label}: a second scoring of batch 8 did not share the shape's buffers")
    if added > shape_bytes[8] / 10:
        raise AssertionError(f"{label}: a second scoring of batch 8 added {added} bytes (its shape's caches: "
                             f"{shape_bytes[8]})")
    if not torch.equal(graphed, eager):
        raise AssertionError(f"{label}: the second scoring's graphed ids differ from the eager search's")
    del shared, new, emb
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model.generate_captions(images[:1], **kw)
    gc.collect()
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    shapes = sorted({k[0] for k in graphs.beams})
    if shapes != [1, 8] or freed < shape_bytes[32] * 0.9:
        raise AssertionError(f"{label}: after a batch-1 beam request the graphs hold beam batches {shapes} "
                             f"(expected [1, 8]) and {freed} bytes were freed (batch 32's caches: {shape_bytes[32]})")
    log(f"  {label}, the beam graphs' memory: a second scoring of the batch-8 shape (repetition penalty 1) shares "
        f"its caches ({shape_bytes[8] / 2**30:.3f} GiB) and added {added / 2**20:.1f} MiB, its ids equal to the "
        f"eager search's; a third shape (batch 1) dropped batch 32's graphs and state, and the memory allocated "
        f"fell by {freed / 2**30:.3f} GiB (its caches {shape_bytes[32] / 2**30:.3f} GiB) [{card()}]")
    return dict(added_bytes=added, freed_bytes=freed, cache_bytes=shape_bytes)


def phase_slice(tokenizer) -> dict:
    from pgica_tpu_torch.generation.slots import Sampler
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

    def request(batch: int, max_length: int, early_stop: bool, **kw) -> dict:
        before, entries = _kernels.launch_counts(), entry_state(model)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        captions = model.generate_captions(images[:batch], max_length=max_length, early_stop=early_stop, **kw)
        seconds = time.perf_counter() - t  # ends in a device->host copy of the ids
        if len(captions) != batch or not all(isinstance(c, str) for c in captions):
            raise AssertionError(f"generate_captions returned {captions!r}")
        after = _kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in SERVING_KERNELS}
        encode = entry_launches(model, entries, VIT_ENCODE, f"request batch {batch}")
        forwards = (launches["flash_attn_fwd"] - encode["flash_attn_fwd"]) // 24  # decoder forwards from the host
        want = {k: encode[k] + DECODER_FORWARD[k] * forwards for k in SERVING_KERNELS}
        # every step replays a CUDA graph (no host launch), and so does the encode once its shape was seen:
        # the host runs the prefix, plus at a shape's first call a warm-up step and the capture (greedy) or
        # two of each (beams: their two graphs), and the encode's warm-up and capture
        first = 1 + (BEAM_CAPTURE_FORWARDS if "num_beams" in kw else 2)
        if launches != want or forwards not in (1, first):
            raise AssertionError(f"request batch {batch} {kw}: launched {launches}, expected {want}")
        return dict(batch=batch, max_length=max_length, early_stop=early_stop, seconds=seconds,
                    captions_per_s=batch / seconds, launches=launches, decoder_forwards=forwards,
                    encode_captured=bool(encode["flash_attn_fwd"]),
                    peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, **kw)

    def show(tag: str, r: dict) -> None:
        beams = f" beams {r['num_beams']} (length penalty {r['length_penalty']}, repetition penalty " \
            f"{r['repetition_penalty']})" if "num_beams" in r else ""
        log(f"  {tag} batch {r['batch']} x max_length {r['max_length']} early_stop={r['early_stop']}{beams}: "
            f"{r['seconds'] * 1e3:.1f} ms, {r['captions_per_s']:.1f} captions/s, decoder forwards from the host "
            f"{r['decoder_forwards']}, encode {'captured' if r['encode_captured'] else 'replayed'}, host launches "
            f"{r['launches']}, peak {r['peak_mem_gib']:.2f} GiB")

    _kernels.reset_launch_counts()  # ---- the main path starts here
    served = []
    for batch in (1, 1, 8, 8, 32, 32):  # the first call at a shape captures its graph; the second is timed
        r = request(batch, 32, True)
        served.append(r)
        show("request", r)
    served = served[1::2]
    # the configs' generate_config: 4 beams over 128 tokens (a decoder forward runs batch x 4 rows);
    # the second call of each batch is the one timed
    beamed = []
    for batch in (8, 8, 32, 32):
        r = request(batch, 128, True, **BEAMS)
        beamed.append(r)
        show("beam request", r)
    beamed = beamed[1::2]
    model.generate_captions(images, max_length=64)  # warm-up of the benchmark shape
    bench = [request(32, 64, False) for _ in range(5)]
    for r in bench:
        show("eval greedy", r)
    main_counts = {k: v for k, v in _kernels.launch_counts().items() if k in SERVING_KERNELS}  # ---- and ends here
    if min(main_counts.values()) == 0:
        raise AssertionError(f"the serving path did not launch every kernel: {main_counts}")
    want = DECODER_FORWARD  # the prefix; the encode and 63 steps replay
    if bench[0]["launches"] != want:
        raise AssertionError(f"one 32 x 64 greedy call launched {bench[0]['launches']}, expected {want}")
    median_s = statistics.median(r["seconds"] for r in bench)
    log(f"  eval greedy 32 x 64, each step a CUDA-graph replay: median {median_s * 1e3:.1f} ms -> "
        f"{32 / median_s:.1f} captions/s (median of 5 after one warm-up); host launches per call "
        f"{bench[0]['launches']} (expected {want})")
    log(f"  main-path launch counts (all requests above): {main_counts}")
    entries = entry_checks(model, images)
    beam_checks = {batch: beam_graph_checks(model, images[:batch], DECODER_FORWARD, f"GPT-2 flagship, batch {batch}")
                   for batch in (8, 32)}
    beam_memory = beam_memory_checks(model, images, "GPT-2 flagship")
    eager = eager_eval(model, images, max_length=64)
    log(f"  eval greedy 32 x 64 with the eager step (the same kernels, launched one by one): median "
        f"{eager['median_s'] * 1e3:.1f} ms (of 3 after one warm-up) against {median_s * 1e3:.1f} graphed; "
        f"ids identical to the graphed call's")

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
    # what one 32 x 64 call launches: the encode's graph replayed, the prefix from the host (counted above),
    # then 63 replays of the step graph, which holds 49 LN and 24 flash launches (counted at its capture)
    step = model._decode_graphs.captured[(32, 64, Sampler(), tokenizer.eos_token_id, tokenizer.pad_token_id)][1]
    if step.kernels != {"layernorm_fwd": 49, "flash_attn_fwd": 24}:
        raise AssertionError(f"the 32 x 64 step graph holds {step.kernels}")
    want = {"layernorm_fwd": 27 + 64 * 49, "flash_attn_fwd": 12 + 64 * 24, "rmsnorm_fwd": 0}
    seen = profile["kernels"]
    if seen != want:
        seen = device_counts(lambda: model.generate_captions(images, max_length=64), want,
                             "the profiled 32 x 64 call")["counts"]
    log(f"  one 32 x 64 call launches {want} on the card: the step graph holds {step.kernels}, replayed 63 times; "
        f"the profiler's device kernels (graph replays included): {seen}")
    # the busy share of a batch-32 4-beam request is phase 11a's profile (the same 127 step replays)
    return dict(main_counts=main_counts, served=served, beamed=beamed, beam_checks=beam_checks,
                beam_memory=beam_memory, bench=bench, entries=entries,
                median_s=median_s,
                eager_median_s=eager["median_s"], sync_ms_per_step=(es - fl) / 31 * 1e3, profile=profile,
                model=model)


def profiled(fn, label: str, unprofiled_ms: float) -> dict:
    """Kernel time of one call of ``fn`` (which ends in a host sync) from torch.profiler, and the
    device busy share: that kernel time over the call's wall time measured without the profiler
    (which slows the host, not the kernels). The trace is read off its raw events
    (``pgica_tpu_torch/utils/trace.py``): ``key_averages`` took up to 46 s for one request's."""
    from torch.profiler import ProfilerActivity, profile

    from pgica_tpu_torch.utils import trace

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    events = trace.raw_events(prof)
    kernels = trace.device_totals(events)
    device_ms = sum(us for us, _ in kernels.values()) / 1e3
    by_name = port_kernel_counts(kernels)
    if device_ms <= 0:
        log(f"  profiler, {label}: no device time recorded (busy share not measured)")
        return {"device_ms": None, "kernels": by_name}
    launches = sum(n for _, n in kernels.values())
    busy = device_ms / unprofiled_ms
    log(f"  profiler, one {label}: {launches} kernel launches, kernel time {device_ms:.1f} ms of {unprofiled_ms:.1f} "
        f"ms (unprofiled median) -> device busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}%")
    top = [(name, us / 1e3, n) for name, us, n in trace.largest(kernels, 12)]
    for name, ms, n in top:
        log(f"    {ms:9.2f} ms  {n:6d} x  {name[:100]}")
    log("    host side, by self CPU time under the profiler (which inflates it):")
    for name, us, n in trace.largest(trace.host_self_times(events), 8):
        log(f"    {us / 1e3:9.2f} ms  {n:6d} x  {name[:100]}")
    return {"device_ms": device_ms, "launches": launches, "busy": busy, "kernels": by_name, "top": top}


# the forward kernels a serving path runs, by the device names the profiler gives them
# (csrc: layernorm_fwd_rows, flash_attn_fwd and flash_attn_fwd_tc, rmsnorm_fwd_registers and _loop)
DEVICE_KERNELS = ("layernorm_fwd", "flash_attn_fwd", "rmsnorm_fwd")


def port_kernel_counts(device_totals: dict) -> dict:
    """Launches of each of DEVICE_KERNELS among the profiler's device events (CUDA-graph replays'
    kernels included; ``trace.device_totals``), by name: the host's launch counts do not see a replay."""
    return {name: sum(n for key, (_, n) in device_totals.items() if name in key) for name in DEVICE_KERNELS}


PROFILE_ATTEMPTS = 3
TAIL_KERNELS = 64  # trivial kernels after fn, inside the trace (see device_counts)


def device_counts(fn, want: dict, label: str) -> dict:
    """The port's kernels the profiler sees on the card in one call of ``fn`` (which ends in a host
    sync), held to ``want``, the count that is known exactly from the host: the kernels each graph
    holds (its wrappers' launches under capture) times its replays, plus the eager launches.

    The tracer (CUPTI, through torch.profiler) loses a kernel record now and then on an H100: 19 of
    37,886 kernels in one 32 x 64 call; one RMSNorm of a Llama chunk replay in three profiles of one
    run, none in other runs. So fn is profiled between a kernel and TAIL_KERNELS trivial ones (a
    record lost at an edge of the trace is theirs), up to PROFILE_ATTEMPTS times until the counts
    equal ``want``. If none does, each count must still lie in (0, want] (it may fall short by the
    records the tracer lost, never exceed the launches), and the shortfall is logged; a kernel
    missing from every replay fails either way, since the held count is checked at capture.
    Returns the counts of the best attempt and the attempts made."""
    from torch.profiler import ProfilerActivity, profile

    from pgica_tpu_torch.utils import trace

    seen = []
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x = torch.ones(1, device="cuda")
            x.add_(1)  # the trace holds a kernel before fn's
            torch.cuda.synchronize()
            fn()
            for _ in range(TAIL_KERNELS):
                x.add_(1)
            torch.cuda.synchronize()
        counts = port_kernel_counts(trace.device_totals(trace.raw_events(prof)))
        if counts == want:
            return dict(counts=counts, attempts=attempt, lost=0)
        seen.append(counts)
    if any(c[k] > want[k] or (want[k] > 0) != (c[k] > 0) for c in seen for k in want):
        raise AssertionError(f"{label}: the card ran {seen}, expected {want} ({PROFILE_ATTEMPTS} profiled calls)")
    best = max(seen, key=lambda c: sum(c.values()))
    lost = sum(want.values()) - sum(best.values())
    log(f"  {label}: the profiler saw {best} of {want} in the best of {PROFILE_ATTEMPTS} profiled calls: the tracer "
        f"lost {lost} kernel record(s); the launches are counted exactly at capture")
    return dict(counts=best, attempts=PROFILE_ATTEMPTS, lost=lost)


def eager_eval(model, images, max_length: int) -> dict:
    """The batch path with the eager encode and step (``graphs=None``): the median of 3 calls after a
    warm-up, each ending in a device->host copy; its ids must equal ``generate_captions``' graphed ones."""
    from pgica_tpu_torch.generation.decode import generate

    tok = model.tokenizer

    def call():
        with torch.inference_mode():
            emb = eager_encode(model, images)["embeddings"]
            return generate(model._inference_module(), emb, eos_token_id=tok.eos_token_id,
                            pad_token_id=tok.pad_token_id, max_length=max_length).cpu().numpy()

    ids = call()
    seconds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        call()
        seconds.append(time.perf_counter() - t)
    graphed = model.generate_captions(images, max_length=max_length)
    if [tok.decode(r) for r in ids] != graphed:
        raise AssertionError("the eager step's captions differ from the CUDA-graph step's")
    return dict(median_s=statistics.median(seconds), seconds=seconds)


def same_bits(got, want) -> bool:
    """Whether two entry outputs (tensors, host arrays, or dicts of them) hold the same bits."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(same_bits(got[k], want[k]) for k in want)
    if isinstance(want, torch.Tensor):
        return isinstance(got, torch.Tensor) and got.dtype == want.dtype and torch.equal(got, want)
    return got.dtype == want.dtype and np.array_equal(got, want)


def entry_checks(model, images) -> dict:
    """Phase 5: the wrapper's three entry points (models/model.py; JAX jits them, model.py:324-340) at the
    flagship's full width: ``__call__`` in each mode (generation with labels), ``encode_image`` and
    ``compute_similarity``, each through its CUDA graph against the same function run eagerly on the same
    module (``__call__`` on the f32 masters through the bf16 compute dtype, as JAX's; the other two on the
    bf16 serving copy): a new key's first call (eager on the capture stream) and a replay bit-equal to the
    eager run, the graph holding the eager run's launches; ms a call graphed and eager (the mean of 5, each
    ending in a host sync) and the busy share of one profiled graphed call."""
    from pgica_tpu_torch.data.augment import prepare_images
    from pgica_tpu_torch.models.model import _host
    from pgica_tpu_torch.ops import _kernels

    rng = np.random.default_rng(5)
    imgs = images[:ENTRY_BATCH]
    ids = rng.integers(0, model.tokenizer.vocab_size, (ENTRY_BATCH, ENTRY_SEQ)).astype(np.int32)
    mask = (np.arange(ENTRY_SEQ)[None, :] < rng.integers(4, ENTRY_SEQ + 1, ENTRY_BATCH)[:, None]).astype(np.int32)
    t_ids, t_mask = (torch.from_numpy(a).cuda() for a in (ids, mask))
    served = model._inference_module()

    def pixels():
        return prepare_images(torch.from_numpy(imgs).cuda())

    def forward(mode: str, labels: bool):
        out = model.module(pixels(), t_ids, t_mask, t_ids if labels else None, mode=mode)
        return {k: _host(v) for k, v in out.items()}

    entries = {
        "encode_image": (lambda: model.encode_image(imgs),
                         lambda: {k: v.clone() for k, v in served.encode_image(pixels()).items()}),
        "compute_similarity": (lambda: model.compute_similarity(imgs, ids, mask),
                               lambda: served.compute_similarity(pixels(), t_ids, t_mask).cpu().numpy()),
        **{f"__call__ {mode}" + (" with labels" if labels else ""):
           (lambda mode=mode, labels=labels: model(imgs, ids, mask, labels=ids if labels else None, mode=mode),
            lambda mode=mode, labels=labels: forward(mode, labels))
           for mode, labels in (("contrastive", False), ("generation", True), ("dual", False))},
    }

    def synced(fn):
        def call():
            out = fn()
            torch.cuda.synchronize()
            return out
        return call

    out = {}
    with torch.inference_mode():
        for name, (graphed, eager) in entries.items():
            before = _kernels.launch_counts()
            want = eager()
            after = _kernels.launch_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            known = entry_state(model)
            first, replay = graphed(), graphed()
            new = [g for k, (g, _) in entry_state(model).items() if k not in known]
            if len(new) != 1 or new[0].replays != 1 or new[0].captured.kernels != launched or not launched:
                raise AssertionError(f"{name}: {len(new)} new graphs, holding {[g.captured.kernels for g in new]}, "
                                     f"replayed {[g.replays for g in new]}; the eager run launched {launched}")
            if not same_bits(first, want) or not same_bits(replay, want):
                raise AssertionError(f"{name}: the graphed entry's first call or replay differs from the eager run")
            ms = {"graphed": statistics.median(step_windows(synced(graphed), 1, 5)),
                  "eager": statistics.median(step_windows(synced(eager), 1, 5))}
            busy = profiled(synced(graphed), f"{name} graphed call", ms["graphed"]).get("busy")
            g = new[0].captured
            out[name] = dict(ms=ms, busy=busy, capture_s=g.capture_s, pool_bytes=g.pool_bytes, kernels=g.kernels)
            log(f"  {name}, batch {ENTRY_BATCH}" + ("" if name == "encode_image" else f" x {ENTRY_SEQ} tokens")
                + f": graphed first call and replay bit-equal to the eager run; {ms['graphed']:.2f} ms a call "
                f"graphed (busy {f'{100 * busy:.1f}%' if busy else 'not measured'}) against {ms['eager']:.2f} eager "
                f"(the mean of 5 calls, each from host arrays to its outputs, synchronized); the graph holds the "
                f"eager run's {g.kernels}, captured in {g.capture_s * 1e3:.1f} ms, pool +{g.pool_bytes / 2**20:.1f} "
                f"MiB [{card()}]")
    return out


def on_card(batch: dict, label: str) -> dict:
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in batch.items()}
    log(f"  {label} batch: " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in out.items())
        + ", tokens kept " + " + ".join(str(int(v.sum())) for k, v in out.items() if k.endswith("mask")))
    return out


GRAPH_CHECK_STEPS = 3  # steps a shape takes from one starting state, graphed and eager, to be held bit for bit
GRAPH_WINDOWS = (3, 3)  # (windows, steps a window) of the graphed step's timing: the median window, as bench.py


def tensor_digest(t: torch.Tensor, chunk: int = 1 << 26) -> torch.Tensor:
    """:func:`bits_digest` of one 4-byte tensor, a chunk of its words at a time (its memory stays a chunk's)."""
    words = t.detach().reshape(-1).view(torch.int32)
    out = torch.zeros(3, dtype=torch.int64, device=t.device)
    for at in range(0, words.numel(), chunk):
        w = words[at:at + chunk].to(torch.int64)
        pos = torch.arange(at + 1, at + 1 + w.numel(), device=w.device)
        out += torch.stack([w.sum(), (w * pos).sum(), (w ^ (w >> 7)).sum()])
    return out


def trained_tensors(state) -> list:
    o = state.opt_state
    return o.params + o.mu + o.nu + (o.acc or [])


def state_digest(state) -> torch.Tensor:
    """The bits of a train state: one :func:`tensor_digest` row for each trained leaf, Adam moment and
    accumulator tensor, and a last row of the update count, the micro-step and the skip counter."""
    o = state.opt_state
    rows = [tensor_digest(t) for t in trained_tensors(state)]
    rows.append(torch.stack([o.count_t, o.mini_step_t, state.skipped_t]).to(torch.int64))
    return torch.stack(rows)


def digest_diffs(state, got: torch.Tensor, want: torch.Tensor) -> list:
    """The names of the tensors (and counters) whose digests differ."""
    o = state.opt_state
    names = [f"{kind}:{n}" for kind in ("param", "mu", "nu") + (("acc",) if o.acc else ()) for n in o.names]
    names.append("counters")
    return [names[i] for i in torch.nonzero((got != want).any(dim=1)).flatten().tolist()]


SNAPSHOT_SHARE = 0.25  # a snapshot stays on the card while it takes at most this share of the free memory


def snapshot(state) -> dict:
    """The train state, to start another run from (:func:`restore`): on the card where it fits well (a
    restore is then a copy on the card), else on the host."""
    o = state.opt_state
    tensors = trained_tensors(state)
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    device = "cuda" if nbytes <= SNAPSHOT_SHARE * torch.cuda.mem_get_info()[0] else "cpu"
    return dict(tensors=[t.detach().to(device, copy=True) for t in tensors], device=device, bytes=nbytes,
                counters=(o.count, o.mini_step, state.skipped), step=state.step)


@torch.no_grad()
def restore(state, snap: dict) -> None:
    """Put a :func:`snapshot` back into the state's tensors, in place (a graph holds them by address)."""
    for t, saved in zip(trained_tensors(state), snap["tensors"]):
        t.copy_(saved)
    state.opt_state.count, state.opt_state.mini_step = snap["counters"][:2]
    state.skipped_t.fill_(snap["counters"][2])
    state.step = snap["step"]


def step_windows(fn, windows: int, steps: int) -> list:
    """ms a step over ``windows`` windows of ``steps`` calls of ``fn``, each ending in a host sync."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        out.append((time.perf_counter() - t) / steps * 1e3)
    return out


def executed_launches(host: dict, graphs) -> dict:
    """The port's kernel launches that ran on the card: the host's counts (eager steps, and each capture's
    recording) less the recordings, plus each graph's kernels times its replays; ``graphs``: (kernels a
    graph holds, its replays) pairs."""
    out = dict(host)
    for kernels, replays in graphs:
        for k, n in kernels.items():
            out[k] += n * (replays - 1)
    return out


def run_sequence(fn, state, batches: list, call, walls: list | None = None) -> list:
    """The losses of ``fn``'s steps on ``batches`` (each read on the host); with ``walls``, each step's ms."""
    losses = []
    for b in batches:
        t = time.perf_counter()
        losses.append(float(call(fn, state, b)[1]["loss"]))
        if walls is not None:
            walls.append((time.perf_counter() - t) * 1e3)
    return losses


def graphed_path(step, state, runs: dict, call, expected: dict, label: str):
    """Phases 6-8's main path: each run of ``runs`` (name -> the batches of one run, ``GRAPH_CHECK_STEPS``
    of one shape) through ``GraphedTrainStep`` from one starting state (the first step of a shape eager
    on the capture stream and captured, the others replays), then its timing; each graph must hold
    ``expected``; then one profiled step of each shape. ``call(fn, state, batch) -> (state, metrics)``.
    Returns (the graphed step, the results by name, the launches the path ran on the card, the
    starting state's snapshot); :func:`eager_reference` then holds the runs to the eager step."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.training.graphs import GraphedTrainStep

    start = snapshot(state)
    graphed = GraphedTrainStep(step)
    results = {}
    _kernels.reset_launch_counts()  # ---- the main path starts here
    for i, (name, batches) in enumerate(runs.items()):
        if i:
            restore(state, start)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        losses = run_sequence(graphed, state, batches[:1], call)
        first_s = time.perf_counter() - t
        losses += run_sequence(graphed, state, batches[1:], call)
        digest = state_digest(state)
        ms = step_windows(lambda: run_sequence(graphed, state, batches[-1:], call), *GRAPH_WINDOWS)
        _, metrics = call(graphed, state, batches[-1])
        results[name] = dict(losses=losses, digest=digest, ms_per_step=statistics.median(ms), windows_ms=ms,
                             first_step_s=first_s, metrics={k: float(v) for k, v in metrics.items()},
                             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    counts = executed_launches(_kernels.launch_counts(),  # ---- and ends here
                               [(g.captured.kernels, g.replays) for g in graphed.graphs.values()])
    if state.skipped or not all(math.isfinite(x) for r in results.values() for x in r["losses"]):
        raise AssertionError(f"{label}: skipped {state.skipped}, losses {[r['losses'] for r in results.values()]}")
    for name, batches in runs.items():
        key, g = next((key, g) for key, g in graphed.graphs.items()
                      if all(g.static[k].shape == v.shape for k, v in batches[0].items()))
        c = g.captured
        if c.kernels != expected:
            raise AssertionError(f"{label}: the graph of {key} holds {c.kernels}, expected {expected}")
        r = results[name]
        r.update(capture_s=c.capture_s, pool_mib=c.pool_bytes / 2**20, replays=g.replays,
                 rows_seq=tuple(batches[0][k].shape for k in batches[0] if k.endswith("ids"))[0], kernels=c.kernels)
        r["profile"] = profiled(lambda: run_sequence(graphed, state, batches[-1:], call), f"{label} {name} graphed step",
                                r["ms_per_step"])
    return graphed, results, counts, start


def eager_reference(step, state, runs: dict, call, expected: dict, label: str, start: dict, results: dict,
                    profile: bool = False) -> None:
    """Each run of :func:`graphed_path` again through the eager step (the plain version; one step must launch
    ``expected``) from the same starting state: every trained leaf, Adam moment and counter must end with
    the graphed run's bits (:func:`state_digest`) and the losses must be the same. The eager step's ms
    (the median of its steps after the first) and, with ``profile``, one profiled step's busy share are
    logged beside the graphed step's, with each graph's capture and pool."""
    from pgica_tpu_torch.ops import _kernels

    for name, batches in runs.items():
        restore(state, start)
        r = results[name]
        torch.cuda.reset_peak_memory_stats()
        before = _kernels.launch_counts()
        walls = []
        losses = run_sequence(step, state, batches[:1], call, walls)
        after = _kernels.launch_counts()
        per_step = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        if per_step != expected:
            raise AssertionError(f"{label} {name}: one eager step launched {per_step}, expected {expected}")
        losses += run_sequence(step, state, batches[1:], call, walls)
        diffs = digest_diffs(state, state_digest(state), r.pop("digest"))
        if diffs or losses != r["losses"]:
            raise AssertionError(f"{label} {name}: after {len(batches)} steps the graphed run differs from the eager "
                                 f"one in {len(diffs)} tensors {diffs[:4]}; losses {r['losses']} against {losses}")
        eager = dict(ms_per_step=statistics.median(walls[1:]), step_ms=walls,
                     peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        if profile:
            eager["profile"] = profiled(lambda: run_sequence(step, state, batches[-1:], call),
                                        f"{label} {name} eager step", eager["ms_per_step"])
        r["eager"] = eager

        def busy(p):
            return f"{100 * p['busy']:.1f}%" if p and p.get("busy") else "not measured"

        log(f"  {label} {name} {r['rows_seq']}: {len(batches)} steps graphed (the first eager, then captured in "
            f"{r['capture_s']:.3f} s, pool {r['pool_mib']:.1f} MiB; the others replays) bit-equal to {len(batches)} "
            f"eager steps from the same state (every trained leaf, Adam moment and counter; the state restored from "
            f"the {start['device']}), losses {', '.join(f'{x:.6f}' for x in losses)}; ms a step graphed "
            f"{r['ms_per_step']:.1f} (windows {', '.join(f'{w:.1f}' for w in r['windows_ms'])}) against eager "
            f"{eager['ms_per_step']:.1f} (steps {', '.join(f'{w:.1f}' for w in walls)}); busy graphed "
            f"{busy(r['profile'])}" + (f", eager {busy(eager.get('profile'))}" if profile else "")
            + f"; peak {r['peak_mem_gib']:.2f} GiB graphed, {eager['peak_mem_gib']:.2f} eager; the graph holds "
            f"{r['kernels']} [{card()}]")


def skip_checks(graphed, state, batch: dict, call, label: str) -> dict:
    """A NaN batch through a replay of ``batch``'s graph: ``skipped`` +1, every other bit kept."""
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0] = float("nan")
    before, replays = state_digest(state), graphed.replays
    _, m = call(graphed, state, bad)
    after = state_digest(state)
    kept = torch.equal(after[:-1], before[:-1]) and torch.equal(after[-1, :2], before[-1, :2])
    if graphed.replays != replays + 1 or not kept or int(after[-1, 2]) != int(before[-1, 2]) + 1 or math.isfinite(
            float(m["loss"])):
        raise AssertionError(f"{label}: a NaN batch through a replay: replays {replays} -> {graphed.replays}, "
                             f"kept {kept}, skipped {int(before[-1, 2])} -> {int(after[-1, 2])}, loss {float(m['loss'])}")
    log(f"  {label}: a NaN batch through a replay: skipped {int(before[-1, 2])} -> {int(after[-1, 2])}, every trained "
        f"leaf, Adam moment and the update count bit-equal to before (loss {float(m['loss'])})")
    return dict(skipped=int(after[-1, 2]))


FORWARD_KERNELS = ("layernorm_fwd", "flash_attn_fwd", "rmsnorm_fwd", "fused_ce_fwd")
EVAL_WINDOWS = (3, 3)  # (windows, calls a window) of an eval step's timing, graphed and eager: the median window


def forward_launches(step_launches: dict) -> dict:
    """What a stage's eval step launches: its train step's forward kernels (the same forward, no backward)."""
    return {k: v for k, v in step_launches.items() if k in FORWARD_KERNELS}


def eval_checks(eval_step, train_graphed, batches: dict, ref, expected: dict, label: str, profile: bool = True):
    """Phases 6-8: the stage's eval step through ``GraphedEvalStep`` (the trainer's route on the card), its graphs
    in ``train_graphed``'s pool as the trainer shares it, against the eager eval step on each batch of
    ``batches``: the eager step launches ``expected``, the key's graph holds as many, and its first call (eager
    on the capture stream) and a replay give the eager step's metrics bit for bit; then ms a call graphed and
    eager (the median of EVAL_WINDOWS, each call ending in a read of the loss) and, with ``profile``, the busy
    share of one profiled call of each. Returns (the graphed eval step, the results by batch)."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.training.graphs import GraphedEvalStep

    graphed = GraphedEvalStep(eval_step, pool_of=train_graphed)
    out = {}
    for name, batch in batches.items():
        args = (ref, batch) if eval_step.takes_ref else (batch,)
        before = _kernels.launch_counts()
        want = {k: v.clone() for k, v in eval_step(*args).items()}
        after = _kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        first = graphed(*args)
        replay = graphed(*args)
        g = next(g for g in graphed.graphs.values() if all(g.static[k].shape == v.shape for k, v in batch.items()))
        if launched != expected or g.captured.kernels != expected or g.replays != 1:
            raise AssertionError(f"{label} eval {name}: the eager step launched {launched}, the graph holds "
                                 f"{g.captured.kernels} ({g.replays} replays), expected {expected}")
        bad = [k for k in want for got in (first, replay) if not torch.equal(got[k], want[k])]
        if bad or first.keys() != want.keys() or not all(math.isfinite(float(v)) for v in want.values()):
            raise AssertionError(f"{label} eval {name}: the graphed metrics differ from the eager step's in {bad}")

        def call(fn):
            return lambda: float(fn(*args)["loss"])

        ms = {"graphed": statistics.median(step_windows(call(graphed), *EVAL_WINDOWS)),
              "eager": statistics.median(step_windows(call(eval_step), *EVAL_WINDOWS))}
        busy = {how: profiled(call(fn), f"{label} {name} {how} eval step", ms[how]).get("busy") if profile else None
                for how, fn in (("graphed", graphed), ("eager", eval_step))}
        out[name] = dict(ms=ms, busy=busy, capture_s=g.captured.capture_s, pool_bytes=g.captured.pool_bytes,
                         kernels=g.captured.kernels, metrics={k: float(v) for k, v in want.items()},
                         shares_pool=graphed.shares_pool)
        shares = ", ".join(f"{how} {100 * b:.1f}%" if b else f"{how} not measured" for how, b in busy.items())
        log(f"  {label} eval step, {name}: graphed (first call eager, captured in {g.captured.capture_s:.3f} s into "
            f"{'the train graphs' if graphed.shares_pool else 'its own'} pool (+{g.captured.pool_bytes / 2**20:.1f} "
            f"MiB), then a replay) bit-equal to the "
            f"eager step in all {len(want)} metrics (loss {float(want['loss']):.6f}); the graph holds the eager "
            f"step's {g.captured.kernels}; ms a call graphed {ms['graphed']:.2f} against eager {ms['eager']:.2f}; "
            f"busy {shares} [{card()}]")
    return graphed, out


def train_after_eval(graphed, step, state, batch: dict, call, start: dict, label: str) -> None:
    """After the eval graphs replayed in the train graphs' pool: one train replay from ``start`` bit-equal to one
    eager step from it (the eval graphs overwrote nothing the train graph keeps)."""
    restore(state, start)
    replays = graphed.replays
    call(graphed, state, batch)
    got = state_digest(state)
    restore(state, start)
    call(step, state, batch)
    diffs = digest_diffs(state, got, state_digest(state))
    if graphed.replays != replays + 1 or diffs:
        raise AssertionError(f"{label}: the train replay after the eval replays differs from the eager step in "
                             f"{diffs[:4]} (replays {replays} -> {graphed.replays})")
    log(f"  {label}: a train replay after the eval graphs replayed in its pool is bit-equal to the eager step from "
        "the same state (every trained leaf, Adam moment and counter)")


ACCUMULATION_STEPS = 9  # 12c's and phase 9's accumulation of 4: a NaN at micro-step 2 delays the first update to
# micro-step 4; the second, at 8, replays the update's graph


def accumulation_check(module, batch: dict, trainer_route: bool = False) -> dict:
    """Gradient accumulation 4 on the flagship's stage 1 (configs/default.yaml's), ACCUMULATION_STEPS micro-steps
    on ``batch`` with a NaN batch at micro-step 2, through the eager step and through the graphs from one
    starting state: the same bits, both graphs (accumulate, update) replayed. With ``trainer_route``, as
    phase 9's trainer runs it: every block checkpointed and the images augmented, with the model's dropout
    (0.1 in the text tower that trains), so that the captured recomputes (their dropout drawn from
    ReplayStreams' generators) are held to the eager step's."""
    from pgica_tpu_torch.ops.dropout import FastDropout
    from pgica_tpu_torch.training.graphs import GraphedTrainStep
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState, make_stage1_train_step

    opt = create_optimizer(5e-5, 1000, 10, gradient_accumulation_steps=4, freeze_vision_backbone=True,
                           frozen_prefixes=("caption_decoder",))
    state = TrainState.create(module, opt)
    step = make_stage1_train_step(module, opt, temperature=0.5, augment=trainer_route)
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][0] = float("nan")
    batches = [bad if i == 2 else batch for i in range(ACCUMULATION_STEPS)]
    rates = sorted({m.rate for m in module.text_encoder.modules() if isinstance(m, FastDropout)})
    label = "accumulation 4" + (f", checkpointing, augmentation and the text tower's dropout {rates}"
                                if trainer_route else "")

    def call(fn, st, b):
        return fn(st, b, 0)

    configs = {m: m.config for m in module.modules() if hasattr(getattr(m, "config", None), "remat")}
    set_remat(module, trainer_route)
    try:
        start = snapshot(state)
        eager = run_sequence(step, state, batches, call)
        want = state_digest(state)
        restore(state, start)
        graphed = GraphedTrainStep(step)
        losses = run_sequence(graphed, state, batches, call)
        diffs = digest_diffs(state, state_digest(state), want)
        replays = {"update" if key[0] else "accumulate": g.replays for key, g in graphed.graphs.items()}
        blocks = [len(g.streams.generators) for g in graphed.graphs.values()]
        counters = (state.opt_state.count, state.opt_state.mini_step, state.skipped)
        graphed.close()
    finally:
        for m, config in configs.items():
            m.config = config
    if diffs or str(losses) != str(eager) or counters != (2, 0, 1) or min(replays.values()) == 0 or len(replays) != 2 \
            or (trainer_route and (min(blocks) == 0 or max(rates) == 0)):
        raise AssertionError(f"{label} with a NaN at micro-step 2: the graphs differ from the eager step in "
                             f"{diffs[:4]}, losses {losses} against {eager}, counters {counters}, replays {replays}, "
                             f"recomputed blocks a graph {blocks}")
    log(f"  {label}, {ACCUMULATION_STEPS} micro-steps at {tuple(batch['caption_ids'].shape)} with a NaN batch at "
        f"micro-step 2: the graphs (replays {replays}; blocks recomputed under their own generators {blocks}) "
        f"bit-equal to the eager step from the same state (every trained leaf, Adam moment, accumulator and "
        f"counter; losses {', '.join(f'{x:.6f}' for x in losses)}); update count, micro-step, skipped {counters}")
    return dict(replays=replays, counters=counters, recomputed_blocks=blocks)


def check_main_path(label: str, counts: dict, kernels) -> None:
    missing = [k for k in kernels if counts[k] == 0]
    if missing:
        raise AssertionError(f"the {label} path did not launch {missing}: {counts}")
    log(f"  {label} main-path launch counts: {counts}")


def check_f32_route(label: str, counts: dict, min_sq: int) -> None:
    """A float32 path's flash forwards went through the register-tiled kernel (flash_attn_fwd_f32, counted
    beside flash_attn_fwd): all of them where the path's shortest attention, ``min_sq`` rows, reaches
    F32_TILED_MIN_SQ, else at least one."""
    from pgica_tpu_torch.ops.flash_attention import F32_TILED_MIN_SQ

    every = min_sq >= F32_TILED_MIN_SQ
    tiled, launched = counts["flash_attn_fwd_f32"], counts["flash_attn_fwd"]
    if tiled == 0 or tiled > launched or (every and tiled != launched):
        raise AssertionError(f"{label}: {tiled} of {launched} f32 flash forwards took flash_attn_fwd_f32")
    log(f"  {label}: {tiled} of {launched} flash forwards took flash_attn_fwd_f32")


# ------------------------------------------------------------------ phase 6

# launches of one flagship stage-1 step: ViT (frozen, forward only) pre_ln + 12 x 2 + post_ln and
# its projection ln; text tower 24 x 2 + ln_f and its projection ln; the backward of every LN
# that trains; 12 + 24 attention forwards, 24 backwards
STAGE1_STEP_LAUNCHES = {"layernorm_fwd": 27 + 50, "flash_attn_fwd": 12 + 24, "layernorm_bwd": 51,
                        "flash_attn_bwd_dq": 24, "flash_attn_bwd_dkv": 24}


def phase_stage1(model) -> dict:
    from pgica_tpu_torch.training.train_step import make_stage1_eval_step

    model._inference_cache = model._decode_graphs = model._entry_graphs = None  # frees serving's bf16 copy and
    # its graphs for training (a later request would recast and capture them again)
    torch.cuda.empty_cache()
    state, step, _ = stage1_trainer(model.module, lr=5e-5, warmup=10, total=1000)  # bench.py's optimizer
    rng = np.random.default_rng(0)
    batches = {name: on_card(b, name) for name, b in (("full-pad", stage1_batch(rng, 128, 128)),
                                                      ("bucketed", stage1_batch(rng, 128, 128, (8, 28))))}

    def call(fn, st, b):
        return fn(st, b, 0)

    runs = {name: [b] * GRAPH_CHECK_STEPS for name, b in batches.items()}
    graphed, results, main_counts, start = graphed_path(step, state, runs, call, STAGE1_STEP_LAUNCHES, "stage 1")
    check_main_path("stage-1, graphed (2 x (3 + 10) steps)", main_counts, STAGE1_STEP_LAUNCHES)
    eval_graphed, evals = eval_checks(make_stage1_eval_step(model.module, 0.5), graphed, batches, None,
                                      forward_launches(STAGE1_STEP_LAUNCHES), "stage 1")
    train_after_eval(graphed, step, state, batches["bucketed"], call, start, "stage 1 bucketed")
    nan = skip_checks(graphed, state, batches["bucketed"], call, "stage 1 bucketed")
    eval_graphed.close()
    graphed.close()
    eager_reference(step, state, runs, call, STAGE1_STEP_LAUNCHES, "stage 1", start, results, profile=True)
    del state, step, graphed, start
    gc.collect()
    torch.cuda.empty_cache()
    accumulation = accumulation_check(model.module, batches["bucketed"])
    trainer_route = accumulation_check(model.module, batches["bucketed"], trainer_route=True)
    return dict(main_counts=main_counts, shapes=results, nan=nan, accumulation=accumulation,
                trainer_route=trainer_route, evals=evals)


# ------------------------------------------------------------------ phase 7

# launches of one flagship stage-2 step: policy and reference each run the ViT (pre_ln + 12 x 2 +
# post_ln, the projection ln; 12 attentions) and the decoder (cross_ln + 24 x 2 + ln_f; 24
# self-attentions; the cross-attention to the one vision token is plain PyTorch, as in JAX), and
# one fused-CE forward; the policy's backward runs the decoder's 50 LN and 24 attention
# backwards, the vision head's LN backward (the ViT backbone is frozen) and dh and dW
STAGE2_STEP_LAUNCHES = {"layernorm_fwd": 2 * (27 + 50), "flash_attn_fwd": 2 * (12 + 24), "layernorm_bwd": 51,
                        "flash_attn_bwd_dq": 24, "flash_attn_bwd_dkv": 24, "fused_ce_fwd": 2,
                        "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}


STAGE2_FREE_EVAL_LAUNCHES = {"layernorm_fwd": 27 + 50, "flash_attn_fwd": 12 + 24, "fused_ce_fwd": 1}


def check_dpo(label: str, r: dict) -> None:
    if not all(x > 0 for x in r["losses"]) or not r["metrics"]["policy_chosen_logp"] < 0:
        raise AssertionError(f"{label}: losses {r['losses']}, metrics {r['metrics']}")


def phase_stage2(model) -> dict:
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.training.train_step import make_stage2_eval_step, make_stage2_train_step

    torch.cuda.empty_cache()
    ref = frozen_copy(model.module, torch.bfloat16)  # the trainer's default: the policy at stage-2 start, bf16
    state, _, opt, _ = stage2_trainer(model.module, ref, lr=1e-5, warmup=10, total=1000)  # bench.py's optimizer
    step = make_stage2_train_step(model.module, opt, beta=0.1)
    rng = np.random.default_rng(0)
    batches = {name: on_card(b, name) for name, b in (("full-pad", stage2_batch(rng, 32, 128)),
                                                      ("bucketed", stage2_batch(rng, 32, 128, (8, 28))))}

    def call(fn, st, b):
        return fn(st, ref, b, 0)

    runs = {name: [b] * GRAPH_CHECK_STEPS for name, b in batches.items()}
    graphed, results, main_counts, start = graphed_path(step, state, runs, call, STAGE2_STEP_LAUNCHES, "stage 2")
    for name, r in results.items():
        check_dpo(f"stage 2 {name}", r)
    check_main_path("stage-2, graphed (2 x (3 + 10) steps)", main_counts, STAGE2_STEP_LAUNCHES)
    eval_graphed, evals = eval_checks(make_stage2_eval_step(model.module, 0.1), graphed, batches, ref,
                                      forward_launches(STAGE2_STEP_LAUNCHES), "stage 2")
    # reference-free: the policy's forward only, one fused-CE forward
    free_graphed, free = eval_checks(make_stage2_eval_step(model.module, 0.1, reference_free=True), graphed,
                                     {"bucketed": batches["bucketed"]}, None, STAGE2_FREE_EVAL_LAUNCHES,
                                     "stage 2 reference-free", profile=False)
    train_after_eval(graphed, step, state, batches["full-pad"], call, start, "stage 2 full-pad")
    free_graphed.close()
    eval_graphed.close()
    graphed.close()
    eager_reference(step, state, runs, call, STAGE2_STEP_LAUNCHES, "stage 2", start, results, profile=True)
    return dict(main_counts=main_counts, shapes=results, evals=evals, reference_free_eval=free)


# ------------------------------------------------------------------ phase 8

LLAMA_LAYERS = 4
# What phase 8 cuts from configs/siglip_llama8b.yaml, and why (PERF.md §4 has the arithmetic)
LLAMA_REDUCED = (
    f"each Llama-3-8B tower (text tower and caption decoder) runs {LLAMA_LAYERS} of its 32 layers at full width: "
    "stage 2 under the trainer's partition then holds the trained decoder (1.47 B parameters x 16 B of f32 "
    "master, gradient and two Adam moments = 23.5 GB), the frozen text tower and SigLIP in f32 (1.81 B x 4 B = "
    "7.2 GB) and the bf16 reference (3.28 B x 2 B = 6.6 GB), ~37 GB before activations and AdamW's temporaries; "
    "8 layers would hold ~58 GB, and the full 32-layer decoder's training state alone ~120 GB, past one 80 GB card",
    "every train step is an update (gradient accumulation 1 where the config has 4); warmup 500 of 1,000 steps",
)
# launches of one image encode (SigLIP pre_ln + 27 x 2 + post_ln and the projection ln; 27
# attentions) and of one decoder forward at decode (2 RMSNorms per block and ln_f; one attention
# per block; the cross-attention does not run at decode, decoder.py:16-21)
SIGLIP_ENCODE = {"layernorm_fwd": 1 + 2 * 27 + 1 + 1, "flash_attn_fwd": 27}
LLAMA_FORWARD = {"rmsnorm_fwd": 2 * LLAMA_LAYERS + 1, "flash_attn_fwd": LLAMA_LAYERS}
LLAMA_DECODE = {"layernorm_fwd": 0, **LLAMA_FORWARD}  # as the profiler counts a replay's kernels
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
# phase 4's optimizer replay at Llama width skips the leaves larger than this: the 128,256 x 4,096 token
# embedding and the three 4,096 x 14,336 MLP matrices (PHASE4_REDUCED)
REPLAY_MAX = 20_000_000
# phase 4's two architectures: 2 layers a tower for GPT-2, 1 for SigLIP + Llama (PHASE4_REDUCED)
PHASE4_REDUCED = ("SigLIP + Llama-3-8B runs 1 layer a tower (2 before: its CPU reference took 142.5-178.2 s of "
                  "the run; one layer still runs every kernel and path of the architecture)",
                  "its train steps take 2 captions and 1 pair (4 and 4 at first, then 2 and 2): the CPU's steps over "
                  "the 128,256-row vocab set the phase's time",
                  "the stage-2 reference of both architectures is the CPU model's frozen copy with every matrix's rows "
                  "rolled by one (a model built from another seed before: 12.7 s of the Llama run's CPU time)",
                  f"the CPU replay of its card optimizer leaves out the leaves of more than {REPLAY_MAX:,} elements (the "
                  "token embedding, 35 s of CPU Adam over it at first; then the MLP matrices, ~10 s a stage at a "
                  "100,000,000 limit; the replay keeps the attention, norm and projection leaves; GPT-2's keeps every "
                  "leaf)")
FULL_WIDTH = {
    "gpt2": dict(vision="openai/clip-vit-base-patch32", text="gpt2-medium", vocab=GPT2_VOCAB, stage1_batch=8,
                 stage2_batch=4, layers=2,
                 serving=SERVING_KERNELS, stage1=STAGE1_STEP_LAUNCHES, stage2=STAGE2_STEP_LAUNCHES,
                 stage2_frozen=None),
    "llama": dict(vision=SIGLIP, text=LLAMA, vocab=LLAMA_VOCAB, stage1_batch=2, stage2_batch=1, layers=1,
                  serving=LLAMA_SERVING_KERNELS,
                  stage1=LLAMA_STAGE1_LAUNCHES, stage2=LLAMA_STAGE2_LAUNCHES, stage2_frozen="text_encoder",
                  replay_max=REPLAY_MAX),
}


def phase_llama(tokenizer) -> dict:
    from pgica_tpu_torch.training.train_step import make_stage1_eval_step, make_stage2_eval_step, make_stage2_train_step
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine
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
    # configs/siglip_llama8b.yaml's generate_config: 4 beams (which ignore its sampling flags)
    sample = dict(max_length=128, do_sample=True, top_p=0.9, temperature=0.8, early_stop=True, **BEAMS)
    model.generate_captions(images[:1], **{**sample, "max_length": 4})  # the bf16 copy, cuBLAS handles
    torch.cuda.synchronize()
    log(f"  built (random weights, seed 0, f32 masters and a bf16 copy) and warmed in {time.perf_counter() - t0:.1f} "
        f"s: {sum(p.numel() for p in model.module.parameters()):,} parameters, image {size} px; reduced: "
        + "; ".join(LLAMA_REDUCED))

    def request(batch: int, seed: int) -> dict:
        before, entries = _kernels.launch_counts(), entry_state(model)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        captions = model.generate_captions(images[:batch], seed=seed, **sample)
        seconds = time.perf_counter() - t  # ends in a device->host copy of the ids
        if len(captions) != batch or not all(isinstance(c, str) for c in captions):
            raise AssertionError(f"generate_captions returned {captions!r}")
        after = _kernels.launch_counts()
        launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        encode = entry_launches(model, entries, SIGLIP_ENCODE, f"llama request, batch {batch}")
        forwards = (launches.get("flash_attn_fwd", 0) - encode["flash_attn_fwd"]) // LLAMA_LAYERS
        want = {"layernorm_fwd": encode["layernorm_fwd"],
                "flash_attn_fwd": encode["flash_attn_fwd"] + LLAMA_FORWARD["flash_attn_fwd"] * forwards,
                "rmsnorm_fwd": LLAMA_FORWARD["rmsnorm_fwd"] * forwards}
        want = {k: v for k, v in want.items() if v}
        # the prefix from the host, the steps replays of the two beam graphs (captured at a shape's first call),
        # the encode a replay of its graph (captured at the shape's first call)
        if launches != want or forwards not in (1, 1 + BEAM_CAPTURE_FORWARDS):
            raise AssertionError(f"llama request, batch {batch}: launched {launches}, expected {want}")
        r = dict(batch=batch, seconds=seconds, decoder_forwards=forwards, launches=launches,
                 peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(f"  request batch {batch} x max_length {sample['max_length']} (4 beams, early_stop): {seconds * 1e3:.1f} ms, "
            f"{batch / seconds:.2f} captions/s, decoder forwards from the host {forwards}, launches {launches} (as "
            f"expected), peak {r['peak_mem_gib']:.2f} GiB")
        return r

    _kernels.reset_launch_counts()  # ---- the serving path starts here
    served = [request(batch, seed) for seed, batch in enumerate((1, 8, 1, 8))]  # the second of each is warm
    serving_counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("Llama serving", serving_counts, LLAMA_SERVING_KERNELS)
    beam_checks = {batch: beam_graph_checks(model, images[:batch], LLAMA_FORWARD, f"Llama slice, batch {batch}")
                   for batch in (1, 8)}
    module = model._inference_module()
    with torch.inference_mode():  # outputs: finite first-token logits of the expected shape
        emb = model.encode_image(images)["embeddings"]
        mask = torch.zeros(8, 2, dtype=torch.int32, device="cuda")
        mask[:, 0] = 1
        first, _ = module.decode_prefix(emb, init_kv_cache(module.decoder_config, 8, 2, torch.bfloat16, "cuda"), mask)
    if first.shape != (8, LLAMA_VOCAB) or not bool(torch.isfinite(first).all()):
        raise AssertionError(f"llama prefix logits: shape {tuple(first.shape)}, finite {bool(torch.isfinite(first).all())}")
    log(f"  prefix logits (8, {LLAMA_VOCAB}) bf16: all finite")
    serving_profile = profiled(lambda: model.generate_captions(images, seed=9, **sample), "batch-8 4-beam request",
                               served[-1]["seconds"] * 1e3)

    log(f"  -- phase 10 on the Llama slice: the continuous-batching engine (slots {LLAMA_SLOTS}, chunk {SERVE_CHUNK}, "
        f"max_length {SERVE_MAX_LENGTH}) and the decode graphs")
    eng = ContinuousDecodeEngine(model, slots=LLAMA_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH)
    eng.warmup()
    engine_images = np.random.default_rng(14).integers(0, 256, size=(2 * LLAMA_SLOTS, size, size, 3), dtype=np.uint8)
    engine = graph_checks(model, eng, engine_images, LLAMA_DECODE, "Llama slice", SIGLIP_ENCODE)
    eng.start()
    entries = entry_state(model)
    _kernels.reset_launch_counts()  # ---- the Llama engine path starts here
    engine_against_batch(eng.submit, model, engine_images, 2, "Llama engine against the batch path")
    # the batch path's encodes replay their graphs: SigLIP's LayerNorms run only there and in the engine's
    # admission graphs, so the path's counts take the entry graphs' replays in
    engine_counts = entry_executed(model, _kernels.launch_counts(), entries)  # ---- and ends here
    check_main_path("Llama engine", engine_counts, LLAMA_SERVING_KERNELS)
    eng.stop()
    del eng  # it holds the bf16 copy, which training frees
    quant = quant_llama(model)

    model._inference_cache = model._decode_graphs = model._entry_graphs = None  # frees serving's bf16 copy and
    # its graphs for training (a later request would recast and capture them again)
    torch.cuda.empty_cache()
    rng = np.random.default_rng(1)
    state, step, _ = stage1_trainer(model.module, lr=5e-5, warmup=500, total=1000)
    batch = on_card(stage1_batch(rng, 4, 512, image=size, vocab=LLAMA_VOCAB), "Llama stage-1")
    runs, call = {"4 x 512": [batch] * GRAPH_CHECK_STEPS}, (lambda fn, st, b: fn(st, b, 0))
    graphed, results, stage1_counts, start = graphed_path(step, state, runs, call, LLAMA_STAGE1_LAUNCHES,
                                                          "Llama stage 1")
    check_main_path("Llama stage-1, graphed (3 + 10 steps)", stage1_counts, LLAMA_STAGE1_LAUNCHES)
    eval_graphed, eval1 = eval_checks(make_stage1_eval_step(model.module, 0.5), graphed, {"4 x 512": batch}, None,
                                      forward_launches(LLAMA_STAGE1_LAUNCHES), "Llama stage 1")
    eval_graphed.close()
    graphed.close()
    eager_reference(step, state, runs, call, LLAMA_STAGE1_LAUNCHES, "Llama stage 1", start, results)
    stage1 = results["4 x 512"]
    del state, step, graphed, start
    gc.collect()
    torch.cuda.empty_cache()

    ref = frozen_copy(model.module, torch.bfloat16)  # the trainer's reference: the policy at stage-2 start, bf16
    state, _, opt, _ = stage2_trainer(model.module, ref, lr=1e-5, warmup=500, total=1000, frozen="text_encoder")
    step = make_stage2_train_step(model.module, opt, beta=0.1)
    batch = on_card(stage2_batch(rng, 2, 512, image=size, vocab=LLAMA_VOCAB), "Llama stage-2")
    runs, call = {"2 pairs x 512": [batch] * GRAPH_CHECK_STEPS}, (lambda fn, st, b: fn(st, ref, b, 0))
    graphed, results, stage2_counts, start = graphed_path(step, state, runs, call, LLAMA_STAGE2_LAUNCHES,
                                                          "Llama stage 2")
    stage2 = results["2 pairs x 512"]
    check_dpo("Llama stage 2", stage2)
    check_main_path("Llama stage-2, graphed (3 + 10 steps)", stage2_counts, LLAMA_STAGE2_LAUNCHES)
    eval_graphed, eval2 = eval_checks(make_stage2_eval_step(model.module, 0.1), graphed, {"2 pairs x 512": batch},
                                      ref, forward_launches(LLAMA_STAGE2_LAUNCHES), "Llama stage 2")
    eval_graphed.close()
    graphed.close()
    eager_reference(step, state, runs, call, LLAMA_STAGE2_LAUNCHES, "Llama stage 2", start, results)
    del start
    return dict(served=served, serving_profile=serving_profile, beam_checks=beam_checks, engine=engine, stage1=stage1,
                stage2=stage2, quant=quant, evals={"stage1": eval1, "stage2": eval2},
                counts={"llama_serving": serving_counts, "llama_engine": engine_counts, "llama_stage1": stage1_counts,
                        "llama_stage2": stage2_counts, "llama_int8": quant["counts"]})


# ------------------------------------------------------------------ phase 9

ROOT = Path(__file__).resolve().parent
PHASE9_DIR = ROOT / "build" / "phase9"
PHASE9_STEPS = 8
PHASE9_LAYERS = 4  # phases 9 and 11b: each tower's layers (ViT-B/32: 12, GPT-2 Medium: 24)
PHASE9_SAVE_STEPS = 7  # one autosave a stage (5 wrote three of 7.5 GB: the run's disk is limited)
# What phase 9 changes in configs/default.yaml, and why; width and depth are the config's
PHASE9_SAMPLES = 88  # split 73/19/8: 64 to train (8 batches), 16 to validate (2 batches), 8 to test
PHASE9_SPLITS = {"train_split": 0.73, "val_split": 0.19, "test_split": 0.08}
PHASE9_REDUCED = (
    f"each tower runs {PHASE9_LAYERS} of its layers at full width (ViT-B/32 12, GPT-2 Medium 24): at full depth "
    "phase 9 and 11b took ~175 s of a run that phase 16 took past ~1,100 s on a slow host, at 12 layers 116 s of a "
    "1,005 s run on another, and at 6 layers 76.8 s of a 934.1 s run, past the run's budget on a third; the CLIs "
    "read depth from the presets, which the phase cuts",
    "stage 1 and stage 2 run 1 epoch each (the config: 10 and 5)",
    f"model.vocab_size {GPT2_VOCAB:,}, GPT-2's BPE vocab and the five specials (as phases 5-7): the config leaves "
    "the vocab to the tokenizer, and offline, without GPT-2's vocab.json, that is the byte tokenizer's 261",
    f"the data paths point at {PHASE9_SAMPLES} synthetic JPEGs (256-480 px a side) with captions, written to "
    "build/phase9/data as a CSV (Conceptual Captions) and a preference JSON (UltraFeedback): the datasets are "
    "not in the repository",
    f"data splits {PHASE9_SPLITS} (the config: 0.8/0.1/0.1 of 80 before): 64 to train as before, 16 to validate, "
    "so that each stage's validation runs two batches of one shape and replays its eval graph, 8 to test",
    f"--max-steps {PHASE9_STEPS}: {PHASE9_STEPS} micro-steps a stage, 2 updates at the config's gradient "
    "accumulation of 4",
    f"training.save_steps {PHASE9_SAVE_STEPS} (the config: 1000), so that stage 1 leaves a mid-epoch, "
    "mid-accumulation autosave to resume from",
    "outputs, checkpoints and logs under build/phase9, deleted at the end; wandb disabled (WANDB_MODE)",
)
# every training kernel of the flagship's two stages
TRAIN_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                 "fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")


def phase9_data() -> tuple[Path, Path]:
    """PHASE9_SAMPLES seeded JPEGs of varied sizes with captions: a Conceptual Captions CSV and an
    UltraFeedback preference JSON (the preferred caption is the image's, the rejected one its first
    two words), both in the formats the loaders read."""
    import csv
    import io

    from PIL import Image

    from pgica_tpu_torch.utils.factories import _dummy_caption

    rng = np.random.default_rng(9)
    data = PHASE9_DIR / "data"
    (data / "images").mkdir(parents=True)
    rows, pairs = [], []
    for i in range(PHASE9_SAMPLES):
        h, w = (int(x) for x in rng.integers(256, 481, size=2))
        coarse = Image.fromarray(rng.integers(0, 256, size=(6, 6, 3), dtype=np.uint8)).resize((w, h), Image.BICUBIC)
        pixels = np.asarray(coarse, np.int16) + rng.integers(-12, 13, size=(h, w, 3), dtype=np.int16)
        buf = io.BytesIO()
        Image.fromarray(pixels.clip(0, 255).astype(np.uint8)).save(buf, format="JPEG", quality=90)
        path = data / "images" / f"{i:04d}.jpg"
        path.write_bytes(buf.getvalue())
        caption = _dummy_caption(rng)
        rows.append({"image_path": f"images/{path.name}", "caption": caption})
        pairs.append({"image_path": f"images/{path.name}", "preferred_caption": caption,
                      "rejected_caption": " ".join(caption.split()[:2]), "preference_score": 0.9})
    with open(data / "captions.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["image_path", "caption"])
        writer.writeheader()
        writer.writerows(rows)
    (data / "preferences.json").write_text(json.dumps(pairs))
    return data / "captions.csv", data / "preferences.json"


def phase9_config() -> Path:
    """configs/default.yaml with PHASE9_REDUCED's changes, written to build/phase9."""
    import yaml

    captions, preferences = phase9_data()
    cfg = yaml.safe_load((ROOT / "configs" / "default.yaml").read_text())
    cfg["training"]["stage1"]["num_epochs"] = 1
    cfg["training"]["stage2"]["num_epochs"] = 1
    cfg["training"]["save_steps"] = PHASE9_SAVE_STEPS
    cfg["data"].update(PHASE9_SPLITS)
    cfg["data"]["conceptual_captions_path"] = str(captions)
    cfg["data"]["ultrafeedback_path"] = str(preferences)
    # the flagship's vocab, as phases 5-7 (bench.py): the offline byte tokenizer's ids are a subset
    cfg["model"]["vocab_size"] = GPT2_VOCAB
    cfg["paths"] = {"output_dir": str(PHASE9_DIR / "run"), "checkpoint_dir": str(PHASE9_DIR / "run" / "checkpoints"),
                    "log_dir": str(PHASE9_DIR / "logs"), "cache_dir": str(PHASE9_DIR / "cache")}
    kept = (cfg["hardware"]["mixed_precision"], cfg["hardware"]["gradient_checkpointing"],
            cfg["training"]["stage1"]["gradient_accumulation_steps"], cfg["data"]["native_decode"],
            cfg["data"]["device_side_normalization"])
    if kept != ("bf16", True, 4, "fast", True):
        raise AssertionError(f"configs/default.yaml changed under phase 9: {kept}")
    path = PHASE9_DIR / "default_phase9.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def graph_report(trainer, label: str, replayed: bool = True) -> dict:
    """Hold a CLI run's graphed train and eval steps (``trainer.graphs``, each stage's validation under
    ``eval``) to the trainer's rule: an eager step only at each key's first sighting, then replays (at least
    one a stage where ``replayed``), the eval graphs in the train graphs' pool; log each stage's keys,
    replays, capture seconds and pool."""
    out = {}
    for stage, g in sorted(trainer.graphs.items()):
        e = g.get("eval")
        for what, r in (("train", g), ("eval", e)):
            if r is None or r["keys"] == 0 or r["eager_steps"] != r["keys"] or (replayed and r["replays"] == 0) or (
                    what == "eval" and not r["shares_pool"]):
                raise AssertionError(f"{label} stage {stage} {what}: {r}")
            log(f"  {label} stage {stage} {what}: {r['keys']} graphs (one eager step each, at the key's first "
                f"sighting), {r['replays']} replays; captures " + ", ".join(f"{x:.3f}" for x in r["capture_s"])
                + f" s; pool {r['pool_bytes'] / 2**20:.1f} MiB" + (" (the train graphs')" if what == "eval" else ""))
        keep = ("keys", "eager_steps", "replays", "capture_s", "pool_bytes")
        out[stage] = {**{k: g[k] for k in keep}, **({"eval": {k: e[k] for k in keep}} if e else {})}
    if not out:
        raise AssertionError(f"{label}: the trainer took no graphed step")
    return out


def cli_executed(host: dict, trainer) -> dict:
    """A CLI run's launches that ran on the card (:func:`executed_launches` over the trainer's graphs)."""
    return executed_launches(host, [pair for g in trainer.graphs.values()
                                    for pair in zip(g["kernels"], g["replays_by_key"])])


def show_stage(stage: str, record: dict, profile: dict | None, first_step: int = 0) -> dict:
    """A stage's train-step walls (the device time between CUDA events around each step: the graphed steps
    end in no host sync), the ms per update of an accumulation of 4 (micro-steps 4-7, ending in an
    update), the device busy share over the profiled window (kernel time over the window's wall,
    synchronized at both ends, its autosave left out) and the peak."""
    steps = record["step_seconds"]
    r = dict(step_ms=[x * 1e3 for x in steps], first_ms=steps[0] * 1e3,
             ms_per_micro_step=statistics.median(steps[1:]) * 1e3 if len(steps) > 1 else steps[0] * 1e3,
             peak_mem_gib=record["peak_mem_gib"], train_loss=record["train_loss"], val_loss=record["val_loss"])
    if len(steps) >= 8:
        r["ms_per_update"] = sum(steps[4:8]) * 1e3
    if profile and profile.get("busy"):
        r.update(busy=profile["busy"], profile=profile)
        r["host_top"] = [dict(name=n, ms=ms, calls=c) for n, ms, c in profile["host_top"]]
    log(f"  {stage}: micro-steps {first_step}.. ms " + ", ".join(f"{x:.1f}" for x in r["step_ms"])
        + f"; median after the first {r['ms_per_micro_step']:.1f} ms"
        + (f", {r['ms_per_update']:.1f} ms an update (micro-steps 4-7)" if "ms_per_update" in r else "")
        + (f"; peak {r['peak_mem_gib']:.2f} GiB" if r["peak_mem_gib"] is not None else "")
        + f"; train loss {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}" + (
            f"; profiled micro-steps 2-7 (host and CUDA activity): kernel time {profile['device_ms']:.1f} ms "
            f"({profile['device_ms'] / profile['steps']:.1f} a micro-step) over {profile['launches']} launches in a "
            f"window of {profile['wall_ms']:.1f} ms (data included, {profile['autosave_ms']:.1f} ms of autosave left "
            f"out; the host tracing's cost included) -> device busy {100 * r['busy']:.1f}%; the steps' walls "
            f"{profile['step_ms']:.1f} ms; memory copies {profile['memcpy_ms']:.1f} ms" if "busy" in r else ""))
    if "host_top" in r:
        log(f"    host, inside the profiled steps: operators, autograd nodes and CUDA runtime calls "
            f"{profile['host_ms']:.1f} ms of self time; largest: " + "; ".join(f"{h['name']} {h['ms']:.1f} ms / {h['calls']}" for h in r["host_top"]))
    return r


def phase9_data_path(trainer) -> str:
    """Hold phase 9 to the config's data path: the files' datasets, uint8 batches (normalized on the
    card), the vocab; and say which decoder read the JPEGs."""
    from pgica_tpu_torch.data import native_image
    from pgica_tpu_torch.data.loader import ConceptualCaptionsDataset, UltraFeedbackDataset

    views = (trainer.train_loader.dataset, trainer.preference_train_loader.dataset)
    kinds = tuple(type(v.dataset) for v in views)
    processor = views[0].dataset.image_processor
    image = views[0][0]["image"]
    vocab = trainer.model.module.decoder_config.vocab_size
    if (kinds != (ConceptualCaptionsDataset, UltraFeedbackDataset) or image.dtype != np.uint8
            or (processor.native_decode, processor.device_side_normalization) != ("fast", True)
            or vocab != GPT2_VOCAB):
        raise AssertionError(f"phase 9 left the config's data path: {kinds}, images {image.dtype}, "
                             f"{processor.native_decode}, {processor.device_side_normalization}, vocab {vocab}")
    path = views[0].dataset.data[views[0].indices[0]]["image_path"]
    native = native_image.decode_resize_jpeg(Path(path).read_bytes(), processor.image_size, prescale=True)
    if native is not None and np.array_equal(native, image):
        decoder = "native/image.cpp (built with g++ and libjpeg)"
    elif native_image.get_library() is None:
        decoder = f"PIL: the native decoder did not build here ({native_image.build_error})"
    else:
        raise AssertionError(f"{path}: the native decoder rejected the file, or its image is not the batch's")
    return (f"data: {len(views[0])} + {len(views[1])} training samples from the JPEG files, decoded by {decoder}, "
            f"shipped as uint8 {tuple(image.shape)} and normalized on the card; decoder vocab {vocab:,}")


def same_checkpoint(a: Path, b: Path) -> str:
    """Hold two checkpoints' parameters and optimizer state to each other, bit for bit."""
    pa, pb = (torch.load(p / "state.pt", map_location="cpu", weights_only=True) for p in (a, b))
    diffs = [k for k in pa["params"] if not torch.equal(pa["params"][k], pb["params"][k])]
    oa, ob = pa["opt_state"], pb["opt_state"]
    for key in ("mu", "nu"):
        diffs += [f"{key}:{n}" for n in oa["names"] if not torch.equal(oa[key][n], ob[key][n])]
    if (oa["count"], oa["mini_step"], oa["acc"] is None) != (ob["count"], ob["mini_step"], ob["acc"] is None):
        diffs.append("counters")
    if diffs:
        worst = max((float((pa["params"][k].float() - pb["params"][k].float()).abs().max()), k)
                    for k in diffs if k in pa["params"]) if any(k in pa["params"] for k in diffs) else None
        raise AssertionError(f"the resumed run differs from the uninterrupted one in {len(diffs)} tensors "
                             f"({diffs[:4]}); largest parameter difference {worst}")
    return (f"{len(pa['params'])} parameters and {2 * len(oa['names'])} Adam moments bit-identical, count "
            f"{oa['count']}, mini-step {oa['mini_step']}")


def phase_train_cli() -> dict:
    """Phase 9: ``python -m pgica_tpu_torch.scripts.train``'s main path at the flagship's full width."""
    import os

    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.scripts import train as train_cli

    shutil.rmtree(PHASE9_DIR, ignore_errors=True)
    PHASE9_DIR.mkdir(parents=True)
    os.environ["WANDB_MODE"] = "disabled"
    try:
        with cut_presets(PHASE9_LAYERS):  # phase 11b's CLIs read the same depth from the presets
            cfg_path = phase9_config()
            log(f"  configs/default.yaml (GPT-2 flagship, bf16, gradient checkpointing, accumulation 4, native decode "
                f"fast, device-side normalization) written to {cfg_path.relative_to(ROOT)}; changed: "
                + "; ".join(PHASE9_REDUCED))
            _kernels.reset_launch_counts()  # ---- the main path starts here
            t = time.perf_counter()
            trainer = train_cli.run(["--config", str(cfg_path), "--max-steps", str(PHASE9_STEPS),
                                     "--profile-dir", str(PHASE9_DIR / "profile")])
            run_s = time.perf_counter() - t
            counts = cli_executed(_kernels.launch_counts(), trainer)  # ---- and ends here
            check_main_path("training entry point (stages 1 and 2)", counts, TRAIN_KERNELS)
            graphs = graph_report(trainer, "phase 9")
            log(f"  train_cli.run: stage 1, stage 2 (bf16 reference), validation, checkpoints and the best model's "
                f"reload in {run_s:.1f} s; global step {trainer.global_step}")
            log("  " + phase9_data_path(trainer))
            stages = {name: show_stage(name, trainer.history[name][0], trainer.profiles.get(int(name[-1])))
                      for name in ("stage1", "stage2")}
            if trainer.global_step != 2 * PHASE9_STEPS or not all(
                    math.isfinite(r[k]) for r in stages.values() for k in ("train_loss", "val_loss")):
                raise AssertionError(f"phase 9: global step {trainer.global_step}, stages {stages}")
            saves = trainer.checkpoints.saves
            for sv in saves:
                log(f"  checkpoint {sv['name']} (stage {sv['stage']}, step {sv['global_step']}): {sv['bytes'] / 1e9:.3f} "
                    f"GB in {sv['seconds']:.2f} s ({sv['bytes'] / 1e9 / sv['seconds']:.2f} GB/s), the train loop held "
                    f"{sv['blocking_s']:.2f} s")

            # a second trainer resumes stage 1 from its mid-epoch autosave, through the CLI
            auto = PHASE9_DIR / "run" / "checkpoints" / "autosave_stage1"
            t = time.perf_counter()
            resumed = train_cli.run(["--config", str(cfg_path), "--stage", "1", "--max-steps", str(PHASE9_STEPS),
                                     "--output-dir", str(PHASE9_DIR / "resumed"), "--resume", str(auto)])
            resume_s = time.perf_counter() - t
            stages["stage1_resumed"] = show_stage("stage 1 resumed (no profiler, no autosave)",
                                                  resumed.history["stage1"][0], None, first_step=PHASE9_SAVE_STEPS)
            graph_report(resumed, "phase 9 resumed", replayed=False)
            del resumed
            verdict = same_checkpoint(PHASE9_DIR / "run" / "checkpoints" / "checkpoint_stage1_epoch0",
                                      PHASE9_DIR / "resumed" / "checkpoints" / "checkpoint_stage1_epoch0")
            log(f"  resumed from autosave_stage1 (global step {PHASE9_SAVE_STEPS}: epoch 0, micro-step "
                f"{PHASE9_SAVE_STEPS}, mid-accumulation) through "
                f"train_cli.run in {resume_s:.1f} s: its end-of-stage-1 checkpoint against the uninterrupted run's: "
                f"{verdict}")

            # serving after training: the bf16 copy is the trained masters' cast, not the stage-2 start's
            model = trainer.model
            images = np.random.default_rng(9).integers(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)
            t = time.perf_counter()
            captions = model.generate_captions(images, max_length=32, early_stop=True, **BEAMS)
            serve_ms = (time.perf_counter() - t) * 1e3
            if len(captions) != 8 or not all(isinstance(c, str) for c in captions):
                raise AssertionError(f"generate_captions after training returned {captions!r}")
            served = dict(model._inference_module().named_parameters())
            fresh = dict(frozen_copy(model.module, torch.bfloat16).named_parameters())
            stale = [n for n in fresh if not torch.equal(served[n], fresh[n])]
            if stale:
                raise AssertionError(f"the serving copy is not the trained masters' cast: {stale[:4]}")
            start = torch.load(PHASE9_DIR / "run" / "checkpoints" / "stage2_reference" / "state.pt", map_location="cpu",
                               weights_only=True)["params"]["caption_decoder.lm.wte.weight"]
            moved = int((served["caption_decoder.lm.wte.weight"].cpu() != start).sum())
            if moved == 0:
                raise AssertionError("the served decoder embedding equals the stage-2 start's: training did not reach it")
            log(f"  generate_captions after training, batch 8, 4 beams, max_length 32: {serve_ms:.1f} ms; the bf16 "
                f"serving copy equals the trained masters' cast in all {len(fresh)} tensors, and {moved:,} elements of its "
                f"decoder embedding differ from the stage-2 start's (the reference checkpoint)")
            del trainer, model, served, fresh
            gc.collect()
            torch.cuda.empty_cache()
            log("== phase 11b: the evaluation CLIs on phase 9's checkpoints and JPEGs")
            clis = phase_eval_clis()
        disk = sum(f.stat().st_size for f in PHASE9_DIR.rglob("*") if f.is_file())
        log(f"  build/phase9 held {disk / 1e9:.2f} GB ({disk / 2**30:.2f} GiB) of checkpoints, results and traces")
        for done in ("run", "resumed", "profile"):  # phase 12c writes its own: the run's disk is limited
            shutil.rmtree(PHASE9_DIR / done, ignore_errors=True)
        t = time.perf_counter()
        log("== phase 12c: LoRA through the training entry point (configs/lora.yaml, GPT-2 flagship at full width, "
            f"{LORA_LAYERS} layers a tower, phase 9's JPEGs)")
        lora = phase_lora_cli(PHASE9_DIR / "data" / "captions.csv", PHASE9_DIR / "data" / "preferences.json")
        lora["seconds"] = time.perf_counter() - t
        log(f"  phase 12c: {lora['seconds']:.1f} s; ms per micro-step (median after the first, {LORA_LAYERS} layers "
            f"a tower): LoRA stage 1 {lora['stages']['stage1']['ms_per_micro_step']:.1f}, stage 2 "
            f"{lora['stages']['stage2']['ms_per_micro_step']:.1f} [{card()}]")
        t = time.perf_counter()
        log("== phase 13a: the dataset BPE, the grain loader and the training CLI with both (configs/default.yaml, "
            f"GPT-2 flagship at full width, {PHASE13_LAYERS} layers a tower, phase 9's JPEGs)")
        grain = phase_grain_bpe_cli()
        grain["seconds"] = time.perf_counter() - t
        log(f"  phase 13a: {grain['seconds']:.1f} s; ms per micro-step (median after the first, {PHASE13_LAYERS} "
            f"layers a tower): stage 1 {grain['stages']['stage1']['ms_per_micro_step']:.1f}, stage 2 "
            f"{grain['stages']['stage2']['ms_per_micro_step']:.1f} [{card()}]")
        return dict(counts=counts, stages=stages, saves=saves, run_s=run_s, resume_s=resume_s, serve_ms=serve_ms,
                    clis=clis, lora=lora, grain=grain, graphs=graphs)
    finally:
        shutil.rmtree(PHASE9_DIR, ignore_errors=True)


REPORT_SECTIONS = {"num_samples", "caption_quality", "preference_alignment", "diversity", "efficiency",
                   "target_comparison"}
PREDICT_IMAGES = 16


def phase_eval_clis() -> dict:
    """Phase 11b: run_evaluation, evaluate and predict (``main(argv)``, as the command line calls them) on phase 9's
    config, JPEGs and stage-2 best model, with its stage-1 best model as the CLIP-Score judge."""
    import os

    import yaml

    from pgica_tpu_torch.scripts import evaluate, predict, run_evaluation

    ckpts = PHASE9_DIR / "run" / "checkpoints"
    best, judge = ckpts / "best_model_stage2", ckpts / "best_model_stage1"
    cfg = yaml.safe_load((PHASE9_DIR / "default_phase9.yaml").read_text())
    cfg["evaluation"]["clip_judge_checkpoint"] = str(judge)
    cfg_path = PHASE9_DIR / "default_phase9_eval.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    os.environ["MLFLOW_TRACKING_URI"] = (PHASE9_DIR / "mlruns").as_uri()  # if mlflow is installed: inside build/
    walls = {}

    t = time.perf_counter()
    report, model = run_evaluation.run(["--config", str(cfg_path), "--checkpoint", str(best), "--dataset", "both",
                                        "--output-dir", str(PHASE9_DIR / "eval")])
    walls["run_evaluation"] = time.perf_counter() - t
    saved = torch.load(best / "state.pt", map_location="cpu", weights_only=True)["params"]
    restored = model.module.state_dict()
    differ = [k for k in saved if not torch.equal(restored[k].cpu(), saved[k])]
    if differ or saved.keys() != restored.keys():
        raise AssertionError(f"run_evaluation's restored masters differ from {best.name}: {differ[:4]}")
    tensors = len(saved)
    del model, restored, saved
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in report["datasets"].items():
        values = [v for k, sec in r.items() if k not in ("num_samples", "target_comparison") for v in sec.values()]
        if (set(r) != REPORT_SECTIONS or r["caption_quality"].get("clip_score_self_judged") != 0.0
                or not all(map(math.isfinite, values))):
            raise AssertionError(f"run_evaluation's {name} report: {r}")
        log(f"  run_evaluation, {name}: {r['num_samples']} samples; " + "; ".join(
            f"{sec}: " + ", ".join(f"{k} {v:.4g}" for k, v in r[sec].items())
            for sec in ("caption_quality", "preference_alignment", "diversity", "efficiency")))
    log(f"  run_evaluation --dataset both: {walls['run_evaluation']:.1f} s (the model, the judge from "
        f"{judge.name}, 2 x (warm-up + 1 request)); restored masters equal {best.name}'s {tensors} "
        f"tensors bit for bit; summary {report['summary']}; every report has its five sections and "
        f"clip_score_self_judged 0.0")

    t = time.perf_counter()
    out = PHASE9_DIR / "evaluate_test.json"
    if evaluate.main(["--config", str(cfg_path), "--model-path", str(best), "--split", "test", "--output", str(out),
                      "--output-dir", str(PHASE9_DIR / "eval_test")]) != 0:
        raise AssertionError("evaluate.main failed")
    walls["evaluate"] = time.perf_counter() - t
    split = json.loads(out.read_text())
    if split["metrics"].get("clip_score_self_judged") != 0.0 or not all(map(math.isfinite, split["metrics"].values())):
        raise AssertionError(f"evaluate --split test: {split}")
    log(f"  evaluate --split test: {walls['evaluate']:.1f} s, {split['num_samples']} samples: "
        + ", ".join(f"{k} {v:.4g}" for k, v in split["metrics"].items()))

    jpegs = sorted((PHASE9_DIR / "data" / "images").glob("*.jpg"))
    folder = PHASE9_DIR / "predict_images"
    folder.mkdir()
    for path in jpegs[:PREDICT_IMAGES]:
        shutil.copy(path, folder / path.name)
    answers = {}
    for label, argv in (("--image", ["--image", str(jpegs[0])]), ("--image-dir", ["--image-dir", str(folder)])):
        t = time.perf_counter()
        out = PHASE9_DIR / f"predict{label.replace('--', '_')}.json"
        if predict.main(["--config", str(cfg_path), "--model-path", str(best), "--output", str(out), *argv]) != 0:
            raise AssertionError(f"predict.main {label} failed")
        walls[f"predict {label}"] = time.perf_counter() - t
        answers[label] = json.loads(out.read_text())
    one, many = answers["--image"], answers["--image-dir"]
    if not isinstance(one.get("caption"), str) or len(many) != PREDICT_IMAGES or not all(
            isinstance(r["caption"], str) for r in many):
        raise AssertionError(f"predict: {one}, {many[:2]}")
    log(f"  predict --image: {walls['predict --image']:.1f} s (request {one['latency_ms']:.1f} ms), caption "
        f"{one['caption'][:40]!r}; predict --image-dir ({PREDICT_IMAGES} JPEGs, batches of 8): "
        f"{walls['predict --image-dir']:.1f} s, {len(set(r['caption'] for r in many))} distinct captions "
        f"[{card()}]")
    return dict(walls=walls, report=report, split=split)


# ------------------------------------------------------------------ phase 10

# scripts/serve.py's defaults (--slots, --chunk, --max-length); the Llama slice's pool is half as wide
SERVE_SLOTS, SERVE_CHUNK, SERVE_MAX_LENGTH = 16, 8, 32
LLAMA_SLOTS = 8
GPT2_FORWARD = {"layernorm_fwd": 49, "flash_attn_fwd": 24, "rmsnorm_fwd": 0}  # one decoder forward at decode
# a seeded Poisson arrival of requests, the same schedule for every scheduler
POISSON_REQUESTS, POISSON_RATE = 128, 100.0  # requests, requests/s


def run_engine_to_end(eng, images) -> tuple:
    """Admit ``images`` (one per slot) into ``eng``'s free pool and run chunks until every slot is
    done, on its stream, without its threads: (the first chunk's last-step logits, seqs, chunks)."""
    with eng._on_stream():
        eng._admit(eng._state, images, np.arange(len(images)))
        first = eng._run_chunk()[1].clone()
        chunks = 1
        while bool(eng._state.active.any()):
            eng._run_chunk()
            chunks += 1
        seqs = eng._state.seqs.clone()
        eng._sync()
    return first, seqs, chunks


def timed_replays(fn, stream, reps: int = 20) -> float:
    """ms per call of ``fn`` on ``stream`` (in inference mode, as the slot states were made): CUDA
    events around ``reps`` calls after one."""
    with torch.inference_mode(), torch.cuda.stream(stream):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def dead_graph_capture(bare: bool) -> str:
    """Capture a graph while a dead reference cycle holds another one, with the cyclic collector set to
    run inside the capture: through CapturedSteps (no collection during its capture) or, with ``bare``, a
    bare ``torch.cuda.graph``. "captured", or the error."""
    from pgica_tpu_torch.generation.slots import CapturedSteps

    dev = torch.device("cuda")
    stream = torch.cuda.Stream(dev)
    w = torch.ones(256, 256, device=dev)

    def fn():
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1, 1, 1)  # a collection at (nearly) every allocation from here on
        out = w
        for _ in range(50):
            out = out @ w * 0.5
        return out

    gc.collect()
    cycle = {"graph": CapturedSteps(lambda: w * 3, dev, stream)}
    cycle["self"] = cycle  # only the cyclic collector frees it
    del cycle
    try:
        if bare:
            fn()
            torch.cuda.synchronize()
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
                fn()
        else:
            CapturedSteps(fn, dev, stream).replay()
        torch.cuda.synchronize()
        return "captured"
    except Exception as exc:  # noqa: BLE001 — the answer is the error
        return f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
    finally:
        gc.set_threshold(700, 10, 10)


def failed_capture() -> str:
    """A graphed eval step (training/graphs.py:GraphedEvalStep, the trainer's route on the card) whose body
    reads a value back to the host: its first call runs eagerly, then its capture must raise, with no eager
    fall-back, at that call and at the next. "raised <error>" twice, or what happened instead."""
    from pgica_tpu_torch.training.graphs import GraphedEvalStep
    from pgica_tpu_torch.training.train_step import EvalStep

    linear = torch.nn.Linear(8, 8).cuda()

    def metrics(module, _, batch):
        y = module(batch["image"])
        return {"loss": y.sum() * float(y.abs().max())}  # float(): a device->host read, refused under capture

    step = GraphedEvalStep(EvalStep(linear, metrics, ("image",), None, None, None, takes_ref=False))
    out = []
    for _ in range(2):
        try:
            step({"image": np.ones((4, 8), np.float32)})
            out.append("returned")
        except Exception as exc:  # noqa: BLE001 — the answer is the error
            out.append(f"raised {type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''}")
    return " | ".join(out)


def start_failed_capture() -> subprocess.Popen:
    """``failed_capture()`` in a process of its own (a refused capture may leave the process's CUDA context in
    error), started so that it runs beside other work."""
    return subprocess.Popen([sys.executable, "-c", "import chip_smoke; print(chip_smoke.failed_capture())"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def check_failed_capture(process: subprocess.Popen) -> str:
    """A graphed eval step whose capture fails raises at each call (``failed_capture``, in ``process``)."""
    try:
        out, err = process.communicate(timeout=300)
    finally:
        if process.poll() is None:
            process.kill()
            process.wait()
    answer = (out.strip().splitlines() or ["no answer"])[-1]
    calls = answer.split(" | ")
    if len(calls) != 2 or not all(c.startswith("raised") for c in calls):
        raise AssertionError(f"a graphed eval step whose body reads to the host: {answer!r} (exit "
                             f"{process.returncode}; {err.strip().splitlines()[-3:]})")
    log(f"  a graphed eval step whose body reads a value to the host: its capture raised at both calls, no eager "
        f"fall-back ({calls[0][:160]}; the process exited {process.returncode})")
    return answer


def start_bare_capture() -> subprocess.Popen:
    """``dead_graph_capture(True)`` in a process of its own (its voided capture leaves that process's CUDA
    context in error), started early so that it runs beside other work."""
    return subprocess.Popen([sys.executable, "-c", "import chip_smoke; print(chip_smoke.dead_graph_capture(True))"],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def capture_under_collection(bare_process: subprocess.Popen) -> None:
    """A collection inside a capture that frees a dead graph voids the capture (the bare case, in
    ``bare_process``); CapturedSteps turns the collector off while it captures, so it must capture."""
    try:
        bare = bare_process.communicate(timeout=300)[0].strip().splitlines()
    finally:
        if bare_process.poll() is None:
            bare_process.kill()
            bare_process.wait()
    ours = dead_graph_capture(False)
    if ours != "captured":
        raise AssertionError(f"CapturedSteps under a collection that frees a dead graph: {ours}")
    log(f"  a capture during which the cyclic collector frees a dead CUDA graph: bare torch.cuda.graph "
        f"{(bare or ['no answer'])[-1]!r} (information); CapturedSteps captured")


def admission_checks(eng, eager, images, per_encode: dict, per_forward: dict, label: str) -> dict:
    """Each admission bucket of ``eng`` (graphed, warmed) against ``eager`` (``cuda_graph=False``): the same
    images into the same slot ids, the last slots in reverse order for half the bucket's rows (at least one)
    and padding (>= S) for the rest, into a free pool; every state tensor's first S rows must be bit-equal
    (the caches, seqs, pos, tok, presence, active), and each graph must hold the encode's and the prefix's
    launches (``per_encode`` + ``per_forward``). Times the widest bucket's admission both ways (host wall,
    pinned copies included, to a synchronize); both pools are free again after. Capture seconds and pools."""
    slots = eng.slots
    want = {k: per_encode.get(k, 0) + per_forward.get(k, 0) for k in {**per_encode, **per_forward}}
    want = {k: v for k, v in want.items() if v}

    def admit(e, ids, reps: int = 1) -> float:
        with e._on_stream():
            e._state.reset()
            e._sync()
            t = time.perf_counter()
            for _ in range(reps):
                e._admit(e._state, images[:len(ids)], ids)
            e._sync()
        return (time.perf_counter() - t) * 1e3 / reps

    out = {}
    for b in eng.buckets:
        ids = np.full(b, slots, np.int64)
        real = max(1, b // 2)
        ids[:real] = np.arange(slots - 1, slots - 1 - real, -1)
        for e in (eng, eager):
            admit(e, ids)
        got, ref = eng._state, eager._state
        differ = [name for name in got.padded if not torch.equal(getattr(got, name), getattr(ref, name))]
        if not torch.equal(got.cache_buffer[:, :, :slots], ref.cache_buffer[:, :, :slots]):
            differ.append("caches")
        graph = eng.admissions[b][2]
        if differ or graph.kernels != want:
            raise AssertionError(f"{label}: bucket {b}'s admission graph differs from the eager admission in {differ}, "
                                 f"or holds {graph.kernels} (expected {want})")
        out[b] = dict(capture_s=graph.capture_s, pool_bytes=graph.pool_bytes)
    widest = np.arange(slots)
    ms = {"graphed": admit(eng, widest, 5), "eager": admit(eager, widest, 5)}
    for e in (eng, eager):
        with e._on_stream():
            e._state.reset()
            e._sync()
    log(f"  {label}: each admission bucket's graph ({', '.join(str(b) for b in eng.buckets)}; padding ids in every "
        f"bucket from 2) against the eager admission: every state tensor's first {slots} rows bit-equal; each graph "
        f"holds {want}; captured in " + ", ".join(f"{r['capture_s'] * 1e3:.1f}" for r in out.values()) + " ms, pools "
        + ", ".join(f"{r['pool_bytes'] / 2**20:.1f}" for r in out.values()) + f" MiB; bucket {slots}: "
        f"{ms['graphed']:.3f} ms a graphed admission against {ms['eager']:.3f} eager (5 each, host wall to a "
        f"synchronize) [{card()}]")
    return dict(buckets=out, ms=ms)


def graph_checks(model, eng, images, per_forward: dict, label: str, per_encode: dict) -> dict:
    """Phase 10's checks of one model's graphs: ``eng`` (graphed, warmed, not started) against an
    eager engine: each admission bucket's graph against the eager admission (``admission_checks``:
    ``per_encode`` and ``per_forward`` give what its graph holds), then the same first requests (the
    first chunk's last-step logits bit-equal, the captions equal); the kernels each graph holds (its
    wrappers' launches under capture) and those one replay runs (the profiler's device kernel names);
    the batch path's graphed step against the eager one (first-step logits bit-equal, sampled ids
    equal, greedy ids equal to the engine's)."""
    from pgica_tpu_torch.generation.decode import generate
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine
    from pgica_tpu_torch.generation.slots import Sampler, admit, decode_steps, init_slot_state

    slots, tok = eng.slots, model.tokenizer
    eager = ContinuousDecodeEngine(model, slots=slots, chunk=eng.chunk, max_length=eng.max_length, cuda_graph=False)
    eager.warmup()
    admissions = admission_checks(eng, eager, images, per_encode, per_forward, label)
    first = images[:slots]
    logits_g, seqs_g, chunks = run_engine_to_end(eng, first)
    logits_e, seqs_e, chunks_e = run_engine_to_end(eager, first)
    if not torch.equal(logits_g, logits_e) or not torch.equal(seqs_g, seqs_e) or chunks != chunks_e:
        raise AssertionError(f"{label}: the graphed chunk differs from the eager one (logits equal "
                             f"{torch.equal(logits_g, logits_e)}, ids equal {torch.equal(seqs_g, seqs_e)})")
    chunk_ms = {"graphed": timed_replays(eng.graph.replay, eng._stream),
                "eager": timed_replays(lambda: eager._chunk(eager._state), eager._stream, reps=5)}

    def on(replay, stream):
        def run():
            with torch.cuda.stream(stream):
                replay()
            stream.synchronize()
        return run

    want = {k: eng.chunk * v for k, v in per_forward.items()}
    if eng.graph.kernels != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: the chunk graph holds {eng.graph.kernels}, expected {want}")
    chunk_seen = device_counts(on(eng.graph.replay, eng._stream), want, f"{label}: one chunk replay")

    # the batch path: generate_captions' graphed step against the eager one, on the same rows
    module, pick = eng.module, Sampler()
    captions = model.generate_captions(first, max_length=eng.max_length)  # captures (slots, max_length)
    with torch.inference_mode():
        emb = model.encode_image(first)["embeddings"]
        ids_e = generate(module, emb, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                         max_length=eng.max_length)
        state = init_slot_state(module.decoder_config, slots, eng.max_length, module.compute_dtype, model.device,
                                eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
        admit(module, state, emb, torch.arange(slots, device=model.device), pick)
        step_e = decode_steps(module, state, 1, pick)
        graphed_state, step = model._decode_graphs.get(slots, eng.max_length, pick, tok.eos_token_id,
                                                       tok.pad_token_id)
        admit(module, graphed_state, emb, torch.arange(slots, device=model.device), pick)
        step.replay()
        if not torch.equal(step.out, step_e):
            raise AssertionError(f"{label}: the graphed batch step's first logits differ from the eager step's")
        # sampling (top-p 0.9, temperature 0.8): the graph draws what the eager step draws from one seed
        sampled = [generate(module, emb, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                            max_length=eng.max_length, do_sample=True, temperature=0.8, top_p=0.9,
                            repetition_penalty=1.1, generator=torch.Generator(model.device).manual_seed(5),
                            graphs=graphs) for graphs in (model._decode_graphs, None)]
        if not torch.equal(*sampled):
            raise AssertionError(f"{label}: the graphed sampled step's ids differ from the eager step's")
    engine_captions = [tok.decode(r) for r in seqs_g.cpu().numpy()]
    if [tok.decode(r) for r in ids_e.cpu().numpy()] != captions or captions != engine_captions:
        raise AssertionError(f"{label}: graphed batch, eager batch and engine captions differ")
    if step.kernels != {k: v for k, v in per_forward.items() if v}:
        raise AssertionError(f"{label}: the step graph holds {step.kernels}, expected {per_forward}")
    step_seen = device_counts(on(step.replay, torch.cuda.current_stream()), per_forward,
                              f"{label}: one batch-step replay")
    step_ms = {"graphed": timed_replays(step.replay, torch.cuda.current_stream()),
               "eager": timed_replays(lambda: decode_steps(module, state, 1, pick), torch.cuda.current_stream(),
                                      reps=5)}
    eager.stop()
    r = dict(admissions=admissions, chunk_ms=chunk_ms, step_ms=step_ms, chunk_kernels=want, step_kernels=per_forward,
             chunk_profiled=chunk_seen, step_profiled=step_seen,
             chunks=chunks, chunk_capture_s=eng.graph.capture_s, chunk_pool_mib=eng.graph.pool_bytes / 2**20,
             step_capture_s=step.capture_s, step_pool_mib=step.pool_bytes / 2**20)
    log(f"  {label}: the graphed chunk ({eng.chunk} steps x {slots} slots, captured in {r['chunk_capture_s'] * 1e3:.1f} "
        f"ms, pool reserved {r['chunk_pool_mib']:.1f} MiB) against the eager chunk on {slots} requests: first-chunk logits "
        f"bit-equal, ids equal over {chunks} chunks; {chunk_ms['graphed']:.3f} ms a replay against "
        f"{chunk_ms['eager']:.3f} eager (CUDA events, 20 replays, 5 eager calls); the graph holds and one replay "
        f"launches {want} on the card (= {eng.chunk} x {per_forward}; the profiler saw {chunk_seen['counts']})")
    log(f"  {label}: the batch path's graphed step (batch {slots}, captured in {r['step_capture_s'] * 1e3:.1f} ms, pool "
        f"reserved {r['step_pool_mib']:.1f} MiB) against the eager step: first-step logits bit-equal; generate_captions "
        f"(graphed), the eager generate and the engine give the same {slots} captions, and sampled ids (top-p 0.9, "
        f"one seed) are the same graphed and eager; {step_ms['graphed']:.3f} ms a "
        f"step replay against {step_ms['eager']:.3f} eager; the graph holds and one replay launches {per_forward} "
        f"(the profiler saw {step_seen['counts']})")
    return r


class IdsAsText:
    """Stands in for an engine's tokenizer: a caption as its token ids. The flagship's ids run past the
    built-in tokenizer's 261, whose decode drops them, so decoded captions hide most of the draws."""

    @staticmethod
    def decode(row) -> str:
        return " ".join(str(int(t)) for t in row)


def sampled_engines(model, images, label: str) -> None:
    """Sampled token ids (temperature 1.5, no nucleus cut, repetition penalty 1.1, seed 3) of ``images`` sent one
    at a time through a graphed engine (each admission and chunk a replay, the generator registered with every
    graph) and an eager one: each admission reseeds the generator, so both must give the same ids."""
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine

    ids = {}
    for graphed in (True, False):
        eng = ContinuousDecodeEngine(model, slots=SERVE_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH,
                                     do_sample=True, temperature=1.5, top_p=1.0, repetition_penalty=1.1, seed=3,
                                     cuda_graph=graphed)
        eng.tokenizer = IdsAsText()
        eng.warmup()
        eng.start()
        try:
            ids[graphed] = [eng.submit(image, timeout=300)["caption"] for image in images]
        finally:
            eng.stop()
    if ids[True] != ids[False]:
        raise AssertionError(f"{label}: the graphed engine's sampled ids differ from the eager engine's")
    log(f"  {label}: {len(images)} sampled requests one at a time (seed 3, temperature 1.5): the graphed engine's "
        f"token ids equal the eager engine's ({len(set(ids[True]))} distinct of {len(images)})")


def staggered_bursts(submit, images, bursts: int, gap_s: float) -> list:
    """Submit ``images`` in ``bursts`` equal bursts ``gap_s`` apart, one thread a request; the captions."""
    out, errs = [None] * len(images), []
    size = len(images) // bursts

    def go(i):
        try:
            time.sleep((i // size) * gap_s)
            out[i] = submit(images[i], timeout=300)["caption"]
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"staggered bursts: {errs[:4]}, alive {sum(t.is_alive() for t in threads)}")
    return out


def engine_against_batch(submit, model, images, bursts: int, label: str) -> None:
    """Greedy captions through ``submit`` (the engine) in staggered bursts == generate_captions."""
    got = staggered_bursts(submit, images, bursts, 0.05)
    size = len(images) // bursts
    want = sum((model.generate_captions(images[i:i + size], max_length=SERVE_MAX_LENGTH)
                for i in range(0, len(images), size)), [])
    if got != want:
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"{label}: engine captions differ from generate_captions at {diff[:8]}")
    log(f"  {label}: {len(images)} requests in {bursts} bursts 50 ms apart through the engine: captions equal "
        f"generate_captions' (graphed, batch {size}) for every image")


def poisson_run(submit, images, seed: int = 10) -> dict:
    """POISSON_REQUESTS requests at POISSON_RATE a second (seeded exponential gaps), one thread a
    request; latency percentiles (submit's own, queue to caption) and captions/s over the run."""
    gaps = np.random.default_rng(seed).exponential(1.0 / POISSON_RATE, POISSON_REQUESTS)
    arrivals = np.cumsum(gaps)
    lat, done, errs = [None] * POISSON_REQUESTS, [None] * POISSON_REQUESTS, []
    t0 = time.perf_counter() + 0.05

    def go(i):
        time.sleep(max(0.0, t0 + arrivals[i] - time.perf_counter()))
        try:
            lat[i] = submit(images[i % len(images)], timeout=300)["latency_ms"]
            done[i] = time.perf_counter()
        except Exception as e:  # noqa: BLE001 — raised below
            errs.append((i, repr(e)))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(POISSON_REQUESTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errs or any(x is None for x in lat):
        raise AssertionError(f"Poisson run: {errs[:4]}")
    wall = max(done) - t0
    return dict(p50_ms=float(np.percentile(lat, 50)), p95_ms=float(np.percentile(lat, 95)),
                captions_per_s=POISSON_REQUESTS / wall, wall_s=wall)


def http_check(service, label: str) -> None:
    """A server on 127.0.0.1, port 0, in front of ``service``: /healthz, then a /caption POST of a
    seeded JPEG, whose caption must be generate_captions' for the decoded image."""
    import http.client
    import io

    from PIL import Image

    from pgica_tpu_torch.scripts.serve import _Server, make_handler

    rng = np.random.default_rng(12)
    pixels = Image.fromarray(rng.integers(0, 256, size=(6, 8, 3), dtype=np.uint8)).resize((320, 240), Image.BICUBIC)
    buf = io.BytesIO()
    pixels.save(buf, format="JPEG", quality=90)
    jpeg = buf.getvalue()
    server = _Server(("127.0.0.1", 0), make_handler(service))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=120)
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        health = json.loads(resp.read())
        if resp.status != 200 or health.get("status") != "ok":
            raise AssertionError(f"{label}: /healthz answered {resp.status} {health}")
        conn.request("POST", "/caption", body=jpeg, headers={"Content-Type": "image/jpeg"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    want = service.model.generate_captions(np.array(service.image_processor.process_image(jpeg)[None]),
                                           max_length=SERVE_MAX_LENGTH, early_stop=True)[0]
    if resp.status != 200 or out.get("caption") != want:
        raise AssertionError(f"{label}: /caption answered {resp.status} {out}, expected the caption {want!r}")
    log(f"  {label}: HTTP on 127.0.0.1 - /healthz {health}; /caption of a {len(jpeg):,}-byte seeded JPEG: 200 in "
        f"{out['latency_ms']:.1f} ms, the caption generate_captions gives the decoded image")


def phase_after_training(model) -> dict:
    """Phase 10, after phases 6-7 trained the flagship's masters in place: generate_captions recasts
    the bf16 copy and captures its graphs anew, and must equal the eager step on that copy."""
    from pgica_tpu_torch.generation.decode import generate

    images = np.random.default_rng(10).integers(0, 256, size=(8, 224, 224, 3), dtype=np.uint8)
    t = time.perf_counter()
    captions = model.generate_captions(images, max_length=SERVE_MAX_LENGTH, early_stop=True)
    first_ms = (time.perf_counter() - t) * 1e3
    module, tok = model._inference_module(), model.tokenizer
    if model._decode_graphs is None or model._decode_graphs.module is not module:
        raise AssertionError("the decode graphs are not the trained copy's")
    with torch.inference_mode():
        emb = model.encode_image(images)["embeddings"]
        ids = generate(module, emb, eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id,
                       max_length=SERVE_MAX_LENGTH, early_stop=True).cpu().numpy()
    if [tok.decode(r) for r in ids] != captions:
        raise AssertionError("after training, graphed generate_captions differs from the eager step")
    log(f"  after phases 6-7 trained the masters: generate_captions (batch 8 x {SERVE_MAX_LENGTH}, early_stop) recast "
        f"the bf16 copy and captured its graph anew ({first_ms:.1f} ms with the cast and the capture); its captions "
        f"equal the eager step's on the trained copy")
    return dict(first_ms=first_ms)


# ------------------------------------------------------------------ phase 11

# 4 requests of configs/default.yaml's generate_config, plus the warm-up (8 requests, 256 images before; cut to keep
# the run inside its time limit)
EVAL_SAMPLES, EVAL_BATCH = 128, 32
EVAL_DIR = ROOT / "build" / "phase11"
VIT_ENCODE = {"layernorm_fwd": 27, "flash_attn_fwd": 12}  # pre_ln, 12 x 2, post_ln, projection ln
TEXT_TOWER = {"layernorm_fwd": 50, "flash_attn_fwd": 24}  # 24 x 2, ln_f, projection ln
DECODER_FORWARD = {"layernorm_fwd": 49, "flash_attn_fwd": 24}
BACKWARD_KERNELS = ("layernorm_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "fused_ce_bwd_dh", "fused_ce_bwd_dw",
                    "rmsnorm_bwd")


def metric_routes(metrics: dict) -> str:
    """Which optional packages the metrics found, and the flags of the routes they took."""
    found = []
    for name in ("nltk", "rouge_score"):
        try:
            found.append(f"{name} {getattr(__import__(name), '__version__', 'importable')}")
        except ImportError as e:
            found.append(f"{name} not installed ({e})")
    flags = {k: metrics[k] for k in ("meteor_nltk", "meteor_synonym_stage", "bert_score_proxy", "clip_score_self_judged")
             if k in metrics}
    return "; ".join(found) + f"; flags {flags}"


def phase_evaluation(model) -> dict:
    """Phase 11a: EvaluationRunner over the trained flagship of phases 6-7 with configs/default.yaml's evaluation
    section (4 beams, max_length 128, no early_stop) and targets, over EVAL_SAMPLES dummy captioned images."""
    from pgica_tpu_torch.data.loader import DataLoader
    from pgica_tpu_torch.evaluation.runner import EvaluationRunner, generate_kwargs
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import DummyConceptualDataset, create_metrics, create_processors

    config = Config(ROOT / "configs" / "default.yaml")
    image_processor, text_processor = create_processors(config, model.tokenizer)
    loader = DataLoader(DummyConceptualDataset(image_processor, text_processor, EVAL_SAMPLES, seed=11), EVAL_BATCH)
    metrics = create_metrics(config, model)
    spent = {"compute_all_metrics": 0.0, "_text_tower_tokens": 0.0, "compute_clip_score": 0.0}

    def timed(name):
        fn = getattr(metrics, name)

        def call(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t
            return out
        setattr(metrics, name, call)

    for name in spent:
        timed(name)
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    runner = EvaluationRunner(model, config, metrics, EVAL_DIR)
    kwargs = generate_kwargs(config)
    key = beam_key(model.tokenizer, EVAL_BATCH, kwargs["max_length"])
    graphs = model._decode_graphs
    # the warm-up request captures the beam graphs unless this copy's graphs hold them already
    captures = 0 if graphs is not None and graphs.module is model._decode_module() and key in graphs.beams \
        else BEAM_CAPTURE_FORWARDS
    try:
        entries = entry_state(model)
        _kernels.reset_launch_counts()  # ---- the main path starts here
        t = time.perf_counter()
        result = runner.run_evaluation(loader)
        wall_s = time.perf_counter() - t
        counts = _kernels.launch_counts()  # ---- and ends here
        records = json.loads((EVAL_DIR / "predictions.json").read_text())
        saved = json.loads((EVAL_DIR / "metrics.json").read_text())
    finally:
        shutil.rmtree(EVAL_DIR, ignore_errors=True)
    m = result["metrics"]
    predictions = [r["prediction"] for r in records]
    log(f"  EvaluationRunner (configs/default.yaml: {kwargs}) over {EVAL_SAMPLES} dummy images at batch {EVAL_BATCH}: "
        f"{result['num_samples']} captions in {wall_s:.1f} s; metric routes: {metric_routes(m)}")
    bad = [k for k, v in saved.items() if not math.isfinite(v)]
    if result["num_samples"] != EVAL_SAMPLES or bad or saved.keys() != m.keys():
        raise AssertionError(f"phase 11a: {result['num_samples']} samples, metrics not finite {bad}, {saved.keys()}")
    log("  metrics (all finite): " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()))

    # the launches reckoned from what ran: each request runs the prefix from the host, its encode a replay of
    # the batch shape's graph (captured at the shape's first call: the warm-up request's, after phases 6-7
    # recast the copy) and its max_length - 1 steps replays of the two beam graphs, which the warm-up request
    # captured (4 decoder forwards more; the recast copy has none yet); BERTScore embeds each distinct text
    # once, EVAL_BATCH texts an eager text-tower forward (JAX does not jit it either); CLIP-Score's similarity
    # of the first batch's images and captions is a graph too, captured at its shape's first call
    requests = EVAL_SAMPLES // EVAL_BATCH + 1
    texts = len(dict.fromkeys(predictions + [r for rec in records for r in rec["references"]]))
    bert_forwards = -(-texts // metrics.BERT_SCORE_BATCH)
    now = entry_state(model)
    new = [g for k, (g, _) in now.items() if k not in entries or entries[k][0] is not g]
    held = [g.captured.kernels for g in new]  # at most the batch's encode and CLIP-Score's similarity, once each
    similarity = {k: VIT_ENCODE[k] + TEXT_TOWER[k] for k in SERVING_KERNELS}
    if len(held) > 2 or any(h not in (VIT_ENCODE, similarity) for h in held) or held.count(VIT_ENCODE) > 1:
        raise AssertionError(f"phase 11a: the run captured entry graphs holding {held}")
    captured_entries = {k: ENTRY_CAPTURE_CALLS * sum(h[k] for h in held) for k in SERVING_KERNELS}
    want = {k: requests * DECODER_FORWARD[k] + captures * DECODER_FORWARD[k] + captured_entries[k]
            + bert_forwards * TEXT_TOWER[k] for k in SERVING_KERNELS}
    got = {k: counts[k] for k in SERVING_KERNELS}
    backward = {k: counts.get(k, 0) for k in BACKWARD_KERNELS}
    if got != want or any(backward.values()):
        raise AssertionError(f"phase 11a launched {got} (backward {backward}), reckoned {want}")
    replays = sum(g.replays for g in new) + sum(g.replays - entries[k][1] for k, (g, _) in now.items()
                                                 if k in entries and entries[k][0] is g)
    log(f"  launches from the host {got} = reckoned from {requests} requests x the prefix, the beam graphs' "
        f"capture ({captures} decoder forwards), {bert_forwards} BERTScore text-tower forwards ({texts} distinct "
        f"texts), and the entry graphs the run captured (the encode and CLIP-Score's similarity: {held}, each "
        f"launched twice, its first call and its capture); {replays} entry-graph replays (every later encode); "
        f"no backward kernel ran {backward}")
    captured = model._decode_graphs.beams[key]
    if [g.kernels for g in captured.graphs] != [DECODER_FORWARD, DECODER_FORWARD]:
        raise AssertionError(f"phase 11a: the beam graphs hold {[g.kernels for g in captured.graphs]}")
    log(f"  the runner's warm-up captured the beam graphs (batch {EVAL_BATCH} x 4 beams x {kwargs['max_length']}): "
        "each holds " f"{DECODER_FORWARD}, captured in "
        + " and ".join(f"{g.capture_s * 1e3:.1f}" for g in captured.graphs) + " ms, pools "
        + " and ".join(f"{g.pool_bytes / 2**20:.1f}" for g in captured.graphs) + " MiB (shared)")

    direct = []
    for batch in loader:
        direct.extend(model.generate_captions(batch["image"], **kwargs))
    if direct != predictions:
        diff = sum(a != b for a, b in zip(direct, predictions))
        raise AssertionError(f"phase 11a: {diff} of the runner's captions differ from generate_captions' own")
    log(f"  the runner's {len(predictions)} captions equal generate_captions' on the same batches ({len(set(predictions))} "
        "distinct)")

    latencies_s = m["latency_ms_mean"] * m["latency_n_requests"] / 1e3
    generation_s = latencies_s + m["decode_warmup_ms"] / 1e3
    first = next(iter(loader))["image"]
    profile = profiled(lambda: model.generate_captions(first, **kwargs), "batch-32 4-beam eval request (128 steps)",
                       m["latency_ms_median"])
    # on the card: the encode and the prefix, then 127 replays of a graph that holds one decoder forward
    replayed = {k: VIT_ENCODE.get(k, 0) + kwargs["max_length"] * DECODER_FORWARD.get(k, 0) for k in DEVICE_KERNELS}
    seen = profile["kernels"]
    if seen != replayed:
        seen = device_counts(lambda: model.generate_captions(first, **kwargs), replayed,
                             "the profiled eval request")["counts"]
    log(f"  the profiled request ran {replayed} on the card (the profiler saw {seen}): its 127 steps replayed the beam "
        "graphs")
    r = dict(counts=counts, captions_per_s=EVAL_SAMPLES / latencies_s, latency_ms_mean=m["latency_ms_mean"],
             latency_ms_median=m["latency_ms_median"], warmup_ms=m["decode_warmup_ms"], generation_s=generation_s,
             metrics_s=spent["compute_all_metrics"], bert_s=spent["_text_tower_tokens"],
             clip_s=spent["compute_clip_score"], wall_s=wall_s, busy=profile.get("busy"), texts=texts,
             bert_forwards=bert_forwards)
    log(f"  eval run: {r['captions_per_s']:.2f} captions/s over the {EVAL_SAMPLES // EVAL_BATCH} timed requests (latency mean "
        f"{r['latency_ms_mean']:.1f} ms, median {r['latency_ms_median']:.1f}; warm-up {r['warmup_ms']:.1f} ms); "
        f"generation {generation_s:.1f} s against metrics {r['metrics_s']:.1f} s (BERTScore's text-tower forwards "
        f"{r['bert_s']:.2f} s, CLIP-Score {r['clip_s']:.2f} s) of {wall_s:.1f} s [{card()}]")
    return r


# the eager decode loop before the step ran as a CUDA graph: this script's phase 5 at commit 785cccd
# (PERF.md; H100 80GB HBM3, 700 W), ms
EAGER_LOOP_MS = {"eval 32 x 64": 804.5, "greedy batch 1 x 32": 648.4, "greedy batch 8 x 32": 564.6,
                 "greedy batch 32 x 32": 561.5}


def serving_summary(served: dict, serving: dict, llama: dict) -> None:
    """Phase 10's numbers on lines of their own, each beside the card's name and power limit."""
    tag = f"[{card()}]"
    now = {"eval 32 x 64": served["median_s"] * 1e3,
           **{f"greedy batch {r['batch']} x 32": r["seconds"] * 1e3 for r in served["served"]}}
    for name, ms in now.items():
        log(f"  serving, {name}, each step a CUDA-graph replay: {ms:.1f} ms (the eager loop at 785cccd: "
            f"{EAGER_LOOP_MS[name]:.1f} ms) {tag}")
    log(f"  serving, eval 32 x 64 with this tree's eager step: {served['eager_median_s'] * 1e3:.1f} ms; device busy "
        f"{100 * served['profile']['busy']:.1f}% of the graphed call {tag}")
    for name, r in serving["runs"].items():
        log(f"  serving, Poisson {POISSON_REQUESTS} requests at {POISSON_RATE:.0f}/s, {name}: p50 {r['p50_ms']:.1f} ms, "
            f"p95 {r['p95_ms']:.1f} ms, {r['captions_per_s']:.1f} captions/s {tag}")
    for label, c in (("GPT-2 flagship", serving["checks"]), ("Llama slice", llama["engine"])):
        log(f"  serving, {label}: chunk graph captured in {c['chunk_capture_s'] * 1e3:.1f} ms, pool "
            f"{c['chunk_pool_mib']:.1f} MiB, replay {c['chunk_ms']['graphed']:.3f} ms (eager {c['chunk_ms']['eager']:.3f}); "
            f"step graph {c['step_capture_s'] * 1e3:.1f} ms, pool {c['step_pool_mib']:.1f} MiB, replay "
            f"{c['step_ms']['graphed']:.3f} ms (eager {c['step_ms']['eager']:.3f}) {tag}")
        a = c["admissions"]
        log(f"  serving, {label}: admission graphs by bucket (capture ms / pool MiB) "
            + ", ".join(f"{b}: {r['capture_s'] * 1e3:.1f} / {r['pool_bytes'] / 2**20:.1f}" for b, r in a["buckets"].items())
            + f"; the widest bucket {a['ms']['graphed']:.3f} ms graphed, {a['ms']['eager']:.3f} eager {tag}")
    for label, checks in (("GPT-2 flagship", served["beam_checks"]), ("Llama slice", llama["beam_checks"])):
        for batch, c in checks.items():
            log(f"  serving, {label}, 4 beams x 128 at batch {batch}: graphed {c['ms']['graphed']:.1f} ms, eager "
                f"{c['ms']['eager']:.1f} ms; beam graphs captured in "
                + " and ".join(f"{x * 1e3:.1f}" for x in c["capture_s"]) + " ms, pools "
                + " and ".join(f"{x / 2**20:.1f}" for x in c["pool_bytes"]) + f" MiB {tag}")


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def phase_serving() -> dict:
    """Phase 10: the serving entry points on configs/default.yaml's GPT-2 flagship at full width."""
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.scripts.serve import CaptionService, ContinuousCaptionService
    from pgica_tpu_torch.utils.config import Config

    config = Config(ROOT / "configs" / "default.yaml")
    config.set("model.vocab_size", GPT2_VOCAB)  # the flagship's vocab, as phases 5-9
    bare_capture = start_bare_capture()  # beside the services' build
    t = time.perf_counter()
    cont = ContinuousCaptionService(config, slots=SERVE_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH)
    warm = cont.warmup(start_worker=False)
    log(f"  ContinuousCaptionService (configs/default.yaml, vocab {GPT2_VOCAB:,}, bf16; slots {SERVE_SLOTS}, chunk "
        f"{SERVE_CHUNK}, max_length {SERVE_MAX_LENGTH}) built and warmed in {time.perf_counter() - t:.1f} s: "
        + ", ".join(f"{b} {s * 1e3:.0f} ms" for b, s in warm))
    images = np.random.default_rng(13).integers(0, 256, size=(48, 224, 224, 3), dtype=np.uint8)
    checks = graph_checks(cont.model, cont.engine, images, GPT2_FORWARD, "GPT-2 flagship", VIT_ENCODE)
    sampled_engines(cont.model, images[:4], "GPT-2 flagship")
    capture_under_collection(bare_capture)
    cont.engine.start()
    t = time.perf_counter()
    batch = CaptionService(config, max_batch=32, max_length=SERVE_MAX_LENGTH)
    warm = batch.warmup()
    captures = [c for _, c in batch.model._decode_graphs.captured.values()]
    log(f"  CaptionService (max_batch 32, early_stop) built and warmed in {time.perf_counter() - t:.1f} s: "
        + ", ".join(f"bucket {b} {s * 1e3:.0f} ms" for b, s in warm) + "; step graphs captured in "
        + ", ".join(f"{c.capture_s * 1e3:.0f}" for c in captures) + " ms, pools "
        + ", ".join(f"{c.pool_bytes / 2**20:.0f}" for c in captures) + " MiB")

    _kernels.reset_launch_counts()  # ---- the main path starts here
    engine_against_batch(cont.submit, cont.model, images, 3, "GPT-2 engine against the batch path")
    for service, label in ((cont, "continuous scheduler"), (batch, "batch scheduler")):
        http_check(service, label)
    runs = {"continuous, graphed chunk": poisson_run(cont.submit, images),
            "batch, graphed step": poisson_run(batch.submit, images)}
    main_counts = {k: v for k, v in _kernels.launch_counts().items() if k in SERVING_KERNELS}  # ---- and ends here
    check_main_path("serving entry points (engine and batch scheduler, HTTP)", main_counts, SERVING_KERNELS)
    # the eager chunk against the graphed one: graph_checks' timed replays
    for name, r in runs.items():
        log(f"  Poisson arrival, {POISSON_REQUESTS} requests at {POISSON_RATE:.0f}/s (seed 10), {name}: latency p50 "
            f"{r['p50_ms']:.1f} ms, p95 {r['p95_ms']:.1f} ms, {r['captions_per_s']:.1f} captions/s over "
            f"{r['wall_s']:.2f} s [{card()}]")
    # no profiled Poisson run: one under torch.profiler (the continuous engine's, 128 threads submitting,
    # graph replays on the dispatch thread) never returned in one of three runs, its submit timeouts
    # unfired, and the run met its limit; the busy share of serving is phase 5's and the replays'
    stats = cont.engine.stats()
    log(f"  engine stats: {stats}")
    cont.shutdown()
    batch.shutdown()
    return dict(checks=checks, runs=runs, main_counts=main_counts, stats=stats)


# ------------------------------------------------------------------ phase 12

Q8_KERNELS = ("q8_matmul_w8a8", "q8_matmul_w8")
Q8_MODE_KERNEL = {"int8": "q8_matmul_w8a8", "int8_weight_only": "q8_matmul_w8"}
# (M, K, N, where): the decode paths' projections. GPT-2 Medium at M = 1, 8 (a batch of 8), 16 (the engine's
# slots), 32 (a batch of 32) and 128 (32 x 4 beams); Llama-3-8B at a batch of 8
Q8_SHAPES = tuple((m, k, n, where) for k, n, where in ((1024, 1024, "GPT-2 Medium q/k/v/out_proj"),
                                                       (1024, 4096, "GPT-2 Medium fc_in"),
                                                       (4096, 1024, "GPT-2 Medium fc_out"))
                  for m in (1, 8, 16, 32, 128)) + (
    (8, 4096, 4096, "Llama-3-8B q/o_proj"), (8, 4096, 1024, "Llama-3-8B k/v_proj"),
    (8, 4096, 14336, "Llama-3-8B gate/up_proj"), (8, 14336, 4096, "Llama-3-8B down_proj"))
Q8_LIBRARY_M = (16, 32, 128)  # GPT-2 rows also timed with the plain version and the library yardsticks (and Llama's)
Q8_RAGGED = ((5, 1000, 1001), (33, 777, 100), (1, 16, 3), (70, 4104, 24), (129, 64, 8))  # tails of M, N and K
Q8_SUMMARY_SHAPE = (16, 1024, 1024)  # the engine's 16 slots through q/k/v/out_proj: most of a step's launches
# W8A8's bf16 output: the f32 value (exact arithmetic on the int32 sums) rounded once, as the plain version rounds it
Q8_W8A8_BF16_ULPS = 0
Q8_W8_F32_TOL = (1e-4, 1e-5)  # f32 weight-only on CUDA cores: K products summed in another order (K up to 14,336)
QUANT_LOGIT_ATOL = 1e-4  # the quantized 2-layer f32 flagship's logits, card against CPU


def bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> int:
    """The largest distance in bf16 units in the last place between two bf16 tensors (0: bit-equal)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


def q8_launch(weight_only: bool, x, q, s, b, out, sx=None) -> None:
    """One launch of an int8 entry point on explicit buffers (W8A8 writes the row scales to ``sx``)."""
    from pgica_tpu_torch.ops import _kernels

    m, k = x.shape
    n = q.shape[0]
    bias = None if b is None else b.data_ptr()
    tail = (m, n, k, _kernels.DTYPE_CODES[x.dtype], _kernels.stream_handle(x))
    if weight_only:
        _kernels.launch("q8_matmul_w8", x.data_ptr(), q.data_ptr(), s.data_ptr(), bias, out.data_ptr(), *tail)
    else:
        _kernels.launch("q8_matmul_w8a8", x.data_ptr(), sx.data_ptr(), q.data_ptr(), s.data_ptr(), bias,
                        out.data_ptr(), *tail)


def q8_inputs(m: int, k: int, n: int, dtype: torch.dtype, gen: torch.Generator):
    from pgica_tpu_torch.ops.quant import quantize_weight

    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    q, s = quantize_weight(torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k))
    return x, q, s, 0.1 * torch.randn(n, device="cuda", generator=gen)


def q8_case(m: int, k: int, n: int, weight_only: bool, dtype: torch.dtype, gen: torch.Generator,
            timed: bool = True, library: bool = False, where: str = "") -> dict:
    """One int8 entry point against its plain version at (M, K) x (N, K).

    W8A8 (one launch, the row quantizer fused): the row scales that the instance of x's dtype writes, and those
    of the f32 instance run on the same values, bit-equal to quantize_rows'; the f32 output bit-equal to the
    plain version's (exact arithmetic on the int32 sums), the bf16 output Q8_W8A8_BF16_ULPS from it.
    Weight-only: bf16 within TOL, f32 within Q8_W8_F32_TOL. Both: two runs bit-equal. Timed on rotating
    input sets > 2x L2 (the weight arrives cold, as in a decode step over 24 layers); the bound counts the
    int8 weight, its scales and bias, x and y once, and 2 M N K operations at the int8 (W8A8) or bf16
    (weight-only) dense peak; the library yardsticks are torch._int_mm (the int8 product alone, where its
    shape rules allow it) and F.linear on a bf16 dequantized weight (which reads 2 bytes a weight)."""
    from pgica_tpu_torch.ops.quant import q8_matmul, q8_matmul_ref, q8_plan, quantize_rows

    x, q, s, b = q8_inputs(m, k, n, dtype, gen)
    got, again = q8_matmul(x, q, s, b, weight_only), q8_matmul(x, q, s, b, weight_only)
    torch.cuda.synchronize()
    want = q8_matmul_ref(x, q, s, b, weight_only)
    label = f"q8 {'w8' if weight_only else 'w8a8'} ({m}, {k}) x ({n}, {k}) {dname(dtype)}"
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two runs on the same inputs differ")
    r = dict(shape=f"({m}, {k}) x ({n}, {k})", dtype=dname(dtype), where=where)
    if weight_only:
        atol, rtol = Q8_W8_F32_TOL if dtype == torch.float32 else TOL[dtype]
        r.update(max_abs_err=check_close(label, got, want, atol, rtol), atol=atol, rtol=rtol)
    else:
        # the row scales of this dtype's own instance, then (for a bf16 shape) of the f32 one on the same values
        want_sx = quantize_rows(x)[1]
        sx, out = torch.full((m,), float("nan"), device="cuda"), torch.empty_like(got)
        q8_launch(False, x, q, s, b, out, sx)
        torch.cuda.synchronize()
        if not torch.equal(sx, want_sx) or not torch.equal(out, got):
            raise AssertionError(f"{label}: the fused row quantizer's scales differ from quantize_rows'")
        xf = x.float()
        sx32, got32 = torch.full((m,), float("nan"), device="cuda"), torch.empty(m, n, device="cuda")
        q8_launch(False, xf, q, s, b, got32, sx32)
        torch.cuda.synchronize()
        if not torch.equal(sx32, want_sx):
            raise AssertionError(f"{label}: the f32 instance's row scales differ from quantize_rows'")
        if not torch.equal(got32, q8_matmul_ref(xf, q, s, b)):
            raise AssertionError(f"{label}: the f32 output (exact on the int32 sums) differs from the plain one")
        if dtype == torch.float32 and not torch.equal(got, want):
            raise AssertionError(f"{label}: the f32 output differs from the plain version's")
        ulps = 0
        if dtype == torch.bfloat16 and (ulps := bf16_ulps(got, want)) > Q8_W8A8_BF16_ULPS:
            raise AssertionError(f"{label}: {ulps} bf16 ulps from the plain version")
        r.update(max_abs_err=float((got.float() - want.float()).abs().max()), ulps=ulps, atol=0.0, rtol=0.0)
    if not timed:
        return r
    if dtype == torch.bfloat16 or not weight_only:
        r["plan"] = q8_plan(m, n, k, dtype, weight_only)
    nbytes = n * k + 8 * n + (m * k + m * n) * x.element_size()
    n_sets = max(1, math.ceil(100e6 / nbytes))
    sets = [(x, q, s, b, weight_only)] + [(*q8_inputs(m, k, n, dtype, gen), weight_only) for _ in range(n_sets - 1)]
    r.update(ms=time_ms(q8_matmul, sets), input_sets=n_sets,
             **bound(nbytes, 2 * m * n * k, dtype if weight_only else torch.int8))
    if library:
        r["plain_ms"] = time_ms(q8_matmul_ref, sets)
        deq = [(xs, (qs.to(dtype) * ss.to(dtype)[:, None]), bs.to(dtype)) for xs, qs, ss, bs, _ in sets]
        r["linear_ms"] = time_ms(F.linear, deq)
        r["int_mm_ms"] = library_time(lambda xs, qs: torch._int_mm(xs, qs.t()),
                                      [(quantize_rows(xs)[0], qs) for xs, qs, _, _, _ in sets])
        r["library_ms"] = r["linear_ms"] if weight_only else r["int_mm_ms"]
    return r


def show_q8(kernel: str, r: dict) -> None:
    err = (f"{r['ulps']} bf16 ulp (f32 output and row quantizer bit-equal)" if "ulps" in r and r["dtype"] == "bfloat16"
           else "bit-equal" if "ulps" in r else f"max_abs_err {r['max_abs_err']:.3e} (atol {r['atol']}, rtol {r['rtol']})")
    extra = ""
    if "plain_ms" in r:
        lib = "refused" if r["int_mm_ms"] is None else f"{r['int_mm_ms']:.5f}"
        extra = f" plain_ms {r['plain_ms']:.5f} torch._int_mm {lib} F.linear(bf16 dequantized) {r['linear_ms']:.5f}"
    plan = r.get("plan")
    tiling = (f"; {plan['rows']}-row x {plan['cols']}-column blocks, split {plan['split']}, {plan['blocks']} blocks"
              if plan else "")
    log(f"  {kernel} {r['where']} {r['shape']} {r['dtype']}: {err}; kernel_ms {r['ms']:.5f}{extra} bound_ms "
        f"{r['bound_ms']:.6f} ({r['bound_by']}; {r['input_sets']} input sets{tiling})")


def phase_int8_kernels() -> dict:
    """Phase 12a: both int8 entry points against their plain versions at the decode paths' shapes, bf16 (and f32
    at the GPT-2 shapes of one row count: phase 12b's f32 check runs them), ragged tails, each bf16 shape timed."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    results = {name: [] for name in Q8_KERNELS}
    for weight_only, name in ((False, "q8_matmul_w8a8"), (True, "q8_matmul_w8")):
        for m, k, n, where in Q8_SHAPES:
            library = m in Q8_LIBRARY_M or "Llama" in where
            r = q8_case(m, k, n, weight_only, torch.bfloat16, gen, library=library, where=where)
            results[name].append(r)
            show_q8(name, r)
        for m, k, n in Q8_RAGGED + ((2, 1024, 1024), (2, 4096, 1024)):
            for dtype in (torch.bfloat16, torch.float32):
                r = q8_case(m, k, n, weight_only, dtype, gen, timed=False)
                results[name].append(r)
        worst = max(r.get("ulps", r["max_abs_err"]) for r in results[name] if "ms" not in r)
        log(f"  {name}: ragged tails {Q8_RAGGED} and the f32 GPT-2 rows, bf16 and f32, against the plain version: "
            f"within tolerance (worst {'ulps' if not weight_only else 'abs err'} {worst})")
    return results


def set_quantization(model, mode) -> None:
    """Switch a model's decode to ``mode`` (None: the compute-dtype copy); the old twin and its graphs go."""
    model.quantization = mode
    model._quant_cache = model._decode_graphs = None
    torch.cuda.empty_cache()


def quant_logits(model, images, steps: int = 3):
    """The decode module's (the int8 twin's) prefix and step logits, as decode_logits gives the masters'."""
    from pgica_tpu_torch.models.lm import init_kv_cache

    module, cache_len = model._decode_module(), 17
    with torch.inference_mode():
        emb = model.encode_image(images)["embeddings"]
        caches = init_kv_cache(module.decoder_config, emb.shape[0], cache_len, torch.float32, model.device)
        slots = torch.arange(cache_len, device=model.device)
        mask_at = lambda t: (slots[None, :] <= t).to(torch.int32).expand(emb.shape[0], cache_len)  # noqa: E731
        logits, caches = module.decode_prefix(emb, caches, mask_at(0))
        out = [logits.cpu()]
        for t in range(1, steps + 1):
            logits, caches = module.decode_step(logits.argmax(-1)[:, None], t, caches, mask_at(t))
            out.append(logits.cpu())
    return out


def quant_full_width(cuda, cpu, images) -> None:
    """Phase 12b's f32 check, on phase 4's 2-layer GPT-2 flagship: the int8 twin's logits on the card (the
    kernels) against the CPU's (the plain versions), both modes."""
    from pgica_tpu_torch.ops import _kernels

    for mode in Q8_MODE_KERNEL:
        for model in (cuda, cpu):
            set_quantization(model, mode)
        before = _kernels.launch_counts()[Q8_MODE_KERNEL[mode]]
        got = quant_logits(cuda, images)
        launched = _kernels.launch_counts()[Q8_MODE_KERNEL[mode]] - before
        want = quant_logits(cpu, images)
        errs = [check_close(f"quantized ({mode}) full width: {'prefix' if i == 0 else f'step {i}'} logits", g, c,
                            QUANT_LOGIT_ATOL, 0.0) for i, (g, c) in enumerate(zip(got, want))]
        log(f"  phase 12b, {mode}: the int8 twin of phase 4's 2-layer f32 GPT-2 flagship, prefix and 3 steps' logits "
            f"(2, {GPT2_VOCAB}), card against CPU: max_abs_err {max(errs):.3e} (atol {QUANT_LOGIT_ATOL}); "
            f"{launched} {Q8_MODE_KERNEL[mode]} launches (4 forwards x 2 layers x 6 projections)")
        if launched != 4 * 2 * 6:
            raise AssertionError(f"{mode}: {launched} int8 launches, expected 48")
    for model in (cuda, cpu):
        set_quantization(model, None)



def phase_quant_serving(model, served: dict) -> dict:
    """Phase 12b on the trained bf16 flagship of phases 6-7: generate_captions through the int8 twin in both
    modes (greedy at batch 1, 8 and 32 x 32 with early_stop, each step a graph replay; the configs' 4-beam
    request at batch 8) and the engine's chunk replay, beside the same requests in bf16."""
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine
    from pgica_tpu_torch.generation.slots import Sampler
    from pgica_tpu_torch.ops import _kernels

    images = np.random.default_rng(12).integers(0, 256, size=(32, 224, 224, 3), dtype=np.uint8)
    tok = model.tokenizer
    set_quantization(model, None)
    bf16 = {b: model.generate_captions(images[:b], max_length=32, early_stop=True) for b in (8, 32)}
    bf16_beams = model.generate_captions(images[:8], max_length=128, early_stop=True, **BEAMS)
    key = lambda b: (b, 32, Sampler(), tok.eos_token_id, tok.pad_token_id)  # noqa: E731

    def request(batch: int, **kw) -> dict:
        torch.cuda.synchronize()
        t = time.perf_counter()
        captions = model.generate_captions(images[:batch], early_stop=True, **kw)
        return dict(seconds=time.perf_counter() - t, captions=captions)

    runs, engines = {}, {}
    _kernels.reset_launch_counts()  # ---- the main path starts here
    for mode in Q8_MODE_KERNEL:
        set_quantization(model, mode)
        kernel = Q8_MODE_KERNEL[mode]
        r = {}
        for batch in (1, 8, 32):
            request(batch, max_length=32)  # captures the step graph of this batch
            r[f"greedy {batch}"] = request(batch, max_length=32)
            held = model._decode_graphs.captured[key(batch)][1].kernels
            if held != {**DECODER_FORWARD, kernel: 24 * 6}:
                raise AssertionError(f"{mode}: the batch-{batch} step graph holds {held}")
        request(8, max_length=128, **BEAMS)
        r["4 beams 8"] = request(8, max_length=128, **BEAMS)
        held = [g.kernels for g in model._decode_graphs.beams[beam_key(tok, 8)].graphs]
        if held != [{**DECODER_FORWARD, kernel: 24 * 6}] * 2:
            raise AssertionError(f"{mode}: the batch-8 beam graphs hold {held}")
        eng = ContinuousDecodeEngine(model, slots=SERVE_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH)
        eng.warmup()
        if eng.module is not model._decode_module():
            raise AssertionError(f"{mode}: the engine does not decode through the twin")
        want = {k: SERVE_CHUNK * v for k, v in {**DECODER_FORWARD, kernel: 24 * 6}.items()}
        if eng.graph.kernels != want:
            raise AssertionError(f"{mode}: the chunk graph holds {eng.graph.kernels}, expected {want}")
        r["chunk_ms"] = timed_replays(eng.graph.replay, eng._stream)
        _, seqs, _ = run_engine_to_end(eng, images[:SERVE_SLOTS])
        engine_captions = [tok.decode(s) for s in seqs.cpu().numpy()]
        eng.stop()
        engines[mode] = eng  # its admission graphs are held against the eager admission after the path
        batch16 = model.generate_captions(images[:SERVE_SLOTS], max_length=SERVE_MAX_LENGTH)
        if engine_captions != batch16:
            raise AssertionError(f"{mode}: the engine's captions differ from generate_captions'")
        agree = {name: sum(a == b for a, b in zip(r[name]["captions"], ref)) / len(ref)
                 for name, ref in (("greedy 8", bf16[8]), ("greedy 32", bf16[32]), ("4 beams 8", bf16_beams))}
        runs[mode] = r
        log(f"  {mode}: greedy 32 tokens (early_stop, each step a graph replay holding {kernel} x 144, 49 LN, 24 "
            f"flash): batch 1 {r['greedy 1']['seconds'] * 1e3:.1f} ms, 8 {r['greedy 8']['seconds'] * 1e3:.1f}, 32 "
            f"{r['greedy 32']['seconds'] * 1e3:.1f}; 4 beams x 128 at batch 8 {r['4 beams 8']['seconds'] * 1e3:.1f} "
            f"ms; the engine's chunk ({SERVE_CHUNK} steps x {SERVE_SLOTS} slots) {r['chunk_ms']:.3f} ms a replay, its "
            f"{SERVE_SLOTS} captions equal generate_captions'; captions equal to bf16's (information only): "
            + ", ".join(f"{k} {100 * v:.0f}%" for k, v in agree.items()))
        r["agreement"] = agree
    counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("int8 serving (phase 12b)", counts, Q8_KERNELS + SERVING_KERNELS)
    for mode, eng in engines.items():  # an eager engine on the same twin's bits (set_quantization rebuilds it)
        set_quantization(model, mode)
        eager = ContinuousDecodeEngine(model, slots=SERVE_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH,
                                       cuda_graph=False)
        runs[mode]["admissions"] = admission_checks(eng, eager, images, VIT_ENCODE,
                                                    {**DECODER_FORWARD, Q8_MODE_KERNEL[mode]: 24 * 6}, f"{mode} twin")
        eager.stop()
    del eng, eager, engines
    set_quantization(model, None)
    bf16_ms = {f"greedy {r['batch']}": r["seconds"] * 1e3 for r in served["served"]}
    log(f"  bf16 on this card (phase 5, random weights): greedy batch 1 / 8 / 32 "
        + " / ".join(f"{bf16_ms[f'greedy {b}']:.1f}" for b in (1, 8, 32))
        + f" ms; 4 beams batch 8 {served['beamed'][0]['seconds'] * 1e3:.1f} ms [{card()}]")
    return dict(counts=counts, runs={m: {k: (v["seconds"] * 1e3 if isinstance(v, dict) and "seconds" in v else v)
                                         for k, v in r.items()} for m, r in runs.items()})


def quant_llama(model) -> dict:
    """Phase 12b on the Llama slice (LLAMA_REDUCED): a greedy request at batch 8 x 32 in bf16 and through the int8
    twin in both modes, each step a graph replay; the step graph holds the int8 kernels. Then the engine's
    admission graphs through each twin against the eager admission (``admission_checks``)."""
    from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine
    from pgica_tpu_torch.generation.slots import Sampler
    from pgica_tpu_torch.ops import _kernels

    images = np.random.default_rng(13).integers(0, 256, size=(8, model.image_size, model.image_size, 3),
                                                dtype=np.uint8)
    tok = model.tokenizer
    out = {}
    _kernels.reset_launch_counts()  # ---- the main path starts here
    for mode in (None, *Q8_MODE_KERNEL):
        set_quantization(model, mode)
        model.generate_captions(images, max_length=32)  # the capture
        torch.cuda.synchronize()
        t = time.perf_counter()
        captions = model.generate_captions(images, max_length=32)
        out[mode or "bf16"] = dict(ms=(time.perf_counter() - t) * 1e3, captions=captions)
        held = model._decode_graphs.captured[(8, 32, Sampler(), tok.eos_token_id, tok.pad_token_id)][1].kernels
        want = {**{k: v for k, v in LLAMA_FORWARD.items()}, **({Q8_MODE_KERNEL[mode]: 7 * LLAMA_LAYERS} if mode else {})}
        if held != want:
            raise AssertionError(f"Llama {mode}: the step graph holds {held}, expected {want}")
    counts = _kernels.launch_counts()  # ---- and ends here
    check_main_path("Llama int8 serving (phase 12b)", counts, Q8_KERNELS)
    admissions = {}
    for mode in Q8_MODE_KERNEL:  # the engine's admission graphs through the twin, against the eager admission
        set_quantization(model, mode)
        eng = ContinuousDecodeEngine(model, slots=LLAMA_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH)
        eng.warmup()
        eager = ContinuousDecodeEngine(model, slots=LLAMA_SLOTS, chunk=SERVE_CHUNK, max_length=SERVE_MAX_LENGTH,
                                       cuda_graph=False)
        admissions[mode] = admission_checks(eng, eager, images, SIGLIP_ENCODE,
                                            {**LLAMA_FORWARD, Q8_MODE_KERNEL[mode]: 7 * LLAMA_LAYERS},
                                            f"Llama slice, {mode} twin")
        eng.stop()
        eager.stop()
        del eng, eager
    set_quantization(model, None)
    log("  phase 12b on the Llama slice, greedy batch 8 x 32, each step a graph replay: "
        + "; ".join(f"{name} {r['ms']:.1f} ms" + (f" (captions equal to bf16's: "
                    f"{sum(a == b for a, b in zip(r['captions'], out['bf16']['captions']))} of 8)" if name != "bf16"
                    else "") for name, r in out.items())
        + f"; the step graph holds {7 * LLAMA_LAYERS} int8 launches ({LLAMA_LAYERS} layers x 7 projections) "
        f"[{card()}]")
    return dict(counts=counts, ms={k: v["ms"] for k, v in out.items()}, admissions=admissions)


LORA_DIR = ROOT / "build" / "phase12"
LORA_STEPS = 4
LORA_ACCUMULATION = 2
LORA_LAYERS = 4  # 12c: each tower's layers (ViT-B/32: 12, GPT-2 Medium: 24)
LORA_PAIRS = 2 * 5 * LORA_LAYERS  # init_lora on the flagship's shapes: 5 (A, B) pairs a block of the two GPT-2 towers
LORA_ADAPTER_VALUES = 2 * 1_229_056 * LORA_LAYERS  # 58,994,688 at the full 24 layers
LORA_REDUCED = (
    f"each tower runs {LORA_LAYERS} of its layers at full width (the CLI and predict read depth from the presets, "
    "which are cut for the phase): at full depth 12c took 47-61 s, and phases 14-15 need the time",
    "configs/lora.yaml's width, depth and vocab as phase 9 runs configs/default.yaml's (PHASE9_REDUCED: 1 epoch a "
    "stage, vocab 50,262, phase 9's JPEGs and splits, outputs under build/phase12, deleted at the end)",
    f"--max-steps {LORA_STEPS}: {LORA_STEPS} micro-steps a stage",
    f"gradient accumulation {LORA_ACCUMULATION} (the config: 4), so that a stage takes 2 updates: the schedule's first "
    "has lr 0, and with one update the adapters would not move",
)


def phase_lora_cli(captions: Path, preferences: Path) -> dict:
    """Phase 12c: ``python -m pgica_tpu_torch.scripts.train --config configs/lora.yaml`` at the flagship's full width
    (LORA_REDUCED): both stages train the adapters only, the base masters stay bit-unchanged (held to a fresh
    build of the same seed) until the best checkpoint's merged params are loaded at the end, the stage-2 steps
    never launch the fused-CE dW kernel, and the folded checkpoint loads through predict.main."""
    import yaml

    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.scripts import predict, train as train_cli
    from pgica_tpu_torch.training.checkpoint import effective_params
    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import create_model

    shutil.rmtree(LORA_DIR, ignore_errors=True)
    LORA_DIR.mkdir(parents=True)
    try:
        with cut_presets(LORA_LAYERS):  # the CLI and predict read depth from the presets
            cfg = yaml.safe_load((ROOT / "configs" / "lora.yaml").read_text())
            if cfg["model"]["lora_config"] != {"r": 16, "lora_alpha": 32, "target_modules": ["c_attn", "c_proj"],
                                               "lora_dropout": 0.1} or not cfg["training"]["load_best_model_at_end"]:
                raise AssertionError(f"configs/lora.yaml changed under phase 12c: {cfg['model']['lora_config']}")
            for stage in ("stage1", "stage2"):
                cfg["training"][stage]["num_epochs"] = 1
                cfg["training"][stage]["gradient_accumulation_steps"] = LORA_ACCUMULATION
            cfg["data"].update(conceptual_captions_path=str(captions), ultrafeedback_path=str(preferences),
                               native_decode="fast", device_side_normalization=True, **PHASE9_SPLITS)
            cfg["model"]["vocab_size"] = GPT2_VOCAB
            cfg["paths"] = {"output_dir": str(LORA_DIR / "run"),
                            "checkpoint_dir": str(LORA_DIR / "run" / "checkpoints"),
                            "log_dir": str(LORA_DIR / "logs"), "cache_dir": str(LORA_DIR / "cache")}
            path = LORA_DIR / "lora_phase12.yaml"
            path.write_text(yaml.safe_dump(cfg, sort_keys=False))
            log(f"  configs/lora.yaml (GPT-2 flagship, LoRA r 16, alpha 32, c_attn/c_proj, dropout 0.1, bf16, gradient "
                f"checkpointing) written to {path.relative_to(ROOT)}; changed: " + "; ".join(LORA_REDUCED))
            _kernels.reset_launch_counts()  # ---- the main path starts here
            t = time.perf_counter()
            trainer = train_cli.run(["--config", str(path), "--max-steps", str(LORA_STEPS)])
            run_s = time.perf_counter() - t
            counts = cli_executed(_kernels.launch_counts(), trainer)  # ---- and ends here
            graph_report(trainer, "12c (LoRA)")
            check_main_path("LoRA training entry point (stages 1 and 2)", counts,
                            tuple(k for k in TRAIN_KERNELS if k != "fused_ce_bwd_dw"))
            if counts["fused_ce_bwd_dw"] != 0:
                raise AssertionError(f"LoRA stage 2 launched fused-CE dW {counts['fused_ce_bwd_dw']} times (the tied "
                                     "embedding is no target)")
            stages = {name: show_stage(f"LoRA {name}", trainer.history[name][0], None) for name in ("stage1", "stage2")}
            ckpts = LORA_DIR / "run" / "checkpoints"
            payload = torch.load(ckpts / "checkpoint_stage2_epoch0" / "state.pt", map_location="cpu", weights_only=True)
            opt = payload["opt_state"]
            moments = sum(opt["mu"][n].numel() + opt["nu"][n].numel() for n in opt["names"])
            adapters = sum(v.numel() for ab in payload["lora"].values() for v in ab.values())
            if (adapters != LORA_ADAPTER_VALUES or moments != 2 * LORA_ADAPTER_VALUES
                    or len(payload["lora"]) != LORA_PAIRS):
                raise AssertionError(f"LoRA: {len(payload['lora'])} pairs, {adapters} adapter values, "
                                     f"{moments} Adam moments")
            fresh = create_model(Config(str(path)), trainer.model.tokenizer, device="cpu")
            start = dict(fresh.module.named_parameters())
            moved_base = [n for n, p in payload["params"].items() if not torch.equal(p, start[n])]
            if moved_base:
                raise AssertionError(f"LoRA moved the base masters: {moved_base[:4]}")
            moved = sum(int((ab["b"] != 0).any()) for ab in payload["lora"].values())
            if moved == 0:
                raise AssertionError("no adapter factor B moved from its zero initialization")
            best = torch.load(ckpts / "best_model_stage2" / "state.pt", map_location="cpu", weights_only=True)
            merged = effective_params(best)
            served = {n: p.cpu() for n, p in trainer.model.module.named_parameters()}
            if trainer.model.lora is not None or any(not torch.equal(merged[n], served[n]) for n in merged):
                raise AssertionError("the model at the end is not the best checkpoint's merged params")
            diff = sum(int((merged[n] != start[n]).sum()) for n in merged)
            log(f"  train_cli.run on configs/lora.yaml in {run_s:.1f} s: {adapters:,} adapter values in {LORA_PAIRS} "
                f"(A, B) pairs and {moments:,} Adam moments (= 2 x {LORA_ADAPTER_VALUES:,}) in the optimizer state; "
                f"the checkpoint's base masters bit-equal to a fresh build's; {moved} of {LORA_PAIRS} B factors moved "
                f"from 0; fused-CE launches fwd {counts['fused_ce_fwd']}, dh {counts['fused_ce_bwd_dh']}, dW "
                f"{counts['fused_ce_bwd_dw']}; at the end the model holds best_model_stage2's merged params ({diff:,} "
                "elements off the base)")
            del trainer, fresh, start, merged, served, payload, best
            gc.collect()
            torch.cuda.empty_cache()
            t = time.perf_counter()
            out = LORA_DIR / "predictions.json"
            if predict.main(["--config", str(path), "--model-path", str(ckpts / "best_model_stage2"),
                             "--image", str(Path(captions).parent / "images" / "0000.jpg"), "--output", str(out)]) != 0:
                raise AssertionError("predict.main failed on the LoRA checkpoint")
            predict_s = time.perf_counter() - t
            log(f"  predict.main on best_model_stage2 (base + adapters, merged on load): {predict_s:.1f} s, "
                f"{json.loads(out.read_text())}")
            return dict(counts=counts, stages=stages, run_s=run_s, predict_s=predict_s)
    finally:
        shutil.rmtree(LORA_DIR, ignore_errors=True)


# ------------------------------------------------------------------ phase 13

PHASE13_DIR = ROOT / "build" / "phase13"
GPT2_HF_VOCAB = 50_257  # GPT-2's own rows: the checkpoint's wte (the module adds the five specials)
BPE_VOCAB = 1024  # data.bpe_vocab_size of 13a: merges stop earlier, once no pair occurs twice in the captions
GRAIN_WORKERS = 2  # configs/default.yaml's data.num_workers is 4 (PHASE13_REDUCED)
GRAIN_STEPS = 4
GPT2_LAYERS = 24
PHASE13_LAYERS = 4  # 13a's CLI: each tower's layers (ViT-B/32: 12, GPT-2 Medium: 24)
PHASE13_REDUCED = (
    f"the CLI's towers run {PHASE13_LAYERS} of their layers at full width (the CLI reads depth from the presets, "
    "which are cut for its run): at full depth 13a took 62-74 s, and phases 14-15 need the time; its loaders, BPE and "
    "steps are the same",
    f"configs/default.yaml as phase 9 runs it (PHASE9_REDUCED), with data.workers_mode grain ({GRAIN_WORKERS} "
    "spawned workers a loader, the config's num_workers 4: each worker is a process that imports torch, and on a "
    "slow host the CLI's four pools of 4 took 79 s of 13a's 124) and data.bpe_vocab_size "
    f"{BPE_VOCAB}, trained on phase 9's captions",
    f"--max-steps {GRAIN_STEPS}: {GRAIN_STEPS} micro-steps a stage, one update at the config's accumulation of 4",
    "no checkpoints (save_steps 0, no epoch or best checkpoint): phase 9 holds the CLI's checkpoints, and the "
    "run's disk writes are limited",
)
NON_ASCII = ["café ☕ naïve", "日本語 caption", "x² + y³", "a → b — c", "١٢٣ digits", "mixed中文and123",
             "non‑breaking space", "emoji \U0001f600\U0001f680 run"]


def written() -> str:
    """This process's writes so far (/proc/self/io): ``write_bytes``, sent to storage, and ``wchar``, passed to
    write calls (the page cache included; where storage does not account ``write_bytes``, the upper bound).
    The run's disk writes are limited."""
    io = dict(line.split(": ") for line in Path("/proc/self/io").read_text().splitlines())
    return (f"{int(io['write_bytes']) / 2**30:.2f} GiB written to storage by this process so far, "
            f"{int(io['wchar']) / 2**30:.2f} GiB through write calls")


def same_batches(label: str, got, want) -> int:
    """Hold two loaders' batches equal, array for array and caption for caption; returns their count."""
    got, want = list(got), list(want)
    if len(got) != len(want) or not got:
        raise AssertionError(f"{label}: {len(got)} batches against {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            if isinstance(w[key], np.ndarray):
                same = isinstance(g[key], np.ndarray) and np.array_equal(g[key], w[key])
            else:
                same = g[key] == w[key]
            if not same:
                raise AssertionError(f"{label}: batch {i} differs in {key}")
    return len(got)


def phase_grain_bpe_cli() -> dict:
    """Phase 13a, inside phase 9 on its JPEGs and captions: the dataset BPE (train, save, the cache), the native
    encoder against the Python path, the grain loader against the thread loader, then the training CLI with
    both (PHASE13_REDUCED) at the flagship's full width, 4 layers a tower."""
    import yaml

    from pgica_tpu_torch.data.loader import ConceptualCaptionsDataset, DataLoader
    from pgica_tpu_torch.data import native_bpe
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.scripts import train as train_cli
    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import create_processors, create_tokenizer, read_caption_corpus

    captions = PHASE9_DIR / "data" / "captions.csv"
    shutil.rmtree(PHASE13_DIR, ignore_errors=True)
    PHASE13_DIR.mkdir(parents=True)
    try:
        cfg = yaml.safe_load((PHASE9_DIR / "default_phase9.yaml").read_text())
        cfg["data"].update(bpe_vocab_size=BPE_VOCAB, workers_mode="grain", num_workers=GRAIN_WORKERS)
        cfg["training"].update(save_steps=0, save_epoch_checkpoints=False, save_best_checkpoints=False)
        cfg["paths"] = {"output_dir": str(PHASE13_DIR / "run"), "checkpoint_dir": str(PHASE13_DIR / "run" / "ckpt"),
                        "log_dir": str(PHASE13_DIR / "logs"), "cache_dir": str(PHASE13_DIR / "cache")}
        path = PHASE13_DIR / "default_phase13.yaml"
        path.write_text(yaml.safe_dump(cfg, sort_keys=False))
        config = Config(str(path))
        log("  changed: " + "; ".join(PHASE13_REDUCED))

        t = time.perf_counter()
        tok = create_tokenizer(config)
        train_s = time.perf_counter() - t
        cached = sorted((PHASE13_DIR / "cache").iterdir())
        t = time.perf_counter()
        again = create_tokenizer(config)
        load_s = time.perf_counter() - t
        corpus = read_caption_corpus(captions)
        ids = [tok.encode(c) for c in corpus]
        if (len(cached) != 1 or not cached[0].name.startswith(f"bpe_{BPE_VOCAB}_") or again.vocab != tok.vocab
                or again._merges != tok._merges or [again.encode(c) for c in corpus] != ids):
            raise AssertionError(f"the cached dataset BPE ({cached}) is not the trained one")
        native = tok._native_encoder()
        if native is None:
            raise AssertionError(f"the native BPE encoder did not build: {native_bpe.build_error}")
        texts = corpus + NON_ASCII
        differ = [t for t in texts if native.encode(t) != tok._python_encode(t)]
        if differ:
            raise AssertionError(f"native and Python BPE ids differ on {differ[:3]}")
        tokens = sum(len(x) for x in ids)
        log(f"  dataset BPE: {len(tok._merges)} merges learned from {len(corpus)} captions (vocab {tok.vocab_size} "
            f"with the specials; asked {BPE_VOCAB}) in {train_s * 1e3:.1f} ms, saved to {cached[0].name} and read "
            f"back from the cache in {load_s * 1e3:.1f} ms, ids identical; {tokens} tokens for "
            f"{sum(len(c.encode()) for c in corpus)} bytes; native ids (build/pgica_tpu_torch/native/"
            f"{native_bpe._library_path().name}) equal the Python path's over {len(texts)} texts "
            f"({len(NON_ASCII)} non-ASCII)")

        image_processor, text_processor = create_processors(config, tok)
        ds = ConceptualCaptionsDataset(captions, image_processor, text_processor)
        thread = DataLoader(ds, 8, shuffle=True, drop_last=True, seed=42)
        grain = DataLoader(ds, 8, shuffle=True, drop_last=True, seed=42, num_workers=GRAIN_WORKERS,
                           workers_mode="grain")
        try:
            t = time.perf_counter()
            n = 0
            for epoch in range(2):
                n += same_batches(f"grain epoch {epoch}", grain, thread)
                if epoch == 0:
                    pool = grain._grain_dl
                elif grain._grain_dl is not pool:
                    raise AssertionError("the grain pool was rebuilt for the second epoch")
            thread.set_epoch(5)
            grain.set_epoch(5)
            n += same_batches("grain epoch 5 from batch 3", grain.iter_batches(3), thread.iter_batches(3))
            if grain._grain_dl is pool:
                raise AssertionError("a resume (set_epoch back, iter_batches(3)) kept the old pool's position")
            loader_s = time.perf_counter() - t
        finally:
            grain.close()
            thread.close()
        log(f"  grain loader ({GRAIN_WORKERS} spawned workers, batch 8 of the JPEGs, native BPE ids in the workers) "
            f"equal to the thread loader's: {n} batches over epochs 0 and 1 (one pool) and epoch 5 from batch 3 (a "
            f"pool positioned anew), {loader_s:.1f} s in all")

        _kernels.reset_launch_counts()  # ---- the main path starts here
        t = time.perf_counter()
        with cut_presets(PHASE13_LAYERS):
            trainer = train_cli.run(["--config", str(path), "--max-steps", str(GRAIN_STEPS)])
        run_s = time.perf_counter() - t
        counts = cli_executed(_kernels.launch_counts(), trainer)  # ---- and ends here
        check_main_path("training entry point with grain workers and the dataset BPE", counts, TRAIN_KERNELS)
        graph_report(trainer, "13a", replayed=False)
        layers = PHASE13_LAYERS
        want = {"flash_attn_bwd_dq": 2 * layers * GRAIN_STEPS, "flash_attn_bwd_dkv": 2 * layers * GRAIN_STEPS,
                "fused_ce_bwd_dh": GRAIN_STEPS, "fused_ce_bwd_dw": GRAIN_STEPS}
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"13a's CLI launched {counts}; {GRAIN_STEPS} steps a stage need {want}")
        loaders = (trainer.train_loader, trainer.preference_train_loader)
        if {ld.workers_mode for ld in loaders} != {"grain"} or trainer.model.tokenizer.vocab != tok.vocab:
            raise AssertionError("13a's CLI did not run the grain loaders and the dataset BPE")
        stages = {}
        for name in ("stage1", "stage2"):
            record = trainer.history[name][0]
            stages[name] = show_stage(f"grain + BPE {name}", record, None)
            stages[name]["input_wait"] = record["input_wait_fraction"]
            if len(record["step_seconds"]) != GRAIN_STEPS:
                raise AssertionError(f"13a {name}: {len(record['step_seconds'])} micro-steps")
        if not all(math.isfinite(r[k]) for r in stages.values() for k in ("train_loss", "val_loss")):
            raise AssertionError(f"13a: a loss is not finite: {stages}")
        log(f"  train_cli.run in {run_s:.1f} s; ms per micro-step (median after the first) stage 1 "
            f"{stages['stage1']['ms_per_micro_step']:.1f}, stage 2 {stages['stage2']['ms_per_micro_step']:.1f}; "
            f"input wait {100 * stages['stage1']['input_wait']:.1f}% / {100 * stages['stage2']['input_wait']:.1f}% of "
            f"each epoch's wall (its first batch waits for the spawned workers); launches {want} as the steps need "
            f"[{card()}]")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        return dict(counts=counts, stages=stages, run_s=run_s, merges=len(tok._merges), loader_s=loader_s)
    finally:
        shutil.rmtree(PHASE13_DIR, ignore_errors=True)


def hf_clip_vision_state_dict(cfg, gen: torch.Generator) -> dict:
    """A seeded ``CLIPVisionModel`` state dict (``vision_model.`` keys, torch layouts) for ``cfg``'s widths."""
    h, p, mlp = cfg.hidden_size, cfg.patch_size, int(cfg.hidden_size * cfg.mlp_ratio)

    def normal(*shape, std=0.02, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen)

    sd = {"embeddings.class_embedding": normal(h),
          "embeddings.patch_embedding.weight": normal(h, 3, p, p),
          "embeddings.position_embedding.weight": normal(cfg.num_patches + 1, h),
          "pre_layrnorm.weight": normal(h, std=0.1, mean=1.0), "pre_layrnorm.bias": normal(h),
          "post_layernorm.weight": normal(h, std=0.1, mean=1.0), "post_layernorm.bias": normal(h)}
    for i in range(cfg.num_layers):
        q = f"encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[q + ln + ".weight"], sd[q + ln + ".bias"] = normal(h, std=0.1, mean=1.0), normal(h)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[q + f"self_attn.{proj}.weight"], sd[q + f"self_attn.{proj}.bias"] = normal(h, h), normal(h)
        sd[q + "mlp.fc1.weight"], sd[q + "mlp.fc1.bias"] = normal(mlp, h), normal(mlp)
        sd[q + "mlp.fc2.weight"], sd[q + "mlp.fc2.bias"] = normal(h, mlp), normal(h)
    return {"vision_model." + k: v for k, v in sd.items()}


def hf_gpt2_state_dict(cfg, vocab: int, gen: torch.Generator) -> dict:
    """A seeded ``GPT2LMHeadModel`` state dict (``transformer.`` keys, Conv1D (in, out) weights, ``lm_head`` tied
    to ``wte``) with ``vocab`` rows, for ``cfg``'s widths."""
    h = cfg.hidden_size

    def normal(*shape, std=0.02, mean=0.0):
        return mean + std * torch.randn(*shape, generator=gen)

    sd = {"wte.weight": normal(vocab, h), "wpe.weight": normal(cfg.max_position_embeddings, h, std=0.01),
          "ln_f.weight": normal(h, std=0.1, mean=1.0), "ln_f.bias": normal(h)}
    for i in range(cfg.num_layers):
        q = f"h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[q + ln + ".weight"], sd[q + ln + ".bias"] = normal(h, std=0.1, mean=1.0), normal(h)
        sd[q + "attn.c_attn.weight"], sd[q + "attn.c_attn.bias"] = normal(h, 3 * h), normal(3 * h)
        sd[q + "attn.c_proj.weight"], sd[q + "attn.c_proj.bias"] = normal(h, h), normal(h)
        sd[q + "mlp.c_fc.weight"], sd[q + "mlp.c_fc.bias"] = normal(h, 4 * h), normal(4 * h)
        sd[q + "mlp.c_proj.weight"], sd[q + "mlp.c_proj.bias"] = normal(4 * h, h), normal(h)
    out = {"transformer." + k: v for k, v in sd.items()}
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


def hf_tensor(name: str, clip: dict, gpt2: dict) -> torch.Tensor | None:
    """The HF tensor a port parameter must equal after ``load_pretrained_towers``, under the documented map
    (written here apart from models/convert.py); None for a parameter the load leaves alone. GPT-2's ``wte``
    gives its rows only."""
    m = re.fullmatch(r"vision_encoder\.backbone\.(.+)", name)
    if m:
        rest = m.group(1)
        v = lambda key: clip["vision_model." + key]  # noqa: E731
        fixed = {"cls_token": lambda: v("embeddings.class_embedding").reshape(1, 1, -1),
                 "pos_embed": lambda: v("embeddings.position_embedding.weight")[None],
                 # OIHW -> the port's (width, P * P * 3) in (h, w, c) order
                 "patch_embed.weight": lambda: v("embeddings.patch_embedding.weight").permute(0, 2, 3, 1).flatten(1),
                 "pre_ln.weight": lambda: v("pre_layrnorm.weight"), "pre_ln.bias": lambda: v("pre_layrnorm.bias"),
                 "post_ln.weight": lambda: v("post_layernorm.weight"),
                 "post_ln.bias": lambda: v("post_layernorm.bias")}
        if rest in fixed:
            return fixed[rest]()
        i, owner, leaf = re.fullmatch(r"blocks\.(\d+)\.(.+)\.(weight|bias)", rest).groups()
        owner = {"ln_0": "layer_norm1", "ln_1": "layer_norm2", "mlp.fc_in": "mlp.fc1", "mlp.fc_out": "mlp.fc2",
                 "attn.q_proj": "self_attn.q_proj", "attn.k_proj": "self_attn.k_proj",
                 "attn.v_proj": "self_attn.v_proj", "attn.out_proj": "self_attn.out_proj"}[owner]
        return v(f"encoder.layers.{i}.{owner}.{leaf}")  # nn.Linear (out, in) on both sides
    m = re.fullmatch(r"(text_encoder\.backbone|caption_decoder\.lm)\.(.+)", name)
    if not m:
        return None
    rest = m.group(2)
    g = lambda key: gpt2["transformer." + key]  # noqa: E731
    if rest in ("wte.weight", "wpe.weight", "ln_f.weight", "ln_f.bias"):
        return g(rest)
    i, owner, leaf = re.fullmatch(r"blocks\.(\d+)\.(.+)\.(weight|bias)", rest).groups()
    q = f"h.{i}."
    if owner in ("ln_0", "ln_1"):
        return g(q + {"ln_0": "ln_1", "ln_1": "ln_2"}[owner] + "." + leaf)
    if owner in ("attn.q_proj", "attn.k_proj", "attn.v_proj"):
        h = g(q + "attn.c_proj.bias").shape[0]
        j = ("attn.q_proj", "attn.k_proj", "attn.v_proj").index(owner)
        full = g(q + "attn.c_attn." + leaf)
        return full[:, j * h:(j + 1) * h].T if leaf == "weight" else full[j * h:(j + 1) * h]
    conv1d = {"attn.out_proj": "attn.c_proj", "mlp.fc_in": "mlp.c_fc", "mlp.fc_out": "mlp.c_proj"}[owner]
    t = g(q + conv1d + "." + leaf)
    return t.T if leaf == "weight" else t  # Conv1D (in, out) -> Linear (out, in)


def greedy_ids(model, images, max_length: int) -> tuple:
    """``generate_captions``' captions and the token rows it decoded them from."""
    rows = []
    decode = model.tokenizer.decode
    model.tokenizer.decode = lambda ids, **kw: rows.append(list(map(int, ids))) or decode(ids, **kw)
    try:
        captions = model.generate_captions(images, max_length=max_length, early_stop=True)
    finally:
        model.tokenizer.decode = decode
    return captions, rows


def pretrained_import(tokenizer, device: str = "cuda", vision: str = "openai/clip-vit-base-patch32",
                      text: str = "gpt2-medium", vocab: int = GPT2_VOCAB, hf_vocab: int = GPT2_HF_VOCAB,
                      batch: int = 8, max_length: int = 32) -> dict:
    """Phase 13b: seeded HF-layout checkpoints of ``vision``'s CLIP tower and the ``text`` GPT-2 at full width
    (``pytorch_model.bin``, written to build/phase13 and deleted after), loaded into a bf16 flagship through
    ``load_pretrained_towers``: every parameter bit-equal to its HF tensor (``hf_tensor``), the appended
    vocab rows and the untouched heads as before, the serving copy recast, and greedy ids equal to a second
    model's that got the same converted trees through ``load_jax_params``."""
    from pgica_tpu_torch.models import convert
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
    from pgica_tpu_torch.ops import _kernels

    root = PHASE13_DIR / "hf"
    shutil.rmtree(root, ignore_errors=True)
    try:
        kwargs = dict(vision_model=vision, text_model=text, projection_dim=512, tokenizer=tokenizer,
                      max_caption_length=128, vocab_size=vocab, dtype=torch.bfloat16, seed=0, device=device)
        t = time.perf_counter()
        model = PreferenceGuidedCaptioningModel(**kwargs)
        size = model.image_size
        images = np.random.default_rng(13).integers(0, 256, size=(batch, size, size, 3), dtype=np.uint8)
        before_caps = model.generate_captions(images, max_length=max_length, early_stop=True)  # copy and graphs
        start = {n: p.detach().cpu().clone() for n, p in model.module.named_parameters()}
        vcfg, lcfg = model.module.vision_config, model.module.text_config
        gen = torch.Generator().manual_seed(13)
        clip, gpt2 = hf_clip_vision_state_dict(vcfg, gen), hf_gpt2_state_dict(lcfg, hf_vocab, gen)
        files = {"clip": root / "clip" / "pytorch_model.bin", "gpt2": root / "gpt2" / "pytorch_model.bin"}
        for key, sd in (("clip", clip), ("gpt2", gpt2)):
            files[key].parent.mkdir(parents=True)
            torch.save(sd, files[key])
        nbytes = sum(f.stat().st_size for f in files.values())
        prep_s = time.perf_counter() - t
        t = time.perf_counter()
        model.load_pretrained_towers(vision_path=files["clip"].parent, text_path=files["gpt2"].parent)
        if device == "cuda":
            torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        shutil.rmtree(root)

        loaded = kept = 0
        for name, p in model.module.named_parameters():
            got, want = p.detach().cpu(), hf_tensor(name, clip, gpt2)
            if name.endswith("wte.weight"):
                ok = torch.equal(got[:hf_vocab], want) and torch.equal(got[hf_vocab:], start[name][hf_vocab:])
            else:
                ok = torch.equal(got, start[name] if want is None else want)
            if not ok:
                raise AssertionError(f"13b: {name} is not {'its start' if want is None else 'its HF tensor'}")
            kept += want is None
            loaded += want is not None
        served = model._inference_module()
        for name in ("caption_decoder.lm.wte.weight", "vision_encoder.backbone.patch_embed.weight"):
            if not torch.equal(served.get_parameter(name), model.module.get_parameter(name).to(torch.bfloat16)):
                raise AssertionError(f"13b: the bf16 serving copy's {name} is not the loaded masters' cast")

        other = PreferenceGuidedCaptioningModel(**kwargs)
        convert.load_jax_params(other.module.vision_encoder.backbone, convert.convert_clip_vision(clip, vcfg))
        for lm in (other.module.text_encoder.backbone, other.module.caption_decoder.lm):
            convert.load_jax_params(lm, convert.pad_vocab_rows(convert.convert_gpt2(gpt2, lcfg), lm))
        del clip, gpt2, start
        differ = [n for (n, a), b in zip(model.module.named_parameters(), other.module.parameters())
                  if not torch.equal(a, b)]
        if differ:
            raise AssertionError(f"13b: load_pretrained_towers and load_jax_params differ in {differ[:4]}")
        _kernels.reset_launch_counts()  # ---- the main path starts here
        t = time.perf_counter()
        captions, ids = greedy_ids(model, images, max_length)
        serve_ms = (time.perf_counter() - t) * 1e3
        counts = _kernels.launch_counts()  # ---- and ends here
        other_caps, other_ids = greedy_ids(other, images, max_length)
        if ids != other_ids or captions != other_caps:
            raise AssertionError(f"13b: greedy ids after the import differ from the bridged model's: {ids} {other_ids}")
        if captions == before_caps:
            raise AssertionError("13b: the captions did not change with the weights")
        log(f"  load_pretrained_towers: CLIP ViT-B/32 vision tower and GPT-2 Medium ({hf_vocab:,} rows, Conv1D) "
            f"from {nbytes / 1e9:.3f} GB of pytorch_model.bin in {load_s:.2f} s ({nbytes / 1e9 / load_s:.2f} GB/s; "
            f"written with the models in {prep_s:.1f} s, deleted after); {loaded} parameters bit-equal to their HF "
            f"tensors (text tower and decoder from one checkpoint), {vocab - hf_vocab} appended rows a vocab and "
            f"{kept} untouched parameters as before; the bf16 serving copy recast; greedy batch {batch} x "
            f"{max_length} through generate_captions in {serve_ms:.1f} ms, ids equal to the load_jax_params "
            f"model's ({sum(map(len, ids))} tokens) [{card() if device == 'cuda' else device}]")
        return dict(counts=counts, load_s=load_s, gb=nbytes / 1e9, serve_ms=serve_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)


NTXENT_ROWS = (128, 100, 37)  # the flagship's stage-1 batch, then ragged batches (partial 128-wide tiles)
NTXENT_DIM = 512  # the projection dim
NTXENT_TEMPERATURE = 0.5  # configs/default.yaml model.temperature
NTXENT_LOSS_RTOL = 1e-5
NTXENT_GRAD_RTOL = 1e-4  # of each gradient's largest element
FCE_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")


def ntxent_inputs(rows: int, gen: torch.Generator, device: str = "cuda") -> tuple:
    from pgica_tpu_torch.ops.losses import l2_normalize

    return tuple(l2_normalize(torch.randn(rows, NTXENT_DIM, device=device, generator=gen)) for _ in range(2))


def ntxent_step(loss_fn, img, txt) -> tuple:
    a, b = img.clone().requires_grad_(), txt.clone().requires_grad_()
    loss, _ = loss_fn(a, b, NTXENT_TEMPERATURE)
    return (loss.detach(), *torch.autograd.grad(loss, (a, b)))


def small_fce_rows(rows: int, d: int, gen: torch.Generator, vocab: int | None = None) -> dict:
    """The three fused-CE kernels at NT-Xent's (rows, d) x (vocab, d) (vocab: rows, or the global negatives'
    gathered rows), f32 x f32, each input set used once per burst among sets > 2x the L2 (time_ms): kernel,
    plain version, and the library (F.linear + F.cross_entropy in f32 for the forward, their autograd backward
    for dh and dW together)."""
    from pgica_tpu_torch.ops.fused_ce import (
        fused_ce_bwd_dh,
        fused_ce_bwd_dh_ref,
        fused_ce_bwd_dw,
        fused_ce_bwd_dw_ref,
        fused_ce_fwd,
        fused_ce_fwd_ref,
    )

    vocab = vocab or rows
    one, wbytes = rows * d * 4, vocab * d * 4
    n_sets = max(1, math.ceil(100e6 / (one + wbytes)))
    sets = []
    for _ in range(n_sets):
        h = torch.randn(rows, d, device="cuda", generator=gen) / NTXENT_TEMPERATURE / d ** 0.5
        w = torch.randn(vocab, d, device="cuda", generator=gen) / d ** 0.5
        y = torch.arange(rows, device="cuda")
        g = torch.full((rows,), -1.0 / rows, device="cuda")  # d(-mean logp)/d logp
        sets.append((h, w, y, fused_ce_fwd(h, w, y)[1], g))
    fwd_sets = [s[:3] for s in sets]
    fwd_bytes = one + wbytes + 4 * rows + 8 * rows
    bwd_in = one + wbytes + 12 * rows
    bounds = {"fused_ce_fwd": bound(fwd_bytes, 2 * rows * vocab * d, torch.bfloat16),
              "fused_ce_bwd_dh": bound(bwd_in + one, 4 * rows * vocab * d, torch.bfloat16),
              "fused_ce_bwd_dw": bound(bwd_in + wbytes, 4 * rows * vocab * d, torch.bfloat16)}

    def lib_bwd(h, w, y, lse, g):
        a, b = h.clone().requires_grad_(), w.clone().requires_grad_()
        out = F.cross_entropy(F.linear(a, b), y, reduction="none")
        return torch.autograd.grad(out, (a, b), g)

    lib_fwd = time_ms(lambda h, w, y: F.cross_entropy(F.linear(h, w), y, reduction="none"), fwd_sets)
    lib_b = time_ms(lib_bwd, sets)
    res = {}
    for kernel, fn, ref, arg_sets in (("fused_ce_fwd", fused_ce_fwd, fused_ce_fwd_ref, fwd_sets),
                                      ("fused_ce_bwd_dh", fused_ce_bwd_dh, fused_ce_bwd_dh_ref, sets),
                                      ("fused_ce_bwd_dw", fused_ce_bwd_dw, fused_ce_bwd_dw_ref, sets)):
        res[kernel] = dict(case="ntxent", shape=f"({rows}, {d}) x ({vocab}, {d})", dtype="h float32, W float32",
                           ms=time_ms(fn, arg_sets), plain_ms=time_ms(ref, arg_sets),
                           library_ms=lib_fwd if kernel == "fused_ce_fwd" else lib_b, input_sets=n_sets,
                           **bounds[kernel])
    return res


def phase_ntxent_and_shapes() -> dict:
    """Phase 13c: ``ntxent_loss_fused`` on the card against the port's ``ntxent_loss`` at the flagship's stage-1
    batch and two ragged ones, its launches, its time against the plain loss (one (B, B) matmul and
    F.cross_entropy, the library figure); then the slice's new kernel shapes against their plain versions,
    timed: the fused-CE kernels at (128, 512) x (128, 512) f32 x f32, the flash forward at cross-attention's
    decode shape (B 8 x 8 heads, 1, 1, 128) and the LN forward at ``cross_ln``'s (8, 1024)."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.ops.losses import ntxent_loss, ntxent_loss_fused

    gen = torch.Generator(device="cuda").manual_seed(13)
    counts = None
    for rows in NTXENT_ROWS:
        img, txt = ntxent_inputs(rows, gen)
        _kernels.reset_launch_counts()  # ---- the main path starts here (one loss, forward and backward)
        loss, gi, gt = ntxent_step(ntxent_loss_fused, img, txt)
        torch.cuda.synchronize()
        got = _kernels.launch_counts()  # ---- and ends here
        if {k: got[k] for k in FCE_KERNELS} != dict.fromkeys(FCE_KERNELS, 2):
            raise AssertionError(f"ntxent_loss_fused ({rows} rows) launched {got}; 2 of each fused-CE kernel expected")
        counts = counts or got
        ploss, pgi, pgt = ntxent_step(ntxent_loss, img, txt)
        loss_err = abs(float(loss) - float(ploss)) / abs(float(ploss))
        if loss_err > NTXENT_LOSS_RTOL:
            raise AssertionError(f"ntxent_loss_fused ({rows} rows): loss {float(loss)} against {float(ploss)}")
        grad_errs = []
        for name, g, pg in (("image", gi, pgi), ("text", gt, pgt)):
            err = float((g - pg).abs().max()) / float(pg.abs().max())
            if not err <= NTXENT_GRAD_RTOL:
                raise AssertionError(f"ntxent_loss_fused ({rows} rows): {name} gradient off by {err:.3e} of its max")
            grad_errs.append(err)
        line = (f"  ntxent_loss_fused ({rows}, {NTXENT_DIM}) f32, tau {NTXENT_TEMPERATURE}: loss {float(loss):.6f}, "
                f"relative error {loss_err:.2e} (tol {NTXENT_LOSS_RTOL}); gradients {grad_errs[0]:.2e} / "
                f"{grad_errs[1]:.2e} of their largest element (tol {NTXENT_GRAD_RTOL}); launches fwd/dh/dW "
                f"{got['fused_ce_fwd']}/{got['fused_ce_bwd_dh']}/{got['fused_ce_bwd_dw']}")
        if rows == NTXENT_ROWS[0]:
            n_sets = max(1, math.ceil(100e6 / (2 * rows * NTXENT_DIM * 4)))
            sets = [ntxent_inputs(rows, gen) for _ in range(n_sets)]
            fused_ms = time_ms(lambda a, b: ntxent_step(ntxent_loss_fused, a, b), sets)
            plain_ms = time_ms(lambda a, b: ntxent_step(ntxent_loss, a, b), sets)
            line += (f"; forward and backward {fused_ms:.5f} ms against ntxent_loss's {plain_ms:.5f} ms "
                     f"[{card()}]")
            timed = dict(fused_ms=fused_ms, plain_ms=plain_ms)
        log(line)
    results = {k: [] for k in (*FCE_KERNELS, "flash_attn_fwd", "layernorm_fwd")}
    checked = {}
    for rows in NTXENT_ROWS:  # each kernel against its plain version, bit-stable over two runs
        checked[rows] = fused_ce_case("ntxent", rows, rows, NTXENT_DIM, torch.float32, torch.float32, gen, timed=False)
        log(f"  fused_ce ntxent ({rows}, {NTXENT_DIM}) x ({rows}, {NTXENT_DIM}) h float32 W float32: max_abs_err "
            f"{fce_errs(checked[rows])}")
    for kernel, r in small_fce_rows(NTXENT_ROWS[0], NTXENT_DIM, gen).items():
        r.update({k: checked[NTXENT_ROWS[0]][kernel][k] for k in ("max_abs_err", "atol", "rtol")})
        results[kernel].append(r)
        show_timed(kernel, r)
    for dtype in (torch.float32, torch.bfloat16):
        r = attention_case("cross-attention at decode", 8, 8, 1, 1, 128, False, None, dtype, gen)
        results["flash_attn_fwd"].append(r)
        show_timed("flash", r)
        r = dict(layernorm_case(8, 1024, dtype, gen), where="cross_ln at decode")
        results["layernorm_fwd"].append(r)
        show_timed("layernorm_fwd", r)
    return dict(counts=counts, results=results, **timed)


def cross_attend_decode(cuda, cpu, images, steps: int = 3) -> dict:
    """Phase 13d, inside phase 4's 2-layer f32 GPT-2: ``decode_prefix`` and ``steps`` ``decode_step``s with
    ``cross_attend_at_decode`` and the vision embeddings, card against CPU (phase 4's 1e-3); each step's launches
    with the flag against without it."""
    from pgica_tpu_torch.models.lm import init_kv_cache
    from pgica_tpu_torch.ops import _kernels

    def run(model, cross: bool):
        module, cache_len = model.module, 17
        module.caption_decoder.cross_attend_at_decode = cross
        try:
            with torch.inference_mode():
                emb = model.encode_image(images)["embeddings"]
                caches = init_kv_cache(module.decoder_config, emb.shape[0], cache_len, torch.float32, model.device)
                slots = torch.arange(cache_len, device=model.device)
                mask_at = lambda t: (slots[None, :] <= t).to(torch.int32).expand(emb.shape[0], cache_len)  # noqa: E731
                logits, caches = module.decode_prefix(emb, caches, mask_at(0))
                out, per_step = [logits.cpu()], []
                for t in range(1, steps + 1):
                    _kernels.reset_launch_counts()  # ---- one step's path starts here
                    logits, caches = module.decode_step(logits.argmax(-1)[:, None], t, caches, mask_at(t), emb)
                    counts = _kernels.launch_counts()  # ---- and ends here
                    per_step.append({k: counts[k] for k in SERVING_KERNELS})
                    out.append(logits.cpu())
            return out, per_step
        finally:
            module.caption_decoder.cross_attend_at_decode = False

    (got, with_flag), (plain, without) = run(cuda, True), run(cuda, False)
    want, _ = run(cpu, True)
    errs = [check_close(f"cross-attention at decode, {'prefix' if i == 0 else f'step {i}'} logits", g, c, 1e-3, 0.0)
            for i, (g, c) in enumerate(zip(got, want))]
    if any(torch.equal(a, b) for a, b in zip(got[1:], plain[1:])):
        raise AssertionError("cross-attention at decode left a step's logits as they were without it")
    extra = [{k: w[k] - wo[k] for k in SERVING_KERNELS} for w, wo in zip(with_flag, without)]
    # the attention over the single vision token is one more flash forward (B x 8 heads, 1, 1, 128), cross_ln
    # one more LN forward
    if any(e != {"layernorm_fwd": 1, "flash_attn_fwd": 1} for e in extra):
        raise AssertionError(f"cross-attention at decode: launches a step with the flag minus without {extra}")
    log(f"  phase 13d: cross_attend_at_decode, prefix and {steps} steps' logits (2, {got[0].shape[-1]}): max_abs_err "
        + ", ".join(f"{e:.3e}" for e in errs) + f" (atol 1e-3); each step launched {with_flag[0]} with the flag, "
        f"{without[0]} without: the cross-attention's flash forward and cross_ln's LN forward")
    return dict(counts=with_flag[0], extra=extra[0])


# ------------------------------------------------------------------ main


# ------------------------------------------------------------------ phase 14: data parallelism

PHASE14_DIR = ROOT / "build" / "phase14"
PARALLEL_WORLD = 2  # ranks; on this one-card machine they share the card over gloo (NCCL refuses two a device)
PARALLEL_MODES = ("replicated", "zero1", "zero3")
PARALLEL_BATCH = 8  # 14a's global batch: 4 rows a rank
PARALLEL_SEQ = 32
PARALLEL_RTOL = 1e-5  # loss, metrics and gradient norm: the ranks against the one process on the whole batch
# ... and atol: DPO's rewards are beta x differences of ~-350 log-probs (32 tokens of a 50,262 vocab), whose
# float32 rounding alone is ~2e-5 each
PARALLEL_ATOL = 1e-5
PARALLEL_LR = 1e-3
PARALLEL_LOOSE_SHARE = 0.02  # parameters beyond PARAM_ATOL, each within Adam's bound (tests/test_torch_trainer.py)
GLOBAL_NEG_ROWS = 256  # 14a's fused NT-Xent: (128, 512) rows a rank against (256, 512) gathered embeddings
PHASE14_STEPS = 3  # a stage's steps in 14b; rank 0's profiler takes the third (trainer.PROFILE_STEPS)
PHASE14_STAGES = {"zero1": "1", "zero3": "2"}  # 14b's run of each mode: --stage
PHASE14_LAYERS = 2  # 14b: each tower's layers (ViT-B/32: 12, GPT-2 Medium: 24)
PHASE14_REDUCED = (
    f"each tower runs {PHASE14_LAYERS} of its layers at full width (ViT-B/32 12, GPT-2 Medium 24): at full depth "
    "each ZeRO step moved ~6.4 GB between the two ranks over gloo's loopback (6.7-11.2 s a step) and 14b took "
    "137-181 s, which with phase 15 took the run near its limit; the CLI reads depth from the presets, which the "
    "ranks cut",
    "ZeRO-1 trains stage 1 (--stage 1) and ZeRO-3 stage 2 (--stage 2, its sharded reference the initial policy): "
    "both stages of both modes would take the phase past its time",
    "1 epoch (the config: 10 and 5), --max-steps 3: 3 steps",
    "gradient accumulation 1 (the config: 4): ZeRO refuses accumulation, as the JAX package does",
    f"model.vocab_size {GPT2_VOCAB:,} (as phase 9); mesh.data 2 (the config: -1, every rank)",
    "the data paths point at no file: the in-memory dummy datasets (64 pairs of 224 px images and captions a "
    "stage) take their place, the global batch 8 (4 a rank)",
    "training.save_steps 3 and no epoch or best checkpoints: one checkpoint, the autosave at the run's last step "
    "(the run's disk is limited); load_best_model_at_end off",
    "outputs, checkpoints, logs and rank 0's profile under build/phase14, deleted at the end; wandb disabled",
)
RANK_TIMEOUT_S = 240


def _rank_entry(target: str, rank: int, world: int, store: str, args: tuple, workdir: str) -> None:
    """A spawned rank: gloo over a file store, the one card (``LOCAL_RANK`` 0 for both), ``target``'s result
    saved for the parent in ``workdir``. A failure leaves its traceback beside it and exits non-zero."""
    import os
    import traceback

    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = "0"
    os.environ["WANDB_MODE"] = "disabled"
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
        out = globals()[target](rank, world, *args)
        torch.save(out, Path(workdir) / f"{target}-rank{rank}.pt")
        dist.destroy_process_group()
    except BaseException:
        (Path(workdir) / f"{target}-rank{rank}.err").write_text(traceback.format_exc())
        raise


def chain(rank: int, world: int, steps: list) -> list:
    """Several rank targets, ``(name, args)`` each, one after another in the same ranks: one spawn, one process
    group and one CUDA context for all of them (a spawned rank's start, its imports and first model took 8-30 s
    on the card's host). Each target's result; what one held is freed before the next starts."""
    out = []
    for target, args in steps:
        out.append(globals()[target](rank, world, *args))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def start_ranks(target: str, *args, workdir: Path = PHASE14_DIR, world: int = PARALLEL_WORLD) -> tuple:
    """``target(rank, world, *args)`` in ``world`` spawned ranks, started; ``join_ranks`` waits."""
    import multiprocessing

    store = workdir / f"{target}.store"
    store.unlink(missing_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(target, r, world, str(store), args, str(workdir)))
             for r in range(world)]
    for p in procs:
        p.start()
    return target, procs, workdir


def join_ranks(started: tuple, timeout: float = RANK_TIMEOUT_S) -> list:
    """Each rank joined within ``timeout``; a rank that fails or hangs fails the phase (the others are
    killed). The ranks' results."""
    target, procs, workdir = started
    deadline = time.perf_counter() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (workdir / f"{target}-rank{r}.err").read_text() for r in range(len(procs))
              if (workdir / f"{target}-rank{r}.err").exists()}
    if hung or errors or any(p.exitcode for p in procs):
        raise AssertionError(f"{workdir.name} {target}: ranks hung {hung}, exit codes {[p.exitcode for p in procs]}; "
                             f"{errors}")
    return [torch.load(workdir / f"{target}-rank{r}.pt", weights_only=False) for r in range(len(procs))]


def parallel_model():
    """Phase 4's GPT-2 flagship at full width, 2 layers a tower, f32, dropout 0, on the card; and the stage-2
    reference (a frozen f32 copy of another seed's, so the rewards are far from 0)."""
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel, frozen_copy
    from pgica_tpu_torch.models.presets import get_text_config, get_vision_config

    spec = FULL_WIDTH["gpt2"]
    kwargs = dict(
        vision_model=dataclasses.replace(get_vision_config(spec["vision"]), num_layers=spec["layers"]),
        text_model=dataclasses.replace(get_text_config(spec["text"]), num_layers=spec["layers"]),
        projection_dim=512, tokenizer=CaptionTokenizer(), max_caption_length=128, vocab_size=spec["vocab"],
        dtype=torch.float32, dropout=0.0, device="cuda")
    model = PreferenceGuidedCaptioningModel(seed=0, **kwargs)
    ref = frozen_copy(PreferenceGuidedCaptioningModel(seed=1, **kwargs).module, torch.float32)
    return model, ref


def bits_digest(tensors) -> torch.Tensor:
    """A digest of the tensors' bits: the int32 words' sum, position-weighted sum and xor-shifted sum, in
    wrapping int64."""
    words = torch.cat([t.detach().float().reshape(-1).view(torch.int32) for t in tensors]).to(torch.int64)
    pos = torch.arange(1, words.numel() + 1, device=words.device)
    return torch.stack([words.sum(), (words * pos).sum(), (words ^ (words >> 7)).sum()])


def same_on_ranks(tensors, mesh, axis: str = "data") -> bool:
    """Whether every rank of ``axis`` holds the same bits (True on one process): each rank's
    :func:`bits_digest`, gathered and compared."""
    from pgica_tpu_torch.parallel import collectives

    if mesh is None or not mesh.distributed:
        return True
    both = collectives.all_gather(bits_digest(tensors)[None], axis, mesh)
    return all(torch.equal(both[0], other) for other in both[1:])


def parallel_steps(mode: str, module, ref, mesh, batches1, batches2) -> dict:
    """Two stage-1 and two stage-2 steps of ``mode`` on this rank's rows of each global batch (the whole batch
    on a one-process mesh); the metrics, whether the masters are bit-identical over the ranks after each step,
    each stage's state bytes, the launches and the final parameters."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.parallel.zero1 import make_zero1_train_step
    from pgica_tpu_torch.parallel.zero3 import make_zero3_train_step
    from pgica_tpu_torch.training.optim import create_optimizer, warmup_cosine_schedule
    from pgica_tpu_torch.training.train_step import (
        TrainState,
        make_stage1_loss,
        make_stage1_train_step,
        make_stage2_loss,
        make_stage2_train_step,
    )

    out = {"metrics": [], "identical": [], "nbytes": {}}
    _kernels.reset_launch_counts()  # ---- the mode's path starts here
    for stage, batches in ((1, batches1), (2, batches2)):
        if mode == "replicated":
            opt = create_optimizer(PARALLEL_LR, 10, 1, freeze_vision_backbone=True,
                                   frozen_prefixes=("caption_decoder",) if stage == 1 else ("text_encoder",))
            state = TrainState.create(module, opt)
            step = (make_stage1_train_step(module, opt, 0.5, mesh=mesh) if stage == 1
                    else make_stage2_train_step(module, opt, beta=0.1, mesh=mesh))
            for b in batches:
                local = mesh.shard_batch(b)
                state, m = step(state, local, 0) if stage == 1 else step(state, ref, local, 0)
                out["metrics"].append({k: float(v) for k, v in m.items()})
                out["identical"].append(same_on_ranks(module.parameters(), mesh))
            continue
        loss_fn = (make_stage1_loss(module, 0.5, mesh=mesh, axis_name="data") if stage == 1
                   else make_stage2_loss(module, ref, beta=0.1, mesh=mesh))
        zero3 = mode == "zero3"
        make = make_zero3_train_step if zero3 else make_zero1_train_step
        kw = {"with_ref": True} if zero3 and stage == 2 else {}
        init_fn, step = make(loss_fn, mesh, "data", learning_rate=warmup_cosine_schedule(PARALLEL_LR, 1, 10),
                             trainable_mask=lambda n: not n.startswith("vision_encoder.backbone."), **kw)
        z = init_fn(module)
        ref_shards = init_fn.shard_ref(ref) if kw else None
        for b in batches:
            local = mesh.shard_batch(b)
            z, m = step(z, local, 0, ref=ref_shards) if kw else step(z, local, 0)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["identical"].append(same_on_ranks(z.params.gather_params().values(), mesh))
        out["nbytes"][stage] = z.nbytes()
        z.params.release()
        if ref_shards is not None:
            ref_shards.release()
    torch.cuda.synchronize()
    out["counts"] = _kernels.launch_counts()  # ---- and ends here
    out["params"] = {k: v.detach().cpu() for k, v in module.named_parameters()}
    return out


def expected_state_bytes(module, mode: str, n: int) -> dict:
    """A rank's bytes of parameter shards and Adam moments from the parameter count: ZeRO-1 one f32 buffer
    padded to a multiple of n; ZeRO-3 the LM blocks' buffers (n divides each) besides the rest's."""
    total = sum(p.numel() for p in module.parameters())
    blocks = sum(p.numel() for name, p in module.named_parameters() if re.search(r"\.(lm|backbone)\.blocks\.", name)
                 and not name.startswith("vision_encoder."))
    share = -(-total // n) if mode == "zero1" else -(-(total - blocks) // n) + blocks // n
    return {"params": 4 * share, "optimizer": 2 * 4 * share}


def global_negatives(mesh) -> dict:
    """``ntxent_loss_fused`` with global negatives against ``ntxent_loss`` with them, on this rank's
    (128, 512) rows against the (256, 512) gathered; its launches; both timed (forward and backward, the
    gathers included)."""
    import functools

    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.ops.losses import ntxent_loss, ntxent_loss_fused

    gen = torch.Generator(device="cuda").manual_seed(14)
    img, txt = ntxent_inputs(GLOBAL_NEG_ROWS, gen)
    rows = GLOBAL_NEG_ROWS // mesh.data_parallel_size
    img, txt = (t[mesh.batch_index * rows:(mesh.batch_index + 1) * rows].contiguous() for t in (img, txt))
    fused = functools.partial(ntxent_loss_fused, axis_name="data")
    plain = functools.partial(ntxent_loss, axis_name="data")
    with mesh:
        _kernels.reset_launch_counts()  # ---- the path starts here
        loss, gi, gt = ntxent_step(fused, img, txt)
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()  # ---- and ends here
        ploss, pgi, pgt = ntxent_step(plain, img, txt)
        times = {}
        for name, fn in (("fused", fused), ("plain", plain)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(20):
                ntxent_step(fn, img, txt)
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) / 20 * 1e3
    return dict(counts=counts, loss=float(loss), plain_loss=float(ploss), times=times,
                grad_errs=[float((g - p).abs().max()) / float(p.abs().max()) for g, p in ((gi, pgi), (gt, pgt))])


def collective_checks(mesh) -> dict:
    """Each collective the port calls, on CUDA tensors over this mesh's backend, against its value: {op: right}."""
    from pgica_tpu_torch.parallel import collectives

    r, n = mesh.batch_index, mesh.data_parallel_size
    base = torch.arange(4, dtype=torch.float32, device="cuda")
    x = base + 10 * r
    every = torch.cat([base + 10 * k for k in range(n)])
    lengths = torch.tensor([3 + r], device="cuda")  # the trainer's bucket length: an int64 max
    return {
        "all_gather_into_tensor": torch.equal(collectives.all_gather(x, "data", mesh), every),
        "reduce_scatter_tensor": torch.equal(collectives.psum_scatter(every, "data", mesh), n * every[4 * r:4 * r + 4]),
        "all_reduce sum": torch.equal(collectives.psum(x, "data", mesh), n * base + 10 * sum(range(n))),
        "all_reduce max, int64": int(collectives.pmax(lengths, "data", mesh)) == 2 + n,
    }


def parallel_parity(rank: int, world: int, inputs: str) -> dict:
    """14a on one rank: the collectives, every mode's steps, then the fused NT-Xent with global negatives."""
    from pgica_tpu_torch.parallel.mesh import MeshContext

    mesh = MeshContext(data=world)
    checks = collective_checks(mesh)
    inp = torch.load(inputs, weights_only=False)
    model, ref = parallel_model()
    initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
    out = {}
    for mode in PARALLEL_MODES:
        model.module.load_state_dict(initial)
        out[mode] = parallel_steps(mode, model.module, ref, mesh, inp["s1"], inp["s2"])
    out["expected_bytes"] = {mode: expected_state_bytes(model.module, mode, world) for mode in ("zero1", "zero3")}
    out["ntxent"] = global_negatives(mesh)
    out["collectives"] = checks
    return out


def parallel_cli(rank: int, world: int, runs: list) -> list:
    """14b on one rank: ``scripts.train.run`` for each (config, output dir, stage) of ``runs`` (rank 0
    profiles); walls, peak, write calls; rank 0's checkpoint against the gathered parameters."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.scripts import train as train_cli

    def io_writes():
        io = dict(line.split(": ") for line in Path("/proc/self/io").read_text().splitlines())
        return int(io["wchar"])

    results = []
    with cut_presets(PHASE14_LAYERS):  # the CLI reads depth from the presets
        for cfg_path, out_dir, stage in runs:
            argv = ["--config", cfg_path, "--stage", stage, "--max-steps", str(PHASE14_STEPS), "--output-dir", out_dir]
            if rank == 0:
                argv += ["--profile-dir", str(Path(out_dir) / "profile")]
            w0 = io_writes()
            _kernels.reset_launch_counts()  # ---- the main path starts here
            t = time.perf_counter()
            trainer = train_cli.run(argv)
            run_s = time.perf_counter() - t
            counts = _kernels.launch_counts()  # ---- and ends here
            name = f"stage{stage}"
            out = dict(counts=counts, run_s=run_s, global_step=trainer.global_step, writes=io_writes() - w0,
                       stage=name, record={k: trainer.history[name][0][k] for k in
                                           ("step_seconds", "peak_mem_gib", "train_loss", "val_loss")},
                       profile=trainer.profiles.get(int(stage)), saves=trainer.checkpoints.saves)
            if rank == 0:
                saved = torch.load(Path(out_dir) / "checkpoints" / f"autosave_{name}" / "state.pt", map_location="cpu",
                                   weights_only=True, mmap=True)
                mine = trainer.model.module.state_dict()
                out["checkpoint_equal"] = saved["params"].keys() == mine.keys() and all(
                    torch.equal(saved["params"][k], v.cpu()) for k, v in mine.items())
                out["checkpoint_zero"] = sorted(saved["opt_state"]["zero"])
                del saved
                shutil.rmtree(out_dir, ignore_errors=True)  # one run's checkpoints on disk at a time
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
            results.append(out)
    return results


def phase14_config(zero: str) -> Path:
    """configs/default.yaml with PHASE14_REDUCED's changes and ``mesh.<zero>``, written to build/phase14."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / "default.yaml").read_text())
    run = PHASE14_DIR / zero
    for stage in ("stage1", "stage2"):
        cfg["training"][stage]["num_epochs"] = 1
        cfg["training"][stage]["gradient_accumulation_steps"] = 1
    cfg["training"].update(save_steps=PHASE14_STEPS, save_epoch_checkpoints=False, save_best_checkpoints=False,
                           load_best_model_at_end=False)
    cfg["model"]["vocab_size"] = GPT2_VOCAB
    cfg["mesh"].update(data=PARALLEL_WORLD, **{zero: True})
    if zero == "zero3":
        cfg["model"]["scan_layers"] = True
    cfg["data"]["conceptual_captions_path"] = str(PHASE14_DIR / "no-data" / "captions.csv")
    cfg["data"]["ultrafeedback_path"] = str(PHASE14_DIR / "no-data" / "preferences.json")
    cfg["paths"] = {"output_dir": str(run), "checkpoint_dir": str(run / "checkpoints"),
                    "log_dir": str(run / "logs"), "cache_dir": str(run / "cache")}
    path = PHASE14_DIR / f"default_{zero}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def check_parity(mode: str, got: dict, want: dict, rank: int, share: float = PARALLEL_LOOSE_SHARE) -> str:
    """A rank's mode against the one process: metrics at PARALLEL_RTOL, parameters by the loose-share rule (all
    but a ``share`` of them within PARAM_ATOL)."""
    if len(got["metrics"]) != len(want["metrics"]):
        raise AssertionError(f"14a {mode} rank {rank}: {len(got['metrics'])} steps against {len(want['metrics'])}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k, v in w.items():
            worst = max(worst, abs(g[k] - v) / max(abs(v), 1e-6))
            if abs(g[k] - v) > PARALLEL_RTOL * abs(v) + PARALLEL_ATOL:
                raise AssertionError(f"14a {mode} rank {rank} step {i}: {k} {g[k]} against {v}")
    if not all(got["identical"]):
        raise AssertionError(f"14a {mode}: the masters differ between the ranks after step(s) "
                             f"{[i for i, s in enumerate(got['identical']) if not s]}")
    loose = total = 0
    bound_ = 2 * PARALLEL_LR * len(want["metrics"])
    for name, exp in want["params"].items():
        d = (got["params"][name] - exp).abs()
        if float(d.max()) > bound_:
            raise AssertionError(f"14a {mode} rank {rank}: {name} off by {float(d.max()):.3e} (Adam's bound {bound_})")
        if not name.endswith("attn.k_proj.bias"):
            loose += int((d > PARAM_ATOL).sum())
            total += d.numel()
    if loose / total >= share:
        raise AssertionError(f"14a {mode} rank {rank}: {loose} of {total} parameters beyond {PARAM_ATOL} (share "
                             f"{share})")
    return (f"metrics within {worst:.2e} relative (rtol {PARALLEL_RTOL}, atol {PARALLEL_ATOL}); {loose} of {total:,} "
            f"parameters beyond {PARAM_ATOL}")


def phase_parallel() -> dict:
    """Phase 14: data parallelism on torch.distributed. 14a: the three modes on two gloo ranks sharing the card
    against one process on the whole batch, and fused NT-Xent with global negatives; 14b: the training CLI on
    configs/default.yaml at 2 layers a tower in two ranks under ZeRO-1 and ZeRO-3; 14c: the CLI under torchrun,
    one NCCL rank."""
    import os

    import yaml

    from pgica_tpu_torch.parallel.mesh import MeshContext

    shutil.rmtree(PHASE14_DIR, ignore_errors=True)
    PHASE14_DIR.mkdir(parents=True)
    os.environ["WANDB_MODE"] = "disabled"
    out = {"counts": {}}
    nccl = None
    try:
        # ---- 14c starts first and runs beside 14a: one NCCL rank under torchrun
        t_c = time.perf_counter()
        cfg = yaml.safe_load((ROOT / "configs" / "smoke.yaml").read_text())
        run = PHASE14_DIR / "nccl"
        cfg["paths"] = {"output_dir": str(run), "checkpoint_dir": str(run / "checkpoints"),
                        "log_dir": str(run / "logs"), "cache_dir": str(run / "cache")}
        (PHASE14_DIR / "smoke_nccl.yaml").write_text(yaml.safe_dump(cfg, sort_keys=False))
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m",
               "pgica_tpu_torch.scripts.train", "--config", str(PHASE14_DIR / "smoke_nccl.yaml"), "--stage", "1",
               "--max-steps", "2"]
        nccl_log = PHASE14_DIR / "nccl.log"
        with open(nccl_log, "w") as sink:  # a file, not a pipe: the rank never waits on this process to read
            nccl = subprocess.Popen(cmd, cwd=ROOT, stdout=sink, stderr=subprocess.STDOUT,
                                    env={**os.environ, "WANDB_MODE": "disabled"})

        # ---- 14a, then 14b in the same ranks: they start; the one process takes 14a's steps on the whole batch
        t = time.perf_counter()
        rng = np.random.default_rng(14)
        inputs = {"s1": [stage1_batch(rng, PARALLEL_BATCH, PARALLEL_SEQ) for _ in range(2)],
                  "s2": [stage2_batch(rng, PARALLEL_BATCH, PARALLEL_SEQ) for _ in range(2)]}
        torch.save(inputs, PHASE14_DIR / "inputs.pt")
        log("  14b: configs/default.yaml changed: " + "; ".join(PHASE14_REDUCED))
        runs = [(str(phase14_config(zero)), str(PHASE14_DIR / zero), stage) for zero, stage in PHASE14_STAGES.items()]
        started = start_ranks("chain", [("parallel_parity", (str(PHASE14_DIR / "inputs.pt"),)),
                                        ("parallel_cli", (runs,))])
        model, ref = parallel_model()
        initial = {k: v.detach().clone() for k, v in model.module.state_dict().items()}
        one = MeshContext(data=1)
        want = {}
        for mode in PARALLEL_MODES:
            model.module.load_state_dict(initial)
            want[mode] = parallel_steps(mode, model.module, ref, one, inputs["s1"], inputs["s2"])
        del model, ref, initial
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  14a: the one process's steps on the whole batch ({PARALLEL_BATCH} x {PARALLEL_SEQ}) in "
            f"{time.perf_counter() - t:.1f} s, beside the ranks")
        chained = join_ranks(started, timeout=3 * RANK_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t
        log(f"  14a and 14b ranks: {out['ranks_s']:.1f} s")
        ranks = [parity for parity, _ in chained]
        for r, res in enumerate(ranks):
            if not all(res["collectives"].values()):
                raise AssertionError(f"14a rank {r}: a collective over gloo gave a wrong result: {res['collectives']}")
        log(f"  14a gloo on CUDA tensors, on both ranks: {', '.join(ranks[0]['collectives'])}: each result right; "
            "no op is routed by backend (parallel/collectives.py calls these on NCCL and gloo alike)")
        for mode in PARALLEL_MODES:
            for r, res in enumerate(ranks):
                verdict = check_parity(mode, res[mode], want[mode], r)
                out["counts"][f"parallel_{mode}_rank{r}"] = res[mode]["counts"]
                line = f"  14a {mode}, rank {r}: 2 stage-1 and 2 stage-2 steps: {verdict}; masters bit-identical " \
                       "over the ranks after every step"
                if mode != "replicated":
                    for stage, nb in res[mode]["nbytes"].items():
                        if nb != res["expected_bytes"][mode]:
                            raise AssertionError(f"14a {mode} rank {r} stage {stage}: state bytes {nb}, reckoned "
                                                 f"{res['expected_bytes'][mode]}")
                    nb = res[mode]["nbytes"][1]
                    line += (f"; this rank holds {nb['params']:,} bytes of parameter shards and {nb['optimizer']:,} "
                             f"of Adam moments (reckoned from the parameter count: equal)")
                log(line)
            check_main_path(f"14a {mode} (rank 0)", ranks[0][mode]["counts"], TRAIN_KERNELS)
            for r, res in enumerate(ranks):
                check_f32_route(f"14a {mode} (rank {r})", res[mode]["counts"], PARALLEL_SEQ - 1)
        nt = [res["ntxent"] for res in ranks]
        for r, n in enumerate(nt):
            if abs(n["loss"] - n["plain_loss"]) > NTXENT_LOSS_RTOL * abs(n["plain_loss"]) or \
                    max(n["grad_errs"]) > NTXENT_GRAD_RTOL:
                raise AssertionError(f"14a fused NT-Xent with global negatives, rank {r}: {n}")
            if {k: n["counts"][k] for k in FCE_KERNELS} != dict.fromkeys(FCE_KERNELS, 2):
                raise AssertionError(f"14a fused NT-Xent, rank {r}: launches {n['counts']}")
            out["counts"][f"ntxent_global_rank{r}"] = n["counts"]
        log(f"  14a ntxent_loss_fused with global negatives, ({GLOBAL_NEG_ROWS // PARALLEL_WORLD}, {NTXENT_DIM}) a "
            f"rank against ({GLOBAL_NEG_ROWS}, {NTXENT_DIM}) gathered, f32: loss relative error "
            f"{max(abs(n['loss'] - n['plain_loss']) / abs(n['plain_loss']) for n in nt):.2e}, gradients "
            f"{max(max(n['grad_errs']) for n in nt):.2e} of their largest element (tol {NTXENT_LOSS_RTOL} / "
            f"{NTXENT_GRAD_RTOL}); 2 launches of each fused-CE kernel a rank; forward and backward, the gathers "
            f"over gloo included, rank 0 {nt[0]['times']['fused']:.3f} ms against ntxent_loss's "
            f"{nt[0]['times']['plain']:.3f} ms [{card()}]")
        gen = torch.Generator(device="cuda").manual_seed(15)
        rows = GLOBAL_NEG_ROWS // PARALLEL_WORLD
        checked = fused_ce_case("global negatives", rows, GLOBAL_NEG_ROWS, NTXENT_DIM, torch.float32,
                                torch.float32, gen, timed=False)
        out["fce"] = small_fce_rows(rows, NTXENT_DIM, gen, vocab=GLOBAL_NEG_ROWS)
        for kernel, r in out["fce"].items():
            r.update({k: checked[kernel][k] for k in ("max_abs_err", "atol", "rtol")})
            show_timed(kernel, r)
        out["ntxent"] = nt[0]

        # ---- 14b: the training CLI at 2 layers a tower, ZeRO-1 (stage 1) and ZeRO-3 (stage 2), in the same ranks
        out["cli"] = {}
        res = [cli for _, cli in chained]
        for i, zero in enumerate(PHASE14_STAGES):
            for r, rank_runs in enumerate(res):
                rr = rank_runs[i]
                if rr["global_step"] != PHASE14_STEPS:
                    raise AssertionError(f"14b {zero} rank {r}: global step {rr['global_step']}")
                check_main_path(f"14b {zero} {rr['stage']} rank {r}", rr["counts"], TRAIN_KERNELS if
                                rr["stage"] == "stage2" else TRAIN_KERNELS[:5])
                out["counts"][f"parallel_cli_{zero}_rank{r}"] = rr["counts"]
                rec, steps = rr["record"], rr["record"]["step_seconds"]
                ckpt = sum(sv.get("bytes", 0) for sv in rr["saves"])
                log(f"  14b {zero} rank {r} {rr['stage']}: steps ms " + ", ".join(f"{x * 1e3:.1f}" for x in steps)
                    + f"; median after the first {statistics.median(steps[1:]) * 1e3:.1f} ms; peak "
                    f"{rec['peak_mem_gib']:.2f} GiB; train loss {rec['train_loss']:.4f}, val loss {rec['val_loss']:.4f}; "
                    f"run {rr['run_s']:.1f} s; checkpoints {[sv['name'] for sv in rr['saves']]} {ckpt / 2**30:.2f} GiB "
                    f"on disk; {rr['writes'] / 2**30:.2f} GiB through write calls (gloo's sockets included)")
            first = res[0][i]
            prof = first["profile"]
            busy = prof.get("busy") if prof else None
            if not first.get("checkpoint_equal"):
                raise AssertionError(f"14b {zero}: rank 0's checkpoint differs from the gathered parameters")
            log(f"  14b {zero}: rank 0's busy share over its profiled step "
                + (f"{100 * busy:.1f}% (kernel time {prof['device_ms']:.1f} ms, memory copies {prof['memcpy_ms']:.1f} "
                   f"ms, window {prof['wall_ms']:.1f} ms; host top {prof['host_top'][:3]})" if busy else "not measured")
                + f"; rank 0's autosave holds the gathered parameters bit for bit and the ZeRO state "
                f"{first['checkpoint_zero']} [{card()}; two ranks share this card]")
            out["cli"][zero] = dict(ranks=[{k: rank_runs[i][k] for k in ("record", "run_s", "writes", "stage")}
                                           for rank_runs in res], busy=busy)

        # ---- 14c: collect the NCCL rank
        nccl.wait(timeout=max(1.0, RANK_TIMEOUT_S - (time.perf_counter() - t_c)))
        text = nccl_log.read_text()
        meta = run / "checkpoints" / "checkpoint_stage1_epoch0" / "meta.json"
        if nccl.returncode != 0 or "backend nccl" not in text or "Training complete" not in text or not meta.exists():
            raise AssertionError(f"14c: torchrun exited {nccl.returncode}:\n{text[-3000:]}")
        steps = json.loads(meta.read_text())["global_step"]
        log(f"  14c: python -m torch.distributed.run --standalone --nproc_per_node=1 -m pgica_tpu_torch.scripts.train "
            f"--config configs/smoke.yaml --stage 1 --max-steps 2 (its paths under build/phase14): exit 0, the process "
            f"group NCCL over 1 rank, {steps} steps, its epoch checkpoint written; ran beside 14a-14b")
        return out
    finally:
        if nccl is not None and nccl.poll() is None:
            nccl.kill()
            nccl.wait()
        shutil.rmtree(PHASE14_DIR, ignore_errors=True)


# ------------------------------------------------------------------ phase 15: tensor and context parallelism

PHASE15_DIR = ROOT / "build" / "phase15"
SCALED = dict(vision="openai/clip-vit-large-patch14", text="gpt2-large", layers=2)  # configs/scaled_vitl_gpt2large
TP_BATCH = 8  # 15b and 15d: stage-1 rows and stage-2 pairs of the global batch, each rank on all of them
TP_SEQ = 128
FCE_TP_ROWS = 2 * TP_BATCH * (TP_SEQ - 1)  # 2,032: stage 2's rows, 8 pairs x 2 sides x 127 shifted tokens
TP_SHARD_ROWS = GPT2_VOCAB // PARALLEL_WORLD  # 25,131: a model-2 rank's block of the vocab
TP4_SHARD_ROWS = -(-GPT2_VOCAB // 4)  # 12,566: a model-4 rank's block, the last one with 2 zero rows
RING_ATOL, RING_GRAD_ATOL = 2e-5, 5e-5  # 15d's ring attention against plain attention, f32
PHASE15_LAYERS = 2  # 15e: each tower's layers (ViT-L/14: 24, GPT-2 Large: 36; ViT-B/32: 12, GPT-2 Medium: 24)
PHASE15_STEPS = 3  # 15e: a stage's steps
CP_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_attn_fwd") + FCE_KERNELS  # the ring runs no flash kernel
PHASE15_REDUCED = (
    f"each tower runs {PHASE15_LAYERS} of its layers at full width (ViT-B/32 12, GPT-2 Medium 24): the CLI reads "
    "depth from the presets, which the ranks cut",
    f"1 epoch, stage 2 only (the config: 5), --max-steps {PHASE15_STEPS}; gradient accumulation 1 (the config: 4)",
    f"model.vocab_size {GPT2_VOCAB:,} (as phase 9); mesh seq 2 (data -1: 1 on two ranks)",
    "the data paths point at no file: the in-memory dummy datasets (64 images and captions) take their place; the "
    "config's batch 32",
    "no checkpoint; load_best_model_at_end off; outputs and logs under build/phase15, deleted at the end; wandb "
    "disabled",
)


def scaled_model():
    """configs/scaled_vitl_gpt2large.yaml's towers at full width (ViT-L/14: 1,024 wide, 16 heads; GPT-2 Large:
    1,280 wide, 20 heads; vocab 50,262), phase 4's 2 layers a tower, f32, dropout 0, seeded, on the card."""
    from pgica_tpu_torch.data.tokenizer import CaptionTokenizer
    from pgica_tpu_torch.models.model import PreferenceGuidedCaptioningModel
    from pgica_tpu_torch.models.presets import get_text_config, get_vision_config

    return PreferenceGuidedCaptioningModel(
        vision_model=dataclasses.replace(get_vision_config(SCALED["vision"]), num_layers=SCALED["layers"]),
        text_model=dataclasses.replace(get_text_config(SCALED["text"]), num_layers=SCALED["layers"]),
        projection_dim=512, tokenizer=CaptionTokenizer(), max_caption_length=TP_SEQ, vocab_size=GPT2_VOCAB,
        dtype=torch.float32, dropout=0.0, device="cuda", seed=0)


def local_heads(module) -> dict:
    """The heads of one rank's attention (q rows / head_dim), and its rows of the decoder's ``wte``."""
    def heads(attn):
        return attn.q_proj.weight.shape[0] // attn.head_dim

    return {"vit": heads(module.vision_encoder.backbone.blocks[0].attn),
            "text": heads(module.text_encoder.backbone.blocks[0].attn),
            "decoder": heads(module.caption_decoder.lm.blocks[0].attn),
            "cross": heads(module.caption_decoder.cross_attention),
            "wte_rows": module.caption_decoder.lm.wte.weight.shape[0]}


def tp_collective_checks(tp, cp) -> dict:
    """ppermute, copy_to, reduce_from and gather_from on CUDA tensors over gloo: each value and gradient against
    its transpose's: {check: right}."""
    from pgica_tpu_torch.parallel import collectives

    n = PARALLEL_WORLD
    r = cp.axis_index("seq")
    base = torch.arange(4, dtype=torch.float32, device="cuda")
    out = {}
    x = (base + 10 * r).requires_grad_()
    y = collectives.ppermute(x, "seq", [(i, (i + 1) % n) for i in range(n)], cp)  # from rank r - 1
    (y * (r + 1)).sum().backward()  # x went to rank r + 1, whose weight is r + 2
    out["ppermute value"] = torch.equal(y, base + 10 * ((r - 1) % n))
    out["ppermute gradient (the inverse permutation)"] = torch.equal(x.grad, torch.full_like(base, (r + 1) % n + 1))
    m = tp.axis_index("model")
    x = (base + 10 * m).requires_grad_()
    c = collectives.copy_to(x, "model", tp)
    (c * (m + 1)).sum().backward()
    out["copy_to: identity forward, psum backward"] = torch.equal(c, x) and torch.equal(
        x.grad, torch.full_like(base, sum(k + 1 for k in range(n))))
    x = (base + 10 * m).requires_grad_()
    red = collectives.reduce_from(x, "model", tp)
    (red * (m + 1)).sum().backward()
    out["reduce_from: psum forward, identity backward"] = torch.equal(
        red, n * base + 10 * sum(range(n))) and torch.equal(x.grad, torch.full_like(base, m + 1))
    x = (base + 10 * m)[None].requires_grad_()
    gat = collectives.gather_from(x, "model", -1, tp)
    (gat * torch.arange(4 * n, device="cuda")).sum().backward()
    out["gather_from: gather forward, own block backward"] = torch.equal(
        gat[0], torch.cat([base + 10 * k for k in range(n)])) and torch.equal(
        x.grad[0], torch.arange(4 * m, 4 * m + 4, dtype=torch.float32, device="cuda"))
    return out


def tp_steps(module, mesh, batches1, batches2) -> dict:
    """Two stage-1 and two stage-2 updates under the trainer's partitions (the first at lr 0: warm-up from 0),
    tensor-parallel on ``mesh`` (the whole batch on each rank) or on one process (``mesh`` None): metrics,
    whether the replicated masters are bit-identical over the ranks, each step's launches, the parameters
    (gathered)."""
    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, tp_dims
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState, make_stage1_train_step, make_stage2_train_step

    out = {"metrics": [], "identical": [], "counts": {}}
    cut = tp_dims(module)
    for stage, batches in ((1, batches1), (2, batches2)):
        opt = create_optimizer(PARALLEL_LR, 10, 1, freeze_vision_backbone=True,
                               frozen_prefixes=("caption_decoder",) if stage == 1 else ("text_encoder",))
        state = TrainState.create(module, opt)
        ref = frozen_copy(module, torch.float32) if stage == 2 else None
        step = (make_stage1_train_step(module, opt, 0.5, mesh=mesh) if stage == 1
                else make_stage2_train_step(module, opt, beta=0.1, mesh=mesh))
        for i, b in enumerate(batches):
            _kernels.reset_launch_counts()  # ---- a step of the path starts here
            state, m = step(state, b, 0) if stage == 1 else step(state, ref, b, 0)
            torch.cuda.synchronize()
            out["counts"][f"stage{stage}_step{i}"] = _kernels.launch_counts()  # ---- and ends here
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["identical"].append(same_on_ranks([p for k, p in module.named_parameters() if k not in cut], mesh,
                                                  "model"))
        del ref
    whole = gathered_state_dict(module, mesh) if cut else module.state_dict()
    out["params"] = {k: v.detach().cpu() for k, v in whole.items()}
    return out


def cp_steps(module, ref, mesh, batches) -> dict:
    """Two stage-2 updates (the first at lr 0), context-parallel on ``mesh`` (``seq``: each rank holds its half of
    every caption) or on one process: metrics, masters bit-identical over the ranks, launches, parameters."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.training.cp_step import make_stage2_cp_train_step
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState, make_stage2_train_step

    opt = create_optimizer(PARALLEL_LR, 10, 1, freeze_vision_backbone=True, frozen_prefixes=("text_encoder",))
    state = TrainState.create(module, opt)
    step = (make_stage2_cp_train_step(module, opt, mesh, "seq", beta=0.1, use_fused_ce=True) if mesh is not None
            else make_stage2_train_step(module, opt, beta=0.1))
    out = {"metrics": [], "identical": [], "counts": {}}
    for i, b in enumerate(batches):
        _kernels.reset_launch_counts()  # ---- a step of the path starts here
        state, m = step(state, ref, b, 0)
        torch.cuda.synchronize()
        out["counts"][f"stage2_step{i}"] = _kernels.launch_counts()  # ---- and ends here
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["identical"].append(same_on_ranks(module.parameters(), mesh, "seq"))
    out["params"] = {k: v.detach().cpu() for k, v in module.named_parameters()}
    return out


def ring_check(mesh) -> dict:
    """``ring_attention`` over this rank's half of the flagship decoder's causal self-attention with a key
    padding bias, (16, 16, 128, 64) f32, against plain attention (``xla_attention``) over the whole sequence:
    the output block and the gradients of sum(out * g) for its q, k and v blocks; both timed, forward and
    backward."""
    from pgica_tpu_torch.ops.attention import xla_attention
    from pgica_tpu_torch.ops.ring_attention import ring_attention

    gen = torch.Generator(device="cuda").manual_seed(15)
    b, h, s, d = 2 * TP_BATCH, 16, TP_SEQ, 64
    q, k, v, g = (torch.randn(b, h, s, d, device="cuda", generator=gen) for _ in range(4))
    lens = torch.randint(s // 3, s + 1, (b,), device="cuda", generator=gen)
    keep = torch.arange(s, device="cuda")[None, :] < lens[:, None]
    bias = torch.where(keep, 0.0, -1e9)
    r, n = mesh.axis_index("seq"), mesh.axis_size("seq")
    blk = slice(r * s // n, (r + 1) * s // n)

    def ring_pass():
        leaves = [t[:, :, blk].contiguous().requires_grad_() for t in (q, k, v)]
        with mesh:
            o = ring_attention(*leaves, "seq", causal=True, kv_bias=bias[:, blk].contiguous())
        return (o.detach(), *torch.autograd.grad(o, leaves, g[:, :, blk]))

    def plain_pass():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = xla_attention(*leaves, keep[:, None, None, :], True)
        return (o.detach(), *torch.autograd.grad(o, leaves, g))

    got, want = ring_pass(), plain_pass()
    errs = {name: float((a - w_[:, :, blk]).abs().max()) for name, a, w_ in zip(("out", "dq", "dk", "dv"), got, want)}
    times = {}
    for name, fn in (("ring", ring_pass), ("plain", plain_pass)):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t) / 10 * 1e3
    return dict(errs=errs, times=times, shape=f"({b}, {h}, {s // n} of {s}, {d})")


def tp_cp_parity(rank: int, world: int, inputs: str) -> dict:
    """15a, 15b and 15d on one rank: the collectives; the scaled config's towers cut over model 2; the
    flagship sequence-sharded over seq 2; ring attention against plain attention."""
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.parallel.sharding import shard_module, sharded_bytes

    tp, cp = MeshContext(model=world), MeshContext(seq=world)
    out = {"collectives": tp_collective_checks(tp, cp)}
    inp = torch.load(inputs, weights_only=False)
    model = scaled_model()
    shard_module(model.module, tp)
    out["bytes"], out["heads"] = sharded_bytes(model.module), local_heads(model.module)
    out["tp"] = tp_steps(model.module, tp, inp["s1"], inp["s2"])
    if rank:
        del out["tp"]["params"]  # rank 0's gathered copy is the ranks' (their replicated masters are checked)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model, ref = parallel_model()
    out["cp"] = cp_steps(model.module, ref, cp, inp["cp"])
    if rank:
        del out["cp"]["params"]
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    out["ring"] = ring_check(cp)
    return out


@contextlib.contextmanager
def cut_presets(layers: int):
    """The presets of 15e's towers cut to ``layers`` layers for the duration (the CLI reads depth from them)."""
    from pgica_tpu_torch.models import presets

    held = {}
    for table, names in ((presets.VISION_PRESETS, (SCALED["vision"], "openai/clip-vit-base-patch32")),
                         (presets.TEXT_PRESETS, (SCALED["text"], "gpt2-medium"))):
        for name in names:
            held[(id(table), name)] = (table, table[name])
            table[name] = dataclasses.replace(table[name], num_layers=layers)
    try:
        yield
    finally:
        for (_, name), (table, cfg) in held.items():
            table[name] = cfg


def digests(state) -> dict:
    """{name: bits_digest} of a state dict, on the host."""
    return {k: bits_digest([v.cuda()]).cpu() for k, v in state.items()}


def tp_cp_cli(rank: int, world: int, runs: list) -> list:
    """15e on one rank: ``scripts.train.run`` for each (config, output dir, stage) of ``runs`` with 15e's cut
    presets (rank 0 profiles); walls, peak, launches; for a tensor-parallel run the digests of the gathered
    parameters (rank 0) and this rank's bytes of the cut parameters."""
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, sharded_bytes, tp_dims
    from pgica_tpu_torch.scripts import train as train_cli

    results = []
    with cut_presets(PHASE15_LAYERS):
        for cfg_path, out_dir, stage in runs:
            argv = ["--config", cfg_path, "--stage", stage, "--max-steps", str(PHASE15_STEPS), "--output-dir", out_dir]
            if rank == 0:
                argv += ["--profile-dir", str(Path(out_dir) / "profile")]
            _kernels.reset_launch_counts()  # ---- the main path starts here
            t = time.perf_counter()
            trainer = train_cli.run(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t
            counts = _kernels.launch_counts()  # ---- and ends here
            stages = ("stage1", "stage2") if stage == "all" else (f"stage{stage}",)
            out = dict(counts=counts, run_s=run_s, global_step=trainer.global_step, mesh=dict(trainer.mesh.shape),
                       records={s: {k: trainer.history[s][0][k] for k in ("step_seconds", "peak_mem_gib",
                                                                          "train_loss", "val_loss")} for s in stages},
                       profiles=trainer.profiles, saves=trainer.checkpoints.saves)
            module = trainer.model.module
            if tp_dims(module):
                out["bytes"] = sharded_bytes(module)
                whole = gathered_state_dict(module, trainer.mesh)
                if rank == 0:
                    out["digests"] = digests(whole)
                del whole
            del trainer, module
            gc.collect()
            torch.cuda.empty_cache()
            results.append(out)
    return results


def show_cli_runs(label: str, name: str, axis: str, kernels, runs: list, out: dict) -> None:
    """Check and log each rank's CLI run (``tp_cp_cli``'s result) of one configuration: the steps, the mesh, the
    launches; each stage's step ms, peak and rank 0's busy share, kept in ``out``."""
    for r, rr in enumerate(runs):
        steps = PHASE15_STEPS * len(rr["records"])
        if rr["global_step"] != steps or rr["mesh"][axis] != 2:
            raise AssertionError(f"{label} {name} rank {r}: global step {rr['global_step']}, mesh {rr['mesh']}")
        check_main_path(f"{label} {name} rank {r}", rr["counts"], kernels)
        out["counts"][f"cli_{name}_rank{r}"] = rr["counts"]
        for stage, rec in rr["records"].items():
            st = rec["step_seconds"]
            prof = rr["profiles"].get(int(stage[-1])) if r == 0 else None
            busy = prof.get("busy") if prof else None
            log(f"  {label} {name} rank {r} {stage}: steps ms " + ", ".join(f"{x * 1e3:.1f}" for x in st)
                + f"; median after the first {statistics.median(st[1:]) * 1e3:.1f} ms; peak "
                f"{rec['peak_mem_gib']:.2f} GiB; train loss {rec['train_loss']:.4f}, val loss "
                f"{rec['val_loss']:.4f}" + (f"; rank 0's busy share over its profiled step {100 * busy:.1f}% "
                                            f"(kernel time {prof['device_ms']:.1f} ms, memory copies "
                                            f"{prof['memcpy_ms']:.1f} ms, window {prof['wall_ms']:.1f} ms)"
                                            if busy is not None else ""))
            out["cli"].setdefault(name, {}).setdefault(stage, []).append(
                dict(step_seconds=st, peak_mem_gib=rec["peak_mem_gib"], busy=busy))
        log(f"  {label} {name} rank {r}: run {rr['run_s']:.1f} s; checkpoints {[sv['name'] for sv in rr['saves']]}")


def phase15_config(name: str, base: str, mesh: dict, save_steps: int, root: Path = PHASE15_DIR) -> Path:
    """``base`` (a config under configs/) with PHASE15_REDUCED's changes and ``mesh``, written to ``root``."""
    import yaml

    cfg = yaml.safe_load((ROOT / "configs" / base).read_text())
    run = root / name
    for stage in ("stage1", "stage2"):
        cfg["training"][stage]["num_epochs"] = 1
        cfg["training"][stage]["gradient_accumulation_steps"] = 1
    cfg["training"].update(save_steps=save_steps, save_epoch_checkpoints=False, save_best_checkpoints=False,
                           load_best_model_at_end=False)
    cfg["model"]["vocab_size"] = GPT2_VOCAB
    cfg["mesh"].update(mesh)
    batch = max(cfg["training"][stage]["batch_size"] for stage in ("stage1", "stage2"))
    cfg["data"]["dummy_samples"] = max(64, (PHASE15_STEPS + 1) * batch)  # a validation batch and the steps'
    cfg["data"]["conceptual_captions_path"] = str(root / "no-data" / "captions.csv")
    cfg["data"]["ultrafeedback_path"] = str(root / "no-data" / "preferences.json")
    cfg["paths"] = {"output_dir": str(run), "checkpoint_dir": str(run / "checkpoints"),
                    "log_dir": str(run / "logs"), "cache_dir": str(run / "cache")}
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def phase_tp_cp() -> dict:
    """Phase 15: tensor and context parallelism on two gloo ranks that share the card. 15a the collectives;
    15b the scaled config's towers at full width cut over model 2 against one process (whose steps, kept as
    ``one_process``, phase 16a checks its ranks against); 15c the fused-CE kernels on a vocab block; 15d the
    flagship sequence-sharded over seq 2 against one process, ring attention against plain; 15e the training
    CLI on configs/default.yaml (stage 2, seq 2). Phase 16b runs the scaled config's CLI, over model and fsdp."""
    import os

    from pgica_tpu_torch.utils import factories
    from pgica_tpu_torch.utils.config import Config

    shutil.rmtree(PHASE15_DIR, ignore_errors=True)
    PHASE15_DIR.mkdir(parents=True)
    os.environ["WANDB_MODE"] = "disabled"
    out = {"counts": {}}
    try:
        # ---- 15a, 15b, 15d: the ranks start; the one process takes the same steps meanwhile
        t = time.perf_counter()
        rng = np.random.default_rng(15)
        inputs = {"s1": [stage1_batch(rng, TP_BATCH, TP_SEQ) for _ in range(2)],
                  "s2": [stage2_batch(rng, TP_BATCH, TP_SEQ) for _ in range(2)],
                  "cp": [stage2_batch(rng, TP_BATCH, TP_SEQ) for _ in range(2)]}
        torch.save(inputs, PHASE15_DIR / "inputs.pt")
        log("  15e: configs changed: " + "; ".join(PHASE15_REDUCED))
        cp_cfg = phase15_config("cp", "default.yaml", {"seq": 2}, 0)
        # 15a/15b/15d, then 15e's CLI, in the same ranks
        started = start_ranks("chain", [("tp_cp_parity", (str(PHASE15_DIR / "inputs.pt"),)),
                                        ("tp_cp_cli", ([(str(cp_cfg), str(PHASE15_DIR / "cp"), "2")],))],
                              workdir=PHASE15_DIR)
        model = scaled_model()
        want = {"tp": tp_steps(model.module, None, inputs["s1"], inputs["s2"])}
        out["one_process"] = dict(want["tp"], inputs={k: inputs[k] for k in ("s1", "s2")})  # 16a's reference
        whole_bytes = {k: v.numel() * v.element_size() for k, v in model.module.named_parameters()}
        del model
        model, ref = parallel_model()
        want["cp"] = cp_steps(model.module, ref, None, inputs["cp"])
        del model, ref
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  15b/15d: the one process's steps on the whole batch in {time.perf_counter() - t:.1f} s, beside the "
            "ranks")
        chained = join_ranks(started, timeout=3 * RANK_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t
        log(f"  15a/15b/15d and 15e ranks: {out['ranks_s']:.1f} s")
        ranks = [parity for parity, _ in chained]
        for r, res in enumerate(ranks):
            if not all(res["collectives"].values()):
                raise AssertionError(f"15a rank {r}: {res['collectives']}")
        log(f"  15a on CUDA tensors over gloo, both ranks: {', '.join(ranks[0]['collectives'])}: each value and "
            "gradient right")
        heads = ranks[0]["heads"]
        if heads != {"vit": 8, "text": 10, "decoder": 10, "cross": 4, "wte_rows": TP_SHARD_ROWS} or any(
                res["heads"] != heads for res in ranks):
            raise AssertionError(f"15b: a rank's attention heads / wte rows: {[res['heads'] for res in ranks]}")
        for r, res in enumerate(ranks):
            local, whole = res["bytes"]
            if 2 * local != whole:
                raise AssertionError(f"15b rank {r}: {local} of {whole} bytes of the cut parameters")
        cut_share = ranks[0]["bytes"][1] / sum(whole_bytes.values())
        for mode in ("tp", "cp"):
            res0 = dict(ranks[0][mode])
            for r, res in enumerate(ranks):
                verdict = check_parity(mode, {**res[mode], "params": res0["params"]}, want[mode], r)
                log(f"  15{'b' if mode == 'tp' else 'd'} rank {r}: {len(want[mode]['metrics'])} updates against one "
                    f"process on the whole batch: {verdict}; the replicated masters bit-identical over the ranks "
                    "after every step")
        for r, res in enumerate(ranks):
            c = res["tp"]["counts"]["stage2_step1"]
            if {k: c[k] for k in FCE_KERNELS} != {"fused_ce_fwd": 2, "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}:
                raise AssertionError(f"15b rank {r}: a stage-2 step's fused-CE launches {c}")
            one = want["tp"]["counts"]["stage2_step1"]
            if any(c[k] != one[k] for k in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")):
                raise AssertionError(f"15b rank {r}: flash launches {c} against one process's {one}")
            check_main_path(f"15b stage-2 step (rank {r})", c, TRAIN_KERNELS)
            for step, cnt in res["tp"]["counts"].items():
                check_f32_route(f"15b {step} (rank {r})", cnt, TP_SEQ - 1)
            out["counts"][f"tp_stage1_rank{r}"] = res["tp"]["counts"]["stage1_step1"]
            out["counts"][f"tp_stage2_rank{r}"] = c
            cc = res["cp"]["counts"]["stage2_step1"]
            check_main_path(f"15d CP stage-2 step (rank {r})", cc, CP_KERNELS)
            out["counts"][f"cp_stage2_rank{r}"] = cc
        log(f"  15b: a rank's heads ViT-L 8 of 16, GPT-2 Large 10 of 20 (text tower and decoder), cross-attention 4 "
            f"of 8; its wte {TP_SHARD_ROWS:,} of {GPT2_VOCAB:,} rows; a stage-2 step launches the fused CE forward 2, "
            f"dh 1 and dW 1 on that block and as many flash kernels as one process, on the local heads; each rank "
            f"holds {ranks[0]['bytes'][0]:,} of the {ranks[0]['bytes'][1]:,} bytes of the cut parameters (half; the "
            f"cut ones are {100 * cut_share:.1f}% of the model's bytes)")
        ring = [res["ring"] for res in ranks]
        for r, rg in enumerate(ring):
            e = rg["errs"]
            if e["out"] > RING_ATOL or max(e["dq"], e["dk"], e["dv"]) > RING_GRAD_ATOL:
                raise AssertionError(f"15d ring attention rank {r}: {e}")
        grad_err = max(max(rg["errs"][k] for k in ("dq", "dk", "dv")) for rg in ring)
        log(f"  15d ring_attention {ring[0]['shape']} causal, key padding, f32, both ranks: output within "
            f"{max(rg['errs']['out'] for rg in ring):.2e} (atol {RING_ATOL}), dq/dk/dv within "
            f"{grad_err:.2e} (atol {RING_GRAD_ATOL}) of plain "
            f"attention over the whole sequence; forward and backward rank 0 {ring[0]['times']['ring']:.3f} ms "
            f"(ppermutes over gloo included) against plain's {ring[0]['times']['plain']:.3f} ms on the whole "
            f"sequence [{card()}; two ranks share this card]")
        out["ring"] = ring[0]

        # ---- 15c: the fused-CE kernels on a vocab block, out-of-shard targets, the global lse
        t = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(16)
        out["fce"] = {}
        pad = 4 * TP4_SHARD_ROWS - GPT2_VOCAB  # model 4's last block: 2 zero rows
        for case, rows, shard in (("vocab block", TP_SHARD_ROWS, (TP_SHARD_ROWS, GPT2_VOCAB, 0)),
                                  ("padded vocab block", TP4_SHARD_ROWS, (3 * TP4_SHARD_ROWS, GPT2_VOCAB, pad))):
            res = fused_ce_case(case, FCE_TP_ROWS, rows, 1280, torch.bfloat16, torch.float32, gen, shard=shard)
            for kernel, r in res.items():
                show_timed(kernel, r)
            out["fce"][case] = res
        log(f"  15c: {time.perf_counter() - t:.1f} s")

        # ---- 15e: the training CLI in the same two ranks: CP stage 2 on configs/default.yaml (16b runs the scaled
        # config's tensor-parallel CLI, over fsdp too)
        out["cli"] = {}
        show_cli_runs("15e", "cp", "seq", CP_KERNELS, [cli[0] for _, cli in chained], out)
        return out
    finally:
        shutil.rmtree(PHASE15_DIR, ignore_errors=True)


# ------------------------------------------------------------------ phase 16: FSDP at rest

PHASE16_DIR = ROOT / "build" / "phase16"
FSDP_MESH = dict(data=1, fsdp=2, model=2)  # 16a and 16b: four gloo ranks share the card
FSDP_WORLD = 4
FSDP_LOOSE_SHARE = 1e-4  # 16a: fewer than 0.01% of the parameters beyond PARAM_ATOL
CARD_BYTES = 80e9  # the H100's memory, beside a rank's reckoned training state
PHASE16_REDUCED = (
    f"each tower runs {PHASE15_LAYERS} of its layers at full width (ViT-L/14 24, GPT-2 Large 36): the CLI reads "
    "depth from the presets, which the ranks and the checking process cut",
    f"1 epoch a stage (the config: 10 and 5), --max-steps {PHASE15_STEPS}; gradient accumulation 1 (the config: 4)",
    f"model.vocab_size {GPT2_VOCAB:,} (the config's own); mesh: fsdp 2 over the config's own model 2 (data -1: 1)",
    "the data paths point at no file: the in-memory dummy datasets take their place; the config's batches (16, 8)",
    f"one checkpoint, the autosave at the run's last step ({2 * PHASE15_STEPS}), and the stage-2 reference; "
    "load_best_model_at_end off; outputs under build/phase16, deleted at the end; wandb disabled",
)


def spec_bytes(module, shape: dict, trained) -> dict:
    """A rank's bytes of parameters and Adam moments (f32, of the leaves ``trained(name)`` keeps) under the rule
    table on a mesh of ``shape``, reckoned from the whole module's leaves (meta tensors will do): each leaf
    divided by the sizes of the axes its spec cuts it over; a column bias of a kernel cut over ``model`` is the
    rank's slice, as ``shard_module`` keeps it. Every rank holds as many bytes when the cuts are even."""
    from pgica_tpu_torch.parallel.sharding import infer_param_spec, jax_leaf, module_tp_dims

    tp = module_tp_dims(module, shape)
    params = adam = 0
    for name, p in module.named_parameters():
        path, jshape = jax_leaf(module, name, p)
        n = p.numel()
        for axis in infer_param_spec(path, jshape, shape):
            n //= 1 if axis is None else shape[axis]
        if name in tp and not any(infer_param_spec(path, jshape, shape)):
            n //= shape["model"]
        params += n * p.element_size()
        adam += 2 * n * 4 if trained(name) else 0
    return {"params": params, "adam": adam}


def fsdp_steps(module, mesh, batches1, batches2) -> dict:
    """Two stage-1 and two stage-2 updates as :func:`tp_steps` does, on this rank's rows of each global batch of a
    model cut over ``model`` and ``fsdp``: metrics, whether the leaves neither axis cuts are bit-identical over the
    ranks after each step, each step's launches and ms, rank 0's busy share over the last stage-2 step
    (profiled), the peak, this rank's parameter and Adam bytes, the gathered parameters."""
    from torch.profiler import ProfilerActivity, profile

    from pgica_tpu_torch.models.model import frozen_copy
    from pgica_tpu_torch.ops import _kernels
    from pgica_tpu_torch.parallel.sharding import gathered_state_dict, param_axes
    from pgica_tpu_torch.training.optim import create_optimizer
    from pgica_tpu_torch.training.train_step import TrainState, make_stage1_train_step, make_stage2_train_step
    from pgica_tpu_torch.utils import trace

    out = {"metrics": [], "identical": [], "counts": {}, "ms": {}, "adam": {}}
    cut = param_axes(module)
    out["params_bytes"] = sum(p.numel() * p.element_size() for p in module.parameters())
    torch.cuda.reset_peak_memory_stats()
    for stage, batches in ((1, batches1), (2, batches2)):
        opt = create_optimizer(PARALLEL_LR, 10, 1, freeze_vision_backbone=True,
                               frozen_prefixes=("caption_decoder",) if stage == 1 else ("text_encoder",))
        state = TrainState.create(module, opt)
        out["adam"][stage] = sum(t.numel() * t.element_size() for t in state.opt_state.mu + state.opt_state.nu)
        ref = frozen_copy(module, torch.float32) if stage == 2 else None
        step = (make_stage1_train_step(module, opt, 0.5, mesh=mesh) if stage == 1
                else make_stage2_train_step(module, opt, beta=0.1, mesh=mesh))
        for i, b in enumerate(batches):
            local = mesh.shard_batch(b)
            traced = stage == 2 and i == len(batches) - 1 and mesh.rank == 0
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if traced else None
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()  # ---- a step of the path starts here
            t = time.perf_counter()
            with prof if prof is not None else contextlib.nullcontext():
                state, m = step(state, local, 0) if stage == 1 else step(state, ref, local, 0)
                torch.cuda.synchronize()
            out["ms"][f"stage{stage}_step{i}"] = (time.perf_counter() - t) * 1e3
            out["counts"][f"stage{stage}_step{i}"] = _kernels.launch_counts()  # ---- and ends here
            if prof is not None:
                device = trace.device_totals(trace.raw_events(prof))
                kernels = sum(us for k, (us, _) in device.items() if not k.startswith(("Memcpy", "Memset")))
                out["busy"] = {"device_ms": kernels / 1e3, "step_ms": out["ms"][f"stage{stage}_step{i}"],
                               "memcpy_ms": sum(us for k, (us, _) in device.items()
                                                if k.startswith(("Memcpy", "Memset"))) / 1e3}
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["identical"].append(same_on_ranks([p for k, p in module.named_parameters() if k not in cut], mesh,
                                                  ("fsdp", "model")))
        del ref
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    whole = gathered_state_dict(module, mesh)
    out["params"] = {k: v.detach().cpu() for k, v in whole.items()} if mesh.rank == 0 else None
    return out


def fsdp_parity(rank: int, world: int, inputs: str) -> dict:
    """16a on one rank: the scaled config's towers cut over model 2 and then fsdp 2, two stage-1 and two stage-2
    updates on this rank's rows."""
    from pgica_tpu_torch.parallel.mesh import MeshContext
    from pgica_tpu_torch.parallel.sharding import shard_fsdp, shard_module, sharded_bytes

    mesh = MeshContext(**FSDP_MESH)
    inp = torch.load(inputs, weights_only=False)
    model = scaled_model()
    shard_module(model.module, mesh)
    shard_fsdp(model.module, mesh)
    out = fsdp_steps(model.module, mesh, inp["s1"], inp["s2"])
    out["cut_bytes"], out["coords"] = sharded_bytes(model.module), mesh.coords
    return out


def phase_fsdp(one: dict) -> dict:
    """Phase 16: FSDP at rest on four gloo ranks that share the card. 16a: configs/scaled_vitl_gpt2large.yaml's
    towers at full width (2 layers a tower, f32) cut over fsdp 2 x model 2 against phase 15b's one process on the
    whole batch (``one``); 16b: the training CLI on that config over fsdp 2 x model 2, its checkpoint loaded bit
    for bit into one process; and configs/siglip_llama8b.yaml's rank bytes at full depth from the rule table."""
    import os

    from pgica_tpu_torch.models.model import build_module
    from pgica_tpu_torch.utils import factories
    from pgica_tpu_torch.utils.config import Config

    shutil.rmtree(PHASE16_DIR, ignore_errors=True)
    PHASE16_DIR.mkdir(parents=True)
    os.environ["WANDB_MODE"] = "disabled"
    out = {"counts": {}, "cli": {}}
    try:
        # ---- 16a: four ranks against the one process of 15b, then 16b's CLI in the same ranks
        t = time.perf_counter()
        torch.save(one["inputs"], PHASE16_DIR / "inputs.pt")
        log("  16b: configs changed: " + "; ".join(PHASE16_REDUCED))
        cfg = phase15_config("fsdp", "scaled_vitl_gpt2large.yaml", {"fsdp": 2}, 2 * PHASE15_STEPS, root=PHASE16_DIR)
        chained = join_ranks(start_ranks("chain", [("fsdp_parity", (str(PHASE16_DIR / "inputs.pt"),)),
                                                   ("tp_cp_cli", ([(str(cfg), str(PHASE16_DIR / "fsdp"), "all")],))],
                                         workdir=PHASE16_DIR, world=FSDP_WORLD), timeout=5 * RANK_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t
        log(f"  16a and 16b ranks: {out['ranks_s']:.1f} s")
        ranks = [parity for parity, _ in chained]
        with torch.device("meta"):
            whole = scaled_model_meta()
        frozen = {1: ("vision_encoder.backbone.", "caption_decoder."), 2: ("vision_encoder.backbone.", "text_encoder.")}
        want_bytes = {stage: spec_bytes(whole, FSDP_MESH, lambda n, f=f: not n.startswith(f))
                      for stage, f in frozen.items()}
        for r, res in enumerate(ranks):
            got = {"params": res["params_bytes"], "adam": res["adam"]}
            if got["params"] != want_bytes[1]["params"] or any(res["adam"][s] != want_bytes[s]["adam"] for s in (1, 2)):
                raise AssertionError(f"16a rank {r}: bytes {got} against the rule table's {want_bytes}")
            verdict = check_parity("fsdp", {**res, "params": ranks[0]["params"]}, one, r, share=FSDP_LOOSE_SHARE)
            log(f"  16a rank {r} at {res['coords']}: {len(one['metrics'])} updates against one process on the whole "
                f"batch: {verdict}; the leaves neither axis cuts bit-identical over the ranks after every step")
            for step in ("stage1_step1", "stage2_step1"):
                c, o = res["counts"][step], one["counts"][step]
                if any(c[k] != o[k] for k in TRAIN_KERNELS if not k.startswith("fused_ce")) or (
                        step.startswith("stage2") and {k: c[k] for k in FCE_KERNELS} != {
                            "fused_ce_fwd": 2, "fused_ce_bwd_dh": 1, "fused_ce_bwd_dw": 1}):
                    raise AssertionError(f"16a rank {r} {step}: launches {c} against one process's {o}")
                check_main_path(f"16a {step} (rank {r})", c, TRAIN_KERNELS if step.startswith("stage2") else
                                [k for k in TRAIN_KERNELS if not k.startswith("fused_ce")])
                check_f32_route(f"16a {step} (rank {r})", c, TP_SEQ - 1)
            out["counts"][f"fsdp_stage1_rank{r}"] = res["counts"]["stage1_step1"]
            out["counts"][f"fsdp_stage2_rank{r}"] = res["counts"]["stage2_step1"]
            log(f"  16a rank {r}: steps ms " + ", ".join(f"{k} {v:.1f}" for k, v in res["ms"].items())
                + f"; peak {res['peak_gib']:.2f} GiB; parameters {res['params_bytes']:,} B, Adam stage 1 "
                f"{res['adam'][1]:,} B, stage 2 {res['adam'][2]:,} B (the rule table's); cut parameters "
                f"{res['cut_bytes'][0]:,} of {res['cut_bytes'][1]:,} B [{card()}; four ranks share this card]")
        busy = ranks[0]["busy"]
        log(f"  16a rank 0's busy share over its profiled stage-2 step {100 * busy['device_ms'] / busy['step_ms']:.1f}% "
            f"(kernel time {busy['device_ms']:.1f} ms, memory copies {busy['memcpy_ms']:.1f} ms, step "
            f"{busy['step_ms']:.1f} ms)")
        out["a"] = {"ms": [res["ms"] for res in ranks], "peak_gib": [res["peak_gib"] for res in ranks],
                    "busy": busy, "bytes": want_bytes}

        # ---- 16b: the training CLI in the four ranks on the scaled config over fsdp 2 x model 2
        t = time.perf_counter()
        runs = [cli[0] for _, cli in chained]
        if any(rr["mesh"]["fsdp"] != 2 for rr in runs):
            raise AssertionError(f"16b: meshes {[rr['mesh'] for rr in runs]}")
        show_cli_runs("16b", "fsdp", "model", TRAIN_KERNELS, runs, out)
        with cut_presets(PHASE15_LAYERS):
            one_process = factories.create_model(Config(str(cfg)), device="cuda")
        auto = PHASE16_DIR / "fsdp" / "checkpoints" / "autosave_stage2"
        factories.restore_params(one_process, auto)
        got, gathered = digests(one_process.module.state_dict()), runs[0]["digests"]
        if got.keys() != gathered.keys() or any(not torch.equal(got[k], gathered[k]) for k in got):
            raise AssertionError("16b: the FSDP checkpoint loaded into one process differs from the ranks' gathered "
                                 "parameters")
        log(f"  16b: {auto.relative_to(ROOT)} loaded into one process (factories.restore_params): its {len(got)} "
            "tensors bit-equal to the ranks' gathered parameters (digests of their bits)")
        del one_process
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  16b: the checkpoint's check {time.perf_counter() - t:.1f} s")

        # ---- configs/siglip_llama8b.yaml at its own mesh and full depth: a rank's bytes from the rule table
        with torch.device("meta"):
            llama = build_module("google/siglip-so400m-patch14-384", "meta-llama/Meta-Llama-3-8B", projection_dim=512,
                                 vocab_size=LLAMA_VOCAB, max_caption_length=128, freeze_vision_backbone=True)
        out["llama8b"] = {}
        for name, mesh in (("fsdp 2 x model 4", dict(data=1, fsdp=2, model=4)),
                           ("model 4 alone (replicated over fsdp)", dict(data=2, fsdp=1, model=4))):
            out["llama8b"][name] = {stage: spec_bytes(llama, mesh, lambda n, f=f: not n.startswith(f))
                                    for stage, f in frozen.items()}
        whole_bytes = sum(p.numel() * 4 for p in llama.parameters())
        for stage in frozen:
            own, alone = (out["llama8b"][k][stage] for k in out["llama8b"])
            log(f"  16: configs/siglip_llama8b.yaml at full depth on its own mesh (fsdp 2 x model 4, f32 masters), "
                f"stage {stage}: a rank holds {own['params'] / 1e9:.2f} GB of parameters and {own['adam'] / 1e9:.2f} "
                f"GB of Adam moments, {(own['params'] + own['adam']) / 1e9:.2f} GB beside the card's "
                f"{CARD_BYTES / 1e9:.0f} GB ({(alone['params'] + alone['adam']) / 1e9:.2f} GB with the parameters "
                f"replicated over fsdp; the whole model's masters {whole_bytes / 1e9:.2f} GB); from the rule table, "
                "nothing allocated")
        return out
    finally:
        shutil.rmtree(PHASE16_DIR, ignore_errors=True)


def scaled_model_meta():
    """:func:`scaled_model`'s module on the current (meta) device: its leaves' shapes, no weights."""
    from pgica_tpu_torch.models.model import build_module
    from pgica_tpu_torch.models.presets import get_text_config, get_vision_config

    return build_module(dataclasses.replace(get_vision_config(SCALED["vision"]), num_layers=SCALED["layers"]),
                        dataclasses.replace(get_text_config(SCALED["text"]), num_layers=SCALED["layers"]),
                        projection_dim=512, vocab_size=GPT2_VOCAB, max_caption_length=TP_SEQ, dropout=0.0,
                        freeze_vision_backbone=True)


FCE_SHAPE = f"({4 * 511}, 4096) x ({LLAMA_VOCAB}, 4096)"
# name -> (source, the TPU kernel it replaces, the shape and type of the Llama stage-2 step (phase 8)
# that its summary row reports: the one most of that step's launches take)
KERNEL_META = {
    "layernorm_fwd": ("pgica_tpu_torch/csrc/layernorm_fwd.cu", "pgica_tpu/ops/layernorm.py:75", "(1460, 1152)",
                      "bfloat16"),
    "flash_attn_fwd": ("pgica_tpu_torch/csrc/flash_attn_fwd.cu", "pgica_tpu/ops/flash_attention.py:34",
                       "(32, 730, 730, 72)", "bfloat16"),
    # the f32 route of the same entry point at Sq >= F32_TILED_MIN_SQ: flash_attn_fwd_f32, register-tiled
    "flash_attn_fwd_f32": ("pgica_tpu_torch/csrc/flash_attn_fwd.cu", "pgica_tpu/ops/flash_attention.py:34",
                           "(32, 730, 730, 72)", "float32"),
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
    # a run that hangs dumps every thread's stack to stderr before its limit (1,200 s) ends it
    faulthandler.dump_traceback_later(STACKS_AFTER_S, exit=False)
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
        log(f"  ({name.split(':')[0]}: {phases[name.split(':')[0]]:.1f} s; {time.perf_counter() - t_start:.1f} s into "
            f"the run; {written()})")
        return out

    kernels = phase("phase 3: kernels vs plain on the card", phase_kernels)
    int8 = phase("phase 12a: the int8 decode kernels vs plain on the card", phase_int8_kernels)
    cross = {}
    refused = start_failed_capture()  # beside phase 4, whose CPU references leave the card idle
    for arch in FULL_WIDTH:
        cross[arch] = phase(f"phase 4 ({arch}): full width, {FULL_WIDTH[arch]['layers']} layer(s) a tower, f32: card "
                            "(kernels) vs CPU (plain)", phase_full_width, tokenizer, arch)
        gc.collect()
    check_failed_capture(refused)
    served = phase("phase 5: serving (flagship, bf16, caption requests)", phase_slice, tokenizer)
    model = served.pop("model")
    trained = phase("phase 6: the slice, stage-1 training (flagship, bf16 over f32 masters)", phase_stage1, model)
    dpo = phase("phase 7: the slice, stage-2 DPO training (flagship, bf16 over f32 masters, bf16 reference)",
                phase_stage2, model)
    phase("phase 10a: graphed serving after training (the flagship of phases 6-7)", phase_after_training, model)
    evaluation = phase("phase 11a: evaluation (EvaluationRunner, configs/default.yaml's evaluation section, the trained "
                       "flagship of phases 6-7)", phase_evaluation, model)
    quant = phase("phase 12b: int8 decode (W8A8 and weight-only) on the trained flagship of phases 6-7",
                  phase_quant_serving, model, served)
    del model
    gc.collect()  # the GPT-2 flagship is free now
    torch.cuda.empty_cache()
    llama = phase(f"phase 8: the Llama slice (SigLIP so400m + Llama-3-8B, {LLAMA_LAYERS} of 32 layers, bf16 over f32 "
                  "masters): serving, stage 1, stage 2", phase_llama, tokenizer)
    gc.collect()  # the Llama slice is free now
    torch.cuda.empty_cache()
    cli = phase("phase 9: the training entry point (python -m pgica_tpu_torch.scripts.train, configs/default.yaml, "
                "GPT-2 flagship at full width)", phase_train_cli)
    gc.collect()
    torch.cuda.empty_cache()
    serving = phase("phase 10: serving through the entry points (GPT-2 flagship, configs/default.yaml: the "
                    "continuous-batching engine and the batch scheduler behind HTTP, CUDA graphs)", phase_serving)
    gc.collect()
    torch.cuda.empty_cache()
    imported = phase("phase 13b: offline import at full width (load_pretrained_towers: seeded HF checkpoints of CLIP "
                     "ViT-B/32's vision tower and GPT-2 Medium into the bf16 flagship)", pretrained_import, tokenizer)
    gc.collect()
    torch.cuda.empty_cache()
    ntxent = phase("phase 13c: ntxent_loss_fused on the fused-CE kernels, and the slice's new kernel shapes",
                   phase_ntxent_and_shapes)
    gc.collect()
    torch.cuda.empty_cache()
    parallel = phase("phase 14: data parallelism on torch.distributed (14a/14b: two gloo ranks sharing the card; "
                     "14c: one NCCL rank under torchrun)", phase_parallel)
    gc.collect()
    torch.cuda.empty_cache()
    tp_cp = phase("phase 15: tensor and context parallelism (two gloo ranks sharing the card: configs/"
                  "scaled_vitl_gpt2large.yaml over model 2, the flagship over seq 2)", phase_tp_cp)
    gc.collect()
    torch.cuda.empty_cache()
    fsdp = phase("phase 16: FSDP at rest (four gloo ranks sharing the card: configs/scaled_vitl_gpt2large.yaml over "
                 "fsdp 2 x model 2)", phase_fsdp, tp_cp.pop("one_process"))
    serving_summary(served, serving, llama)
    log(f"  total {time.perf_counter() - t_start:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items())
        + ")")

    paths = {"serving": served["main_counts"], "stage1": trained["main_counts"], "stage2": dpo["main_counts"],
             **llama["counts"], "train_cli": cli["counts"], "serving_engine": serving["main_counts"],
             "evaluation": evaluation["counts"], "int8_serving": quant["counts"], "lora_cli": cli["lora"]["counts"],
             "grain_bpe_cli": cli["grain"]["counts"], "pretrained_serving": imported["counts"],
             "ntxent_fused": ntxent["counts"], "cross_attend_decode_step": cross["gpt2"]["counts"],
             **parallel["counts"], **tp_cp["counts"], **fsdp["counts"]}
    summary = []
    bursts = f"median of {BF16_TIMING['trials']} bursts of {BF16_TIMING['reps']}"
    # the path whose launches a kernel's line gives: the Llama slice's stage 2 (bf16), and for the f32
    # forward route 14a's replicated f32 steps (rank 0)
    main_path = {"flash_attn_fwd_f32": "parallel_replicated_rank0"}
    for name, (source, replaces, shape, dtype) in KERNEL_META.items():
        # times at the Llama stage-2 shape in the type the path gives it; the error is the worst over
        # the shapes timed in that type
        bf16 = [r for r in kernels[name] if r["dtype"].startswith(dtype.split(",")[0]) and "ms" in r]
        at = next(r for r in bf16 if r["shape"] == shape and r["dtype"] == dtype)
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": paths[main_path.get(name, "llama_stage2")][name],
            "launches_by_path": {path: counts.get(name, 0) for path, counts in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in bf16),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_by": at["bound_by"], "library_ms": at["library_ms"], "shape": shape, "dtype": dtype,
            "inputs": at["input_sets"] if isinstance(at["input_sets"], str)
            else f"{at['input_sets']} input sets rotating through > 2x L2 (cold), "
            + (f"median of {F32_TIMING['trials']} bursts of {F32_TIMING['reps']}" if dtype == "float32" else bursts),
        })
        if "cuda_cores_ms" in at:  # the f32 route: the CUDA-core kernel it replaced, timed in turns with it
            summary[-1]["cuda_cores_ms"] = at["cuda_cores_ms"]
        if name in parallel["fce"]:  # phase 14a's shape: a rank's rows against the gathered global negatives
            g = parallel["fce"][name]
            summary[-1]["global_negatives"] = {k: g[k] for k in ("shape", "dtype", "max_abs_err", "ms", "plain_ms",
                                                                   "bound_ms", "bound_by", "library_ms")}
        for case, key in (("vocab block", "vocab_block"), ("padded vocab block", "vocab_block_padded")):
            if name in tp_cp["fce"][case]:  # phase 15c: a model-2 (model-4) rank's block of the vocab
                g = tp_cp["fce"][case][name]
                summary[-1][key] = {k: g[k] for k in ("shape", "dtype", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "library_ms")}
    m, k, n = Q8_SUMMARY_SHAPE
    for name in Q8_KERNELS:
        # no TPU kernel: the JAX package's int8 dot is XLA's; the time at the engine's 16 slots through a
        # 1024 x 1024 projection, the error the worst over the timed bf16 shapes
        at = next(r for r in int8[name] if r["shape"] == f"({m}, {k}) x ({n}, {k})" and "plain_ms" in r)
        summary.append({
            "name": name, "route": "cuda", "source": "pgica_tpu_torch/csrc/q8_matmul.cu",
            "replaces": "pgica_tpu/ops/quant.py:68", "launches": quant["counts"][name],
            "launches_by_path": {path: counts.get(name, 0) for path, counts in paths.items()},
            "max_abs_err": max(r["max_abs_err"] for r in int8[name] if "ms" in r),
            "ms": at["ms"], "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"], "shape": at["shape"], "dtype": "bfloat16",
            "inputs": f"{at['input_sets']} input sets rotating through > 2x L2 (cold), {bursts}",
        })
    print(smi)
    print(json.dumps({"kernels": summary}))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
