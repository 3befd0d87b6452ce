"""Iteration-level continuous batching for caption decode (serving); port of pgica_tpu/generation/engine.py.

The batch scheduler in ``scripts/serve.py`` admits requests only between
decodes: a request that misses a decode's batching window waits for that
whole decode plus its own. This engine admits requests between decode steps
instead, over a fixed pool of S decode slots (generation/slots.py), as the
JAX engine does:

* each slot carries its own KV-cache rows, write position, repetition-
  penalty presence and active flag, and decodes at its own position (per-row
  cache writes and ``wpe`` gathers, models/layers.py and decoder.py);
* decode advances in chunks of C steps. On the card a chunk is one CUDA
  graph, captured once (``warmup``) and replayed: its shapes never change,
  the counterpart of the JAX engine's one jitted ``lax.scan``;
* between chunks the dispatch thread admits new requests into free slots:
  the vision encode and the prefix of an admission bucket, then an
  ``index_copy_`` of the rows into their slots (padding rows into the
  state's scratch row). On the card each bucket's admission is one CUDA
  graph (captured by ``warmup``), as the JAX engine jits ``admit_fn`` once
  per bucket: its images and slot ids reach static device buffers by
  non-blocking copies from pinned host memory on the dispatch stream;
* the device never waits for the host: the dispatch thread owns one CUDA
  stream, on which it runs admissions and queues up to ``max_inflight``
  chunks, and never waits on a result; each chunk's [seqs | active]
  snapshot goes by a non-blocking copy into a pinned host buffer of its
  own, and fetch threads wait on that chunk's CUDA event, complete the
  finished requests and free their slots.

Greedy captions are token-identical to the batch path's (same argmax,
repetition penalty and EOS handling; tests/test_torch_engine.py). Sampling
draws from one generator across admissions and chunks, so its stream
differs from a fresh batch decode's, as the JAX engine's does (slots join
mid-stream). Each admission reseeds it from the engine's seed and the
number of requests admitted before, so that a request's draws do not
depend on how many chunks the pipeline ran while it waited (a matter of
timing): requests submitted one at a time repeat under a seed. The engine serves the weights the model had at construction,
as the JAX engine serves the params it took then: in bf16 the model's
serving copy of that moment, in float32 a copy of its masters (the train
steps and ``load_jax_params`` update the masters in place). That float32
copy costs one more copy of the weights: 3.2 GB for the flagship's 803.3 M
parameters. With the model's ``quantization`` the prefix and the steps run
on its int8 twin of that moment (JAX engine.py:229-230), the vision encode
on the inference module.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pgica_tpu_torch.core.prng import STEP_STRIDE
from pgica_tpu_torch.data.augment import prepare_images
from pgica_tpu_torch.generation.slots import (
    CapturedSteps,
    Sampler,
    SlotState,
    admit,
    decode_steps,
    init_slot_state,
    to_device,
)
from pgica_tpu_torch.models.model import frozen_copy

logger = logging.getLogger(__name__)


def make_engine_fns(encode_module, decode_module, *, slots: int, chunk: int, max_length: int, eos_token_id: int,
                    pad_token_id: int, pick: Sampler, device: torch.device):
    """Build (init_state, admit_fn, chunk_fn) for a slot pool (JAX engine.py:64-191).

    ``encode_module`` runs the vision tower, ``decode_module`` the prefix and
    the steps (the int8 twin with quantization; else the same module).

    ``init_state(seed)`` makes the pool, every slot free; ``admit_fn(state,
    images, slot_ids)`` encodes a uint8 NHWC admission bucket (a tensor on
    the device) through the vision tower and admits its rows into
    ``slot_ids`` (int64 on the device, ids >= ``slots`` padding), reading
    nothing back to the host, so that a CUDA graph captures it;
    ``chunk_fn(state)`` advances every slot by up to ``chunk`` tokens in
    place and returns the (S, max_length + 1) [seqs | active] snapshot and
    the last step's logits, fresh tensors (under capture: the graph's, which
    the next replay overwrites).
    """
    def init_state(seed: int) -> SlotState:
        generator = torch.Generator(device).manual_seed(seed) if pick.do_sample else None
        return init_slot_state(decode_module.decoder_config, slots, max_length, decode_module.compute_dtype, device,
                               eos_token_id=eos_token_id, pad_token_id=pad_token_id, generator=generator)

    def admit_fn(state: SlotState, images: torch.Tensor, slot_ids: torch.Tensor) -> None:
        pixels = prepare_images(images)
        admit(decode_module, state, encode_module.encode_image(pixels)["embeddings"], slot_ids, pick)

    def chunk_fn(state: SlotState) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = decode_steps(decode_module, state, chunk, pick)
        return torch.cat([state.seqs, state.active.to(torch.int64)[:, None]], dim=1), logits

    return init_state, admit_fn, chunk_fn


class ContinuousDecodeEngine:
    """Continuous-batching caption decoder over a slot pool.

    Public surface, as the JAX engine's: ``warmup()``, ``start()``, blocking
    ``submit(image) -> {"caption", "latency_ms"}``, ``stats()``, ``stop()``.
    ``cuda_graph`` (the card only) replays each chunk and each admission
    bucket as a CUDA graph; False runs them eagerly, as on the CPU (to
    measure what the graphs save).
    """

    def __init__(
        self,
        model,
        *,
        slots: int = 16,
        chunk: int = 8,
        max_length: int = 32,
        temperature: float = 1.0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
        do_sample: bool = False,
        seed: int = 0,
        max_inflight: int = 3,
        fetch_threads: int = 2,
        cuda_graph: bool = True,
    ):
        self.model = model
        self.tokenizer = model.tokenizer
        self.device = model.device
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.max_length = int(max_length)
        self.pick = Sampler(do_sample, temperature, top_p, repetition_penalty)
        module = model._inference_module()
        # the float32 inference module is the masters themselves: serve a copy of them
        self.encode_module = frozen_copy(module, torch.float32) if module is model.module else module
        self.module = model._decode_module() if model.quantization else self.encode_module  # what decodes
        self._init_state, self._admit_fn, self._chunk = make_engine_fns(
            self.encode_module, self.module, slots=self.slots, chunk=self.chunk, max_length=self.max_length,
            eos_token_id=self.tokenizer.eos_token_id, pad_token_id=self.tokenizer.pad_token_id,
            pick=self.pick, device=self.device,
        )
        self._seed = int(seed)
        self._state = self._init_state(self._seed)
        self._admitted = 0  # requests admitted so far: each admission's sampling seed
        on_card = self.device.type == "cuda"
        self.cuda_graph = bool(cuda_graph) and on_card
        self.graph: Optional[CapturedSteps] = None  # the captured chunk, once warmed
        # bucket -> (image buffer, slot-id buffer, the captured admission), once warmed
        self.admissions: Dict[int, Tuple[torch.Tensor, torch.Tensor, CapturedSteps]] = {}
        self._stream = torch.cuda.Stream(self.device) if on_card else None
        self.buckets = [b for b in (1, 2, 4, 8, 16, 32, 64) if b <= self.slots]
        # Non-power-of-two slot pools (e.g. --slots 24) must still be able to
        # admit a full burst in one bucket, in FIFO order.
        if self.buckets[-1] != self.slots:
            self.buckets.append(self.slots)

        self._queue: "queue.Queue" = queue.Queue()
        self._fetchq: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._work = threading.Event()  # something to do (arrivals or active slots)
        # host slot table: None = free, else {request dict, 'seq': admit seq}
        self._table: List[Optional[dict]] = [None] * self.slots
        self._free = list(range(self.slots))
        self._outstanding = 0  # admitted, not yet harvested
        self._chunk_seq = 0
        inflight = max(1, int(max_inflight))
        self._inflight = threading.Semaphore(inflight)
        # one host buffer per chunk in flight (pinned on the card, for the non-blocking copy); a
        # fetch thread returns its buffer before it releases its chunk's semaphore slot
        self._buffers: "queue.Queue" = queue.Queue()
        for _ in range(inflight):
            self._buffers.put(torch.empty((self.slots, self.max_length + 1), dtype=torch.int64, pin_memory=on_card))
        # Out-of-order harvests from several fetch threads are safe: a slot only
        # goes inactive once per occupancy, and the per-slot admit seq guard
        # skips pre-admission snapshots.
        self._n_fetch = max(1, int(fetch_threads))
        self._threads = [
            threading.Thread(target=self._dispatch_loop, daemon=True, name="engine-dispatch"),
        ] + [
            threading.Thread(target=self._fetch_loop, daemon=True, name=f"engine-fetch-{i}")
            for i in range(self._n_fetch)
        ]
        self._started = False
        # instrumentation: admits by bucket, chunk count, per-request (queue-to-admit, total)
        # latencies, fetch waits
        self.counters = {"chunks": 0, "admits": {}, "fetch_ms": []}
        self._req_phases = []

    # -- lifecycle -----------------------------------------------------------------

    def _on_stream(self):
        """The dispatch thread's context: inference mode on the engine's stream (the card's)."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        if self._stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def warmup(self) -> List:
        """Run every admission bucket once and one chunk: on the card each is captured as a graph first.

        Returns (bucket or "chunk", seconds) timings; the captures' seconds
        and pool bytes are in ``self.graph``, ``self.admissions`` and
        ``stats()``. Every slot stays free.
        """
        size = self.model.image_size
        timings = []
        with self._on_stream():
            for b in self.buckets:
                t0 = time.perf_counter()
                ids = np.full((b,), self.slots, np.int64)  # all padding: dropped
                self._admit(self._state, np.zeros((b, size, size, 3), np.uint8), ids)
                self._sync()
                timings.append((b, time.perf_counter() - t0))
            t0 = time.perf_counter()
            self._run_chunk()
            self._sync()
            timings.append(("chunk", time.perf_counter() - t0))
        return timings

    def start(self):
        if not self._started:
            self._started = True
            for t in self._threads:
                t.start()

    def stop(self, timeout: float = 10.0):
        """Stop the threads and wait for them (an interpreter that exits under a running thread
        may abort)."""
        self._stop.set()
        self._work.set()
        self._inflight.release()  # unblock a dispatch waiting on the semaphore
        for _ in range(self._n_fetch):
            self._fetchq.put(None)
        if self._started:
            for t in self._threads:
                t.join(timeout)

    def stats(self) -> dict:
        with self._lock:
            phases = list(self._req_phases)
            counters = {
                "chunks": self.counters["chunks"],
                "admits": dict(self.counters["admits"]),
                "fetch_ms": list(self.counters["fetch_ms"][-200:]),
            }
        out = {"chunks_dispatched": counters["chunks"], "admits_by_bucket": counters["admits"]}
        graphs = {f"admit {b}": graph for b, (_, _, graph) in self.admissions.items()}
        if self.graph is not None:
            graphs["chunk"] = self.graph
        if graphs:
            out["graphs"] = {name: {"capture_s": round(g.capture_s, 4), "pool_bytes": g.pool_bytes}
                             for name, g in graphs.items()}
        if counters["fetch_ms"]:
            out["fetch_wait_p50_ms"] = round(float(np.percentile(counters["fetch_ms"], 50)), 1)
        if phases:
            qa = [p[0] for p in phases[-500:]]
            out["queue_to_admit_p50_ms"] = round(float(np.percentile(qa, 50)), 1)
            out["queue_to_admit_p95_ms"] = round(float(np.percentile(qa, 95)), 1)
        return out

    # -- request path ----------------------------------------------------------------

    def submit(self, image: np.ndarray, timeout: float = 30.0) -> dict:
        """Blocking: enqueue one uint8 HWC image, wait for its caption.

        Validates the image eagerly so a malformed direct-API call fails in
        the caller's thread instead of inside the dispatch daemon (which must
        never die: a dead dispatch thread hangs the whole service).
        """
        image = np.asarray(image)
        size = self.model.image_size
        if image.shape != (size, size, 3):
            raise ValueError(
                f"image must be HWC uint8 of shape ({size}, {size}, 3); got {image.shape}"
            )
        done = threading.Event()
        slot = {"image": image.astype(np.uint8, copy=False), "event": done,
                "caption": None, "error": None, "cancelled": False,
                "t0": time.perf_counter()}
        self._queue.put(slot)
        self._work.set()
        if not done.wait(timeout):
            # Mark so an un-admitted request is skipped at admission instead
            # of being decoded with no waiter (wasting a slot under overload).
            # A race with an admission in progress is benign: the request is
            # decoded and harvested with no reader.
            slot["cancelled"] = True
            raise TimeoutError("caption request timed out")
        if slot["error"] is not None:
            raise RuntimeError("caption request failed in the engine") from slot["error"]
        return {"caption": slot["caption"],
                "latency_ms": round(1000.0 * (time.perf_counter() - slot["t0"]), 2)}

    # -- dispatch thread ----------------------------------------------------------------

    def _take_arrivals(self) -> List[dict]:
        with self._lock:
            n_free = len(self._free)
        out = []
        while len(out) < n_free:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r.get("cancelled"):
                continue  # submit() timed out waiting; don't waste a slot
            out.append(r)
        return out

    def _fail_outstanding(self, exc: BaseException):
        """Fail every queued and admitted request and free the slot pool.

        Called when the dispatch loop hits an unexpected error: the slot
        state may be half-written, so the only safe recovery is to error out
        all in-flight work, reset the state (in place: the chunk graph holds
        its tensors) and keep the daemon alive for future requests.
        """
        victims: List[dict] = []
        with self._lock:
            for s, entry in enumerate(self._table):
                if entry is not None:
                    victims.append(entry["req"])
                self._table[s] = None
            self._free = list(range(self.slots))
            self._outstanding = 0
        while True:
            try:
                victims.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in victims:
            req["error"] = exc
            req["event"].set()
        try:
            self._state.reset()
        except Exception:  # noqa: BLE001 — daemon must survive
            logger.exception("engine state reset failed; next dispatch will retry")

    def _dispatch_loop(self):
        """Daemon loop. The body is guarded: any error (bad admit input, a
        transient device failure mid-chunk) fails the outstanding requests and
        continues, instead of silently killing the thread and hanging every
        future submit() while /healthz still reports ok."""
        with self._on_stream():
            while not self._stop.is_set():
                try:
                    self._dispatch_once()
                except Exception as exc:  # noqa: BLE001 — daemon must survive
                    logger.exception("engine dispatch error; failing outstanding requests")
                    self._fail_outstanding(exc)

    def _admit(self, state: SlotState, images: np.ndarray, slot_ids: np.ndarray) -> None:
        """Admit a bucket of uint8 NHWC images into ``slot_ids`` (ids >= slots are padding) on the
        current stream: a replay of the bucket's graph (captured at first use), or eagerly."""
        images = torch.from_numpy(np.ascontiguousarray(images))
        ids = torch.from_numpy(np.ascontiguousarray(slot_ids, dtype=np.int64))
        if not self.cuda_graph:
            self._admit_fn(state, to_device(images, self.device), to_device(ids, self.device))
            return
        if state is not self._state:
            raise ValueError("the admission graphs write the engine's own slot state")
        image_buffer, id_buffer, graph = self._admission(len(ids))
        # pinned blocks from the caching host allocator: not reused before these copies end
        image_buffer.copy_(images.pin_memory(), non_blocking=True)
        id_buffer.copy_(ids.pin_memory(), non_blocking=True)
        graph.replay()

    def _admission(self, bucket: int) -> Tuple[torch.Tensor, torch.Tensor, CapturedSteps]:
        """The bucket's static input buffers and captured admission, captured at first use. The
        capture's eager run admits blank images into padding ids (the scratch row only), and hands
        the sampling generator back as it found it."""
        if bucket not in self.admissions:
            size = self.model.image_size
            images = torch.zeros((bucket, size, size, 3), dtype=torch.uint8, device=self.device)
            ids = torch.full((bucket,), self.slots, dtype=torch.int64, device=self.device)
            generator = self._state.generator
            before = None if generator is None else generator.get_state()
            graph = CapturedSteps(lambda: self._admit_fn(self._state, images, ids), self.device, self._stream,
                                  (generator,))
            if before is not None:
                generator.set_state(before)
            self.admissions[bucket] = (images, ids, graph)
        return self.admissions[bucket]

    def _run_chunk(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One chunk on the current stream, a graph replay (captured at first use) or eager steps:
        (snapshot, the last step's logits)."""
        if not self.cuda_graph:
            return self._chunk(self._state)
        if self.graph is None:
            self.graph = CapturedSteps(lambda: self._chunk(self._state), self.device, self._stream,
                                       (self._state.generator,))
        self.graph.replay()
        return self.graph.out

    def _dispatch_once(self):
        """One dispatch iteration: admit what fits, then queue one chunk."""
        size = self.model.image_size
        arrivals = self._take_arrivals()
        if arrivals:
            a = len(arrivals)
            # buckets always end at self.slots, and arrivals <= free <= slots,
            # so one bucket always covers the whole burst (overflow re-queue
            # kept purely as a safety net).
            bucket = next(b for b in self.buckets if b >= a) if a <= self.buckets[-1] else self.buckets[-1]
            arrivals, overflow = arrivals[:bucket], arrivals[bucket:]
            for r in overflow:
                self._queue.put(r)
            images = np.zeros((bucket, size, size, 3), np.uint8)
            ids = np.full((bucket,), self.slots, np.int64)
            now = time.perf_counter()
            with self._lock:
                for i, req in enumerate(arrivals):
                    s = self._free.pop()
                    images[i] = req["image"]
                    ids[i] = s
                    req["t_admit"] = now
                    # snapshots from chunks dispatched before this admit
                    # must not harvest the new occupant
                    self._table[s] = {"req": req, "seq": self._chunk_seq}
                self._outstanding += len(arrivals)
                self.counters["admits"][bucket] = self.counters["admits"].get(bucket, 0) + 1
            if self._state.generator is not None:
                self._state.generator.manual_seed(self._seed * STEP_STRIDE + self._admitted)
            self._admitted += len(arrivals)
            self._admit(self._state, images, ids)
        with self._lock:
            busy = self._outstanding > 0
        if busy:
            # Wait for a chunk slot, but keep admissions flowing: a request
            # arriving during the wait should not queue behind it.
            acquired = False
            while not self._stop.is_set():
                if self._inflight.acquire(timeout=0.004):
                    acquired = True
                    break
                if not self._queue.empty():
                    with self._lock:
                        has_free = bool(self._free)
                    if has_free:
                        break  # admit first, chunk next iteration
            if not acquired or self._stop.is_set():
                if acquired:
                    self._inflight.release()
                return
            buffer = self._buffers.get_nowait()  # one per permit: never empty here
            try:
                self._chunk_seq += 1
                self.counters["chunks"] += 1
                buffer.copy_(self._run_chunk()[0], non_blocking=True)
                event = None
                if self._stream is not None:
                    event = torch.cuda.Event()
                    event.record(self._stream)
                self._fetchq.put((self._chunk_seq, buffer, event))
            except BaseException:
                self._buffers.put(buffer)
                self._inflight.release()  # the fetch that would release never runs
                raise
        else:
            self._work.clear()
            if not self._queue.empty():
                return  # a submit raced the clear; re-check arrivals now
            # nothing active and no arrivals: sleep until a submit
            self._work.wait(timeout=0.05)

    # -- fetch threads ----------------------------------------------------------------

    def _fetch_loop(self):
        while True:
            item = self._fetchq.get()
            if item is None:
                return
            seq, buffer, event = item
            t0 = time.perf_counter()
            try:
                if event is not None:
                    event.synchronize()  # this chunk's snapshot has reached the host buffer
                snap_np = buffer.numpy().copy()
            except Exception:  # noqa: BLE001 — daemon must survive
                logger.exception("engine snapshot fetch failed; skipping chunk %d", seq)
                self._buffers.put(buffer)
                self._inflight.release()
                continue
            fetch_ms = 1000.0 * (time.perf_counter() - t0)
            self._buffers.put(buffer)
            self._inflight.release()
            seqs_np, active_np = snap_np[:, :-1], snap_np[:, -1].astype(bool)
            finished = []
            now = time.perf_counter()
            with self._lock:
                self.counters["fetch_ms"].append(fetch_ms)
                self.counters["fetch_ms"] = self.counters["fetch_ms"][-1000:]
                for s, entry in enumerate(self._table):
                    if entry is None or seq <= entry["seq"]:
                        continue  # free, or admitted after this chunk was dispatched
                    if not active_np[s]:
                        req = entry["req"]
                        finished.append((req, seqs_np[s]))
                        self._req_phases.append((
                            1000.0 * (req.get("t_admit", req["t0"]) - req["t0"]),
                            1000.0 * (now - req["t0"]),
                        ))
                        self._req_phases = self._req_phases[-1000:]
                        self._table[s] = None
                        self._free.append(s)
                        self._outstanding -= 1
            for req, row in finished:
                req["caption"] = self.tokenizer.decode(row)
                req["event"].set()
            if finished:
                self._work.set()
