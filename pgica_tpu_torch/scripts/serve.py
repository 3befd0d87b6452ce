"""Caption-serving CLI of the port (the counterpart of scripts/serve.py).

An HTTP endpoint that queues incoming images and decodes them, either in
padded batches (``--scheduler batch``: a batching window, fixed batch
buckets, one ``generate_captions`` call a batch) or through the
continuous-batching engine (``--scheduler continuous``: requests join
between chunks of decode steps, generation/engine.py), and reports rolling
latency percentiles.

    python -m pgica_tpu_torch.scripts.serve --config configs/default.yaml --port 8077 \\
        [--model-path checkpoints/best_model_stage2] [--scheduler continuous] [--device cpu]

POST /caption   body: raw image bytes (JPEG/PNG) or JSON
                {"image": [[...]]} array -> {"caption": ..., "latency_ms": ...}
GET  /healthz   -> {"status": "ok", "p50_ms": ..., "p95_ms": ..., "served": N}

The flags are the JAX CLI's, with ``--platform`` replaced by ``--device``
(``cuda``, the default, or ``cpu``). On the card every decode step is a
replayed CUDA graph: one per batch bucket on the batch scheduler; on the
continuous one, one per chunk and one per admission bucket (the vision
encode, the prefix and the slot scatter), captured by ``warmup``
(``--prejit`` builds the kernels and captures them, then exits). ``--quant int8`` or
``--quant int8_weight_only`` decodes through the model's int8 twin (the
hand-written ``csrc/q8_matmul.cu`` on the card), the vision encode staying
in the compute dtype. Images travel as uint8 and are normalized on the
device.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


def _load_serving_model(config, model_path=None, device: str = "cuda"):
    """(image_processor, model) with the uint8 wire format and an optional checkpoint."""
    from pgica_tpu_torch.utils.factories import create_model, create_processors, create_tokenizer, restore_params

    tokenizer = create_tokenizer(config)
    image_processor, _ = create_processors(config, tokenizer)
    # Serving wire format is uint8: hosts decode and resize only, the model
    # normalizes on the device (augment.prepare_images).
    image_processor.device_side_normalization = True
    model = create_model(config, tokenizer, device=device)
    if model_path:
        restore_params(model, model_path)
    return image_processor, model


def _as_uint8(image) -> np.ndarray:
    """The batch buffer is uint8 (wire format); a silent cast would turn [0, 1]-normalized floats
    into all-zero images. Accept [0, 255]-ranged floats, reject normalized ones loudly. An all-zero
    image is black under either convention: allow it."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        if np.issubdtype(image.dtype, np.floating) and image.size and 0.0 < image.max() <= 1.0:
            raise ValueError(
                "submit() expects uint8 images in [0, 255] (got normalized "
                f"float with max {float(image.max()):.3f}); multiply by 255 first"
            )
        image = np.clip(image, 0, 255).astype(np.uint8)
    return image


class _Latencies:
    """Rolling latency window, served count and the HTTP layer's accepted-but-parsing count."""

    def __init__(self):
        self._latencies: List[float] = []
        self._served = 0
        self._arriving = 0
        self._lock = threading.Lock()

    def begin_arrival(self):
        """Signal an accepted request whose payload is still being parsed.

        Call before the (possibly slow) body read and image decode; pass
        ``arrived=True`` to the matching ``submit`` so the count drops the
        moment the request is enqueued. On a parse failure, call
        :meth:`abort_arrival` instead.
        """
        with self._lock:
            self._arriving += 1

    def abort_arrival(self):
        with self._lock:
            self._arriving = max(0, self._arriving - 1)

    def _record(self, latency_ms: float) -> None:
        with self._lock:
            self._latencies.append(latency_ms)
            self._latencies = self._latencies[-1000:]  # rolling window
            self._served += 1

    def stats(self) -> dict:
        with self._lock:
            lat = list(self._latencies)
            served = self._served
            arriving = self._arriving
        out = {"status": "ok", "served": served, "arriving": arriving}
        if lat:
            out["p50_ms"] = round(float(np.percentile(lat, 50)), 2)
            out["p95_ms"] = round(float(np.percentile(lat, 95)), 2)
        return out


class CaptionService(_Latencies):
    """Owns the model and the batching loop (JAX scripts/serve.py:61-266)."""

    def __init__(self, config, model_path=None, max_batch: int = 32, batch_wait_ms: float = 5.0,
                 max_length: int = 32, workers: int = 2, batch_wait_max_ms: float = 75.0,
                 early_stop: bool = True, device: str = "cuda"):
        super().__init__()
        self.image_processor, self.model = _load_serving_model(config, model_path, device)
        self.max_batch = int(max_batch)
        self.batch_wait_s = float(batch_wait_ms) / 1000.0
        self.batch_wait_max_s = max(float(batch_wait_max_ms) / 1000.0, self.batch_wait_s)
        self.max_length = int(max_length)
        # Early-exit decode: the loop stops once every caption in the bucket
        # hit EOS, token-identical to the fixed-length one, so the served
        # latency tracks the captions' length instead of the static bound.
        self.early_stop = bool(early_stop)
        self.buckets = [b for b in (1, 2, 4, 8, 16, 32, 64) if b <= self.max_batch]
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # One decode occupies the card at a time; a worker that dispatched
        # while another decode is in flight would only fragment a burst into
        # serialized narrow decodes. Workers hold this lock across
        # generate_captions (whose graphs one thread at a time may replay)
        # and keep draining the queue while waiting for it, so everything
        # that arrives during decode A rides one decode B.
        self._device = threading.Lock()
        # >1 batching workers pipeline bursts: worker B forms its batch (and
        # absorbs the queue) while worker A's decode is still on the device.
        self._workers = [
            threading.Thread(target=self._loop, daemon=True)
            for _ in range(max(1, int(workers)))
        ]

    # -- lifecycle ---------------------------------------------------------------

    def warmup(self, start_worker: bool = True) -> list:
        """Run every batch bucket once (on the card: build the kernels, capture the step graphs),
        so that cold-start latency stays off the request path. Returns (batch, seconds) timings."""
        size = self.model.image_size
        timings = []
        for b in self.buckets:
            t0 = time.perf_counter()
            self.model.generate_captions(
                np.zeros((b, size, size, 3), np.uint8), max_length=self.max_length,
                early_stop=self.early_stop,
            )
            timings.append((b, time.perf_counter() - t0))
        if start_worker:
            for w in self._workers:
                w.start()
        return timings

    def shutdown(self, timeout: float = 10.0):
        self._stop.set()
        for w in self._workers:
            if w.is_alive():
                w.join(timeout)

    # -- request path -------------------------------------------------------------

    def submit(self, image: np.ndarray, timeout: float = 30.0, arrived: bool = False) -> dict:
        """Blocking single-request API used by the HTTP handler threads."""
        try:
            image = _as_uint8(image)
            done = threading.Event()
            slot = {"image": image, "event": done, "caption": None, "t0": time.perf_counter()}
            self._queue.put(slot)
        finally:
            if arrived:
                self.abort_arrival()  # enqueued (or rejected): not "arriving"
        if not done.wait(timeout):
            raise TimeoutError("caption request timed out")
        latency_ms = 1000.0 * (time.perf_counter() - slot["t0"])
        self._record(latency_ms)
        return {"caption": slot["caption"], "latency_ms": round(latency_ms, 2)}

    # -- batching loop -------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _loop(self):
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.batch_wait_s
            hard_deadline = time.perf_counter() + self.batch_wait_max_s
            # Cap at the largest bucket, not max_batch: with --max-batch 12 the
            # buckets are [1, 2, 4, 8].
            while len(batch) < self.buckets[-1]:
                now = time.perf_counter()
                if now >= hard_deadline:
                    break
                if now >= deadline and self._arriving <= 0:
                    break
                # Adaptive window: every arrival extends the deadline by one
                # base window, and the window also stays open while the HTTP
                # layer holds accepted requests whose payloads are still being
                # parsed, both bounded by the hard cap, so that a burst rides
                # one wide decode instead of a narrow one and a wide one.
                wait = min(max(deadline - now, 0.002), hard_deadline - now)
                try:
                    batch.append(self._queue.get(timeout=wait))
                    deadline = time.perf_counter() + self.batch_wait_s
                except queue.Empty:
                    pass
            # Wait for the card, absorbing the queue the whole time.
            while not self._device.acquire(timeout=0.002):
                while len(batch) < self.buckets[-1]:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
            try:
                # A burst that lands as the window closes is already queued: take it now.
                while len(batch) < self.buckets[-1]:
                    try:
                        batch.append(self._queue.get_nowait())
                    except queue.Empty:
                        break
                bucket = self._bucket(len(batch))
                try:  # keep the server alive; any failure fails only this batch
                    size = self.model.image_size
                    images = np.zeros((bucket, size, size, 3), np.uint8)
                    for i, slot in enumerate(batch):
                        images[i] = slot["image"]
                    captions = self.model.generate_captions(
                        images, max_length=self.max_length, early_stop=self.early_stop)
                except Exception as e:  # noqa: BLE001 — the worker must survive
                    captions = [f"<error: {type(e).__name__}>"] * bucket
            finally:
                self._device.release()
            for i, slot in enumerate(batch):
                slot["caption"] = captions[i]
                slot["event"].set()


class ContinuousCaptionService(_Latencies):
    """Iteration-level continuous batching (``--scheduler continuous``, JAX scripts/serve.py:269-341).

    Requests join the decode between chunks of steps instead of between
    whole decodes: a request that arrives while captions are in flight waits
    at most one chunk plus its own decode. Engine details:
    generation/engine.py. Public surface matches CaptionService.
    """

    def __init__(self, config, model_path=None, slots: int = 16, chunk: int = 8,
                 max_length: int = 32, device: str = "cuda", **_ignored):
        from pgica_tpu_torch.generation.engine import ContinuousDecodeEngine

        super().__init__()
        self.image_processor, self.model = _load_serving_model(config, model_path, device)
        self.engine = ContinuousDecodeEngine(self.model, slots=slots, chunk=chunk, max_length=max_length)
        self.buckets = self.engine.buckets

    def warmup(self, start_worker: bool = True) -> list:
        timings = self.engine.warmup()
        if start_worker:
            self.engine.start()
        return timings

    def shutdown(self):
        self.engine.stop()

    def submit(self, image: np.ndarray, timeout: float = 30.0, arrived: bool = False) -> dict:
        try:
            image = _as_uint8(image)
        finally:
            if arrived:
                self.abort_arrival()
        out = self.engine.submit(image, timeout=timeout)
        self._record(out["latency_ms"])
        return out

    def stats(self) -> dict:
        out = super().stats()
        out["scheduler"] = "continuous"
        out.update(self.engine.stats())
        return out


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, service.stats())
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/caption":
                self._send(404, {"error": "unknown path"})
                return
            # Announce the request before the body read and image decode: the
            # batching window stays open for announced arrivals.
            service.begin_arrival()
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length)
                ctype = self.headers.get("Content-Type", "")
                if ctype.startswith("application/json"):
                    arr = np.asarray(json.loads(raw)["image"], np.float32)
                    image = service.image_processor.process_image(arr.astype(np.uint8))
                else:
                    # raw bytes: JPEGs take the native decode where it built, else PIL
                    image = service.image_processor.process_image(raw)
            except Exception as e:  # noqa: BLE001 — a bad body is the client's 400
                service.abort_arrival()
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                self._send(200, service.submit(image, arrived=True))
            except Exception as e:  # noqa: BLE001 — report, keep serving
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class _Server(ThreadingHTTPServer):
    # The default listen backlog is 5: a 16-way connect storm drops accepts.
    # It must be a class attribute: __init__ binds and listens with it.
    request_queue_size = 64


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Caption serving (PyTorch port)")
    ap.add_argument("--config", default="configs/default.yaml")
    ap.add_argument("--model-path", default=None)
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument(
        "--max-batch", type=int, default=32,
        help="largest decode bucket; bursts up to this size ride ONE decode instead of queueing "
             "behind a smaller bucket",
    )
    ap.add_argument("--batch-wait-ms", type=float, default=5.0)
    ap.add_argument(
        "--batch-wait-max-ms", type=float, default=75.0,
        help="hard cap on the adaptive batching window: each arrival (and each accepted-but-still-"
             "parsing request) extends the window by --batch-wait-ms, never past this cap",
    )
    ap.add_argument("--max-length", type=int, default=32)
    ap.add_argument(
        "--scheduler", default="batch", choices=["batch", "continuous"],
        help="'batch': coalesce requests into whole decodes (admission only between decodes); "
             "'continuous': continuous batching over a fixed slot pool: requests join between "
             "chunks of decode steps (generation/engine.py)",
    )
    ap.add_argument("--slots", type=int, default=16,
                    help="continuous scheduler: decode slot-pool width (one captured chunk graph)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="continuous scheduler: decode steps per chunk (admission granularity)")
    ap.add_argument("--workers", type=int, default=2,
                    help="batching loop threads; 2 pipelines host prep of batch B under batch A's decode")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cuda needs a card)")
    ap.add_argument("--quant", default=None, choices=["int8", "int8_weight_only"],
                    help="decode-time int8 of the decoder LM (ops/quant.py): 'int8' = W8A8 (int8 products, "
                         "int32 sums), 'int8_weight_only' = int8 weights dequantized in the matmul; overrides "
                         "inference.quantization")
    ap.add_argument("--no-early-stop", action="store_true",
                    help="decode every step to --max-length instead of ending once every caption "
                         "emitted EOS (deterministic per-bucket latency, e.g. for probes)")
    ap.add_argument("--prejit", action="store_true",
                    help="build the kernels and capture every decode graph, print timings, and exit")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)

    from pgica_tpu_torch.utils.config import Config
    from pgica_tpu_torch.utils.factories import setup_logging

    setup_logging(level="INFO", filename="serving.log")
    config = Config(args.config)
    if args.quant:
        config.set("inference.quantization", args.quant)
    if args.scheduler == "continuous":
        service = ContinuousCaptionService(
            config, model_path=args.model_path, slots=args.slots, chunk=args.chunk,
            max_length=args.max_length, device=args.device,
        )
    else:
        service = CaptionService(
            config, model_path=args.model_path, max_batch=args.max_batch,
            batch_wait_ms=args.batch_wait_ms, max_length=args.max_length,
            workers=args.workers, batch_wait_max_ms=args.batch_wait_max_ms,
            early_stop=not args.no_early_stop, device=args.device,
        )
    if args.prejit:
        print("prejit: building the kernels and capturing the decode graphs...", file=sys.stderr)
        for b, secs in service.warmup(start_worker=False):
            print(f"  bucket {b:>5}: {secs:.1f}s", file=sys.stderr)
        return 0
    print("warming up decode buckets...", file=sys.stderr)
    service.warmup()
    server = _Server(("0.0.0.0", args.port), make_handler(service))
    print(f"serving on :{args.port} (buckets {service.buckets})", file=sys.stderr)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
