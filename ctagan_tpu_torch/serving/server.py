"""HTTP synthesis service with micro-batching (``ctagan_tpu/serving/server.py``).

- ``POST /synthesize``: request body = one NCCT DICOM slice; response = the
  synthetic-CTA DICOM slice (same header, fresh SeriesInstanceUID).
- ``GET /healthz``: model status and rolling batch latency.

A collector thread drains the request queue up to ``max_batch`` (or
``batch_timeout_ms``) and runs one generator forward per batch under
``torch.inference_mode()`` on the service's own CUDA stream (or on the CPU).
With ``quantize="int8"`` the generator is quantized once at construction
and each batch runs ``ops/quantize.py::generator_int8_forward`` (the int8
residual body through K7).
Forwards are enqueued asynchronously; up to ``pipeline_depth`` batches stay
in flight, each synced by its device→host copy in ``_resolve``. Batches are
not padded to ``max_batch``: InstanceNorm is per sample, so a short batch
gives the same per-slice result (in int8 the per-tensor activation scales
span the batch, as in JAX, whose padded batches share them too). The DICOM codec and the host preprocessing
are the port's numpy modules (``data/dicom.py``, ``data/native.py``).
"""
from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ctagan_tpu_torch.data.dicom import dicom_bytes, generate_uid, read_dicom
from ctagan_tpu_torch.data.native import (
    dual_window_native,
    resize_nearest_native,
)


class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image  # (H, W, C) model-input context stack
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[str] = None


class _SeriesRing:
    """Per-series state for 2.5-D models: the last ``C`` preprocessed slices
    plus the requests waiting for their right-context to arrive."""

    __slots__ = ("slices", "pending", "count", "touched")

    def __init__(self):
        self.slices: "deque" = deque()  # (index, image), len kept <= C
        self.pending: "deque" = deque()  # (_Pending, center_index)
        self.count = 0
        self.touched = time.monotonic()


class SynthesisService:
    def __init__(
        self,
        g_model: torch.nn.Module,
        size: int = 512,
        max_batch: int = 16,
        batch_timeout_ms: float = 5.0,
        pipeline_depth: int = 2,
        quantize: str = "",
        channels: int = 1,
    ):
        if channels % 2 != 1:
            raise ValueError("channels (context_slices) must be odd")
        if quantize == "int8":
            from ctagan_tpu_torch.ops.quantize import (
                generator_int8_forward,
                quantize_generator,
            )

            qparams = quantize_generator(g_model)
            self._fwd = lambda x: generator_int8_forward(qparams, x)
        elif quantize:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        else:
            self._fwd = g_model
        g_model.eval()
        self.device = next(g_model.parameters()).device
        self.size = size
        self.channels = channels
        self._rings: dict = {}
        self._ring_lock = threading.Lock()
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1e3
        self.pipeline_depth = max(1, pipeline_depth)
        self.quantize = quantize
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._latencies = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        # warm-up forward: builds the kernels and picks the conv algorithms
        warm = np.zeros((1, size, size, channels), np.float32)
        self._fetch(self._forward(warm))
        self._worker.start()

    def _stream_ctx(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _forward(self, x: np.ndarray) -> torch.Tensor:
        """Enqueue one batch's forward; returns the (not yet synced) output."""
        with self._stream_ctx(), torch.inference_mode():
            xt = torch.from_numpy(x).to(self.device, non_blocking=True)
            return self._fwd(xt)

    def _fetch(self, y: torch.Tensor) -> np.ndarray:
        """Device→host copy of a forward's output; waits for the batch."""
        with self._stream_ctx(), torch.inference_mode():
            return y.float().cpu().numpy()

    def _resolve(self, item):
        """Sync one in-flight batch and wake its waiters."""
        batch, y_dev, t0 = item
        try:
            y = self._fetch(y_dev)
            for i, p in enumerate(batch):
                p.result = y[i, :, :, 0]
                p.event.set()
        except Exception as e:  # device-side failure surfaces at sync
            for p in batch:
                p.error = repr(e)
                p.event.set()
        with self._lock:
            self._latencies.append(time.perf_counter() - t0)
            if len(self._latencies) > 200:
                self._latencies.pop(0)

    def _run(self):
        inflight: "deque" = deque()
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1 if not inflight else 0.0)
            except queue.Empty:
                if inflight:  # idle: drain the pipeline
                    self._resolve(inflight.popleft())
                continue
            batch = [first]
            deadline = time.perf_counter() + self.batch_timeout
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            t0 = time.perf_counter()
            try:
                x = np.stack([p.image for p in batch])  # (b, H, W, C)
                inflight.append((batch, self._forward(x), t0))
            except Exception as e:  # host-side failure (bad shapes etc.)
                for p in batch:
                    p.error = repr(e)
                    p.event.set()
            while len(inflight) > self.pipeline_depth:
                self._resolve(inflight.popleft())
        while inflight:  # stop(): don't leave waiters hanging until timeout
            self._resolve(inflight.popleft())

    def _context_window(self, ring: _SeriesRing, center: int, hi: int):
        """Centered context for ``center``, offsets clamped into the received
        range [oldest, hi] (``PairedSliceDataset._load_context``)."""
        half = self.channels // 2
        by_idx = dict(ring.slices)
        lo = ring.slices[0][0]
        return np.stack(
            [by_idx[min(max(center + off, lo), hi)]
             for off in range(-half, half + 1)],
            axis=-1,
        )

    def _enqueue_series(self, image, series: str, last: bool) -> _Pending:
        """2.5-D streaming: ring the slice and dispatch every request whose
        centered context is complete (slice i leaves when slice i + C//2
        arrives, or at once on ``last``, with the end-of-series clamp)."""
        half = self.channels // 2
        p = _Pending(None)
        ready = []
        with self._ring_lock:
            ring = self._rings.setdefault(series, _SeriesRing())
            ring.touched = time.monotonic()
            i = ring.count
            ring.count += 1
            ring.slices.append((i, image))
            while len(ring.slices) > self.channels:
                ring.slices.popleft()
            ring.pending.append((p, i))
            while ring.pending and (last or ring.pending[0][1] + half <= i):
                q, c = ring.pending.popleft()
                q.image = self._context_window(ring, c, i)
                ready.append(q)
            if last:
                del self._rings[series]
            elif len(self._rings) > 512:  # abandoned-stream GC
                stale = min(self._rings, key=lambda k: self._rings[k].touched)
                if stale != series:
                    for q, _c in self._rings[stale].pending:
                        q.error = "series evicted (abandoned stream)"
                        q.event.set()
                    del self._rings[stale]
        for q in ready:
            self._queue.put(q)
        return p

    def synthesize(self, image: np.ndarray, timeout: float = 60.0,
                   series: Optional[str] = None,
                   last: bool = False) -> np.ndarray:
        """Synthesize one slice. 2.5-D models (``channels`` > 1) stream a
        series with ``series`` (C//2 slices of lag, flushed by ``last``);
        without it the slice is a one-slice series (C copies)."""
        img = np.asarray(image, np.float32)
        if self.channels == 1:
            p = _Pending(img[..., None])
            self._queue.put(p)
        elif series is None:
            p = _Pending(np.repeat(img[..., None], self.channels, -1))
            self._queue.put(p)
        else:
            p = self._enqueue_series(img, str(series), last)
        if not p.event.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    def stats(self):
        with self._lock:
            lats = list(self._latencies)
        return {
            "batches_served": len(lats),
            "p50_batch_ms": float(np.median(lats) * 1e3) if lats else None,
            "max_batch": self.max_batch,
            "pipeline_depth": self.pipeline_depth,
            "quantize": self.quantize or None,
            "size": self.size,
            "device": str(self.device),
        }

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        self._worker.join(timeout)


def _make_handler(service: SynthesisService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                body = json.dumps({"status": "ok", **service.stats()})
                self._reply(200, body.encode(), "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/synthesize":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                ds = read_dicom(self.rfile.read(n))
                _, full = dual_window_native(ds.pixel_array())
                orig = full.shape[0]
                if full.shape != (service.size, service.size):
                    full = resize_nearest_native(
                        np.ascontiguousarray(full, np.float32), service.size)
                # 2.5-D streaming: X-Series-UID groups a stream (default: the
                # slice's own SeriesInstanceUID); X-Last-Slice: 1 flushes it
                series = self.headers.get("X-Series-UID") or getattr(
                    ds, "series_instance_uid", None)
                last = self.headers.get("X-Last-Slice", "0") == "1"
                if service.channels > 1 and self.headers.get(
                        "X-Single-Slice", "0") == "1":
                    series = None  # stateless: replicate-context
                fake = service.synthesize(full, series=series, last=last)
                if fake.shape[0] != orig:
                    fake = resize_nearest_native(
                        np.ascontiguousarray(fake, np.float32), orig)
                ds.set_pixel_data((fake + 1.0) * 0.5 * 4095.0)
                ds.series_instance_uid = generate_uid()
                self._reply(200, dicom_bytes(ds), "application/dicom")
            except Exception as e:  # request boundary: report, keep serving
                msg = json.dumps({"error": repr(e)}).encode()
                self._reply(400, msg, "application/json")

    return Handler


def _service(g_model, size, max_batch, pipeline_depth, quantize, channels):
    return SynthesisService(g_model, size=size, max_batch=max_batch,
                            pipeline_depth=pipeline_depth, quantize=quantize,
                            channels=channels)


def serve(g_model, host: str = "127.0.0.1", port: int = 8080,
          size: int = 512, max_batch: int = 16, pipeline_depth: int = 2,
          quantize: str = "", channels: int = 1):
    """Run the synthesis HTTP server in this thread (blocking)."""
    service = _service(g_model, size, max_batch, pipeline_depth, quantize,
                       channels)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    try:
        server.serve_forever()
    finally:
        server.server_close()
        service.stop()


def serve_async(g_model, host: str = "127.0.0.1", port: int = 0,
                size: int = 512, max_batch: int = 16,
                pipeline_depth: int = 2, quantize: str = "",
                channels: int = 1):
    """Start the server in a background thread; returns (server, service,
    port). Stop with ``server.shutdown(); server.server_close();
    service.stop()``."""
    service = _service(g_model, size, max_batch, pipeline_depth, quantize,
                       channels)
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, service, server.server_address[1]
