"""Dynamic request batching onto a ladder of batch sizes (counterpart of the
query-bank lane of owlvit_tpu/serve.py `DetectorServer`).

  * Requests are batched onto a short ladder of batch sizes ("buckets"); a
    partial batch is zero-padded up to the smallest bucket that fits. Every
    image is independent in the forward pass (per-token LN and MLP,
    within-image attention), so pad rows cannot perturb real rows.
  * `max_delay_ms` bounds how long the first request of a batch waits for
    co-riders; `max_queue` sheds load with `ServerOverloaded`.
  * One dispatch thread owns the device. Per batch: the host images are
    packed into a pinned buffer, copied to the device without blocking, the
    forward + NMS is queued, and the packed [B, K*7] result is fetched, the
    one synchronisation of the batch. A completion thread unpacks results
    and resolves futures on the host.

Thresholds (confidence/IoU/top_k) are fixed per server. The zero-shot and
one-shot lanes, `bulk_detect` and the HTTP front end are not ported yet.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field

import numpy as np
import torch

from owlvit_tpu_torch.models import owlvit
from owlvit_tpu_torch.models.configs import OwlViTConfig
from owlvit_tpu_torch.ops import nms as nms_ops
from owlvit_tpu_torch.ops.preprocess import normalize_image


class ServerOverloaded(RuntimeError):
    """Raised by submit() when the request queue is at max_queue."""


@dataclass
class _Request:
    image: np.ndarray  # [S, S, 3] uint8, already model-sized
    orig_wh: tuple  # (w, h) of the client image, for box rescale
    future: Future = field(default_factory=Future)
    t_enqueue: float = field(default_factory=time.perf_counter)


def _size_to_model(image: np.ndarray, S: int) -> np.ndarray:
    """Validate + bicubic-resize one RGB uint8 image to the model's square
    input (HF image_processing_owlvit: square resize, no aspect
    preservation). PIL is imported only when a resize is needed."""
    if image.ndim != 3 or image.shape[-1] != 3:
        raise ValueError(f"expected [H, W, 3] RGB image, got {image.shape}")
    if image.shape[:2] != (S, S):
        from PIL import Image

        image = np.asarray(
            Image.fromarray(np.ascontiguousarray(image, np.uint8))
            .resize((S, S), Image.BICUBIC), np.uint8,
        )
    return np.ascontiguousarray(image, np.uint8)


def _flatten_bucket(chunk, bucket: int, S: int, out: np.ndarray | None = None
                    ) -> np.ndarray:
    """Pack <= bucket model-sized images into one [bucket, S*S*3] uint8 block,
    zero rows after the last image; into `out` when given."""
    flat = np.zeros((bucket, S * S * 3), np.uint8) if out is None else out
    for i, im in enumerate(chunk):
        flat[i] = im.reshape(-1)
    flat[len(chunk):] = 0
    return flat


def _fail_futures(batch, e: Exception) -> None:
    """set_exception on every request, tolerating futures a client already
    cancelled (set_exception then raises, which must not kill a worker)."""
    for req in batch:
        try:
            req.future.set_exception(e)
        except InvalidStateError:  # cancelled by its client
            continue


class DetectorServer:
    """Dynamically batched detection server over forward + NMS.

    Parameters
    ----------
    params, cfg : the detector (`owlvit.OwlViT`, e.g. from `owlvit.init` or
        `convert.from_jax_tree`) and its config.
    buckets : ascending batch sizes.
    max_delay_ms : how long the first request of a batch waits for more
        traffic before a partial (padded) batch goes out.
    confidence_threshold, iou_threshold, top_k : decode protocol
        (reference: 0.01 / 0.6 / 200).
    warmup : run every bucket once at startup (first-use costs, such as the
        kernel build, stay out of the first request).
    autostart : start the worker threads immediately. Tests pass False to
        enqueue a deterministic batch before starting.
    max_inflight : fetched batches waiting for the completion thread before
        the dispatch thread blocks.
    max_queue : admission bound; `submit` raises `ServerOverloaded` beyond it.
    device : where the model runs; params are moved there.
    """

    def __init__(
        self,
        params: owlvit.OwlViT,
        cfg: OwlViTConfig,
        *,
        buckets: tuple = (1, 8, 32),
        max_delay_ms: float = 5.0,
        confidence_threshold: float = 0.01,
        iou_threshold: float = 0.6,
        top_k: int = 200,
        warmup: bool = True,
        autostart: bool = True,
        max_inflight: int = 2,
        max_queue: int = 1024,
        device: torch.device | str = "cpu",
    ):
        if (not buckets or list(buckets) != sorted(set(buckets))
                or buckets[0] < 1):
            raise ValueError(f"buckets must be ascending unique >=1: {buckets}")
        # Serving is forward-only: the whole encoder is the frozen prefix
        # (k=0), which allows the fixed-shift softmax.
        self.cfg = cfg.replace(trainable_last_k=0, static_softmax=True)
        self.buckets = tuple(int(b) for b in buckets)
        self.max_delay_s = max_delay_ms / 1e3
        self.image_size = cfg.vision.image_size
        self.device = torch.device(device)
        self._params = params.to(self.device).eval()
        self._thresholds = dict(confidence_threshold=confidence_threshold,
                                iou_threshold=iou_threshold, top_k=top_k)
        self._top_k = top_k
        S = self.image_size
        # one host staging buffer per bucket, pinned so the copy is async
        pin = self.device.type == "cuda"
        self._staging = {
            b: torch.empty((b, S * S * 3), dtype=torch.uint8, pin_memory=pin)
            for b in self.buckets
        }
        self._q: queue.Queue = queue.Queue()
        self._max_queue = int(max_queue)
        self._done_q: queue.Queue = queue.Queue(maxsize=max(1, int(max_inflight)))
        self._lock = threading.Lock()  # stats and latency
        # submit() checks _stop and enqueues under this lock, and close()
        # sets _stop under it, so no request lands behind the stop sentinel
        self._submit_lock = threading.Lock()
        self._stats = {
            "requests": 0, "batches": 0, "padded_rows": 0,
            "bucket_counts": {b: 0 for b in self.buckets},
        }
        self._latency = deque(maxlen=10_000)  # seconds, submit -> result
        self._stop = threading.Event()
        self._threads: list = []
        if warmup:
            self._warmup()
        if autostart:
            self.start()

    # ------------------------------------------------------------- lifecycle

    def serve_batch(self, images_flat_u8: torch.Tensor) -> torch.Tensor:
        """[b, S*S*3] uint8 on the device -> packed detections [b, K*7] fp32
        on the device: normalize, forward, NMS, pack."""
        S = self.image_size
        b = images_flat_u8.shape[0]
        with torch.inference_mode():
            pixels = normalize_image(images_flat_u8.reshape(b, S, S, 3))
            boxes, sims = owlvit.forward_train(self._params, self.cfg, pixels)
            out = nms_ops.postprocess(boxes, sims, **self._thresholds)
            return nms_ops.pack_detections(out).reshape(b, -1)

    def _warmup(self):
        S = self.image_size
        for b in self.buckets:
            z = torch.zeros((b, S * S * 3), dtype=torch.uint8, device=self.device)
            self.serve_batch(z).cpu()

    def start(self):
        if self._threads:
            return
        for fn, name in [(self._dispatch_loop, "owlvit-serve-dispatch"),
                         (self._complete_loop, "owlvit-serve-complete")]:
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def close(self):
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)  # wake the dispatcher; nothing can follow it
        for t in self._threads:
            t.join(timeout=30)
        self._threads = []
        # requests the dispatcher never took (it was not started, or did
        # not stop in time) would otherwise hang their clients
        stranded = []
        try:
            while True:
                item = self._q.get_nowait()
                if item is not None:
                    stranded.append(item)
        except queue.Empty:
            pass
        _fail_futures(stranded, RuntimeError("DetectorServer closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- clients

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one RGB uint8 [H, W, 3] image; returns a Future.

        The future resolves to `{"boxes": [n, 4] xyxy in the original image's
        pixels, "scores": [n], "classes": [n]}` with only valid (post-NMS)
        detections. Images not model-sized are bicubic-resized on the host."""
        # shed load before paying for the resize
        if self._q.qsize() >= self._max_queue:
            raise ServerOverloaded(
                f"request queue at max_queue={self._max_queue}; retry later")
        h, w = image.shape[:2] if image.ndim == 3 else (0, 0)
        req = _Request(_size_to_model(image, self.image_size), (w, h))
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("DetectorServer is closed")
            self._q.put(req)
        return req.future

    def detect(self, image: np.ndarray, timeout: float | None = None) -> dict:
        """Synchronous convenience wrapper around `submit`."""
        return self.submit(image).result(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            lat = sorted(self._latency)
            out = {
                **{k: (dict(v) if isinstance(v, dict) else v)
                   for k, v in self._stats.items()},
                "queue_depth": self._q.qsize(),
            }
        if lat:
            pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
            out["latency_ms"] = {
                "p50": round(pick(0.50) * 1e3, 2),
                "p90": round(pick(0.90) * 1e3, 2),
                "p99": round(pick(0.99) * 1e3, 2),
                "n": len(lat),
            }
        return out

    # ----------------------------------------------------------- worker side

    def _dispatch_loop(self):
        # Dispatch when the largest bucket fills or the oldest request's
        # delay window expires; drain the queue greedily first, so a backlog
        # (already past its window) goes out as full batches, not one by one.
        max_b = self.buckets[-1]
        pend: deque = deque()
        stop = False
        while not stop or pend:
            timeout = (None if not pend else
                       max(0.0, pend[0].t_enqueue + self.max_delay_s
                           - time.perf_counter()))
            try:
                nxt = (self._q.get(timeout=timeout)
                       if timeout is None or timeout > 0
                       else self._q.get_nowait())
                while True:
                    if nxt is None:
                        stop = True
                        break
                    pend.append(nxt)
                    nxt = self._q.get_nowait()
            except queue.Empty:
                pass
            now = time.perf_counter()
            while pend and (len(pend) >= max_b or stop
                            or pend[0].t_enqueue + self.max_delay_s <= now):
                batch = [pend.popleft() for _ in range(min(len(pend), max_b))]
                try:
                    packed = self._dispatch(batch)
                except Exception as e:  # noqa: BLE001 — a device failure must
                    # reach the waiting clients, not hang their futures
                    _fail_futures(batch, e)
                    continue
                self._done_q.put((packed, batch))
        self._done_q.put(None)

    def _dispatch(self, batch: list) -> np.ndarray:
        """Stage, copy, run and fetch one batch -> packed [bucket, K*7]."""
        n = len(batch)
        bucket = next(b for b in self.buckets if b >= n)
        staging = self._staging[bucket]
        # the previous batch from this buffer was fetched (synchronised)
        # before this one, so its copy is done and the buffer is free
        _flatten_bucket([r.image for r in batch], bucket, self.image_size,
                        out=staging.numpy())
        dev = staging.to(self.device, non_blocking=True)
        packed = self.serve_batch(dev).cpu().numpy()  # the one sync
        with self._lock:
            self._stats["batches"] += 1
            self._stats["padded_rows"] += bucket - n
            self._stats["bucket_counts"][bucket] += 1
        return packed

    def _unpack_row(self, row: np.ndarray, orig_wh: tuple) -> dict:
        """Decode one image's packed [K, 7] block (boxes/score/class/valid)
        into the client result dict, boxes rescaled to original pixels."""
        keep = row[:, 6] > 0.5
        w, h = orig_wh
        return {
            "boxes": row[keep, :4] * np.array([w, h, w, h], np.float32),
            "scores": row[keep, 4],
            "classes": row[keep, 5].astype(np.int32),
        }

    def _complete_loop(self):
        # host-only: unpack fetched results and resolve futures
        while True:
            item = self._done_q.get()
            if item is None:
                return
            packed, batch = item
            now = time.perf_counter()
            packed = packed.reshape(packed.shape[0], self._top_k, 7)
            for i, req in enumerate(batch):
                try:
                    req.future.set_result(self._unpack_row(packed[i], req.orig_wh))
                except InvalidStateError:  # cancelled by its client; one
                    continue  # dead request must not stop this thread
            with self._lock:
                self._stats["requests"] += len(batch)
                self._latency.extend(now - r.t_enqueue for r in batch)
