"""Cross-request micro-batching for the feed-forward text-style path,
ported from ``tbist_tpu.api.batching``.

The reference runs every request alone (app.py:116-740,
text/FastTextTransfer.py:36-66). Both sub-networks of the fast text path
are batch-first, so N concurrent requests of one image shape can be one
batched call instead of N. Server threads ``submit()`` their (image,
prompt) and block; one daemon worker drains the queue into groups of one
shape and dtype within a short window and answers up to ``max_batch``
requests with one ``perform_transfer_batch`` call. Batching changes the
scheduling, not the outputs.
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from tbist_tpu_torch.utils.config import EffectRequest

# every live batcher, so that tests and shutdown can stop worker threads
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


def close_all() -> None:
    """Stop every live batcher's worker thread."""
    for b in list(_LIVE):
        b.close()


def eligible(req: EffectRequest) -> bool:
    """True iff the request is exactly a feed-forward text stylization: any
    other stage (masks, pixel art, Gatys, palette, depth, grayscale) goes
    to the general pipeline."""
    t = req.text
    return (
        t is not None
        and bool(t.style_prompt)
        and not t.location_prompt
        and not t.texture_prompt
        and not req.grayscale
        and req.pixel_art is None
        and not req.style_transfer
        and not req.style_mixing
        and not req.color_palette
        and req.depth is None
    )


def dispatch_fast_text_batch(images: List[np.ndarray], prompts: List[str],
                             quantize_uint8: bool = False, device="cuda") -> torch.Tensor:
    """Stack host images and run one batched fast-text call on ``device``.

    uint8 rows stay uint8 through the upload and are cast on the device
    (f32 rows upload as they are); ``quantize_uint8`` quantizes the result
    on the device. Returns the device tensor: the caller reads it back."""
    from tbist_tpu_torch.effects import text_transfer as tt
    from tbist_tpu_torch.utils.imageio import to_uint8_device, upload

    x = upload(np.stack(images), device)
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
    out = tt.perform_transfer_batch(x, list(prompts))
    return to_uint8_device(out) if quantize_uint8 else out


class _Item:
    __slots__ = ("image", "prompt", "event", "result", "error", "batch_n")

    def __init__(self, image: np.ndarray, prompt: str):
        self.image = image  # (H, W, 3) float32 in [0, 1] or uint8
        self.prompt = prompt
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.batch_n = 0


class FastTextBatcher:
    """Coalesce concurrent fast-text requests into batched calls.

    max_batch: the largest batch per call (padded to a power of two inside
        ``perform_transfer_batch``).
    window_ms: how long the worker waits for companions after the first
        request arrives.
    device_lock: a lock the batched calls take, so that they serialize
        against other work on the device.
    quantize_uint8: return uint8 results, quantized on the device
        (clip(round(x*255))), which reads back 4x fewer bytes.
    device: where the calls run (default the card).
    """

    def __init__(self, max_batch: int = 8, window_ms: float = 4.0,
                 device_lock: Optional[threading.Lock] = None, quantize_uint8: bool = False,
                 device="cuda"):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1e3
        self.quantize_uint8 = bool(quantize_uint8)
        self.device = device
        self._device_lock = device_lock
        self._q: "queue.Queue[_Item]" = queue.Queue()
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self.batches_run = 0
        self.requests_served = 0
        self._batch_sizes: List[int] = []
        self._closed = False
        _LIVE.add(self)

    def submit(self, image: np.ndarray, prompt: str) -> np.ndarray:
        """Block until this request's result is ready: an (H, W, 3) float32
        array (uint8 with ``quantize_uint8``). ``image`` is host (H, W, 3)
        float32 in [0, 1], or uint8."""
        return self.submit_item(image, prompt).result

    def submit_item(self, image: np.ndarray, prompt: str) -> _Item:
        """Like :meth:`submit`, but returns the completed queue item, whose
        ``batch_n`` says how many requests shared the call."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) image, got {image.shape}")
        if image.dtype != np.uint8:
            image = image.astype(np.float32)
        self._ensure_worker()
        item = _Item(image, prompt)
        self._q.put(item)
        item.event.wait()
        if item.error is not None:
            # every waiter of a failed batch shares one exception object:
            # raise a shallow copy, so concurrent raises do not race on it
            raise copy.copy(item.error) from item.error
        return item

    @property
    def last_batch_sizes(self) -> List[int]:
        return list(self._batch_sizes)

    def close(self, timeout: float = 2.0) -> None:
        """Stop the worker thread once the queued work has drained;
        idempotent."""
        with self._lock:
            self._closed = True
            worker = self._worker
        if worker is not None and worker.is_alive():
            self._q.put(None)  # a sentinel wakes the blocking drain
            worker.join(timeout)

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._run, name="fast-text-batcher",
                                                daemon=True)
                self._worker.start()

    def _drain(self) -> List[_Item]:
        """One blocking get, then the companions that arrive inside the
        window. The ``None`` sentinel of :meth:`close` is dropped."""
        group = [self._q.get()]
        deadline = time.monotonic() + self.window_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                group.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return [g for g in group if g is not None]

    def _run(self) -> None:
        while True:
            if self._closed and self._q.empty():
                return
            group = self._drain()
            if not group:
                if self._closed:
                    return
                continue
            # one call per image shape AND dtype: np.stack over mixed
            # f32/uint8 rows would promote the 0-255 rows beside 0-1 ones
            by_shape: dict = {}
            for it in group:
                by_shape.setdefault((it.image.shape, it.image.dtype.str), []).append(it)
            for items in by_shape.values():
                self._run_batch(items)

    def _run_batch(self, items: List[_Item]) -> None:
        try:
            with self._device_lock or contextlib.nullcontext():
                out = dispatch_fast_text_batch([it.image for it in items],
                                               [it.prompt for it in items],
                                               self.quantize_uint8, self.device)
            out_np = out.cpu().numpy()  # the read-back, outside the lock
            self.batches_run += 1
            self.requests_served += len(items)
            self._batch_sizes.append(len(items))
            if len(self._batch_sizes) > 1024:  # bounded history
                del self._batch_sizes[:-256]
            for i, it in enumerate(items):
                it.result = out_np[i]
                it.batch_n = len(items)
        except BaseException as e:  # to every waiter
            for it in items:
                it.error = e
        finally:
            for it in items:
                it.event.set()
