"""Video pipeline, ported from ``tbist_tpu.video.video``: decode → batched
effects on the card → cross-dissolve → encode.

Reference: app.py:742-864, a sequential per-frame loop that writes every
frame to a temp JPG, re-reads it, runs the image pipeline, then optionally
inserts cross-dissolve frames and changes the fps.

Every path streams with constant host memory in video length: a decode-ahead
thread (``_Prefetch``), the chunk's work queued on the card, the
cross-dissolve on the card per chunk (``_dissolve_step``), an ordered
read-back into pinned memory (``_FetchPipeline``) and a streaming encode on
that read-back's thread (``_StreamWriter``). The main thread never waits for
a chunk's result before it queues the next chunk. Pure requests ride lanes
that take a whole chunk as one batch: the Gatys lanes (one style, two-style
mixing, the depth loss; ``parallel.batched``, K1 and K3), the feed-forward
text style, and the masked text style (one DINO and one SAM encoder call a
chunk, K4). Chains of per-image device stages (grayscale, pixel art, colour
palette) send a chunk through one ``apply_image`` call; the rest run frame
by frame.

On two or more cards every lane splits a chunk's frames over the dp
production mesh (``parallel.mesh``), as the JAX package does: the chunk is
at least one frame a card (``_chunk_size``), each card runs its frames with
its own replica of the models (Ghiasi; DINO and SAM, so K4 runs on each
card; VGG-19 through ``parallel.batched``), and the results come back to the
first card in frame order for the dissolve and the ordered read-back. The
JAX package pads every chunk to one compiled shape by repeating its last
frame; a chunk here runs its real frames only, split unevenly where it must:
the eager port compiles nothing, and in a Gatys lane a pad frame would be
400 L-BFGS steps of VGG-19 spent on a copy.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import queue
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from tbist_tpu_torch.compose import pipeline as pipe
from tbist_tpu_torch.ops import masks as mask_ops
from tbist_tpu_torch.parallel import mesh as mesh_lib
from tbist_tpu_torch.utils.config import EffectRequest
from tbist_tpu_torch.utils.imageio import (
    bucket_shape,
    image_resize_bilinear,
    resolve_device,
    to_uint8_device,
    upload,
)
from tbist_tpu_torch.utils.logging import RunMetrics, logger
from tbist_tpu_torch.utils.precision import full_f32


def read_frames(video_path: str, max_frames: Optional[int] = None):
    """Decode to (frames list of HxWx3 uint8 RGB, fps)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    return frames, fps


def probe_fps(video_path: str) -> float:
    """Container fps without decoding any frames."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    cap.release()
    return fps


def read_frame_chunks(video_path: str, chunk_size: int, max_frames: Optional[int] = None,
                      rgb: bool = True):
    """Decode ``chunk_size`` frames at a time: (B, H, W, 3) uint8 chunks, with
    constant memory in video length. ``rgb=False`` keeps cv2's native BGR
    (the text lane flips channels on the card and saves the host one
    cvtColor per frame each way)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    try:
        buf: List[np.ndarray] = []
        n = 0
        while cap.isOpened():
            ret, frame = cap.read()
            if not ret:
                break
            buf.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if rgb else frame)
            n += 1
            if len(buf) == chunk_size:
                yield np.stack(buf)
                buf = []
            if max_frames and n >= max_frames:
                break
        if buf:
            yield np.stack(buf)
    finally:
        cap.release()


class _Prefetch:
    """Decode-ahead: pull chunks from a generator on ONE worker thread with a
    bounded queue. cv2's decode releases the GIL, so the next chunk decodes
    while the main thread queues the current one on the card."""

    _END = object()

    def __init__(self, gen, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = False

        def run():
            try:
                for item in gen:
                    while not self._stop:
                        try:
                            self._q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stop:
                        gen.close()  # release the cv2 capture promptly
                        break
            except BaseException as e:  # re-raised on the consumer side
                self._err = e
            finally:
                while True:  # END must land even if the queue is full
                    try:
                        self._q.put(self._END, timeout=0.1)
                        break
                    except queue.Full:
                        if self._stop:
                            break

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._t.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Abort: unblock and join the worker (a consumer that stops early
        would otherwise leave it, and its cv2 capture, pinned on a full
        queue)."""
        self._stop = True
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=5)


def _open_writer(out_path: str, fps: float, w: int, h: int):
    import cv2

    for codec in ("avc1", "mp4v"):
        out = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*codec), fps, (w, h))
        if out.isOpened():
            return out
    raise RuntimeError(f"no usable mp4 codec (tried avc1, mp4v) for {out_path}")


def write_video(frames: List[np.ndarray], fps: float, out_path: str) -> str:
    import cv2

    h, w = frames[0].shape[:2]
    out = _open_writer(out_path, fps, w, h)
    for f in frames:
        out.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    out.release()
    return out_path


class _StreamWriter:
    """Encode (B, H, W, 3) uint8 chunks as they arrive. Opened lazily on the
    first chunk: the processed frame size is not known up front."""

    def __init__(self, out_path: str, fps: float, bgr: bool = False):
        self._out_path = out_path
        self._fps = fps
        self._wr = None
        self._bgr = bgr  # chunks arrive BGR (the card flipped them): no cvtColor

    def __call__(self, chunk: np.ndarray) -> None:
        import cv2

        if self._wr is None:
            h, w = chunk.shape[1:3]
            self._wr = _open_writer(self._out_path, self._fps, w, h)
        for f in chunk:
            self._wr.write(f if self._bgr else cv2.cvtColor(f, cv2.COLOR_RGB2BGR))

    def close(self) -> None:
        if self._wr is not None:
            self._wr.release()


def _alphas(k: int) -> torch.Tensor:
    """The k blend weights (i+1)/(k+1), as float32 on the CPU (reference
    app.py:820-838)."""
    return torch.tensor([(i + 1) / (k + 1) for i in range(k)], dtype=torch.float32)


def cross_dissolve(frames: List[np.ndarray], k: int) -> List[np.ndarray]:
    """Insert k interpolated frames between every consecutive pair of host
    frames, as the JAX package's ``cross_dissolve``: its eager ops round each
    product and the sum to f32, then clip and truncate to uint8."""
    if k <= 0 or len(frames) < 2:
        return frames
    a = _alphas(k)[None, :, None, None, None]
    prev = torch.from_numpy(np.stack(frames[:-1])).float()[:, None]
    nxt = torch.from_numpy(np.stack(frames[1:])).float()[:, None]
    interp = (prev * (1.0 - a) + nxt * a).clamp(0, 255).to(torch.uint8).numpy()
    out = [frames[0]]
    for i in range(len(frames) - 1):
        out.extend(interp[i])
        out.append(frames[i + 1])
    return out


def _dissolve_chunk(prev_u8: torch.Tensor, chunk_u8: torch.Tensor, k: int) -> torch.Tensor:
    """The cross-dissolve of one chunk on its device: for each consecutive
    pair (prev, c0), (c0, c1), ... k blended frames, then the right frame;
    (B, H, W, C) uint8 -> (B·(k+1), H, W, C) uint8.

    The JAX package's jitted version (``_dissolve_chunk_jit``) fuses the
    blend into fma(prev, 1-a, round_f32(next·a)): one rounding for the first
    product and the sum. In f64 that product and sum are exact (8-bit
    integers times 24-bit fractions), so rounding the f64 result to f32 gives
    the fma's bits on any device; a plain f32 blend misses them by one level
    on about 2% of the pixels at some k. Clip, then truncate as XLA's
    float-to-uint8 convert does."""
    a = upload(_alphas(k), chunk_u8.device)[None, :, None, None, None]  # no host sync
    prevs = torch.cat([prev_u8, chunk_u8[:-1]]).float()[:, None]
    nxt_a = chunk_u8.float()[:, None] * a
    interp = (prevs.double() * (1.0 - a).double() + nxt_a.double()).float()
    interp = interp.clamp(0, 255).to(torch.uint8)
    out = torch.cat([interp, chunk_u8[:, None]], 1)  # (B, k+1, H, W, C)
    return out.reshape((-1,) + tuple(chunk_u8.shape[1:]))


def _dissolve_step(prev: Optional[torch.Tensor], chunk_u8: torch.Tensor, k: int,
                   first: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One streaming dissolve step over a chunk of real frames. Returns (the
    frames to emit, the carry frame for the next chunk's boundary pair)."""
    if first:  # no left boundary: self-pairs give k copies of c0 before it
        prev = chunk_u8[:1]
    out = _dissolve_chunk(prev, chunk_u8, k)
    if first:
        out = out[k:]
    return out, chunk_u8[-1:]


def _u8_chunk(out: torch.Tensor) -> torch.Tensor:
    """Quantize a pipeline output chunk to uint8 on its device before the
    read-back (4x fewer bytes than f32); integer outputs pass through."""
    return to_uint8_device(out) if out.is_floating_point() else out


class _FetchPipeline:
    """Ordered device→host read-back with the encode off the main thread.

    ``submit`` queues the copy of a chunk's uint8 result into pinned host
    memory on the card's stream (``non_blocking``, behind a CUDA event) and
    returns; one worker thread waits for each event in submission order and
    hands the frames to ``emit`` (the stream writer, whose cv2 encode
    releases the GIL). At most ``window`` chunks wait between the two, which
    bounds the pinned memory of a long video. PyTorch's caching host
    allocator gives back the same pinned block for every chunk of one shape.
    A CPU tensor is handed over as it is. ``close`` flushes the tail in
    order and re-raises the first error of ``emit``."""

    def __init__(self, emit, window: int = 4):
        self._ex = ThreadPoolExecutor(max_workers=1)
        self._futs: List = []
        self._emit = emit
        self._window = window

    def _wait_emit(self, event, host: torch.Tensor) -> None:
        if event is not None:
            event.synchronize()
        self._emit(host.numpy())

    def submit(self, res: torch.Tensor) -> None:
        event = None
        if res.device.type == "cuda":
            host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
            host.copy_(res, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = res
        self._futs.append(self._ex.submit(self._wait_emit, event, host))
        while len(self._futs) > self._window:
            self._futs.pop(0).result()

    def close(self) -> None:
        try:
            for f in self._futs:
                f.result()
            self._futs = []
        finally:
            self._ex.shutdown(wait=True)


def _is_pure_style_request(req: EffectRequest) -> bool:
    return (
        req.style_transfer
        and not req.grayscale
        and req.text is None
        and req.pixel_art is None
        and not req.style_mixing
        and not req.color_palette
        and req.depth is None
    )


def _is_pure_mixing_request(req: EffectRequest) -> bool:
    """Style mixing with no other stages: the Gatys lanes take it with the
    feature-space mixed target Gram of the image path (reference two-style
    mixing, app.py:472-590, per frame at app.py:784-815)."""
    return (
        req.style_mixing
        and not req.grayscale
        and req.text is None
        and req.pixel_art is None
        and not req.style_transfer
        and not req.color_palette
        and req.depth is None
    )


def _is_pure_masked_text_request(req: EffectRequest) -> bool:
    """Masked text style (a style prompt with a location and/or texture mask)
    and no other stages: the masked-text lane takes it, one Ghiasi forward and
    one DINO + SAM extraction a chunk (the reference runs TextMaskExtractor
    and the transfer per frame, text/TextMaskExtractor.py:25-68 inside
    app.py:784-815). Mask preprocess options other than the defaults (crop,
    square, resize) are per-frame host work and stay on the general path."""
    t = req.text
    return (
        t is not None
        and bool(t.style_prompt)
        and (bool(t.location_prompt) or bool(t.texture_prompt))
        and tuple(t.mask_crop) == (0, 0, 0, 0)
        and not t.mask_square
        and not tuple(t.mask_resize)
        and not req.grayscale
        and req.pixel_art is None
        and not req.style_transfer
        and not req.style_mixing
        and not req.color_palette
        and req.depth is None
    )


def _is_pure_depth_request(req: EffectRequest) -> bool:
    """Depth-loss stylization with no other stages: the Gatys lanes take it,
    each frame with its own depth target and the depth term in its loss
    (reference depth mode over video, app.py:660-735 inside :784-815). MIP
    stays on the per-frame general path (its layer decomposition and
    reconstruction are host-orchestrated, ``effects.depth.style_mip``)."""
    return (
        req.depth is not None
        and req.depth.mode == "depth_loss"
        and not req.grayscale
        and req.text is None
        and req.pixel_art is None
        and not req.style_transfer
        and not req.style_mixing
        and not req.color_palette
    )


def _is_pure_text_transfer_request(req: EffectRequest) -> bool:
    return (
        req.text is not None
        and bool(req.text.style_prompt)
        and not req.text.location_prompt
        and not req.text.texture_prompt
        and not req.grayscale
        and req.pixel_art is None
        and not req.style_transfer
        and not req.style_mixing
        and not req.color_palette
        and req.depth is None
    )


def _is_batchable_chain(req: EffectRequest) -> bool:
    """Chains whose every stage is a per-image device function with no
    per-frame host work: grayscale, pixel art and colour palette in any
    combination, with no text masks. A whole (B, H, W, 3) chunk goes through
    ONE ``apply_image`` call; per-image semantics hold because Reinhard's
    statistics reduce per image and pixel art quantizes and edges per frame."""
    return (
        req.text is None
        and not req.style_transfer
        and not req.style_mixing
        and req.depth is None
    )


def _chunk_size(frame_batch: int, dp: int = 1) -> int:
    """Frames a chunk: ``frame_batch``, at least one a dp card, rounded up to
    a multiple of dp (``tbist_tpu/video/video.py:678-684``)."""
    bsz = max(frame_batch, dp)
    return -(-bsz // dp) * dp


def _lane_cards(device) -> List[torch.device]:
    """The cards a lane splits its chunks over: the dp production mesh's,
    or ``device`` alone."""
    mesh = mesh_lib.production_mesh(device, dp_only=True)
    if mesh is None:
        return [device]
    logger.info("video: frames split over dp=%d cards", mesh.shape[mesh_lib.DP_AXIS])
    return [row[0] for row in mesh.devices]


def _split(x: torch.Tensor, cards: List[torch.device]) -> List[Tuple[torch.Tensor, torch.device]]:
    """A chunk's frames cut over ``cards`` (unevenly where they must), each
    part on its card."""
    return [(x[a:b].to(d, non_blocking=True), d)
            for (a, b), d in zip(mesh_lib.split_lanes(x.shape[0], len(cards)), cards)]


def _gather(parts: List[torch.Tensor], device) -> torch.Tensor:
    """The parts' frames on ``device``, in order."""
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def _iter_chunks(stack: np.ndarray, bsz: int):
    for i in range(0, stack.shape[0], bsz):
        yield stack[i : i + bsz]


def _run_lane(chunk_iter, sink, dissolve_k: int, process) -> Optional[List[np.ndarray]]:
    """The loop every lane shares: ``process(i, chunk)`` queues a chunk's
    uint8 result on the card; the dissolve (with ``dissolve_k``) and the
    ordered read-back follow. ``sink`` receives each (B, H, W, 3) uint8
    chunk in order; without one the frames are collected and returned."""
    outs: List[np.ndarray] = []
    fetches = _FetchPipeline(sink if sink is not None else outs.extend)
    prev = None
    try:
        for i, raw in enumerate(chunk_iter):
            res = process(i, raw)
            if dissolve_k:
                res, prev = _dissolve_step(prev, res, dissolve_k, i == 0)
            fetches.submit(res)
            logger.info("video: dispatched chunk %d (%d frames)", i, res.shape[0])
    finally:
        fetches.close()
    return None if sink is not None else outs


def _style_vector(registry: pipe.ModelRegistry, prompt: str, device):
    """(Ghiasi params, the prompt's (1, 100) style vector): the prompt is
    embedded once for the whole video (the reference re-runs CLIP per frame
    through the image pipeline, app.py:794)."""
    from tbist_tpu_torch.effects import text_transfer as tt
    from tbist_tpu_torch.models import clip_mlp, clip_text

    registry.ensure("text_transfer")  # for the degraded flags of the loaders below
    g_params, m_params = tt.default_params(device)
    emb = tt._pooled_embedding(prompt, clip_text.get_default_encoder(device), device)
    with full_f32():
        return g_params, clip_mlp.apply(m_params, emb)


def _text_fwd_f32(g_params, chunk_u8: torch.Tensor, style: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """uint8 frames -> Ghiasi -> f32 styled frames, one batched forward."""
    from tbist_tpu_torch.models import ghiasi

    x = chunk_u8.float() / 255.0
    with full_f32():
        return ghiasi.apply(g_params, x, style.expand(x.shape[0], -1), compute_dtype=dtype)


def _text_fwd_u8(g_params, chunk_u8: torch.Tensor, style: torch.Tensor, dtype: torch.dtype,
                 bgr: bool = False) -> torch.Tensor:
    """uint8 frames -> Ghiasi -> uint8. ``bgr``: frames arrive and leave in
    cv2's native BGR, flipped on the card."""
    if bgr:
        chunk_u8 = chunk_u8.flip(-1)
    out = to_uint8_device(_text_fwd_f32(g_params, chunk_u8, style, dtype))
    return out.flip(-1) if bgr else out


def _batched_text_transfer(frames: Optional[List[np.ndarray]], req: EffectRequest, sink=None,
                           chunk_iter=None, bgr: bool = False, dissolve_k: int = 0,
                           registry: Optional[pipe.ModelRegistry] = None,
                           device="cuda") -> Optional[List[np.ndarray]]:
    """Feed-forward Ghiasi stylization of all frames, one batched forward a
    chunk of ``req.video.frame_batch`` frames.

    ``frames``: host uint8 frames, or None with ``chunk_iter``, an iterator
    of (B, H, W, 3) uint8 chunks (streaming decode). ``bgr``: chunks are
    cv2-native BGR and the emitted chunks stay BGR. ``sink`` and
    ``dissolve_k``: see ``_run_lane``."""
    from tbist_tpu_torch.effects import text_transfer as tt

    device = resolve_device(device)
    registry = registry or pipe.ModelRegistry(device=device)
    g_params, style = _style_vector(registry, req.text.style_prompt, device)
    cd = tt.compute_dtype()  # TBIST_GHIASI_BF16: bf16 activations unless "0"
    cards = _lane_cards(device)
    g_reps = mesh_lib.replicas_of(g_params)  # one copy a card, kept
    if chunk_iter is None:
        chunk_iter = _iter_chunks(np.stack(frames), _chunk_size(req.video.frame_batch,
                                                                len(cards)))

    def process(i, raw):
        x = upload(raw, device)
        if len(cards) == 1:
            return _text_fwd_u8(g_params, x, style, cd, bgr)
        return _gather([_text_fwd_u8(g_reps.on(d), part, style.to(d), cd, bgr)
                        for part, d in _split(x, cards)], device)

    return _run_lane(chunk_iter, sink, dissolve_k, process)


def _composite_loc_u8(chunk_u8, styled, masks, edge: int) -> torch.Tensor:
    x = chunk_u8.float() / 255.0
    return to_uint8_device(mask_ops.composite_by_masks_batch(x, styled, masks, edge))


def _composite_emoji_u8(chunk_u8, styled, seg_masks, emoji, blur: int, step: float,
                        strength: float) -> torch.Tensor:
    x = chunk_u8.float() / 255.0
    return to_uint8_device(mask_ops.emoji_composite_batch(x, styled, seg_masks, emoji, blur,
                                                          step, strength))


def _composite_shared_u8(chunk_u8, styled, m) -> torch.Tensor:
    x = chunk_u8.float() / 255.0
    return to_uint8_device(x * (1.0 - m) + styled * m)


def _batched_masked_text(req: EffectRequest, registry: Optional[pipe.ModelRegistry],
                         sink=None, chunk_iter=None, dissolve_k: int = 0,
                         device="cuda") -> Optional[List[np.ndarray]]:
    """The masked text style over video, a chunk at a time: ONE Ghiasi
    forward styles the chunk, ONE ``batch_mask_extractor`` call gives its
    location masks (one DINO and one SAM encoder call,
    ``models.dino_sam.extract_masks_batch``), and the composite runs on the
    card. The Ghiasi forward is queued before the extractor, so the card runs
    it while the host waits for DINO's logits. With a texture prompt and no
    location prompt the merged stencil mask does not depend on the frame
    (the segmentation mask is all ones): it is computed once and broadcast."""
    from tbist_tpu_torch.effects import masking as masking_fx
    from tbist_tpu_torch.effects import text_transfer as tt

    device = resolve_device(device)
    registry = registry or pipe.ModelRegistry(device=device)
    tcfg = req.text
    g_params, style = _style_vector(registry, tcfg.style_prompt, device)
    cd = tt.compute_dtype()
    has_l, has_x = bool(tcfg.location_prompt), bool(tcfg.texture_prompt)
    extract = registry.ensure("batch_mask_extractor").batch_mask_extractor if has_l else None
    emoji = None
    if has_x:
        emoji = upload(registry.ensure("emoji_extractor").emoji_extractor(tcfg.texture_prompt),
                       device)
    blur, step = int(tcfg.emoji_blur_strength), float(tcfg.emoji_step_size)
    cards = _lane_cards(device)
    g_reps = mesh_lib.replicas_of(g_params)
    shared = {}  # card -> the frame-independent stencil mask (texture, no location)

    def on_card(chunk, d):
        styled = _text_fwd_f32(g_reps.on(d), chunk, style.to(d), cd)
        if has_l:
            masks = upload(extract(chunk, tcfg.location_prompt,
                                   **masking_fx._detection_kwargs(tcfg)), d)
            if has_x:
                return _composite_emoji_u8(chunk, styled, masks, emoji.to(d), blur, step,
                                           tcfg.emoji_style_strength)
            return _composite_loc_u8(chunk, styled, masks, int(tcfg.edge_smoothing))
        return _composite_shared_u8(chunk, styled, shared[d])

    def process(i, raw):
        chunk = upload(raw, device)
        if not has_l and not shared:
            merged = mask_ops.merge_content_style_masks(
                torch.ones(chunk.shape[1:3], dtype=torch.bool, device=device), emoji, blur, step)
            m = torch.clamp(merged * tcfg.emoji_style_strength, 0.0, 1.0)[None, ..., None]
            shared.update({d: m.to(d) for d in cards})
        if len(cards) == 1:
            return on_card(chunk, device)
        # a thread a card: the extractor waits on its own card's DINO logits
        parts = _split(chunk, cards)
        return _gather(mesh_lib.on_devices(lambda j, d: on_card(parts[j][0], d),
                                           [d for _, d in parts]), device)

    return _run_lane(chunk_iter, sink, dissolve_k, process)


def _batched_style(frames: Optional[List[np.ndarray]], req: EffectRequest,
                   inputs: pipe.EffectInputs, registry: Optional[pipe.ModelRegistry],
                   sink=None, chunk_iter=None, dissolve_k: int = 0,
                   styles: Optional[Tuple] = None, depth: bool = False,
                   device="cuda") -> Optional[List[np.ndarray]]:
    """Gatys stylization of video frames, a chunk's frames as the lanes of
    ``parallel.batched.run`` (K1 and K3 once a step for all lanes), in place
    of the reference's one-frame-at-a-time loop (app.py:784-815). Frames are
    resized to their bucket shape and back, antialiased as
    ``jax.image.resize`` is.

    ``styles``: the style images; None takes ``(inputs.style_image,)``. Two
    styles run two-style mixing with ``cfg.style_img_weight``, the target
    Gram mixed in feature space as on the image path (reference
    StyleMixer.py:25-38 via app.py:472-590). ``depth``: the depth-loss mode
    (reference app.py:660-735 over video): each frame's depth target from
    ``registry.depth_estimator`` and the depth term in its loss, weighted by
    ``req.depth.w_depth`` (``optimize.gatys_depth``'s objective)."""
    from tbist_tpu_torch.parallel import batched

    device = resolve_device(device)
    registry = registry or pipe.ModelRegistry(device=device)
    vgg_params = registry.ensure("vgg_params").vgg_params
    cfg = req.gatys
    depth_fn = None
    if depth:
        cfg = dataclasses.replace(cfg, w_depth=req.depth.w_depth)
        depth_fn = registry.ensure("depth_estimator").depth_estimator

    mesh = mesh_lib.production_mesh(device, dp_only=True)
    if mesh is not None:
        logger.info("video: frames split over dp=%d cards", mesh.shape[mesh_lib.DP_AXIS])
    if chunk_iter is None:
        chunk_iter = _iter_chunks(np.stack(frames), _chunk_size(
            req.video.frame_batch, 1 if mesh is None else mesh.shape[mesh_lib.DP_AXIS]))
    chunk_iter = iter(chunk_iter)
    first = next(chunk_iter, None)
    if first is None:
        return None if sink is not None else []
    h, w = first.shape[1:3]
    chunk_iter = itertools.chain([first], chunk_iter)
    bh, bw = bucket_shape(h, w, cfg.shape_bucket, cfg.max_side)

    def bucket_style(s):
        s = s.to(device)
        sh, sw = bucket_shape(s.shape[1], s.shape[2], cfg.shape_bucket, cfg.max_side)
        return s if (sh, sw) == tuple(s.shape[1:3]) else image_resize_bilinear(s, (sh, sw))

    styles = tuple(bucket_style(s) for s in (styles or (inputs.style_image,)))

    def process(i, raw):
        x = upload(raw, device).float() / 255.0
        if (bh, bw) != (h, w):
            x = image_resize_bilinear(x, (bh, bw))
        res = batched.run(cfg, vgg_params, x, styles, depth_fn=depth_fn, device=device,
                          mesh=mesh)
        if (bh, bw) != (h, w):
            res = image_resize_bilinear(res, (h, w))
        return to_uint8_device(res)

    return _run_lane(chunk_iter, sink, dissolve_k, process)


def _lane_components(req: EffectRequest) -> List[str]:
    """The ``ModelRegistry`` fields a lane resolves for ``req``: the image
    path's, with the batch extractor in place of the single-frame one."""
    return ["batch_mask_extractor" if n == "mask_extractor" else n
            for n in pipe.needed_components(req)]


def apply_video(video_path: Optional[str], req: EffectRequest,
                inputs: Optional[pipe.EffectInputs] = None,
                registry: Optional[pipe.ModelRegistry] = None, out_path: Optional[str] = None,
                max_frames: Optional[int] = None, metrics: Optional[RunMetrics] = None,
                device="cuda") -> Optional[str]:
    """Process a video through the effect chain on ``device``. Returns the
    mp4's path, or None on invalid input (then no mp4 is left behind)."""
    if not video_path:
        return None
    device = resolve_device(device)
    inputs = inputs or pipe.EffectInputs()
    registry = registry or pipe.ModelRegistry(device=device)
    metrics = metrics if metrics is not None else RunMetrics()
    vcfg = req.video

    pure_style = _is_pure_style_request(req) and inputs.style_image is not None
    pure_text = _is_pure_text_transfer_request(req)
    pure_masked_text = _is_pure_masked_text_request(req)
    mix_styles = tuple(s for s in (inputs.style_image1, inputs.style_image2) if s is not None)
    pure_mixing = _is_pure_mixing_request(req) and len(mix_styles) > 0
    pure_depth = _is_pure_depth_request(req) and inputs.style_image is not None
    lane = pure_style or pure_text or pure_mixing or pure_masked_text or pure_depth

    fps = probe_fps(video_path)
    k = vcfg.interpolation_frames
    new_fps = fps * (k + 1) if k else fps
    if vcfg.slowmo:
        # floor as app.py:850-851; the max(1, ·) guard differs from the
        # reference on purpose (it writes fps=0 mp4s when floor(fps·speed)
        # is 0, e.g. 8 fps at 0.1x; PARITY.md)
        new_fps = max(1, math.floor(new_fps * vcfg.slowmo))
    if out_path is None:
        out_path = os.path.join(tempfile.mkdtemp(), "output_video.mp4")

    # the text lane stays in cv2's native BGR end to end (flipped on the card)
    mesh = mesh_lib.production_mesh(device, dp_only=True)
    bsz = _chunk_size(vcfg.frame_batch, 1 if mesh is None else mesh.shape[mesh_lib.DP_AXIS])
    chunks = _Prefetch(read_frame_chunks(video_path, bsz, max_frames, rgb=not pure_text))
    first = next(chunks, None)
    if first is None:
        chunks.close()
        return None
    chunk_iter = itertools.chain([first], chunks)
    writer = _StreamWriter(out_path, new_fps, bgr=pure_text)
    done = False
    try:
        if pure_text:
            _batched_text_transfer(None, req, sink=writer, chunk_iter=chunk_iter, bgr=True,
                                   dissolve_k=k, registry=registry, device=device)
        elif pure_masked_text:
            _batched_masked_text(req, registry, sink=writer, chunk_iter=chunk_iter,
                                 dissolve_k=k, device=device)
        elif lane:
            _batched_style(None, req, inputs, registry, sink=writer, chunk_iter=chunk_iter,
                           dissolve_k=k, styles=mix_styles if pure_mixing else None,
                           depth=pure_depth, device=device)
        elif not _general(req, inputs, registry, metrics, writer, chunk_iter, k, device):
            return None
        done = True
    finally:
        writer.close()
        chunks.close()
        if not done and os.path.exists(out_path):
            os.remove(out_path)  # never leave a partial mp4 behind
    if lane:  # the general path's apply_image calls record their own
        pipe.record_degraded(metrics, registry, _lane_components(req))
    return out_path


def _general(req: EffectRequest, inputs: pipe.EffectInputs, registry: pipe.ModelRegistry,
             metrics: RunMetrics, sink, chunk_iter, k: int, device) -> bool:
    """General effect chains, streaming like the lanes: a batchable chain
    (``_is_batchable_chain``) sends each chunk through ONE ``apply_image``
    call; other chains (per-frame host stages: text masks, Gatys with other
    stages, MIP) call it frame by frame. False when a call returns None
    (invalid input)."""
    batchable = _is_batchable_chain(req)

    def process(i, raw):
        x = upload(raw, device).float() / 255.0
        parts = [x] if batchable else [f[None] for f in x]
        outs = []
        for part in parts:
            out = pipe.apply_image(part, req, inputs, registry, metrics)
            if out is None:
                raise _Invalid
            outs.append(_u8_chunk(out))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    try:
        _run_lane(chunk_iter, sink, k, process)
    except _Invalid:
        return False
    return True


class _Invalid(Exception):
    """An ``apply_image`` call of the general path returned None."""
