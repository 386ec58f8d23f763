"""Profiling of the port (counterpart of ``tbist_tpu.utils.prof``).

``trace`` wraps ``torch.profiler`` around a block (CPU and CUDA activity,
optionally written as a Chrome trace). ``device_breakdown`` sums a trace's
GPU kernel time by kind and measures how much of the traced window the
device was busy.

Run as a script on a machine with a CUDA card to profile a path: Gatys
L-BFGS on boat.jpg x starry_night.jpg, SAM ViT-B ``predict_boxes`` at 1024²
on seeded weights (a 480x640 image, one box), the text-location chain
``models.dino_sam.extract_mask`` (seeded GroundingDINO SwinT-OGC and SAM
ViT-B, the same image, the prompt "boat"), or two cheap effects through
the pipeline (pixel art on face.jpg with a 10-colour k-means palette of
picasso2.png and Canny edges; Reinhard colour transfer of sea.png to
black_white_gradient.jpg), or the feed-forward text style through the
pipeline (boat.jpg at 512², prompt "mosaic", the seeded Ghiasi weights and
the prompt-seeded embedding, bf16 activations unless
``TBIST_GHIASI_BF16=0``), or depth-loss Gatys steps at 512px with the
torch-seeded Depth-Anything-V2-Small in the loss graph::

    python -m tbist_tpu_torch.utils.prof --size 512 --steps 30
    python -m tbist_tpu_torch.utils.prof --path sam --steps 10
    python -m tbist_tpu_torch.utils.prof --path text-location --steps 5
    python -m tbist_tpu_torch.utils.prof --path effects --steps 10
    python -m tbist_tpu_torch.utils.prof --path text-style --steps 20
    python -m tbist_tpu_torch.utils.prof --path depth --steps 10

It prints one JSON line: device time by kind and of the top kernels per
step (per call for SAM and text-location), CUDA calls per step that can
block the host, the device's busy share of the profiled window (the
profiler's own host cost included), and the rate of an unprofiled run of
the same length. For text-location it adds each layer's time per call
(CUDA events around the Swin backbone, the fusion layers, the encoder's and
the decoder's deformable attention, the whole DINO forward, SAM's encoder
and its decode), BERT's once per prompt, and the host's thresholding; for
pixel art, the k-means palette's, the quantizer's and Canny's time per call;
for the text style, the MLP's, each Ghiasi layer's, the instance norms' and
the read-back's, and the convolution kernels each Ghiasi layer launches with
its operands' dtype; for depth, the forward spans of Depth Anything and of
VGG-19 within the steps, each one's forward and input gradient alone, the
host's own readings over repeated runs (wall and CPU ms a step,
cudaMallocs, the card's SM clock and power; profiled, the busy share, the
host's waits and the device's copies a step), and the batched lanes of
MIP's batched plan (one lane and two: ms a step, and device time by kind
for two).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# kernel-name substrings -> kind, first match wins
_KINDS = (
    ("K4 sam attention (sam_attn.cu)", ("sam_attn_kernel", "sam_attn_combine_kernel")),
    ("K1 gram (gram.cu)", ("gram_fwd_kernel", "gram_reduce_kernel", "gram_bwd_kernel")),
    ("K3 relu-pool bwd (pool_bwd.cu)", ("pool_bwd_kernel",)),
    # DINO's deformable attention samples its value maps with F.grid_sample
    ("deformable sampling (grid_sample)", ("grid_sampler",)),
    ("sort (query selection)", ("RadixSort", "radixSort", "sortKeyValue", "SortKV")),
    ("max pool (Canny hysteresis)", ("max_pool",)),
    # cuDNN's FFT convolutions run complex (float2, cf32) GEMVs and GEMMs; its layout
    # transposes (nchwToNhwc, nhwcToNchw) belong to the convolutions too
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "dgrad", "winograd",
                             "fft", "float2", "cf32", "nchwToNhwc", "nhwcToNchw")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "dot_kernel", "cutlass")),
    ("linear solve", ("getrf", "getrs", "trsm", "lu_", "laswp", "magma", "solve")),
    ("softmax", ("softmax", "SoftMax")),
    ("layer norm", ("layer_norm", "LayerNorm")),
    ("resize", ("upsample", "interpolate")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "where", "clamp")),
)
# CUDA runtime calls that make the host wait for the device
_BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
             "cudaMemcpy", "cudaMemcpyAsync")


def kind_of(kernel_name: str) -> str:
    for kind, keys in _KINDS:
        if any(k in kernel_name for k in keys):
            return kind
    return "other"


@contextlib.contextmanager
def trace(out_path: Optional[str] = None):
    """Profile CPU and CUDA activity in the block; yields the profiler.
    ``out_path``, when given, receives a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as p:
        yield p
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        p.export_chrome_trace(out_path)


def device_breakdown(p) -> Dict:
    """GPU kernel time by kind (ms), and the busy share of the window from
    the first kernel's start to the last kernel's end."""
    kernels = [e for e in p.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return {"device_events": 0}
    by_kind: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_kind[kind_of(e.name)] = by_kind.get(kind_of(e.name), 0.0) + us
        by_name[e.name[:90]] = by_name.get(e.name[:90], 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    blocking, blocking_ms, copies = {}, {}, {}
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in _BLOCKING:
            blocking[e.name] = blocking.get(e.name, 0) + 1
            blocking_ms[e.name] = blocking_ms.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    for e in kernels:
        if e.name.startswith(("Memcpy", "Memset")):
            copies[e.name] = copies.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_events": len(kernels),
        "kernel_ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in top},
        "window_ms": window / 1e3,
        "busy_share": busy / window if window else None,
        "blocking_calls": blocking,
        "blocking_host_ms": blocking_ms,
        "device_copies": copies,
    }


@contextlib.contextmanager
def host_clock():
    """Wall seconds and this process's CPU seconds (all its threads) over
    the block, in a dict filled at its end. A host-paced loop whose wall
    time grows with its own CPU time spends more CPU on the same work (a
    slower or shared host); one whose wall time grows alone is waiting."""
    out: Dict = {}
    c0, t0 = time.process_time(), time.perf_counter()
    yield out
    out["wall_s"] = time.perf_counter() - t0
    out["process_cpu_s"] = time.process_time() - c0


def _profile(run, steps: int, trace_path: Optional[str]) -> Dict:
    """Time ``run()`` unprofiled, then profile it; ``run`` ends in a read-back."""
    t0 = time.perf_counter()
    run()
    plain_s = time.perf_counter() - t0
    with trace(trace_path) as p:
        run()
    out = device_breakdown(p)
    per_step = {
        key: {k: v / steps for k, v in out.pop(key, {}).items()}
        for key in ("kernel_ms_by_kind", "top_kernels_ms", "blocking_calls", "blocking_host_ms",
                    "device_copies")
    }
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return {"steps": steps, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "iters_per_sec_unprofiled": steps / plain_s, "per_step": per_step, **out}


def _sam(steps: int, trace_path: Optional[str]) -> Dict:
    import numpy as np

    from tbist_tpu_torch.models import sam
    from tbist_tpu_torch.weights import sam as sam_weights

    params = sam_weights.init_params(torch.Generator().manual_seed(0), sam.BASE, device="cuda")
    img = (np.random.default_rng(0).random((480, 640, 3)) * 255).astype(np.uint8)
    boxes = np.asarray([[100.0, 100.0, 400.0, 380.0]], np.float32)

    def run():
        for _ in range(steps):
            sam.predict_boxes(params, sam.BASE, img, boxes)

    for _ in range(2):  # warm-up
        sam.predict_boxes(params, sam.BASE, img, boxes)
    return {"profile": "sam predict_boxes, seeded ViT-B, 1024², 480x640, 1 box",
            **_profile(run, steps, trace_path)}


@contextlib.contextmanager
def _layer_spans(targets):
    """Wrap module functions, (module, name, label or label(*args)), so that
    each call records CUDA events before and after it; yields {label: [(start,
    end), ...]}. A span is the stream's time from the call's first kernel to
    its last: kernels, and any wait for the host's launches between them."""
    spans: Dict[str, list] = {}
    saved = []
    for mod, name, label in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _label=label, **k):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = _fn(*a, **k)
            end.record()
            spans.setdefault(_label(*a) if callable(_label) else _label, []).append((start, end))
            return out

        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)
    try:
        yield spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _text_location(steps: int, trace_path: Optional[str]) -> Dict:
    import numpy as np

    from tbist_tpu_torch.models import dino, dino_sam, sam, swin
    from tbist_tpu_torch.weights import dino_convert
    from tbist_tpu_torch.weights import sam as sam_weights

    dev = torch.device("cuda")
    dparams = dino_convert.init_params(torch.Generator().manual_seed(0), device=dev)
    sparams = sam_weights.init_params(torch.Generator().manual_seed(0), sam.BASE, device=dev)
    # no bert-base-uncased vocab is in the repository: its special tokens at
    # their real ids, the prompt's word at a free one
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, ".": 1012, "?": 1029,
             "boat": 4049}
    img = (np.random.default_rng(0).random((480, 640, 3)) * 255).astype(np.uint8)

    def call():
        return dino_sam.extract_mask(dparams, sparams, img, "boat", vocab=vocab).cpu()

    for _ in range(2):  # warm-up: builds the per-shape constants, caches the prompt
        call()
    targets = [
        (dino, "forward", "dino forward (all)"),
        (swin, "forward", "swin backbone"),
        (dino, "bi_attention", "fusion (bi-attention)"),
        (dino, "deformable_attention",
         lambda query, ref_points, *a: "deformable attention, "
         + ("encoder" if ref_points.shape[-1] == 2 else "decoder")),
        (sam, "encode_uint8", "sam encoder (K4 inside)"),
        (sam, "mask_union_from_embedding", "sam decode and masks"),
    ]
    with _layer_spans(targets) as spans:
        for _ in range(steps):
            call()
    torch.cuda.synchronize()
    layer_ms = {label: sum(s.elapsed_time(e) for s, e in pairs) / steps
                for label, pairs in spans.items()}

    # BERT runs once per prompt (dino_sam caches its output); time it cold
    dino_sam.clear_text_feature_cache()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    dino_sam._text_features(dparams, "boat.", vocab)
    end.record()
    end.synchronize()
    layer_ms["bert + feat_map (once per prompt)"] = start.elapsed_time(end)

    # the host's thresholding and phrase decoding, on outputs already computed
    ids, out = dino_sam._detect_dispatch(dparams, torch.from_numpy(img).to(dev), "boat", vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    boxes, _ = dino_sam._detect_collect(ids, out, vocab)
    layer_ms["host thresholding and phrases (after sync)"] = (time.perf_counter() - t0) * 1e3

    def run():
        for _ in range(steps):
            call()

    return {"profile": "text-location extract_mask, seeded SwinT-OGC + ViT-B, 480x640 "
                       "(detection 800x1056, segmentation 1024²), prompt 'boat'",
            "boxes_kept": int(boxes.shape[0]), "layer_ms_per_call": layer_ms,
            **_profile(run, steps, trace_path)}


def _effects(steps: int, trace_path: Optional[str]) -> Dict:
    from tbist_tpu_torch.compose import pipeline
    from tbist_tpu_torch.ops import canny, palette
    from tbist_tpu_torch.utils.config import EffectRequest, PixelArtConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device

    def image(path):
        return to_device(load_image(os.path.join(_ROOT, path)))

    pixel = PixelArtConfig(use_palette=True, palette_from_image=True, palette_num_colors=10,
                           edge_detect=True, edge_threshold=50)
    cases = {
        "pixel_art": (image("data/content_imgs/face.jpg"), EffectRequest(pixel_art=pixel),
                      pipeline.EffectInputs(pixel_palette_image=image(
                          "data/style_imgs/picasso2.png"))),
        "color_palette": (image("data/content_imgs/sea.png"), EffectRequest(color_palette=True),
                          pipeline.EffectInputs(color_palette_image=image(
                              "data/style_imgs/black_white_gradient.jpg"))),
    }
    targets = [(palette, "palette_from_image", "k-means palette (one read-back)"),
               (palette, "quantize_to_palette", "quantize"),
               (canny, "canny", "canny (64 hysteresis rounds)")]
    out = {}
    for name, (x, req, inputs) in cases.items():
        reg = pipeline.ModelRegistry(device=x.device)

        def run():
            for _ in range(steps):
                pipeline.apply_image(x, req, inputs, reg).cpu()

        run()  # warm-up
        with _layer_spans(targets) as spans:
            run()
        torch.cuda.synchronize()
        layer_ms = {label: sum(s.elapsed_time(e) for s, e in pairs) / steps
                    for label, pairs in spans.items()}
        out[name] = {"layer_ms_per_call": layer_ms, **_profile(
            run, steps, trace_path and f"{os.path.splitext(trace_path)[0]}_{name}.json")}
    return {"profile": "effects through the pipeline: pixel_art face.jpg 1024², palette of "
                       "10 by k-means from picasso2.png, edges at 50; color_palette sea.png "
                       "962x660 to black_white_gradient.jpg 5001x2916", **out}


def _text_style(steps: int, trace_path: Optional[str]) -> Dict:
    from tbist_tpu_torch.compose import pipeline
    from tbist_tpu_torch.effects import text_transfer
    from tbist_tpu_torch.models import clip_mlp, ghiasi
    from tbist_tpu_torch.utils.config import EffectRequest, TextEffectConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device

    x = to_device(load_image(os.path.join(_ROOT, "data/content_imgs/boat.jpg")))
    req = EffectRequest(text=TextEffectConfig(style_prompt="mosaic"))
    reg = pipeline.ModelRegistry(device=x.device)
    readback = []

    def call():
        out = pipeline.apply_image(x, req, None, reg)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = out.cpu()
        end.record()
        readback.append((start, end))
        return out

    def run():
        for _ in range(steps):
            call()

    run()  # warm-up
    readback.clear()
    targets = [(clip_mlp, "apply", "clip-mlp"),
               (ghiasi, "_layer", lambda kind, name, *a: f"ghiasi {name}"),
               (ghiasi, "_instance_norm", "instance norms (inside the layers)")]
    with _layer_spans(targets) as spans:
        run()
    torch.cuda.synchronize()
    spans["read-back (pageable, 3 MB f32)"] = readback
    layer_ms = {label: sum(s.elapsed_time(e) for s, e in pairs) / steps
                for label, pairs in spans.items()}
    return {"profile": "text-style pipeline call, boat.jpg 512², prompt 'mosaic', "
                       f"activations {text_transfer.compute_dtype()}",
            "layer_ms_per_call": layer_ms, "conv_kernels": _conv_kernels(call),
            **_profile(run, steps, trace_path)}


def _depth(steps: int, trace_path: Optional[str]) -> Dict:
    """Depth-loss Gatys steps at 512px with the torch-seeded
    Depth-Anything-V2-Small in the loss graph (what ``--depth depth_loss``
    runs once a checkpoint exists)."""
    from tbist_tpu_torch.models import depth_anything as da
    from tbist_tpu_torch.models import vgg19
    from tbist_tpu_torch.ops import losses
    from tbist_tpu_torch.ops.mip import normalize_depth
    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD, GatysConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device
    from tbist_tpu_torch.utils.precision import full_f32
    from tbist_tpu_torch.weights import vgg as vgg_weights

    content, style = (to_device(load_image(os.path.join(_ROOT, p)), bucket=32, max_side=512)
                      for p in ("data/content_imgs/boat.jpg", "data/style_imgs/starry_night.jpg"))
    dparams = da.init_params(torch.Generator().manual_seed(0), device="cuda")
    vgg = vgg_weights.get_params()

    def estimator(img):  # through the module, so that a span can wrap it
        return da.predict_depth(dparams, da.SMALL, img)

    cfg = GatysConfig(num_steps=steps, w_depth=5e4)
    gatys.stylize(content, [style], GatysConfig(num_steps=3, w_depth=5e4), vgg,
                  depth_fn=estimator)  # warm-up

    def run(n=steps):
        gatys.stylize(content, [style], dataclasses.replace(cfg, num_steps=n), vgg,
                      depth_fn=estimator)[1].cpu()

    host_runs = _host_runs(run, steps)  # first, while the process is new
    with _layer_spans([(da, "predict_depth", "depth anything forward"),
                       (vgg19, "extract_features", "vgg-19 forward")]) as spans:
        gatys.stylize(content, [style], cfg, vgg, depth_fn=estimator)[1].cpu()
    torch.cuda.synchronize()
    layer_ms = {label: sum(s.elapsed_time(e) for s, e in pairs) / steps
                for label, pairs in spans.items()}

    # each part's forward and input gradient alone, as a step runs them
    params = gatys.params_on(vgg, content.device, torch.float32)
    target = normalize_depth(estimator(content)).detach()

    def depth_part(x):
        return cfg.w_depth * losses.depth_loss(normalize_depth(estimator(x)), target)

    layers = cfg.content_layers + cfg.style_layers
    with torch.no_grad():
        grams = {k: losses.gram_matrix(v) for k, v in vgg19.extract_features(
            params, losses.normalize(style, VGG_MEAN, VGG_STD), cfg.style_layers).items()}

    def vgg_part(x):  # the style term (K1, K3) and VGG to conv5_1
        feats = vgg19.extract_features(params, losses.normalize(x, VGG_MEAN, VGG_STD), layers)
        return cfg.w_style * losses.style_loss_from_targets(feats, grams, cfg.style_layers)

    for label, part in (("depth anything forward + input gradient", depth_part),
                        ("vgg-19 forward + input gradient", vgg_part)):
        pairs = []
        with full_f32():
            for _ in range(steps + 2):
                x = content.clone().requires_grad_(True)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                torch.autograd.grad(part(x), x)
                end.record()
                pairs.append((start, end))
        torch.cuda.synchronize()
        layer_ms[label] = sum(s.elapsed_time(e) for s, e in pairs[2:]) / steps

    return {"profile": "depth-loss gatys step, boat.jpg x starry_night.jpg 512², torch-seeded "
                       "Depth-Anything-V2-Small in the loss graph, f32",
            "layer_ms_per_step": layer_ms, "host_runs": host_runs,
            "batched_lanes": _lanes(content, style, vgg, steps),
            **_profile(run, steps, trace_path)}


def _host_runs(run, steps: int, long_steps: int = 100, repeats: int = 4) -> Dict:
    """``run(long_steps)`` ``repeats`` times unprofiled, then ``run(steps)``
    twice profiled, each with ``host_clock``'s readings a step, the
    cudaMallocs it made and the card's SM clock and power (``nvidia-smi``
    once a second, from another thread); profiled, also the busy share, the
    host's blocking calls a step with the host ms spent in them, and the
    device's copies a step. What tells a loaded host from a loop that waits
    on the device, and a slow first run from a slow host."""
    out = {}
    for profiled, n, times in ((False, long_steps, repeats), (True, steps, 2)):
        rows = []
        for _ in range(times):
            mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
            with (trace() if profiled else contextlib.nullcontext()) as p, _smi_samples() as smi:
                with host_clock() as h:
                    run(n)
            row = {"steps": n, "wall_ms_per_step": h["wall_s"] / n * 1e3,
                   "process_cpu_ms_per_step": h["process_cpu_s"] / n * 1e3,
                   "cuda_mallocs": torch.cuda.memory_stats().get("segment.all.allocated", 0)
                   - mallocs,
                   "sm_clock_mhz": [m for m, _ in smi], "power_w": [w for _, w in smi]}
            if profiled:
                b = device_breakdown(p)
                row["busy_share"] = b.get("busy_share")
                for key in ("blocking_calls", "blocking_host_ms", "device_copies"):
                    row[key + "_per_step"] = {k: v / n for k, v in b.get(key, {}).items()}
            rows.append(row)
        out["profiled" if profiled else "unprofiled"] = rows
    return out


@contextlib.contextmanager
def _smi_samples(period_s: float = 1.0):
    """Yields a list that a thread fills with the card's (SM clock MHz,
    power W) from ``nvidia-smi`` every ``period_s`` until the block ends."""
    samples, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30,
            ).stdout
            try:
                samples.append(tuple(float(v) for v in out.split(",")[:2]))
            except ValueError:
                pass
            stop.wait(period_s)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield samples
    finally:
        stop.set()
        thread.join()


def _lanes(content, style, vgg, steps: int) -> Dict:
    """MIP's batched plan: ``parallel.batched.run`` steps of one lane and of
    two (the image and its mirror), no depth term: ms a step unprofiled,
    and device time by kind a step for two."""
    from tbist_tpu_torch.parallel import batched
    from tbist_tpu_torch.utils.config import GatysConfig

    frames = torch.cat([content, torch.flip(content, dims=[2])])
    out = {}
    for b in (1, 2):
        def run(n=steps, b=b):
            batched.run(GatysConfig(num_steps=n), vgg, frames[:b], [style])
            torch.cuda.synchronize()

        run(3)  # warm-up
        t0 = time.perf_counter()
        run()
        out[f"b{b}_ms_per_step"] = (time.perf_counter() - t0) / steps * 1e3
    with trace() as p:
        run()
    kinds = device_breakdown(p)
    out["b2_kernel_ms_by_kind"] = {k: v / steps for k, v in kinds["kernel_ms_by_kind"].items()}
    out["b2_top_kernels_ms"] = {k: v / steps for k, v in kinds["top_kernels_ms"].items()}
    out["b2_busy_share"] = kinds["busy_share"]
    return out


def _conv_kernels(call) -> Dict:
    """The kernels each Ghiasi convolution launches, by layer, with its
    operands' dtype: one ``call()`` records every ``ghiasi._conv``'s
    arguments, then each convolution runs alone under the profiler (inside
    ``full_f32``, as in the pipeline)."""
    from tbist_tpu_torch.models import ghiasi
    from tbist_tpu_torch.utils.precision import full_f32

    labels = [f"{name}.{c}" if kind == "res" else name
              for kind, name, *_ in ghiasi.LAYERS
              for c in (("conv1", "conv2") if kind == "res" else ("",))]
    recorded = []
    conv = ghiasi._conv

    def record(x, p, pad, stride, dtype):
        recorded.append((x, p, pad, stride, dtype))
        return conv(x, p, pad, stride, dtype)

    ghiasi._conv = record
    try:
        call()
    finally:
        ghiasi._conv = conv
    out = {}
    for label, (x, p, pad, stride, dtype) in zip(labels, recorded):
        with full_f32(), trace() as prof:
            conv(x, p, pad, stride, dtype)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kind_of(e.name).startswith("convolution")]
        out[label] = {"operands": str(dtype).replace("torch.", ""), "input": list(x.shape),
                      "kernels": [n[:110] for n in names]}
    return out


def _main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("gatys", "sam", "text-location", "effects", "text-style",
                                       "depth"), default="gatys")
    ap.add_argument("--size", type=int, default=512, help="Gatys image side")
    ap.add_argument("--steps", type=int, default=30,
                    help="steps (Gatys) or calls (the other paths)")
    ap.add_argument("--trace", help="write a Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("prof: needs a CUDA device")
    if args.path == "sam":
        print(json.dumps(_sam(args.steps, args.trace)))
        return
    if args.path == "text-location":
        print(json.dumps(_text_location(args.steps, args.trace)))
        return
    if args.path == "effects":
        print(json.dumps(_effects(args.steps, args.trace)))
        return
    if args.path == "text-style":
        print(json.dumps(_text_style(args.steps, args.trace)))
        return
    if args.path == "depth":
        print(json.dumps(_depth(args.steps, args.trace)))
        return

    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.utils.config import GatysConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device
    from tbist_tpu_torch.weights import vgg as vgg_weights

    imgs = [to_device(load_image(os.path.join(_ROOT, p)), bucket=32, max_side=args.size)
            for p in ("data/content_imgs/boat.jpg", "data/style_imgs/starry_night.jpg")]
    params = vgg_weights.get_params()
    cfg = GatysConfig(num_steps=args.steps)
    gatys.stylize(imgs[0], imgs[1:], GatysConfig(num_steps=3), params)  # warm-up
    torch.cuda.synchronize()

    def run():
        gatys.stylize(imgs[0], imgs[1:], cfg, params)[1].cpu()

    print(json.dumps({"profile": "gatys lbfgs stylize", "size": list(imgs[0].shape[1:3]),
                      **_profile(run, args.steps, args.trace)}))


if __name__ == "__main__":
    _main()
