"""Profiling of the port (counterpart of ``tbist_tpu.utils.prof``).

``trace`` wraps ``torch.profiler`` around a block (CPU and CUDA activity,
optionally written as a Chrome trace). ``device_breakdown`` sums a trace's
GPU kernel time by kind and measures how much of the traced window the
device was busy.

Run as a script on a machine with a CUDA card to profile a path: Gatys
L-BFGS on boat.jpg x starry_night.jpg, SAM ViT-B ``predict_boxes`` at 1024²
on seeded weights (a 480x640 image, one box), or the text-location chain
``models.dino_sam.extract_mask`` (seeded GroundingDINO SwinT-OGC and SAM
ViT-B, the same image, the prompt "boat")::

    python -m tbist_tpu_torch.utils.prof --size 512 --steps 30
    python -m tbist_tpu_torch.utils.prof --path sam --steps 10
    python -m tbist_tpu_torch.utils.prof --path text-location --steps 5

It prints one JSON line: device time by kind and of the top kernels per
step (per call for SAM and text-location), CUDA calls per step that can
block the host, the device's busy share of the profiled window (the
profiler's own host cost included), and the rate of an unprofiled run of
the same length. For text-location it adds each layer's time per call
(CUDA events around the Swin backbone, the fusion layers, the encoder's and
the decoder's deformable attention, the whole DINO forward, SAM's encoder
and its decode), BERT's once per prompt, and the host's thresholding.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from typing import Dict, Optional

import torch

# kernel-name substrings -> kind, first match wins
_KINDS = (
    ("K4 sam attention (sam_attn.cu)", ("sam_attn_kernel", "sam_attn_combine_kernel")),
    ("K1 gram (gram.cu)", ("gram_fwd_kernel", "gram_reduce_kernel", "gram_bwd_kernel")),
    ("K3 relu-pool bwd (pool_bwd.cu)", ("pool_bwd_kernel",)),
    # DINO's deformable attention samples its value maps with F.grid_sample
    ("deformable sampling (grid_sample)", ("grid_sampler",)),
    ("sort (query selection)", ("RadixSort", "radixSort", "sortKeyValue", "SortKV")),
    # cuDNN's FFT convolutions run complex (float2) GEMVs; its layout
    # transposes (nchwToNhwc, nhwcToNchw) belong to the convolutions too
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "fprop", "dgrad", "winograd",
                             "fft", "float2", "nchwToNhwc", "nhwcToNchw")),
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
    blocking = {}
    for e in p.events():
        if e.device_type == torch.autograd.DeviceType.CPU and e.name in _BLOCKING:
            blocking[e.name] = blocking.get(e.name, 0) + 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "device_events": len(kernels),
        "kernel_ms_by_kind": {k: v / 1e3 for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": {k: v / 1e3 for k, v in top},
        "window_ms": window / 1e3,
        "busy_share": busy / window if window else None,
        "blocking_calls": blocking,
    }


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
        for key in ("kernel_ms_by_kind", "top_kernels_ms", "blocking_calls")
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


def _main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("gatys", "sam", "text-location"), default="gatys")
    ap.add_argument("--size", type=int, default=512, help="Gatys image side")
    ap.add_argument("--steps", type=int, default=30,
                    help="steps (Gatys) or calls (SAM, text-location)")
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

    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.utils.config import GatysConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device
    from tbist_tpu_torch.weights import vgg as vgg_weights

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    imgs = [to_device(load_image(os.path.join(root, p)), bucket=32, max_side=args.size)
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
