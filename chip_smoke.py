"""Smoke test of the PyTorch/CUDA port (``tbist_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each fatal:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``tbist_tpu_torch/csrc`` with ``nvcc``, in parallel;
3. kernels: each kernel's wrapper at its path's shapes (K1-K3 at 512px, f32
   and bf16; K4 at the 1024² SAM encoder for one and four images, at a
   ragged 24x40 grid and at SAM's 16x16 grid for a 256 input), held against
   its plain PyTorch version on the same inputs and timed with CUDA events
   beside its bound and a library yardstick; two calls of K1's forward, and
   of K4, must agree bit for bit;
4. agreement: ``stylize`` on the card against the plain CPU path (8 steps,
   64px, torch-seeded weights), plus an 8-step bf16 run; SAM ViT-B (seeded,
   full width, adapted to a 256 input) on the card against the CPU;
5. Gatys path: ``tbist_tpu_torch.cli.main`` — boat.jpg x starry_night.jpg,
   ``--style-transfer``, 400 L-BFGS steps at 512px, full VGG-19 width;
6. SAM path: ``models.sam.predict_boxes`` at full ViT-B width and 1024² on
   seeded weights (a 480x640 image, one box), then the batch lane
   (``encode_uint8_batch`` + ``masks_from_embedding_batch``, 4 frames);
7. mask ops: ``ops.masks.composite_by_mask`` on the card against the CPU,
   with the SAM path's mask;
8. text-location path: GroundingDINO SwinT-OGC at full width on seeded
   weights (a vocab built here) chained with the SAM path's ViT-B: DINO on
   the card against the CPU at 256x320; ``models.dino_sam.extract_mask`` on
   the SAM path's 480x640 image and the prompt "boat" (800x1056 detection,
   1024² segmentation), timed, with its host syncs counted; the 4-frame
   batch lane against single frames; ``api.apply_image`` with the location
   mask around 400 Gatys steps (DINO → SAM → Gatys → ``composite_by_mask``);
   and ``cli.main --text-location``, which without checkpoints takes the
   border-prior fallback;
9. effects path: pixel art (face.jpg, a 10-colour k-means palette from
   picasso2.png, Canny edges), grayscale and Reinhard colour transfer
   (sea.png to black_white_gradient.jpg and to sunset.png), each timed
   through the pipeline with its host syncs counted, held against the same
   call on the CPU and driven through ``cli.main``; k-means twice on the
   card (bitwise equal) and against the CPU; the Gatys path with
   ``--channel-attention``; and ``--resume-dir``: half the steps in two
   segments, then a second call that resumes and runs the other two.

Every launch counter is zeroed just before each path and read just after.
It prints one JSON line per kernel, shape and dtype, then the card's
``nvidia-smi`` line, a ``{"kernels": [...]}`` summary, and last the
``{"ok": true, "device": ...}`` line. Without CUDA, or outside a checkout,
it exits non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE = 512  # the benchmark's image side (boat.jpg is 512x512)
STEPS = 400
STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
GRAM_CHANNELS = (64, 128, 256, 512, 512)  # conv1_1 .. conv5_1
POOL_CHANNELS = (64, 128, 256, 512)  # pool1 .. pool4
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 and TF32 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6  # the H100's L2 cache
ITERS = 50
# K4 shapes (N = B·heads, h, w, d): (a) one 1024² image (12 heads, T = 4096),
# (b) the batch lane's four, (c) a ragged grid (T = 960 is not a multiple of
# 64), (d) SAM at 256 (T = 256); (c) and (d) split their keys
SAM_ATTN_SHAPES = ((12, 64, 64, 64), (48, 64, 64, 64), (3, 24, 40, 64), (12, 16, 16, 64))
SAM_ITERS = 10
# the JAX package's SAM benchmark input (benchmarks/suite.py:56-64)
SAM_IMAGE_HW = (480, 640)
SAM_BOX = [100.0, 100.0, 400.0, 380.0]
TEXT_PROMPT = "boat"
TEXT_ITERS = 5
# the card-vs-CPU check runs DINO at full width at a reduced detection size
DINO_CHECK_HW = (256, 320)
MASK_TOL = 1e-3  # share of a mask's pixels two f32 computations may disagree on
# the effects path: each run's content image and CLI flags, at the sizes a
# user sends (face.jpg 1024², sea.png 962x660; the Reinhard target
# black_white_gradient.jpg is 5001x2916 and the k-means source picasso2.png
# 1080², both taken whole)
PICASSO2 = os.path.join(ROOT, "data/style_imgs/picasso2.png")
_FACE, _SEA = (os.path.join(ROOT, "data/content_imgs", f) for f in ("face.jpg", "sea.png"))
_BW, _SUNSET = (os.path.join(ROOT, "data/style_imgs", f)
                for f in ("black_white_gradient.jpg", "sunset.png"))
EFFECT_RUNS = {
    "pixel_art": (_FACE, ["--pixel-art", "--pixel-from-image", PICASSO2, "--pixel-colors", "10",
                          "--pixel-edges", "--edge-threshold", "50"]),
    "grayscale": (_SEA, ["--grayscale"]),
    "color_palette_bw": (_SEA, ["--color-palette", _BW]),
    "grayscale_color_palette_bw": (_SEA, ["--grayscale", "--color-palette", _BW]),
    "grayscale_color_palette_sunset": (_SEA, ["--grayscale", "--color-palette", _SUNSET]),
}
EFFECT_ITERS = 5
PIXEL_TOL = 1e-3  # share of pixels two computations of pixel art may disagree on
SPIN_HZ = 2e9  # cycles per second of torch.cuda._sleep: at most the H100's 1.98 GHz SM clock


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== phase {name}")
    try:
        yield
    except BaseException:
        log(f"== phase {name} FAILED")
        raise
    log(f"== phase {name} ok ({time.perf_counter() - t0:.1f}s)")


def time_ms(fn, args, iters: int = ITERS) -> float:
    """Mean device time of ``fn(*args)`` over back-to-back calls (CUDA events).

    On the main path a kernel finds its inputs cold in L2 (written by the
    forward pass, or larger than L2), so the calls cycle through copies of
    ``args`` that together exceed twice the L2. A call's host cost (checks,
    allocation, the launch) can exceed a small kernel's device time, so the
    device first spins for about three times the host time of ``iters``
    calls: the calls queue up behind it, and the events see the device run
    them back to back."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in args)
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(math.ceil(2 * L2_BYTES / nbytes) - 1)]
    for i in range(3):  # warm-up
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        fn(*sets[i % len(sets)])
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3 * iters * host_s * SPIN_HZ))
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gram_shapes(size: int):
    return [(1, (size >> k) ** 2, c) for k, c in enumerate(GRAM_CHANNELS)]


def pool_shapes(size: int):
    return [(1, size >> k, size >> k, c) for k, c in enumerate(POOL_CHANNELS)]


def check_kernels(device, size: int):
    """Phase 3: every kernel against its plain version at the main path's
    shapes, f32 and bf16. Returns per-step f32 sums per kernel."""
    from tbist_tpu_torch.utils.precision import full_f32

    with full_f32():  # the plain versions in full f32
        return _check_kernels(device, size)


def _check_kernels(device, size: int):
    import torch

    from tbist_tpu_torch.kernels import gram, pool, relu_pool

    gen = torch.Generator(device=device).manual_seed(0)
    summary = {}

    def record(name, shape, dtype, got, want, rtol, atol, ms, plain_ms, lib_ms, nbytes, flops):
        err = (got.float() - want.float()).abs()
        tol = atol + rtol * want.float().abs()
        ok = bool(torch.all(err <= tol))
        b_ms, b_by = bound_ms(nbytes, flops, str(dtype).split(".")[1])
        line = {
            "kernel": name, "shape": list(shape), "dtype": str(dtype).split(".")[1],
            "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol, "agree": ok,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by,
        }
        log(json.dumps(line))
        if not ok:
            raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees with plain version")
        if dtype == torch.float32:
            s = summary.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                          "library_ms": 0.0, "bound_ms": 0.0,
                                          "bytes_ms": 0.0, "ops_ms": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], line["max_abs_err"])
            for k in ("ms", "plain_ms", "bound_ms"):
                s[k] += line[k]
            s["library_ms"] = None if lib_ms is None else s["library_ms"] + lib_ms
            s["bytes_ms"] += nbytes / PEAK_BYTES * 1e3
            s["ops_ms"] += flops / PEAK_FLOPS["float32"] * 1e3

    for dtype in (torch.float32, torch.bfloat16):
        item = torch.tensor([], dtype=dtype).element_size()
        for b, n, c in gram_shapes(size):
            x = torch.randn((b, n, c), generator=gen, device=device).to(dtype)
            norm = 1.0 / (n * c)
            got = gram.gram_fwd(x, norm)
            if not torch.equal(gram.gram_fwd(x, norm), got):
                raise AssertionError(f"gram_fwd {(b, n, c)} {dtype}: two calls differ")
            want = gram.gram_fwd_plain(x, norm)
            record("gram_fwd", (b, n, c), dtype, got, want, 1e-5, 1e-5 * float(want.abs().max()),
                   time_ms(lambda x: gram.gram_fwd(x, norm), (x,)),
                   time_ms(lambda x: gram.gram_fwd_plain(x, norm), (x,)),
                   time_ms(lambda x: torch.matmul(x[0].T, x[0]), (x,)),
                   # G is symmetric: the upper triangle and diagonal, C(C+1)/2 dot products
                   n * c * item + c * c * 4, n * c * (c + 1))
            m = torch.randn((b, c, c), generator=gen, device=device) * norm
            m = (m + m.transpose(1, 2)).contiguous()
            got = gram.gram_bwd(x, m)
            want = gram.gram_bwd_plain(x, m)
            args = (x, m, m.to(dtype))  # the library call takes M in x's dtype
            record("gram_bwd", (b, n, c), dtype, got, want,
                   1e-5 if dtype == torch.float32 else 8e-3,  # one bf16 rounding apart
                   1e-5 * float(want.float().abs().max()),
                   time_ms(lambda x, m, _: gram.gram_bwd(x, m), args),
                   time_ms(lambda x, m, _: gram.gram_bwd_plain(x, m), args),
                   time_ms(lambda x, _, m2: torch.matmul(x, m2), args),
                   2 * n * c * item + c * c * 4, 2 * n * c * c)
            del x, m, args, got, want
        for shape in pool_shapes(size):
            b, h, w, c = shape
            # quarter steps: exact ties in the windows, exact zeros for the relu
            x = (torch.rand(shape, generator=gen, device=device) * 4).round() / 4
            pre = x - 0.5
            x, pre = x.to(dtype), pre.to(dtype)
            g = torch.randn((b, h // 2, w // 2, c), generator=gen, device=device).to(dtype)
            nbytes = 2.5 * x.numel() * item  # x and gx, out and g at a quarter each
            flops = 2 * x.numel()  # a compare and a scale per input element
            out = pool.pool_fwd(x)
            record("pool_bwd", shape, dtype, pool.pool_bwd(x, out, g),
                   pool.pool_bwd_plain(x, out, g), 0.0, 1e-6,
                   time_ms(pool.pool_bwd, (x, out, g)),
                   time_ms(pool.pool_bwd_plain, (x, out, g)), None, nbytes, flops)
            out = torch.clamp_min(pool.pool_fwd(pre), 0)
            record("relu_pool_bwd", shape, dtype, relu_pool.relu_pool_bwd(pre, out, g),
                   pool.pool_bwd_plain(pre, out, g, relu=True), 0.0, 1e-6,
                   time_ms(relu_pool.relu_pool_bwd, (pre, out, g)),
                   time_ms(lambda *a: pool.pool_bwd_plain(*a, relu=True), (pre, out, g)), None,
                   nbytes, flops)
            del x, pre, g, out
    for s in summary.values():
        s["bound_by"] = "bytes" if s.pop("bytes_ms") >= s.pop("ops_ms") else "operations"
        if not math.isfinite(s["ms"]):
            raise AssertionError(f"kernel time is not finite: {summary}")
    return summary


def check_sam_attn(device):
    """Phase 3, K4: the kernel against its plain version at the SAM shapes.
    Returns the line of the first shape (one launch of the 1024² encoder)."""
    from tbist_tpu_torch.utils.precision import full_f32

    with full_f32():
        return _check_sam_attn(device)


def _check_sam_attn(device):
    import torch
    import torch.nn.functional as F

    from tbist_tpu_torch.kernels import sam_attn

    gen = torch.Generator(device=device).manual_seed(1)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    lines = []
    for n, h, w, d in SAM_ATTN_SHAPES:
        t = h * w
        q = torch.randn((n, t, d), generator=gen, device=device) * d ** -0.5  # pre-scaled
        k, v = (torch.randn((n, t, d), generator=gen, device=device) for _ in range(2))
        bh = torch.randn((n, t, h), generator=gen, device=device)
        bw = torch.randn((n, t, w), generator=gen, device=device)
        args = (q, k, v, bh, bw)
        got = sam_attn.attention_with_rel_bias(*args, h, w)
        if not torch.equal(sam_attn.attention_with_rel_bias(*args, h, w), got):
            raise AssertionError(f"sam_attn {(n, h, w, d)}: two calls differ")
        want = sam_attn.attention_with_rel_bias_plain(*args, h, w)
        # the online softmax sums the T keys in another order, and the
        # 3xTF32 products are within a few f32 roundings of the f32 ones
        rtol, atol = 1e-4, 1e-5 * float(want.abs().max())
        err = (got - want).abs()
        ok, max_err = bool(torch.all(err <= atol + rtol * want.abs())), float(err.max())
        del got, want, err
        ms = time_ms(lambda *a: sam_attn.attention_with_rel_bias(*a, h, w), args, SAM_ITERS)
        plain_ms = time_ms(lambda *a: sam_attn.attention_with_rel_bias_plain(*a, h, w), args,
                           SAM_ITERS)
        # the yardstick gets the (N, T, T) bias built beforehand, outside the timing
        bias = (bh.reshape(n, t, h, 1) + bw.reshape(n, t, 1, w)).reshape(n, t, t)
        lib_ms = time_ms(lambda q, k, v, b: F.scaled_dot_product_attention(
            q, k, v, attn_mask=b, scale=1.0), (q, k, v, bias), SAM_ITERS)
        del bias
        # each input read once and the output written once; the two products
        # as 3xTF32 on the tensor cores (three MMAs each), and beside it the
        # same products in f32 on the CUDA cores
        nbytes, flops = 4 * (4 * n * t * d + n * t * (h + w)), 4 * n * t * t * d
        b_ms, b_by = bound_ms(nbytes, 3 * flops, "tf32")
        line = {"kernel": "sam_attn", "shape": {"N": n, "T": t, "d": d, "h": h, "w": w},
                "dtype": "float32", "splits": sam_attn.kv_splits(n, t, sms),
                "max_abs_err": max_err, "rtol": rtol, "atol": atol, "agree": ok, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                "f32_simt_bound_ms": bound_ms(nbytes, flops, "float32")[0]}
        log(json.dumps(line))
        if not ok:
            raise AssertionError(f"sam_attn {(n, h, w, d)}: kernel disagrees with plain version")
        lines.append(line)
        del q, k, v, bh, bw, args
        torch.cuda.empty_cache()
    return lines[0]


def check_conv_layout(device, size: int) -> bool:
    """Whether cuDNN returns channels-last output for channels-last input at
    the conv shapes of the style layers (then the NHWC view needs no copy)."""
    import torch
    import torch.nn.functional as F

    all_cl = True
    for (_, n, c), cin in zip(gram_shapes(size), (3, 64, 128, 256, 512)):
        side = int(math.isqrt(n))
        x = torch.randn((1, side, side, cin), device=device).permute(0, 3, 1, 2)
        w = torch.randn((c, cin, 3, 3), device=device).contiguous(
            memory_format=torch.channels_last
        )
        y = F.conv2d(x, w, padding=1)
        cl = y.permute(0, 2, 3, 1).is_contiguous()
        log(json.dumps({"conv_out_channels_last": cl, "shape": [1, side, side, c]}))
        all_cl = all_cl and cl
    return all_cl


def check_agreement(device) -> None:
    """Phase 4: the card against the plain CPU path, and a bf16 run."""
    import torch

    from tbist_tpu_torch.models import vgg19
    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.utils.config import GatysConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device

    params = vgg19.init_params(torch.Generator().manual_seed(0))
    cfg = GatysConfig(num_steps=8, w_style=1e4)
    runs = {}
    for dev in (device, torch.device("cpu")):
        c = to_device(load_image(os.path.join(ROOT, "data/content_imgs/boat.jpg")),
                      bucket=32, max_side=64, device=dev)
        s = to_device(load_image(os.path.join(ROOT, "data/style_imgs/starry_night.jpg")),
                      bucket=32, max_side=64, device=dev)
        out, hist = gatys.stylize(c, [s], cfg, params, device=dev)
        runs[dev.type] = (out.cpu(), hist.cpu())
    (o_gpu, h_gpu), (o_cpu, h_cpu) = runs[device.type], runs["cpu"]
    hist_err = float(((h_gpu - h_cpu).abs() / h_cpu.abs()).max())
    img_err = float((o_gpu - o_cpu).abs().max())
    log(json.dumps({"agreement": "card vs cpu, 8 steps at 64px", "loss_rel_err": hist_err,
                    "image_max_err": img_err, "loss_first": float(h_gpu[0]),
                    "loss_last": float(h_gpu[-1])}))
    if not (hist_err <= 1e-3 and img_err <= 1e-2):
        raise AssertionError("card and CPU runs disagree")

    c = to_device(load_image(os.path.join(ROOT, "data/content_imgs/boat.jpg")),
                  bucket=32, max_side=64, device=device)
    out, hist = gatys.stylize(c, [c], GatysConfig(num_steps=8, w_style=1e4, dtype="bfloat16"),
                              params, device=device)
    hist = hist.cpu()
    log(json.dumps({"bf16_run": "8 steps at 64px", "loss_first": float(hist[0]),
                    "loss_last": float(hist[-1])}))
    if not (torch.isfinite(hist).all() and torch.isfinite(out).all()):
        raise AssertionError("bf16 run produced non-finite values")


def check_sam_agreement(device) -> None:
    """Phase 4, SAM: full-width ViT-B (seeded) adapted to a 256 input (a 16x16
    grid, so K4 runs at T = 256), on the card against the CPU: a seeded
    200x300 image, two boxes."""
    import numpy as np
    import torch

    from tbist_tpu_torch import kernels
    from tbist_tpu_torch.models import sam
    from tbist_tpu_torch.weights import sam as wsam

    params, cfg = sam.params_for_size(
        wsam.init_params(torch.Generator().manual_seed(0), sam.BASE), sam.BASE, 256)
    img = (np.random.default_rng(1).random((200, 300, 3)) * 255).astype(np.uint8)
    boxes = np.asarray([[20, 30, 180, 170], [150, 10, 290, 190]], np.float32)
    runs = {}
    for dev in (device, torch.device("cpu")):
        p = wsam.to_device(params, dev)
        kernels.reset_launch_counts()
        emb, scale, nh, nw = sam.encode_uint8(p, cfg, img)
        masks = sam.masks_from_embedding(p, cfg, emb, scale, nh, nw, 200, 300, boxes)
        runs[dev.type] = (emb.cpu(), masks, kernels.launch_counts()["sam_attn"])
    (e_gpu, m_gpu, n_gpu), (e_cpu, m_cpu, n_cpu) = runs[device.type], runs["cpu"]
    emb_err = float((e_gpu - e_cpu).abs().max() / e_cpu.abs().max())
    agree = float(np.mean(m_gpu == m_cpu))
    log(json.dumps({"agreement": "SAM card vs cpu, ViT-B at 256, 200x300, 2 boxes",
                    "embedding_max_rel_err": emb_err, "mask_pixels_agree": agree,
                    "mask_share_true": float(m_gpu.mean()), "sam_attn_launches": n_gpu}))
    if n_gpu != len(sam.BASE.global_layers) or n_cpu != 0:
        raise AssertionError(f"sam_attn launches card {n_gpu}, cpu {n_cpu}")
    if not (emb_err <= 1e-3 and agree >= 0.999 and m_gpu.shape == (2, 200, 300)):
        raise AssertionError("SAM card and CPU runs disagree")


def run_main_path(size: int, steps: int, flags=(), out_name: str = "smoke_out.png"):
    """Phase 5: the CLI at full width, with ``flags`` added to
    ``--style-transfer``; returns (launch counts, metrics, peak bytes)."""
    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import cli, kernels
    from tbist_tpu_torch.utils.logging import RunMetrics

    out_path = os.path.join(ROOT, "build", out_name)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    argv = ["--image", os.path.join(ROOT, "data/content_imgs/boat.jpg"),
            "--style", os.path.join(ROOT, "data/style_imgs/starry_night.jpg"),
            "--style-transfer", *flags, "--steps", str(steps), "--out", out_path,
            "--device", "cuda"]
    metrics = RunMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    rc = cli.main(argv, metrics=metrics)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if rc != 0:
        raise AssertionError(f"cli.main returned {rc}")
    hist = np.asarray(metrics.loss_history)
    img = np.asarray(Image.open(out_path))
    log(json.dumps({"main_path": " ".join(["cli --style-transfer", *flags]), "steps": steps,
                    "image": list(img.shape), "loss_first": float(hist[0]),
                    "loss_last": float(hist[-1]),
                    "iters_per_sec": metrics.extra["iters_per_sec"],
                    "seconds": metrics.timings_s["gatys"], "max_memory_allocated": peak,
                    "launches": counts, "degraded": metrics.degraded}))
    if img.shape != (size, size, 3):
        raise AssertionError(f"output image {img.shape}, expected {(size, size, 3)}")
    if hist.shape != (steps,) or not np.isfinite(hist).all() or not hist[-1] < hist[0]:
        raise AssertionError("loss history is not finite and decreasing")
    _expect_launches(counts, **gatys_launches(steps))
    return counts, metrics, peak


def gatys_launches(steps: int, calls: int = 1):
    """K1 and K3 launches of ``calls`` ``stylize`` calls of ``steps`` steps
    each: every call computes the style targets' Grams once, then each step
    one Gram forward and backward per style layer and a K3 at every pool."""
    n_style = len(STYLE_LAYERS)
    return {"gram_fwd": calls * n_style * (steps + 1), "gram_bwd": calls * n_style * steps,
            "relu_pool_bwd": calls * len(POOL_CHANNELS) * steps}


def _expect_launches(counts, **launches: int) -> None:
    want = {name: launches.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")


def run_sam_path(device, smi: str):
    """Phase 6: SAM ViT-B at full width and 1024², seeded weights. Returns
    (sam_attn launches, metrics, the single path's mask)."""
    import numpy as np
    import torch

    from tbist_tpu_torch import kernels
    from tbist_tpu_torch.models import sam
    from tbist_tpu_torch.weights import sam as wsam

    cfg = sam.BASE
    per_call = len(cfg.global_layers)
    params = wsam.init_params(torch.Generator().manual_seed(0), cfg, device=device)
    log("SAM weights: seeded (init_params, torch.Generator seed 0); no checkpoint in the repo")
    h, w = SAM_IMAGE_HW
    img = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    boxes = np.asarray([SAM_BOX], np.float32)

    # single image: 2 warm-up calls, then 10 timed by the host clock, each
    # ending in the masks' read-back
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(2):
        sam.predict_boxes(params, cfg, img, boxes)
    times = []
    for _ in range(SAM_ITERS):
        t0 = time.perf_counter()
        mask = sam.predict_boxes(params, cfg, img, boxes)
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    calls = 2 + SAM_ITERS
    _expect_launches(counts, sam_attn=per_call * calls)
    launches = counts["sam_attn"]
    peak = torch.cuda.max_memory_allocated()
    if mask.shape != (1, h, w) or mask.dtype != np.bool_:
        raise AssertionError(f"mask {mask.shape} {mask.dtype}, expected (1, {h}, {w}) bool")

    # the encoder alone, by CUDA events
    x, *_ = sam._preprocess(torch.from_numpy(img).to(device)[None], cfg)
    enc_ms = []
    for _ in range(SAM_ITERS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        sam.encode_image(params, cfg, x)
        end.record()
        end.synchronize()
        enc_ms.append(start.elapsed_time(end))

    # the batch lane: 4 frames (the first is the single path's image) with
    # 1-3 boxes each, padded to K = 4
    rng = np.random.default_rng(1)
    frames = np.stack([img] + [(rng.random((h, w, 3)) * 255).astype(np.uint8)
                               for _ in range(3)])
    bx = np.zeros((4, 4, 4), np.float32)
    valid = np.zeros((4, 4), bool)
    for i, n_boxes in enumerate((1, 3, 2, 1)):
        for j in range(n_boxes):
            bx[i, j] = SAM_BOX if (i, j) == (0, 0) else [40 + 90 * j, 30 + 60 * i,
                                                         300 + 90 * j, 260 + 50 * i]
            valid[i, j] = True
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    embs, scale, nh, nw = sam.encode_uint8_batch(params, cfg, frames)
    batch = sam.masks_from_embedding_batch(params, cfg, embs, scale, nh, nw, h, w, bx, valid)
    batch = batch.cpu().numpy()
    batch_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=per_call)
    launches += counts["sam_attn"]
    if batch.shape != (4, h, w) or batch.dtype != np.bool_:
        raise AssertionError(f"batch masks {batch.shape} {batch.dtype}")
    frame_diff = []
    for i in range(4):
        emb, *_ = sam.encode_uint8(params, cfg, frames[i])
        single = sam.masks_from_embedding(params, cfg, emb, scale, nh, nw, h, w,
                                          bx[i][valid[i]]).any(0)
        frame_diff.append(int((single != batch[i]).sum()))
    none_valid = valid.copy()
    none_valid[3] = False
    empty = sam.masks_from_embedding_batch(params, cfg, embs, scale, nh, nw, h, w, bx,
                                           none_valid)[3]
    metrics = {"sam_predict_ms": float(np.median(times)), "sam_predict_ms_all": times,
               "encoder_ms": float(np.median(enc_ms)), "encoder_ms_all": enc_ms,
               "batch4_ms": batch_ms, "mask_share_true": float(mask.mean()),
               "batch_frame_pixels_differing_from_single": frame_diff,
               "max_memory_allocated": peak, "card": smi}
    log(json.dumps({"sam_path": "predict_boxes, ViT-B 1024², 480x640, 1 box", **metrics}))
    if any(frame_diff):
        raise AssertionError(f"batch frames differ from the single path: {frame_diff} pixels")
    if bool(empty.any()):
        raise AssertionError("a frame with no valid box is not all False")
    return launches, metrics, mask[0], params


def check_mask_ops(device, mask) -> None:
    """Phase 7: composite_by_mask(a, b, mask, 9) on the card against the CPU."""
    import numpy as np
    import torch

    from tbist_tpu_torch.ops import masks

    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.random((1, *mask.shape, 3), dtype=np.float32))
            for _ in range(2))
    m = torch.from_numpy(mask)
    got = masks.composite_by_mask(a.to(device), b.to(device), m.to(device), 9).cpu()
    want = masks.composite_by_mask(a, b, m, 9)
    err = float((got - want).abs().max())
    log(json.dumps({"mask_ops": "composite_by_mask(a, b, sam mask, 9), card vs cpu",
                    "shape": list(got.shape), "max_abs_err": err}))
    if not err <= 1e-5:
        raise AssertionError("composite_by_mask: card and CPU disagree")


def _text_vocab():
    """A vocab built here (no bert-base-uncased vocab is in the repository):
    [CLS], [SEP], '.' and '?' at bert-base-uncased's ids, so that the
    sub-sentence masks (``models.dino.SPECIAL_TOKEN_IDS``) act as with the
    real vocab; the prompt's word at a free id below 30522."""
    return {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, ".": 1012, "?": 1029,
            TEXT_PROMPT: 4049}


def _keep_masks(logits: "np.ndarray", n_tokens: int):
    """Per query: DINO's two thresholds as ``dino_sam`` applies them (box on
    the best token, text on tokens 1..min(T, 255)), and whether any score
    lies within 1e-4 of the threshold it meets."""
    import numpy as np

    from tbist_tpu_torch.models import dino_sam

    probs = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    best, text = probs.max(1), probs[:, 1:min(n_tokens, 255)]
    keep = (best > dino_sam.BOX_THRESHOLD) & (text > dino_sam.TEXT_THRESHOLD).any(1)
    near = ((np.abs(best - dino_sam.BOX_THRESHOLD) < 1e-4)
            | (np.abs(text - dino_sam.TEXT_THRESHOLD) < 1e-4).any(1))
    return keep, near


def check_dino_agreement(device, params_cpu, vocab) -> None:
    """Phase 8, first: DINO at full SwinT-OGC width on the card against the
    CPU, at DINO_CHECK_HW, on the SAM path's image."""
    import numpy as np
    import torch

    from tbist_tpu_torch.models import dino_sam
    from tbist_tpu_torch.weights import dino_convert

    h, w = SAM_IMAGE_HW
    img = torch.from_numpy((np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8))
    outs = {}
    for dev in (device, torch.device("cpu")):
        params = dino_convert.to_device(params_cpu, dev) if dev.type == "cuda" else params_cpu
        t0 = time.perf_counter()
        ids, out = dino_sam._detect_dispatch(params, img.to(dev), TEXT_PROMPT, vocab,
                                             det_hw=DINO_CHECK_HW)
        outs[dev.type] = {k: v.cpu().numpy()[0] for k, v in out.items()}
        outs[dev.type]["seconds"] = time.perf_counter() - t0
        del params
    dino_sam.clear_text_feature_cache()
    gpu, cpu = outs[device.type], outs["cpu"]
    same = gpu["topk_index"] == cpu["topk_index"]

    def rel(key):
        a, b = gpu[key][same], cpu[key][same]
        return float(np.abs(a - b).max() / np.abs(b).max())

    errs = {k: rel(k) for k in ("topk_scores", "pred_logits", "pred_boxes")}
    keep_g, near_g = _keep_masks(gpu["pred_logits"], len(ids))
    keep_c, near_c = _keep_masks(cpu["pred_logits"], len(ids))
    near = near_g | near_c
    differ = int(((keep_g != keep_c) & ~near & same).sum())
    log(json.dumps({"agreement": f"DINO card vs cpu, full SwinT-OGC width, {DINO_CHECK_HW}",
                    "max_rel_err": errs, "queries": int(same.size),
                    "queries_selecting_another_token": int((~same).sum()),
                    "kept_card": int(keep_g.sum()), "kept_cpu": int(keep_c.sum()),
                    "kept_differing_off_threshold": differ,
                    "scores_within_1e-4_of_a_threshold": int(near.sum()),
                    "cpu_seconds": cpu["seconds"]}))
    if not (max(errs.values()) <= 1e-3 and same.mean() >= 0.99 and differ == 0):
        raise AssertionError("DINO card and CPU runs disagree")


def sync_sites(fn):
    """Run ``fn()`` with CUDA's sync debug mode on. Returns (its result, host
    ms, the lines that made the host wait for the card): the warning names
    the innermost Python frame, the call of the op that synchronized."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            out = fn()
            ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, ms, [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
                     if "called a synchronizing CUDA operation" in str(w.message)]


def run_text_location_path(device, smi: str, sam_params):
    """Phase 8: the text→mask chain at full width on seeded weights.
    Returns ({kernel: launches over the phase}, metrics)."""
    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import api, cli, kernels
    from tbist_tpu_torch.compose.pipeline import ModelRegistry
    from tbist_tpu_torch.models import dino_sam, sam
    from tbist_tpu_torch.utils.config import EffectRequest, GatysConfig, TextEffectConfig
    from tbist_tpu_torch.utils.logging import RunMetrics
    from tbist_tpu_torch.weights import dino_convert
    from tbist_tpu_torch.weights import vgg as vgg_weights

    per_call = len(sam.BASE.global_layers)
    vocab = _text_vocab()
    t0 = time.perf_counter()
    params_cpu = dino_convert.init_params(torch.Generator().manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params_cpu))
    log(f"DINO weights: seeded SwinT-OGC (init_params, torch.Generator seed 0), {n_params} "
        f"parameters in {time.perf_counter() - t0:.1f}s; no checkpoint and no BERT vocab in "
        f"the repo: vocab built here")
    check_dino_agreement(device, params_cpu, vocab)
    dino = dino_convert.to_device(params_cpu, device)
    del params_cpu
    total = {name: 0 for name in kernels.launch_counts()}

    def tally(counts):
        for k, v in counts.items():
            total[k] += v

    # extract_mask at full size: 2 warm-up calls, then TEXT_ITERS timed by the
    # host clock, each ending in the mask's read-back
    h, w = SAM_IMAGE_HW
    img = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for _ in range(2):
        dino_sam.extract_mask(dino, sam_params, img, TEXT_PROMPT, vocab=vocab).cpu()
    times = []
    for _ in range(TEXT_ITERS):
        t0 = time.perf_counter()
        mask = dino_sam.extract_mask(dino, sam_params, img, TEXT_PROMPT, vocab=vocab).cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=per_call * (2 + TEXT_ITERS))
    tally(counts)
    peak = torch.cuda.max_memory_allocated()
    if mask.shape != (h, w) or mask.dtype != torch.bool:
        raise AssertionError(f"mask {tuple(mask.shape)} {mask.dtype}, expected ({h}, {w}) bool")

    # DINO alone (CUDA events), the boxes kept, and the host syncs from the
    # dispatch to the read-back (sync debug mode warns at each)
    img_dev = torch.from_numpy(img).to(device)
    det_hw = dino_sam._detection_size(h, w)
    dino_ms = []
    for _ in range(TEXT_ITERS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ids, out = dino_sam._detect_dispatch(dino, img_dev, TEXT_PROMPT, vocab)
        end.record()
        end.synchronize()
        dino_ms.append(start.elapsed_time(end))
    boxes, phrases = dino_sam._detect_collect(ids, out, vocab)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    syncs = {}
    (ids, out), dispatch_ms, syncs["dino_dispatch"] = sync_sites(
        lambda: dino_sam._detect_dispatch(dino, img_dev, TEXT_PROMPT, vocab))
    _, encoder_ms, syncs["sam_encoder_queue"] = sync_sites(
        lambda: sam.encode_uint8(sam_params, sam.BASE, img_dev))
    _, _, syncs["collect"] = sync_sites(lambda: dino_sam._detect_collect(ids, out, vocab))
    n_dino = len(syncs["dino_dispatch"])
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=per_call)
    tally(counts)
    metrics = {
        "text_mask_ms": float(np.median(times)), "text_mask_ms_all": times,
        "dino_ms": float(np.median(dino_ms)), "dino_ms_all": dino_ms,
        "detection_hw": list(det_hw), "boxes_kept": int(boxes.shape[0]),
        "phrases_example": phrases[:2], "max_memory_allocated": peak,
        "mask_share_true": float(mask.float().mean()),
        "host_syncs": {k: len(v) for k, v in syncs.items()}, "host_sync_sites": syncs,
        "host_ms": {"dino_dispatch": dispatch_ms, "sam_encoder_queue": encoder_ms},
        "card": smi,
    }
    log(json.dumps({"text_location_path": "extract_mask, seeded SwinT-OGC + ViT-B, 480x640, "
                    f"prompt {TEXT_PROMPT!r}", **metrics}))
    if n_dino:
        raise AssertionError(f"the DINO dispatch waited for the card {n_dino} times")

    # the batch lane: 4 frames (the first is the single image), one DINO and
    # one encoder call; each frame's mask is held to extract_mask on it. The
    # batch's matmuls have other shapes than a single frame's, so cuBLAS may
    # round differently, and a mask logit within rounding of 0 can flip: at
    # most MASK_TOL of a frame's pixels may differ (the CPU tests' limit)
    rng = np.random.default_rng(1)
    frames = np.stack([img] + [(rng.random((h, w, 3)) * 255).astype(np.uint8)
                               for _ in range(3)])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    batch = dino_sam.extract_masks_batch(dino, sam_params, frames, TEXT_PROMPT, vocab=vocab)
    batch = batch.cpu()
    batch_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=per_call)
    tally(counts)
    kernels.reset_launch_counts()
    frame_diff = [int((dino_sam.extract_mask(dino, sam_params, f, TEXT_PROMPT, vocab=vocab)
                       .cpu() != batch[i]).sum()) for i, f in enumerate(frames)]
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=per_call * len(frames))
    tally(counts)
    # where a difference comes from: DINO's outputs for frame 0, batch vs single
    _, single = dino_sam._detect_dispatch(dino, img_dev, TEXT_PROMPT, vocab)
    _, batched = dino_sam._detect_dispatch_batch(dino, torch.from_numpy(frames).to(device),
                                                 TEXT_PROMPT, vocab)
    dino_diff = {k: float((single[k][0] - batched[k][0]).abs().max())
                 for k in ("pred_logits", "pred_boxes")}
    log(json.dumps({"text_location_batch": "extract_masks_batch, 4 frames", "ms": batch_ms,
                    "frame_pixels_differing_from_single": frame_diff,
                    "dino_frame0_batch_vs_single_max_abs": dino_diff,
                    "mask_share_true": [float(m.float().mean()) for m in batch]}))
    if batch.shape != (4, h, w) or max(frame_diff) > MASK_TOL * h * w:
        raise AssertionError(f"batch masks {tuple(batch.shape)} differ from single frames: "
                             f"{frame_diff} pixels")

    # through the pipeline: DINO -> SAM (K4) -> Gatys (K1, K3) -> composite
    boat = os.path.join(ROOT, "data/content_imgs/boat.jpg")
    starry = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")
    reg = ModelRegistry(vgg_params=vgg_weights.get_params(device=device), device=device,
                        mask_extractor=dino_sam.make_mask_extractor(dino, sam_params, vocab))
    req = EffectRequest(text=TextEffectConfig(location_prompt=TEXT_PROMPT), style_transfer=True,
                        gatys=GatysConfig(num_steps=STEPS))
    run = RunMetrics()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = api.apply_image(boat, req, style_image=starry, registry=reg, metrics=run,
                          device=device)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=per_call, **gatys_launches(STEPS))
    tally(counts)
    arr = np.asarray(out)
    log(json.dumps({"text_location_pipeline": f"apply_image, location mask + {STEPS} Gatys "
                    f"steps at {SIZE}px", "seconds": seconds, "image": list(arr.shape),
                    "iters_per_sec": run.extra["iters_per_sec"], "launches": counts,
                    "degraded": run.degraded}))
    if arr.shape != (SIZE, SIZE, 3) or run.degraded:
        raise AssertionError(f"pipeline output {arr.shape}, degraded {run.degraded}")

    # through the CLI: without checkpoints, the border-prior fallback's mask
    out_path = os.path.join(ROOT, "build", "smoke_text_location.png")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    run = RunMetrics()
    kernels.reset_launch_counts()
    rc = cli.main(["--image", boat, "--text-location", TEXT_PROMPT, "--out", out_path,
                   "--device", "cuda"], metrics=run)
    counts = kernels.launch_counts()
    _expect_launches(counts)
    shape = np.asarray(Image.open(out_path)).shape
    log(json.dumps({"text_location_cli": "cli --text-location", "rc": rc, "image": list(shape),
                    "degraded": run.degraded}))
    if rc != 0 or "mask_fallback" not in run.degraded or shape != (SIZE, SIZE, 3):
        raise AssertionError(f"cli --text-location: rc {rc}, degraded {run.degraded}")
    return total, metrics


def _effect_inputs(image: str, flags, device):
    """The request and the input tensors the CLI makes of ``flags``, loaded
    as ``api.apply_image`` loads them (full size, no bucketing)."""
    from tbist_tpu_torch import cli
    from tbist_tpu_torch.utils.imageio import load_image, to_device

    args = cli.build_parser().parse_args(["--image", image, "--out", "unused.png", *flags])
    paths = {"image": args.image, "color_palette_image": args.color_palette,
             "pixel_palette_image": args.pixel_from_image}
    return cli.request_from_args(args), {k: to_device(load_image(p), device=device)
                                         for k, p in paths.items() if p}


def _effect_call(req, tensors, registry):
    """One pipeline call on ``tensors``, ending in the output's read-back."""
    from tbist_tpu_torch.compose import pipeline

    inputs = pipeline.EffectInputs(**{k: v for k, v in tensors.items() if k != "image"})
    return pipeline.apply_image(tensors["image"], req, inputs, registry).cpu()


def run_effects_path(device, smi: str):
    """Phase 9: the cheap effects at their real sizes, then channel attention
    and resumable Gatys. Returns ({kernel: launches over the phase}, metrics)."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import cli, kernels
    from tbist_tpu_torch.compose import pipeline
    from tbist_tpu_torch.ops import palette
    from tbist_tpu_torch.optimize import checkpoint
    from tbist_tpu_torch.utils.imageio import from_device, load_image, to_device
    from tbist_tpu_torch.utils.logging import RunMetrics

    cpu = torch.device("cpu")
    effects = {}
    for name, (image, flags) in EFFECT_RUNS.items():
        req, host = _effect_inputs(image, flags, cpu)
        dev = {k: v.to(device) for k, v in host.items()}
        reg = pipeline.ModelRegistry(device=device)
        kernels.reset_launch_counts()
        _effect_call(req, dev, reg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the inputs, and what earlier phases keep
        times = []
        for _ in range(EFFECT_ITERS):
            t0 = time.perf_counter()
            out = _effect_call(req, dev, reg)
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - held
        again, _, sites = sync_sites(lambda: _effect_call(req, dev, reg))
        _expect_launches(kernels.launch_counts())  # no kernel of the port is on this path
        want = _effect_call(req, host, pipeline.ModelRegistry(device=cpu))
        diff = (out - want).abs()
        n_diff = int((diff > 1e-6).any(-1).sum())
        n_pixels = out.shape[1] * out.shape[2]

        # the same flags through the CLI on the card
        out_path = os.path.join(ROOT, "build", f"smoke_{name}.png")
        run = RunMetrics()
        rc = cli.main(["--image", image, "--out", out_path, *flags, "--device", "cuda"],
                      metrics=run)
        png = np.asarray(Image.open(out_path))
        cli_diff = int((png != np.asarray(from_device(out))).any(-1).sum())
        line = {"effect": name, "flags": [os.path.relpath(f, ROOT) if f.startswith(ROOT) else f
                                          for f in flags],
                "image": list(out.shape[1:]), "ms": float(np.median(times)), "ms_all": times,
                "peak_bytes_of_call": peak, "host_syncs": len(sites), "host_sync_sites": sites,
                "card_vs_cpu_max_abs_err": float(diff.max()),
                "card_vs_cpu_pixels_differing": n_diff, "pixels": n_pixels,
                "repeat_bitwise_equal": bool(torch.equal(out, again)),
                "cli_rc": rc, "cli_pixels_differing_from_pipeline": cli_diff, "card": smi}
        log(json.dumps(line))
        effects[name] = line
        # pixel art's edges and palette decide ties, so it is held by pixels;
        # the other effects are float arithmetic, held to 1e-5
        ok = (n_diff <= PIXEL_TOL * n_pixels if name.startswith("pixel_art")
              else line["card_vs_cpu_max_abs_err"] <= 1e-5)
        if not (ok and rc == 0 and png.shape == tuple(out.shape[1:]) and cli_diff == 0
                and bool(torch.isfinite(out).all()) and line["repeat_bitwise_equal"]):
            raise AssertionError(f"effect {name}: {line}")

    # k-means: two card calls bitwise equal; card and CPU palettes equal from
    # the same initial centres
    picasso = to_device(load_image(PICASSO2), device=device)[0]
    flat = picasso.reshape(-1, 3) * 255.0
    first, second = palette.kmeans(flat, 10), palette.kmeans(flat, 10)
    bitwise = torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    init = palette.draw_init_idx(flat.shape[0], 10)
    times = []
    for _ in range(EFFECT_ITERS):
        t0 = time.perf_counter()
        pal_card = palette.palette_from_image(picasso, 10, init_idx=init)
        times.append((time.perf_counter() - t0) * 1e3)
    pal_cpu = palette.palette_from_image(picasso.cpu(), 10, init_idx=init)
    kline = {"kmeans": f"palette_from_image, {flat.shape[0]} pixels, k 10",
             "ms": float(np.median(times)), "ms_all": times, "two_card_calls_bitwise_equal": bitwise,
             "card_palette_equals_cpu": bool(np.array_equal(pal_card, pal_cpu)),
             "palette": pal_card.tolist()}
    log(json.dumps(kline))
    if not (bitwise and kline["card_palette_equals_cpu"]):
        raise AssertionError(f"k-means: {kline}")

    # channel attention: the Gatys path's run with --channel-attention
    total, ca_metrics, ca_peak = run_main_path(SIZE, STEPS, ["--channel-attention"],
                                               "smoke_channel_attention.png")
    total = dict(total)

    # resumable Gatys: half the steps in two segments, then the rest
    resume_dir = os.path.join(ROOT, "build", "smoke_resume")
    shutil.rmtree(resume_dir, ignore_errors=True)
    boat = os.path.join(ROOT, "data/content_imgs/boat.jpg")
    starry = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")
    resume = []
    half, segment = STEPS // 2, STEPS // 4
    for steps in (half, STEPS):
        run = RunMetrics()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        rc = cli.main(["--image", boat, "--style", starry, "--style-transfer", "--resume-dir",
                       resume_dir, "--steps", str(steps), "--segment-steps", str(segment),
                       "--out", os.path.join(ROOT, "build", "smoke_resume.png"),
                       "--device", "cuda"], metrics=run)
        counts = kernels.launch_counts()
        hist = np.asarray(run.loss_history)
        line = {"resume": f"cli --resume-dir --steps {steps} --segment-steps {segment}", "rc": rc,
                **run.extra, "new_steps": len(hist), "seconds": run.timings_s["gatys"],
                "iters_per_sec": len(hist) / run.timings_s["gatys"],
                "loss_first": float(hist[0]), "loss_last": float(hist[-1]),
                "latest_step": checkpoint.latest_step(resume_dir), "launches": counts}
        log(json.dumps(line))
        resume.append(line)
        if not (rc == 0 and run.extra == {"resumed_at_step": steps - half, "segments": 2}
                and hist.shape == (half,) and np.isfinite(hist).all()
                and line["latest_step"] == steps):
            raise AssertionError(f"resumed run: {line}")
        # each segment is a stylize call: it recomputes the style targets' Grams
        _expect_launches(counts, **gatys_launches(segment, calls=2))
        for k, v in counts.items():
            total[k] += v
    metrics = {"effects": {k: {"ms": v["ms"], "peak_bytes_of_call": v["peak_bytes_of_call"],
                               "host_syncs": v["host_syncs"]} for k, v in effects.items()},
               "kmeans_ms": kline["ms"],
               "channel_attention_iters_per_sec": ca_metrics.extra["iters_per_sec"],
               "channel_attention_max_memory_allocated": ca_peak,
               "resume_iters_per_sec": [r["iters_per_sec"] for r in resume], "card": smi}
    return total, metrics


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


SOURCES = {
    "gram_fwd": ("tbist_tpu_torch/csrc/gram.cu", "tbist_tpu/ops/pallas_gram.py:59"),
    "gram_bwd": ("tbist_tpu_torch/csrc/gram.cu", "tbist_tpu/ops/pallas_gram.py:87"),
    "pool_bwd": ("tbist_tpu_torch/csrc/pool_bwd.cu", "tbist_tpu/ops/pallas_pool.py:87"),
    "relu_pool_bwd": ("tbist_tpu_torch/csrc/pool_bwd.cu",
                      "tbist_tpu/ops/pallas_relu_pool.py:75"),
    "sam_attn": ("tbist_tpu_torch/csrc/sam_attn.cu", "tbist_tpu/ops/pallas_sam_attn.py:57"),
}
# the paths each kernel runs on (text-location: K4 in SAM's encoder behind
# DINO, K1 and K3 where stage 4 runs under the location mask; effects: K1
# and K3 under channel attention and in the resumed segments)
PATHS = {"gram_fwd": "gatys, text-location, effects",
         "gram_bwd": "gatys, text-location, effects",
         "pool_bwd": "none", "relu_pool_bwd": "gatys, text-location, effects",
         "sam_attn": "sam, text-location"}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on the GPU", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "tbist_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    device = torch.device("cuda")

    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        name = torch.cuda.get_device_name(0)
        log(f"nvidia-smi: {smi}")
        log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
            f"count {torch.cuda.device_count()}")

    with phase("build"):
        from tbist_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        logs = _build.build()
        log(f"build seconds {time.perf_counter() - t0:.1f} ({len(logs)} libraries compiled)")
        for source, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or line.startswith("built"):
                    log(f"  {source}: {line.strip()}")

    with phase("kernels"):
        summary = check_kernels(device, SIZE)
        summary["sam_attn"] = check_sam_attn(device)
        conv_cl = check_conv_layout(device, SIZE)

    with phase("agreement"):
        check_agreement(device)
        check_sam_agreement(device)

    with phase("gatys path"):
        counts, metrics, peak = run_main_path(SIZE, STEPS)
        log(f"gatys path: {metrics.extra['iters_per_sec']:.2f} iters/s at {SIZE}px, "
            f"{STEPS} steps, max_memory_allocated {peak / 2**30:.2f} GiB, on {smi}")

    with phase("sam path"):
        counts["sam_attn"], sam_metrics, mask, sam_params = run_sam_path(device, smi)
        log(f"sam path: predict_boxes {sam_metrics['sam_predict_ms']:.2f} ms (median), "
            f"encoder {sam_metrics['encoder_ms']:.2f} ms, max_memory_allocated "
            f"{sam_metrics['max_memory_allocated']} bytes, on {smi}")

    with phase("mask ops"):
        check_mask_ops(device, mask)

    with phase("text-location path"):
        text_counts, text_metrics = run_text_location_path(device, smi, sam_params)
        log(f"text-location path: extract_mask {text_metrics['text_mask_ms']:.2f} ms (median), "
            f"dino {text_metrics['dino_ms']:.2f} ms, {text_metrics['boxes_kept']} boxes kept, "
            f"max_memory_allocated {text_metrics['max_memory_allocated']} bytes, host syncs "
            f"{text_metrics['host_syncs']}, on {smi}")
    del sam_params

    with phase("effects path"):
        effect_counts, effect_metrics = run_effects_path(device, smi)
        log("effects path: " + ", ".join(
            f"{k} {v['ms']:.2f} ms ({v['host_syncs']} host syncs, peak {v['peak_bytes_of_call']} "
            f"bytes above what was held)" for k, v in effect_metrics["effects"].items())
            + f"; k-means {effect_metrics['kmeans_ms']:.2f} ms; channel attention "
            f"{effect_metrics['channel_attention_iters_per_sec']:.2f} iters/s; resumed runs "
            f"{', '.join(f'{r:.2f}' for r in effect_metrics['resume_iters_per_sec'])} iters/s; "
            f"on {smi}")

    launches_by_path = {
        "gatys": {k: v for k, v in counts.items() if k != "sam_attn"},
        "sam": {"sam_attn": counts["sam_attn"]},
        "text-location": text_counts,
        "effects": effect_counts,
    }
    work = {
        "gatys": "one step of the Gatys path at 512px, f32: the sum over its shapes",
        "sam": "one launch at the 1024² encoder (N 12, T 4096, d 64), f32 as 3xTF32",
    }
    rows = []
    for kname, (source, replaces) in SOURCES.items():
        s = summary[kname]
        by_path = {p: c[kname] for p, c in launches_by_path.items() if c.get(kname)}
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "parity": "agree", "path": PATHS[kname],
            "work": work["sam" if kname == "sam_attn" else "gatys"],
        })
    log(f"conv output channels-last at every style layer: {conv_cl}")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
