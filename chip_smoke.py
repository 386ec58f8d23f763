"""Smoke test of the PyTorch/CUDA port (``tbist_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each fatal:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``tbist_tpu_torch/csrc`` with ``nvcc``, in parallel;
3. kernels: each kernel's wrapper at its path's shapes (K1-K3 at 512px, f32
   and bf16, f32 at two lanes as the depth path's batched runs, and f32 at
   the video path's 8 lanes of 480x864; K4 at the 1024² SAM encoder for
   one, four and eight images, at a ragged 24x40 grid and at SAM's 16x16
   grid for a 256 input), held against
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
   segments, then a second call that resumes and runs the other two;
10. text-style path: the feed-forward text style through the pipeline on
   boat.jpg at 512² (seeded Ghiasi and CLIP-MLP, the prompt-seeded
   embedding), bf16 and f32, timed with its host syncs counted, against the
   CPU, and a batch of 8 prompts; the CLIP text tower and T5-base
   (greedy ``generate``) at full width on torch-seeded weights against the
   CPU; ``cli.main --text-style`` (its PNG equal to the pipeline's) and the
   full chain with ``--text-location`` and ``--text-texture`` (fallback
   mask, glyph stencil); the texture-only ``api.apply_image(None, ...)``;
   and the full chain with the seeded DINO+SAM extractor (K4 4 times);
11. depth path: Depth-Anything-V2-Small at full width on torch-seeded
   weights (the forward, and with its input gradient, timed; both against
   the CPU); depth-loss Gatys through the pipeline with it in the loss
   graph, 400 steps at 512px, with the host's CPU time a step; at 128px
   against the CPU, 3 free-running steps, the card's run from a start one
   ulp away, and the loss and gradient at each of the CPU's iterates; MIP
   with two layers in the sequential and (at a quarter of the steps) the
   batched plan, and the batched
   lanes' losses and gradients against each lane alone; the batched lanes
   with the depth term; ``cli.main --depth depth_loss`` and ``--depth
   mip`` (the fallback depth without a checkpoint), each PNG against the
   pipeline's;
12. video path: car.mp4 (852x480, 30 fps, 105 frames, decoded with cv2)
   through the streaming lanes at full width: ``cli.main --video
   --style-transfer`` on one chunk of 8 frames for 400 steps (and 2 steps
   against each frame's own pipeline call), the mixing lane, the
   depth-loss lane with the seeded Depth Anything, ``--text-style`` on all
   frames with 2 dissolve frames at half speed (the first chunk against
   the CPU; host syncs and the device's busy share on a shorter run), the
   masked-text lane with the seeded DINO+SAM batch extractor (K4 4 times)
   against each frame's own pipeline call, a pixel-art chain on all frames
   against the CPU, MIP frame by frame, and the dissolve, card against CPU;
13. serve path: ``serve.make_server(port=0, device="cuda", batch_max=8)`` on
   a thread: /healthz; /v1/image style transfer (400 steps at 512px, K1 and
   K3) bit for bit against ``api.apply_image`` under cuDNN deterministic;
   /v1/image text style under a location mask from the seeded DINO+SAM
   chain (K4) against ``api.apply_image``; a burst of 8 concurrent
   fast-text requests, batched; /v1/video text style on 8 frames of car.mp4
   against ``api.apply_video``; 413 over ``max_body_mb``;
14. cold and warm: ``python -m tbist_tpu_torch.serve`` in two processes, the
   seconds to start and of the first and second Gatys request, without and
   with ``--warmup-size 512 --warmup-programs gatys``;
15. ui: ``ui.basic_cli.main`` with scripted input (mode 0) against
   ``api.apply_image``; ``ui.gradio_app.build_demo`` raises ImportError
   without gradio;
16. weights: ``weights.verify_all.main`` with every family MISSING (exit 0,
   and 1 with ``--strict``), a synthetic torchvision-layout VGG-19 .pth
   through the port's loader on the card, and ``model_load_s`` per family,
   cold and warm, in a fresh process.

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
# 64), (d) SAM at 256 (T = 256), (e) the masked video lane's chunk of 8
# frames; (c) and (d) split their keys
SAM_ATTN_SHAPES = ((12, 64, 64, 64), (48, 64, 64, 64), (3, 24, 40, 64), (12, 16, 16, 64),
                   (96, 64, 64, 64))
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
# the text-style path: the prompts, and the calls each time is the median of
STYLE_PROMPT = "mosaic"
TEXTURE_PROMPT = "fire"
STYLE_ITERS = 10
T5_MAX_LEN = 16
PIXEL_TOL = 1e-3  # share of pixels two computations of pixel art may disagree on
SPIN_HZ = 2e9  # cycles per second of torch.cuda._sleep: at most the H100's 1.98 GHz SM clock
# the video path: car.mp4 (852x480, 30 fps, 105 frames), in chunks of
# VIDEO_LANES frames (VideoConfig.frame_batch's default), which the Gatys
# lanes optimize at their bucket shape, bucket_shape(480, 852, 32, 1024)
VIDEO = os.path.join(ROOT, "data/content_vids/car.mp4")
VIDEO_HW, VIDEO_BUCKET, VIDEO_FPS, VIDEO_FRAMES = (480, 852), (480, 864), 30.0, 105
VIDEO_LANES = 8
VIDEO_SHORT_STEPS = 20  # the mixing, depth-loss and MIP runs
VIDEO_PROFILED_FRAMES = 32  # the text lane's runs under sync debug mode and the profiler


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


def gram_shapes(size, b: int = 1):
    """K1's (B, H·W, C) at the style layers of a ``size`` (a side, or (H, W)) input."""
    h, w = (size, size) if isinstance(size, int) else size
    return [(b, (h >> k) * (w >> k), c) for k, c in enumerate(GRAM_CHANNELS)]


def pool_shapes(size, b: int = 1):
    """K3's (B, H, W, C) at the four pools of a ``size`` (a side, or (H, W)) input."""
    h, w = (size, size) if isinstance(size, int) else size
    return [(b, h >> k, w >> k, c) for k, c in enumerate(POOL_CHANNELS)]


def check_kernels(device, size: int):
    """Phase 3: every kernel against its plain version at the main path's
    shapes: one image in f32 and bf16, two lanes in f32 (MIP's batched plan
    and the batched lanes run VGG-19 at N = 2, K1 on (2, H·W, C); the
    kernels choose their grid and split from the batch), and the video
    path's Gatys lanes in f32 (VIDEO_LANES frames of car.mp4 at their
    VIDEO_BUCKET shape). Returns per-step f32 sums per kernel over the
    one-image shapes, and logs each lane count's sums."""
    from tbist_tpu_torch.utils.precision import full_f32

    with full_f32():  # the plain versions in full f32
        return _check_kernels(device, size)


def _check_kernels(device, size: int):
    import torch

    from tbist_tpu_torch.kernels import gram, pool, relu_pool

    gen = torch.Generator(device=device).manual_seed(0)
    summaries = {}  # lanes -> per-step f32 sums per kernel

    def record(name, shape, dtype, got, want, rtol, atol, ms, plain_ms, lib_ms, nbytes, flops,
               extra=None):
        err = (got.float() - want.float()).abs()
        tol = atol + rtol * want.float().abs()
        ok = bool(torch.all(err <= tol))
        b_ms, b_by = bound_ms(nbytes, flops, str(dtype).split(".")[1])
        line = {
            "kernel": name, "shape": list(shape), "dtype": str(dtype).split(".")[1],
            "max_abs_err": float(err.max()), "rtol": rtol, "atol": atol, "agree": ok,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, **(extra or {}),
        }
        log(json.dumps(line))
        if not ok:
            raise AssertionError(f"{name} {shape} {dtype}: kernel disagrees with plain version")
        if dtype == torch.float32:
            s = summaries.setdefault(shape[0], {}).setdefault(
                name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0})
            s["max_abs_err"] = max(s["max_abs_err"], line["max_abs_err"])
            for k in ("ms", "plain_ms", "bound_ms"):
                s[k] += line[k]
            s["library_ms"] = None if lib_ms is None else s["library_ms"] + lib_ms
            s["bytes_ms"] += nbytes / PEAK_BYTES * 1e3
            s["ops_ms"] += flops / PEAK_FLOPS["float32"] * 1e3

    for dtype, lanes, hw in ((torch.float32, 1, size), (torch.bfloat16, 1, size),
                             (torch.float32, 2, size), (torch.float32, VIDEO_LANES, VIDEO_BUCKET)):
        item = torch.tensor([], dtype=dtype).element_size()
        for b, n, c in gram_shapes(hw, lanes):
            x = torch.randn((b, n, c), generator=gen, device=device).to(dtype)
            norm = 1.0 / (n * c)
            got = gram.gram_fwd(x, norm)
            if not torch.equal(gram.gram_fwd(x, norm), got):
                raise AssertionError(f"gram_fwd {(b, n, c)} {dtype}: two calls differ")

            def plain(x, b=b, norm=norm):
                # lane by lane: cuBLAS runs the batched product, whose sums
                # run over K = H·W up to 262144 terms, without splitting K
                # (slow, and further from f64 than the kernel); one lane's
                # product splits K
                if b == 1:
                    return gram.gram_fwd_plain(x, norm)
                return torch.cat([gram.gram_fwd_plain(x[i:i + 1], norm) for i in range(b)])

            want = plain(x)
            exact = torch.einsum("bnc,bnd->bcd", x.double(), x.double()) * norm
            record("gram_fwd", (b, n, c), dtype, got, want, 1e-5, 1e-5 * float(want.abs().max()),
                   time_ms(lambda x: gram.gram_fwd(x, norm), (x,)), time_ms(plain, (x,)),
                   time_ms(lambda x: torch.matmul(x.transpose(1, 2), x), (x,)),
                   # G is symmetric: the upper triangle and diagonal, C(C+1)/2 dot products
                   b * (n * c * item + c * c * 4), b * n * c * (c + 1),
                   {"max_abs_err_vs_f64": float((got.double() - exact).abs().max()),
                    "plain_max_abs_err_vs_f64": float((want.double() - exact).abs().max()),
                    "batched_plain_max_abs_err_vs_f64": float(
                        (gram.gram_fwd_plain(x, norm).double() - exact).abs().max())})
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
                   b * (2 * n * c * item + c * c * 4), b * 2 * n * c * c)
            del x, m, args, got, want, exact
        for shape in pool_shapes(hw, lanes):
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
        torch.cuda.empty_cache()
    for lanes, summary in summaries.items():
        for s in summary.values():
            s["bound_by"] = "bytes" if s.pop("bytes_ms") >= s.pop("ops_ms") else "operations"
            if not math.isfinite(s["ms"]):
                raise AssertionError(f"kernel time is not finite: {summary}")
        log(json.dumps({"kernel_step_sums": f"{lanes} lane(s), f32, one Gatys step: the sums "
                        "over its shapes", "lanes": lanes, **summary}))
    return summaries[1]


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
    Returns ({kernel: launches over the phase}, metrics, the chain's models:
    (DINO params, SAM params, vocab))."""
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
    return total, metrics, (dino, sam_params, vocab)


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


def _host_ms(fn, iters: int):
    """Median host ms of ``fn()`` (which ends in a read-back) over ``iters``
    calls after two warm-up calls, and the last output."""
    import numpy as np

    for _ in range(2):
        out = fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times, out


@contextlib.contextmanager
def _env(name: str, value: str):
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name)
        else:
            os.environ[name] = saved


def run_text_style_path(device, smi: str, mask_extractor):
    """Phase 10: the feed-forward text style and the emoji texture. Ghiasi
    through the pipeline at 512² (bf16 and f32, batch 8), the CLIP text
    tower and T5-base at full width on torch-seeded weights, the CLI and the
    texture-only API call, pixel art and Reinhard under the texture stencil
    against the CPU, and the full chain with the seeded DINO+SAM
    ``mask_extractor``. Returns ({kernel: launches over the phase}, metrics)."""
    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import api, cli, kernels
    from tbist_tpu_torch.compose import pipeline
    from tbist_tpu_torch.effects import text_transfer as tt
    from tbist_tpu_torch.models import clip_text, sam, t5
    from tbist_tpu_torch.utils import degraded
    from tbist_tpu_torch.utils.config import (EffectRequest, MaskCompositeConfig,
                                              PixelArtConfig, TextEffectConfig)
    from tbist_tpu_torch.utils.imageio import (from_device, load_image, to_device,
                                               to_uint8_device, tree_to)
    from tbist_tpu_torch.utils.logging import RunMetrics
    from tbist_tpu_torch.utils.precision import full_f32

    cpu = torch.device("cpu")
    boat = os.path.join(ROOT, "data/content_imgs/boat.jpg")
    host = to_device(load_image(boat), device=cpu)
    x = host.to(device)
    req = EffectRequest(text=TextEffectConfig(style_prompt=STYLE_PROMPT))
    reg = pipeline.ModelRegistry(device=device)
    metrics = {}

    def call():
        return pipeline.apply_image(x, req, None, reg).cpu()

    # 1. Ghiasi at 512², bf16 (the default) then f32, each the median of
    # STYLE_ITERS pipeline calls ending in the output's read-back
    kernels.reset_launch_counts()
    call()  # warm-up: resolves the weights and the embedding
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    metrics["text_style_ms"], metrics["text_style_ms_all"], out = _host_ms(call, STYLE_ITERS)
    metrics["peak_bytes_of_call"] = torch.cuda.max_memory_allocated() - held
    again, _, sites = sync_sites(call)
    metrics["host_syncs"], metrics["host_sync_sites"] = len(sites), sites
    with _env("TBIST_GHIASI_BF16", "0"):
        metrics["text_style_f32_ms"], metrics["text_style_f32_ms_all"], out32 = _host_ms(
            call, STYLE_ITERS)
        want32 = pipeline.apply_image(host, req, None, pipeline.ModelRegistry(device=cpu))
    # batch 8: eight prompts over the same image, one batched call
    prompts = [STYLE_PROMPT, "fire", "water", "boat", "a painting of flames", "mosaic tiles",
               "starry night", "ink"]
    xb = x.expand(len(prompts), -1, -1, -1).contiguous()
    batch_ms, _, _ = _host_ms(lambda: tt.perform_transfer_batch(xb, prompts).cpu(), STYLE_ITERS)
    metrics["batch8_ms_per_image"] = batch_ms / len(prompts)
    emb_card = tt._pooled_embedding(STYLE_PROMPT, tt.fallback_text_embedding, device).cpu()
    fallback = tt.fallback_text_embedding(STYLE_PROMPT)
    levels = int((to_uint8_device(out).int() - to_uint8_device(out32).int()).abs().max())
    metrics.update({
        "image": list(out.shape), "bf16_vs_f32_max_uint8_levels": levels,
        "card_f32_vs_cpu_f32_max_abs": float((out32 - want32).abs().max()),
        "repeat_bitwise_equal": bool(torch.equal(out, again)),
        "embedding_card_vs_numpy_max_abs": float((emb_card - fallback).abs().max()),
        "degraded": degraded.flags_for(["text_transfer"]),
    })
    counts = kernels.launch_counts()
    _expect_launches(counts)  # no kernel of the port is on this path
    log(json.dumps({"text_style_path": f"pipeline text style, boat.jpg 512², prompt "
                    f"{STYLE_PROMPT!r}, seeded Ghiasi + CLIP-MLP, prompt-seeded embedding",
                    **metrics, "card": smi}))
    if not (levels <= 1 and metrics["card_f32_vs_cpu_f32_max_abs"] <= 1e-4
            and metrics["repeat_bitwise_equal"] and bool(torch.isfinite(out).all())
            and metrics["embedding_card_vs_numpy_max_abs"] <= 1e-6
            and out.shape == (1, SIZE, SIZE, 3)):
        raise AssertionError(f"text style: {metrics}")

    # 2. the CLIP text tower and T5-base at full width, torch-seeded
    gen = torch.Generator().manual_seed(0)
    tower_cpu = clip_text.init_params(gen)
    tower = tree_to(tower_cpu, device)
    tokens = np.zeros((1, clip_text.CONTEXT), np.int64)
    tokens[0, :6] = [49406, 320, 11281, 539, 3293, 49407]  # sot, 4 words, eot
    toks = torch.from_numpy(tokens)
    with full_f32():
        clip_ms, _, emb = _host_ms(lambda: clip_text.encode_tokens(tower, toks.to(device)).cpu(),
                                   STYLE_ITERS)
        emb_cpu = clip_text.encode_tokens(tower_cpu, toks)
    clip_rel = float((emb - emb_cpu).abs().max() / emb_cpu.abs().max())
    del tower, tower_cpu
    # seeded T5-base; as in tests/test_torch_t5.py the decoder's output
    # projections are scaled by 3, so that the greedy decode does not repeat
    # its start token and the card-vs-CPU token check has tokens to compare
    t5_cpu = t5.init_params(torch.Generator().manual_seed(0), t5.BASE)
    for layer in t5_cpu["decoder"]:
        for k in ("self", "cross"):
            layer[k]["o"] *= 3
        layer["mlp"]["wo"] *= 3
    t5_card = tree_to(t5_cpu, device)
    ids = torch.from_numpy(np.random.default_rng(0).integers(2, t5.BASE.vocab, (1, 20)))
    mask = torch.ones(1, 20)
    ids_card, mask_card = ids.to(device), mask.to(device)
    kw = dict(max_len=T5_MAX_LEN)
    t5_ms, _, tokens_card = _host_ms(
        lambda: t5.generate(t5_card, t5.BASE, ids_card, mask_card, **kw).cpu(), STYLE_ITERS)
    _, _, loop_sites = sync_sites(lambda: t5.generate(t5_card, t5.BASE, ids_card, mask_card, **kw))
    tokens_cpu = t5.generate(t5_cpu, t5.BASE, ids, mask, **kw)
    del t5_card, t5_cpu
    models = {"clip_text_ms": clip_ms, "clip_card_vs_cpu_rel": clip_rel,
              "t5_generate_ms": t5_ms, "t5_tokens": tokens_card[0].tolist(),
              "t5_tokens_equal_cpu": bool(torch.equal(tokens_card, tokens_cpu)),
              "t5_host_syncs_in_generate": len(loop_sites), "t5_sync_sites": loop_sites}
    log(json.dumps({"text_models": "CLIP ViT-B/32 text tower (12x512) and T5-base (12+12x768, "
                    f"vocab 32128) on torch-seeded weights; greedy generate max_len {T5_MAX_LEN} "
                    "from 20 ids", **models, "card": smi}))
    metrics.update({k: models[k] for k in ("clip_text_ms", "t5_generate_ms")})
    if not (clip_rel <= 1e-4 and models["t5_tokens_equal_cpu"] and not loop_sites):
        raise AssertionError(f"text models: {models}")

    # 3. the CLI: the text style alone (its PNG equals the pipeline's), the
    # full chain with the fallback mask and the glyph stencil, and the
    # texture-only API call with no input image
    cli_runs = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name, flags in (("style", ["--text-style", STYLE_PROMPT]),
                        ("chain", ["--text-style", STYLE_PROMPT, "--text-location", TEXT_PROMPT,
                                   "--text-texture", TEXTURE_PROMPT])):
        out_path = os.path.join(ROOT, "build", f"smoke_text_{name}.png")
        run = RunMetrics()
        rc = cli.main(["--image", boat, "--out", out_path, *flags, "--device", device.type],
                      metrics=run)
        png = np.asarray(Image.open(out_path))
        cli_runs[name] = {"rc": rc, "image": list(png.shape), "degraded": run.degraded}
        if name == "style":
            cli_runs[name]["pixels_differing_from_pipeline"] = int(
                (png != np.asarray(from_device(out))).any(-1).sum())
    run = RunMetrics()
    stencil = np.asarray(api.apply_image(
        None, EffectRequest(text=TextEffectConfig(texture_prompt=TEXTURE_PROMPT)), metrics=run,
        device=device))
    cli_runs["texture_only_api"] = {"image": list(stencil.shape), "degraded": run.degraded,
                                    "share_set": float((stencil > 0).mean())}
    counts = kernels.launch_counts()
    _expect_launches(counts)
    log(json.dumps({"text_style_cli": cli_runs}))
    chain_flags = {"ghiasi_seeded", "clip_text_fallback", "mask_fallback", "emoji_fallback"}
    if not (cli_runs["style"]["rc"] == 0 and cli_runs["style"]["pixels_differing_from_pipeline"] == 0
            and cli_runs["chain"]["rc"] == 0 and chain_flags <= set(cli_runs["chain"]["degraded"])
            and cli_runs["chain"]["image"] == [SIZE, SIZE, 3]
            and cli_runs["texture_only_api"]["image"] == [172, 172, 3]
            and "emoji_fallback" in run.degraded):
        raise AssertionError(f"text-style CLI: {cli_runs}")

    # 3b. the texture branches of _masked_apply on the card: pixel art and
    # Reinhard run on the original image and are composited through the
    # stencil, inside the fallback location mask and over the whole frame,
    # with composite values other than the text config's emoji ones; each
    # against the same request on the CPU
    sunset = to_device(load_image(os.path.join(ROOT, "data/style_imgs/sunset.png")), device=cpu)
    comp = MaskCompositeConfig(blur_strength=31, step_size_multiplier=0.8, style_strength=1.2)
    texture_runs = {}
    for name, text, effect in (
            ("location+texture, pixel art",
             TextEffectConfig(location_prompt=TEXT_PROMPT, texture_prompt=TEXTURE_PROMPT),
             {"pixel_art": PixelArtConfig(pixel_size=0.3)}),
            ("texture, Reinhard", TextEffectConfig(texture_prompt=TEXTURE_PROMPT),
             {"color_palette": True})):
        treq = EffectRequest(text=text, composite=comp, **effect)
        card_out = pipeline.apply_image(
            x, treq, pipeline.EffectInputs(color_palette_image=sunset.to(device)), reg).cpu()
        cpu_out = pipeline.apply_image(
            host, treq, pipeline.EffectInputs(color_palette_image=sunset),
            pipeline.ModelRegistry(device=cpu))
        diff = (card_out - cpu_out).abs()
        texture_runs[name] = {
            "image": list(card_out.shape), "max_abs": float(diff.max()),
            "share_over_1e-4": float((diff.amax(-1) > 1e-4).float().mean()),
            "share_unchanged": float(((card_out - x.cpu()).abs().amax(-1) < 1e-6)
                                     .float().mean())}
    counts = kernels.launch_counts()
    _expect_launches(counts)
    log(json.dumps({"text_texture_masked_apply": texture_runs}))
    if not all(r["image"] == [1, SIZE, SIZE, 3] and r["share_over_1e-4"] <= MASK_TOL
               and 0 < r["share_unchanged"] < 1 for r in texture_runs.values()):
        raise AssertionError(f"texture branches of _masked_apply: {texture_runs}")

    # 4. the full chain with the seeded DINO+SAM extractor: K4 runs 4 times
    # in its one extract_mask call
    chain_reg = pipeline.ModelRegistry(device=device, mask_extractor=mask_extractor)
    chain_req = EffectRequest(text=TextEffectConfig(style_prompt=STYLE_PROMPT,
                                                    location_prompt=TEXT_PROMPT,
                                                    texture_prompt=TEXTURE_PROMPT))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    chain = pipeline.apply_image(x, chain_req, None, chain_reg).cpu()
    chain_ms = (time.perf_counter() - t0) * 1e3
    counts = kernels.launch_counts()
    _expect_launches(counts, sam_attn=len(sam.BASE.global_layers))
    log(json.dumps({"text_style_chain": "style + DINO/SAM location mask + texture stencil, "
                    "512²", "ms": chain_ms, "image": list(chain.shape), "launches": counts}))
    if not (chain.shape == (1, SIZE, SIZE, 3) and bool(torch.isfinite(chain).all())):
        raise AssertionError(f"text-style chain output {tuple(chain.shape)}")
    metrics["chain_ms"] = chain_ms
    return counts, metrics


def _seeded_depth(device):
    """Depth-Anything-V2-Small on torch-seeded weights (no checkpoint is in
    the repository): (estimator on ``device``, the same estimator on the
    CPU, parameter count)."""
    import functools

    import torch

    from tbist_tpu_torch.models import depth_anything as da
    from tbist_tpu_torch.utils.imageio import tree_to

    params_cpu = da.init_params(torch.Generator().manual_seed(0))
    n = sum(t.numel() for t in _leaves(params_cpu))
    return (functools.partial(da.predict_depth, tree_to(params_cpu, device), da.SMALL),
            functools.partial(da.predict_depth, params_cpu, da.SMALL), n)


def _depth_core_grads(content, device):
    """d mean(depth) / d x of the seeded Depth Anything at its normalized
    518² input x (boat.jpg resized as ``predict_depth`` does), on the card
    and the CPU, in f32 and f64: {"card_f32": ..., "cpu_f64": ...}."""
    import torch

    from tbist_tpu_torch.models import depth_anything as da
    from tbist_tpu_torch.ops.losses import normalize
    from tbist_tpu_torch.utils.imageio import image_resize_bilinear, tree_to
    from tbist_tpu_torch.utils.precision import full_f32

    size, grid = da.SMALL.input_size, da.SMALL.input_size // da.SMALL.patch
    x518 = normalize(image_resize_bilinear(content, (size, size)), da.IMAGENET_MEAN,
                     da.IMAGENET_STD)
    params = da.init_params(torch.Generator().manual_seed(0))
    out = {}
    for name, dev, dtype in (("card_f32", device, torch.float32), ("cpu_f32", None, torch.float32),
                             ("card_f64", device, torch.float64), ("cpu_f64", None, torch.float64)):
        dev = dev or torch.device("cpu")
        p = tree_to(_cast(params, dtype), dev)
        x = x518.to(dev, dtype).requires_grad_(True)
        with full_f32():
            d = da.depth_head(p, da.SMALL, da.encode(p, da.SMALL, x), (grid, grid), (size, size))
            (out[name],) = torch.autograd.grad(d.mean(), x)
    return out


def _cast(tree, dtype):
    """A parameter tree with its floating tensors in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype) if tree.is_floating_point() else tree


def _depth_term(estimator, image, content, w_depth: float) -> float:
    """``optimize.gatys_depth``'s depth term of ``image`` against ``content``."""
    import torch

    from tbist_tpu_torch.ops.losses import depth_loss
    from tbist_tpu_torch.ops.mip import normalize_depth

    with torch.no_grad():
        return float(w_depth * depth_loss(normalize_depth(estimator(image)),
                                          normalize_depth(estimator(content))))


def _loss_grad(cfg, vgg, frames, style, images, w_style=None, depth_fn=None):
    """``gatys.lane_losses`` (the loss of ``gatys.stylize`` and of the
    batched lanes) and its gradient at ``images``, each lane's targets made
    from the same lane of ``frames``, on ``images``' device: ((B,) losses,
    (B, H, W, 3) gradients)."""
    import torch

    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.parallel import batched
    from tbist_tpu_torch.utils.precision import full_f32

    device = images.device
    _, cf, tg, sg = batched.init_batch(cfg, vgg, frames, [style], device)
    td = None
    if depth_fn is not None and cfg.w_depth > 0:
        td = batched.depth_targets(depth_fn, frames.to(device))
    w = cfg.w_style if w_style is None else torch.as_tensor(w_style, device=device)
    x = images.clamp(0.0, 1.0).requires_grad_(True)
    with full_f32():
        loss = gatys.lane_losses(cfg, gatys.params_on(vgg, device, torch.float32), x, cf, tg, sg,
                                 w, depth_fn, td)
        (grad,) = torch.autograd.grad(loss.sum(), x)
    return loss.detach(), grad


def _rel(got, want) -> float:
    """max |got - want| over max |want|, on the CPU."""
    want = want.detach().cpu()
    return float((got.detach().cpu() - want).abs().max() / want.abs().max())


def _l2(got, want) -> float:
    """||got - want|| over ||want||, on the CPU."""
    want = want.detach().cpu().double()
    return float((got.detach().cpu().double() - want).norm() / want.norm())


def run_depth_path(device, smi: str, size: int = SIZE, steps: int = STEPS):
    """Phase 11: depth. Depth-Anything-V2-Small at full width on torch-seeded
    weights (timed, with its input gradient, against the CPU); depth-loss
    Gatys through the pipeline with it in the loss graph; MIP with n = 2 in
    both plans; the batched lanes with the depth term; ``--depth`` through
    the CLI (the fallback depth, as without a checkpoint). Returns
    ({kernel: launches over the phase}, metrics)."""
    import dataclasses

    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import api, cli, kernels
    from tbist_tpu_torch.compose import pipeline
    from tbist_tpu_torch.effects import depth as depth_fx
    from tbist_tpu_torch.ops import mip as mip_ops
    from tbist_tpu_torch.ops.mip import normalize_depth
    from tbist_tpu_torch.optimize import gatys, gatys_depth
    from tbist_tpu_torch.parallel import batched
    from tbist_tpu_torch.utils.config import DepthConfig, EffectRequest, GatysConfig
    from tbist_tpu_torch.utils.imageio import load_image, to_device
    from tbist_tpu_torch.utils.logging import RunMetrics
    from tbist_tpu_torch.utils.precision import full_f32
    from tbist_tpu_torch.utils.prof import host_clock
    from tbist_tpu_torch.weights import vgg as vgg_weights

    cpu = torch.device("cpu")
    boat = os.path.join(ROOT, "data/content_imgs/boat.jpg")
    starry = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")
    content, style = (to_device(load_image(p), bucket=32, max_side=size, device=device)
                      for p in (boat, starry))
    est, est_cpu, n_params = _seeded_depth(device)
    vgg = vgg_weights.get_params(device=device)
    metrics, total = {"depth_anything_params": n_params}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # 1. the seeded model alone: the forward (1370 tokens), the forward with
    # the input gradient, its peak, card against CPU, the map's spread
    def forward():
        with torch.no_grad():
            out = est(content)
        torch.cuda.synchronize()
        return out

    def forward_grad(img=content, fn=est):
        x = img.clone().requires_grad_(True)
        with full_f32():
            (g,) = torch.autograd.grad(fn(x).mean(), x)
        if x.is_cuda:
            torch.cuda.synchronize()
        return g

    kernels.reset_launch_counts()
    metrics["depth_ms"], metrics["depth_ms_all"], depth = _host_ms(forward, STYLE_ITERS)
    forward_grad()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    metrics["depth_grad_ms"], _, grad = _host_ms(forward_grad, 3)
    metrics["depth_grad_peak_bytes"] = torch.cuda.max_memory_allocated() - held
    t0 = time.perf_counter()
    with torch.no_grad():
        want = est_cpu(content.cpu())
    metrics["depth_cpu_seconds"] = time.perf_counter() - t0
    metrics["depth_card_vs_cpu_rel"] = _rel(depth, want)
    # the input gradient, card against CPU, beside its witness: the same
    # gradient with every input pixel one ulp up, on each side. A DPT ReLU
    # whose input crosses 0 between two f32 computations moves it by up to
    # about 1e-2 of max, so each side's f32 is held against f64 as well, at
    # the model's own 518² input (the resizes around it are linear)
    want = forward_grad(content.cpu(), est_cpu)
    up = torch.nextafter(content, torch.full_like(content, 2.0))
    core = _depth_core_grads(content.cpu(), device)
    metrics.update({
        "depth_grad_card_vs_cpu_rel": _rel(grad, want),
        "depth_grad_card_vs_cpu_l2": _l2(grad, want),
        "depth_grad_card_one_ulp_up_rel": _rel(forward_grad(up), grad),
        "depth_grad_cpu_one_ulp_up_rel": _rel(forward_grad(up.cpu(), est_cpu), want),
        "core_grad_card_f32_vs_f64_rel": _rel(core["card_f32"], core["card_f64"]),
        "core_grad_cpu_f32_vs_f64_rel": _rel(core["cpu_f32"], core["card_f64"]),
        "core_grad_card_f64_vs_cpu_f64_rel": _rel(core["card_f64"], core["cpu_f64"]),
    })
    metrics["normalized_depth_std"] = float(normalize_depth(depth).std())
    _expect_launches(kernels.launch_counts())  # no kernel of the port in Depth Anything
    log(json.dumps({"depth_model": f"Depth-Anything-V2-Small, torch-seeded ({n_params} "
                    f"parameters), boat.jpg {size}² -> 518², f32", **metrics,
                    "grad_finite": bool(torch.isfinite(grad).all()), "card": smi}))
    if not (metrics["depth_card_vs_cpu_rel"] <= 1e-4
            and metrics["core_grad_card_f32_vs_f64_rel"] <= 1e-3
            and metrics["core_grad_card_f64_vs_cpu_f64_rel"] <= 1e-6
            and metrics["normalized_depth_std"] > 1e-3 and depth.shape == (size, size)
            and bool(torch.isfinite(grad).all())):
        raise AssertionError(f"seeded Depth Anything: {metrics}")

    # 2. depth-loss Gatys through the pipeline, the seeded model in the graph
    dcfg = DepthConfig(mode="depth_loss")
    req = EffectRequest(depth=dcfg, gatys=GatysConfig(num_steps=steps))
    reg = pipeline.ModelRegistry(device=device, vgg_params=vgg, depth_estimator=est)
    pipeline.apply_image(content, dataclasses.replace(req, gatys=GatysConfig(num_steps=3)),
                         pipeline.EffectInputs(style_image=style), reg)  # warm-up
    run = RunMetrics()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with host_clock() as host:
        out = pipeline.apply_image(content, req, pipeline.EffectInputs(style_image=style), reg,
                                   run)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    one = gatys_depth.stylize_with_depth(content, style, dataclasses.replace(
        req.gatys, num_steps=1, w_depth=dcfg.w_depth), est, vgg, device=device)
    hist = np.asarray(run.loss_history)
    line = {"depth_loss_path": f"pipeline --depth depth_loss, boat.jpg x starry_night.jpg "
                               f"{size}², {steps} steps, seeded Depth Anything in the graph",
            "depth_loss_iters_per_sec": run.extra["iters_per_sec"],
            "seconds": run.timings_s["gatys_depth"], "loss_first": float(hist[0]),
            "loss_last": float(hist[-1]), "loss_min": float(hist.min()),
            "loss_max": float(hist.max()), "loss_argmax": int(hist.argmax()),
            "depth_term_after_step_1": _depth_term(est, one, content, dcfg.w_depth),
            "depth_term_last": _depth_term(est, out, content, dcfg.w_depth),
            "max_memory_allocated": peak, "launches": counts,
            "host_cpu_ms_per_step": host["process_cpu_s"] / steps * 1e3,
            "host_wall_ms_per_step": host["wall_s"] / steps * 1e3, "card": smi}
    log(json.dumps(line))
    add(counts)
    _expect_launches(counts, **gatys_launches(steps))
    # L-BFGS without a line search overshoots early on this objective (the
    # loss peaks at tens of times its start) and need not end below its
    # start within the steps, so progress is the best loss reached
    if not (out.shape == content.shape and np.isfinite(hist).all() and hist.min() < hist[0]
            and line["depth_term_after_step_1"] > 0 and line["depth_term_last"] > 0):
        raise AssertionError(f"depth-loss path: {line}")
    metrics.update({k: line[k] for k in ("depth_loss_iters_per_sec", "depth_term_after_step_1",
                                         "depth_term_last", "host_cpu_ms_per_step")})
    metrics["depth_loss_max_memory_allocated"] = peak
    # card against CPU at 128px, with the fallback depth and with the seeded
    # model, three ways. (a) 3 free-running steps: the loss histories, the
    # first two held. (b) The witness: the card's run from the content image
    # with every pixel one ulp up. L-BFGS's first step is tiny (1/||g||_1),
    # so its curvature pair y = g1 - g0 cancels nearly all of g's digits,
    # and the third loss moves with rounding; (b) says how far. (c) Each of
    # the three iterates: the card's loss at the CPU's iterate, held, so
    # that every step's function is checked without the drift, and its
    # gradient, reported (at kinks: TV's |x| at 0, pool ties, ReLUs)
    cfg3 = GatysConfig(num_steps=3, w_depth=dcfg.w_depth)
    for name, fns in (("fallback depth", (depth_fx._fallback_depth,) * 2),
                      ("seeded Depth Anything", (est, est_cpu))):
        small, imgs = {}, {}
        for dev, fn in zip((device, cpu), fns):
            imgs[dev.type] = [to_device(load_image(p), bucket=32, max_side=128, device=dev)
                              for p in (boat, starry)]
            vgg_dev = vgg_weights.get_params(device=dev)
            m = RunMetrics()
            gatys_depth.stylize_with_depth(*imgs[dev.type], cfg3, fn, vgg_dev, m, device=dev)
            small[dev.type] = np.asarray(m.loss_history)
        c, s = imgs[device.type]
        m = RunMetrics()
        gatys_depth.stylize_with_depth(torch.nextafter(c, torch.full_like(c, 2.0)), s, cfg3,
                                       fns[0], vgg, m, device=device)
        ulp = np.abs(np.asarray(m.loss_history) / small[device.type] - 1)
        rel = np.abs(small[device.type] / small["cpu"] - 1)
        c_cpu, s_cpu = imgs["cpu"]
        vgg_cpu = vgg_weights.get_params(device=cpu)
        forced = []
        for k in range(3):
            it = c_cpu if k == 0 else gatys_depth.stylize_with_depth(
                c_cpu, s_cpu, dataclasses.replace(cfg3, num_steps=k), fns[1], vgg_cpu,
                device=cpu)
            lw, gw = _loss_grad(cfg3, vgg_cpu, c_cpu, s_cpu, it, depth_fn=fns[1])
            lg, gg = _loss_grad(cfg3, vgg, c, s, it.to(device), depth_fn=fns[0])
            forced.append((abs(float(lg[0]) / float(lw[0]) - 1), _rel(gg, gw)))
        line = {"depth_loss_card_vs_cpu": f"3 steps at 128px, {name}",
                "loss_rel_err_by_step": rel.tolist(), "steps_held": 2,
                "card_one_ulp_up_rel_by_step": ulp.tolist(),
                "at_cpu_iterates_loss_rel": [f[0] for f in forced],
                "at_cpu_iterates_grad_rel_of_max": [f[1] for f in forced],
                "card": small[device.type].tolist(), "cpu": small["cpu"].tolist()}
        log(json.dumps(line))
        if not (rel[:2].max() <= 1e-5 and max(f[0] for f in forced) <= 1e-5):
            raise AssertionError(f"depth-loss card and CPU disagree ({name}): {line}")

    # 3. MIP, n = 2, the seeded depth: the sequential plan (the default) at
    # the path's steps, the batched plan at a quarter of them (it saves
    # nothing on one card, and the script keeps to its time), their
    # agreement after 2 steps, and ms a lane's step for each
    mip, batched_steps = {}, steps // 4
    for batched_plan, n_full in ((False, steps), (True, batched_steps)):
        for n_steps in (2, n_full):
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = depth_fx.style_mip(content, style, 2, GatysConfig(num_steps=n_steps), est, vgg,
                                     batched=batched_plan, device=device).cpu()
            ms = (time.perf_counter() - t0) * 1e3
            counts = kernels.launch_counts()
            if n_steps == n_full:
                add(counts)
                # each layer's run computes the style Grams once; the batched
                # plan runs both layers in one launch per Gram and pool
                _expect_launches(counts, **gatys_launches(n_full, calls=1 if batched_plan else 2))
            mip[(batched_plan, n_steps)] = (res, ms, counts)
    metrics["mip_ms"] = mip[(False, steps)][1]
    metrics["mip_batched_ms"] = mip[(True, batched_steps)][1]
    line = {"mip": f"style_mip n 2, seeded depth, {size}², sequential {steps} steps a layer, "
                   f"batched {batched_steps} steps",
            "mip_ms": metrics["mip_ms"], "mip_batched_ms": metrics["mip_batched_ms"],
            "ms_a_lane_step_sequential": metrics["mip_ms"] / (2 * steps),
            "ms_a_lane_step_batched": metrics["mip_batched_ms"] / (2 * batched_steps),
            "plans_gap_after_2_steps": float((mip[(False, 2)][0] - mip[(True, 2)][0]).abs().max()),
            "launches_sequential": mip[(False, steps)][2],
            "launches_batched": mip[(True, batched_steps)][2], "card": smi}
    # the batched plan's lanes against each lane alone: the loss and its
    # gradient at MIP's two layers (its first step), with its per-lane
    # style weights (style_mip's rule: strength 1 keeps w_style, 0.5 maps)
    gcfg = GatysConfig()
    with torch.no_grad():
        layers = mip_ops.generate_layers(content, est(content), 2)
    w = [gcfg.w_style, gatys.style_weight_from_strength(0.5)]
    lb, gb = _loss_grad(gcfg, vgg, layers, style, layers, w_style=w)
    lanes = []
    for i in range(2):
        li, gi = _loss_grad(dataclasses.replace(gcfg, w_style=w[i]), vgg, layers[i:i + 1], style,
                            layers[i:i + 1])
        lanes.append((abs(float(lb[i]) / float(li[0]) - 1), _rel(gb[i], gi[0])))
    line["lanes_vs_alone_loss_rel"] = [v[0] for v in lanes]
    line["lanes_vs_alone_grad_rel_of_max"] = [v[1] for v in lanes]
    log(json.dumps(line))
    if not (line["plans_gap_after_2_steps"] <= 1e-4
            and max(v[0] for v in lanes) <= 2e-5 and max(v[1] for v in lanes) <= 2e-5
            and all(bool(torch.isfinite(r[0]).all()) for r in mip.values())):
        raise AssertionError(f"MIP plans: {line}")

    # 4. the batched lanes with the depth term: 2 frames, 10 steps
    frames = torch.cat([content, torch.flip(content, dims=[2])])
    bcfg = GatysConfig(num_steps=10, w_depth=dcfg.w_depth)
    kernels.reset_launch_counts()
    lanes, lane_hist = batched.run(bcfg, vgg, frames, [style], return_history=True, depth_fn=est,
                                   device=device)
    counts = kernels.launch_counts()
    add(counts)
    _expect_launches(counts, **gatys_launches(10))
    terms = [_depth_term(est, lanes[i:i + 1], frames[i:i + 1], bcfg.w_depth) for i in range(2)]
    line = {"batched_depth_lanes": f"batched.run, 2 frames {size}², 10 steps, seeded depth_fn",
            "loss_first": lane_hist[0].tolist(), "loss_last": lane_hist[-1].tolist(),
            "depth_terms_last": terms, "launches": counts}
    log(json.dumps(line))
    if not (bool(torch.isfinite(lanes).all()) and bool(torch.isfinite(lane_hist).all())
            and min(terms) > 0):
        raise AssertionError(f"batched depth lanes: {line}")

    # 5. the CLI, without a checkpoint: the fallback depth; its PNG against
    # the pipeline's on the same request. cuDNN's default dgrad algorithms
    # are not bitwise repeatable, and L-BFGS spreads a one-ulp difference
    # over 20 steps, so the comparison runs cuDNN deterministic; the
    # pipeline's repeat under the default is reported beside it
    cli_runs = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for mode in ("depth_loss", "mip"):
        out_path = os.path.join(ROOT, "build", f"smoke_depth_{mode}.png")
        argv = ["--image", boat, "--style", starry, "--depth", mode, "--steps", "20",
                "--out", out_path, "--device", device.type]
        req = cli.request_from_args(cli.build_parser().parse_args(argv))

        def pipeline_png():
            return np.asarray(api.apply_image(boat, req, style_image=starry, device=device))

        run = RunMetrics()
        kernels.reset_launch_counts()
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            rc = cli.main(argv, metrics=run)
            want = pipeline_png()
        finally:
            torch.backends.cudnn.deterministic = saved
        png = np.asarray(Image.open(out_path))
        repeat = [pipeline_png() for _ in range(2)]
        add(kernels.launch_counts())
        cli_runs[mode] = {"rc": rc, "image": list(png.shape), "degraded": run.degraded,
                          "pixels_differing_from_pipeline": int((png != want).any(-1).sum()),
                          "default_cudnn_repeat_pixels_differing": int(
                              (repeat[0] != repeat[1]).any(-1).sum())}
    log(json.dumps({"depth_cli": cli_runs}))
    if not all(r["rc"] == 0 and "depth_fallback" in r["degraded"]
               and r["image"] == [SIZE, SIZE, 3] and r["pixels_differing_from_pipeline"] == 0
               for r in cli_runs.values()):
        raise AssertionError(f"--depth through the CLI: {cli_runs}")
    metrics["cli_pixels_differing"] = {k: v["pixels_differing_from_pipeline"]
                                       for k, v in cli_runs.items()}
    return total, metrics


@contextlib.contextmanager
def _written_frames():
    """Yields a list that receives a copy of every uint8 chunk the video
    stream writer encodes, in order."""
    import numpy as np

    from tbist_tpu_torch.video import video as vid

    chunks = []
    real = vid._StreamWriter.__call__

    def spy(self, chunk):
        chunks.append(np.array(chunk))
        return real(self, chunk)

    vid._StreamWriter.__call__ = spy
    try:
        yield chunks
    finally:
        vid._StreamWriter.__call__ = real


def _levels(a, b):
    """|a - b| of two uint8 arrays, as integers."""
    return abs(a.astype("int16") - b.astype("int16"))


def run_video_path(device, smi: str, chain):
    """Phase 12: the video path on car.mp4 at its full 852x480 with full-width
    models on seeded weights: (a) the Gatys lane through the CLI, 400 steps
    on one chunk, and 2 steps against each frame's own pipeline call; (b) the
    mixing lane; (c) the depth-loss lane with the seeded Depth Anything; (d)
    the text lane through the CLI on all 105 frames with 2 dissolve frames
    and slow motion, its first chunk against the CPU, its host syncs and the
    device's busy share; (f) a batchable chain through the CLI on all frames
    against the CPU; (g) MIP on the general per-frame path; (h) the
    dissolve, card against CPU; and last (e) the masked-text lane with the
    seeded DINO+SAM batch extractor (``chain``: DINO params, SAM params,
    vocab) against each frame's own pipeline call. Every lane's
    drive runs with the counts zeroed just before it and read just after.
    Returns ({kernel: launches over the drives}, metrics)."""
    import cv2
    import numpy as np
    import torch

    from tbist_tpu_torch import api, cli, kernels
    from tbist_tpu_torch.compose import pipeline as pipe
    from tbist_tpu_torch.models import dino_sam, sam
    from tbist_tpu_torch.parallel import batched
    from tbist_tpu_torch.utils import prof
    from tbist_tpu_torch.utils.config import (DepthConfig, EffectRequest, GatysConfig,
                                              TextEffectConfig)
    from tbist_tpu_torch.utils.imageio import load_image, to_device, to_uint8_device, upload
    from tbist_tpu_torch.utils.logging import RunMetrics
    from tbist_tpu_torch.video import video as vid

    starry = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")
    picasso = os.path.join(ROOT, "data/style_imgs/picasso.jpg")
    out_dir = os.path.join(ROOT, "build", "video")
    os.makedirs(out_dir, exist_ok=True)
    frames, fps = vid.read_frames(VIDEO)
    log(f"video: {os.path.relpath(VIDEO, ROOT)} decoded with cv2 {cv2.__version__}: "
        f"{len(frames)} frames of {frames[0].shape}, {fps} fps")
    if len(frames) != VIDEO_FRAMES or frames[0].shape != (*VIDEO_HW, 3) or fps != VIDEO_FPS:
        raise AssertionError("car.mp4 did not decode as 105 frames of 852x480 at 30 fps")
    chunk0 = np.stack(frames[:VIDEO_LANES])
    total = {name: 0 for name in kernels.launch_counts()}
    metrics = {"card": smi}

    def drive(fn, **launches):
        """``fn()``, with every count zeroed just before it and read just
        after; returns (its result, seconds, counts, peak bytes)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        _expect_launches(counts, **launches)
        for k, v in counts.items():
            total[k] += v
        return out, seconds, counts, torch.cuda.max_memory_allocated()

    def cli_video(name, flags, max_frames=None):
        out = os.path.join(out_dir, f"{name}.mp4")
        argv = ["--video", VIDEO, *flags, "--out", out, "--device", "cuda"]
        if max_frames:
            argv += ["--max-frames", str(max_frames)]
        run = RunMetrics()
        rc = cli.main(argv, metrics=run)
        if rc != 0:
            raise AssertionError(f"cli --video {' '.join(flags)}: rc {rc}")
        return out, run

    def decoded(path, n, hw=VIDEO_HW, fps=VIDEO_FPS):
        out, out_fps = vid.read_frames(path)
        if len(out) != n or out[0].shape != (*hw, 3) or out_fps != fps:
            raise AssertionError(f"{path}: {len(out)} frames of {out[0].shape} at {out_fps} "
                                 f"fps, expected {n} of {hw} at {fps}")
        return np.stack(out)

    def per_frame(req, inputs, registry, chunk):
        """Each frame through its own ``pipeline.apply_image`` on the card."""
        return np.stack([to_uint8_device(pipe.apply_image(
            upload(f, device)[None].float() / 255.0, req, inputs, registry))[0].cpu().numpy()
            for f in chunk])

    # (a) the Gatys lane: one chunk of 8 lanes at 480x864, 400 steps; the
    # lane's own stream time from CUDA events around batched.run
    lane_events = []
    real_run = batched.run

    def timed_run(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_run(*a, **kw)
        end.record()
        lane_events.append((start, end))
        return out

    batched.run = timed_run
    try:
        (path, run), seconds, counts, peak = drive(
            lambda: cli_video("gatys", ["--style", starry, "--style-transfer", "--steps",
                                        str(STEPS)], VIDEO_LANES), **gatys_launches(STEPS))
    finally:
        batched.run = real_run
    out = decoded(path, VIDEO_LANES)
    lane_ms = sum(s.elapsed_time(e) for s, e in lane_events)
    metrics.update(video_gatys_s=seconds, video_gatys_frames_per_sec=VIDEO_LANES / seconds,
                   video_gatys_ms_per_step=lane_ms / STEPS, video_gatys_max_memory_allocated=peak)
    change = float(_levels(out, chunk0).mean())
    log(json.dumps({"video_gatys": f"cli --video car.mp4 --style-transfer, {VIDEO_LANES} frames, "
                    f"{STEPS} steps, one chunk of {VIDEO_LANES} lanes at {VIDEO_BUCKET}",
                    "seconds": seconds, "frames_per_sec": VIDEO_LANES / seconds,
                    "lane_ms_per_step": lane_ms / STEPS, "max_memory_allocated": peak,
                    "mean_levels_changed": change, "launches": counts,
                    "degraded": run.degraded}))
    if not change > 1.0:
        raise AssertionError("the Gatys lane left the frames as they were")
    reg = pipe.ModelRegistry(device=device)
    inputs = pipe.EffectInputs(style_image=to_device(load_image(starry), device=device))
    req = EffectRequest(style_transfer=True, gatys=GatysConfig(num_steps=2))
    lanes = np.stack(vid._batched_style(list(chunk0), req, inputs, reg, device=device))
    diff = _levels(lanes, per_frame(req, inputs, reg, chunk0))
    log(json.dumps({"video_gatys_lanes_vs_frames": "2 steps, 8 lanes against each frame's "
                    "apply_image", "max_levels": int(diff.max()),
                    "share_over_1": float((diff > 1).mean())}))
    if diff.max() > 2:
        raise AssertionError(f"Gatys lanes differ from single frames by {diff.max()} levels")

    # (b) the mixing lane, two styles
    (path, run), seconds, counts, _ = drive(
        lambda: cli_video("mixing", ["--mixing", "--style", starry, "--style2", picasso,
                                     "--steps", str(VIDEO_SHORT_STEPS)], VIDEO_LANES),
        **gatys_launches(VIDEO_SHORT_STEPS))
    decoded(path, VIDEO_LANES)
    metrics["video_mixing_s"] = seconds
    log(json.dumps({"video_mixing": f"cli --mixing, {VIDEO_LANES} frames, {VIDEO_SHORT_STEPS} "
                    "steps", "seconds": seconds, "launches": counts}))

    # (c) the depth-loss lane with the seeded Depth-Anything-V2-Small: each
    # frame's target once, then each lane's depth term every step
    estimator, _, _ = _seeded_depth(device)
    depth_calls = []

    def counted(img):
        depth_calls.append(img.shape[0])
        return estimator(img)

    run = RunMetrics()
    path, seconds, counts, peak = drive(lambda: api.apply_video(
        VIDEO, EffectRequest(depth=DepthConfig(mode="depth_loss"),
                             gatys=GatysConfig(num_steps=VIDEO_SHORT_STEPS)),
        style_image=starry, registry=pipe.ModelRegistry(device=device, depth_estimator=counted),
        out_path=os.path.join(out_dir, "depth.mp4"), max_frames=VIDEO_LANES, metrics=run,
        device=device), **gatys_launches(VIDEO_SHORT_STEPS))
    decoded(path, VIDEO_LANES)
    metrics.update(video_depth_s=seconds, video_depth_max_memory_allocated=peak)
    log(json.dumps({"video_depth": f"api.apply_video depth_loss, seeded Depth Anything, "
                    f"{VIDEO_LANES} frames, {VIDEO_SHORT_STEPS} steps", "seconds": seconds,
                    "depth_fn_calls": len(depth_calls), "max_memory_allocated": peak,
                    "launches": counts, "degraded": run.degraded}))
    if depth_calls != [1] * (VIDEO_LANES * (VIDEO_SHORT_STEPS + 1)):
        raise AssertionError(f"the depth term did not reach every lane: {len(depth_calls)} calls")

    # (d) the text lane: the first chunk against the CPU (bf16 both), then
    # all frames through the CLI with 2 dissolve frames at half speed
    text = EffectRequest(text=TextEffectConfig(style_prompt=STYLE_PROMPT))
    card = np.stack(vid._batched_text_transfer(list(chunk0), text, device=device))
    cpu = np.stack(vid._batched_text_transfer(list(chunk0), text, device=torch.device("cpu")))
    text_diff = int(_levels(card, cpu).max())
    flags = ["--text-style", STYLE_PROMPT, "--interp-frames", "2", "--slowmo", "0.5"]
    (path, run), seconds, counts, peak = drive(lambda: cli_video("text", flags))
    n_out, out_fps = VIDEO_FRAMES + (VIDEO_FRAMES - 1) * 2, math.floor(VIDEO_FPS * 3 * 0.5)
    decoded(path, n_out, fps=out_fps)
    req = cli.request_from_args(cli.build_parser().parse_args(["--out", "x", *flags]))

    def short():
        return api.apply_video(VIDEO, req, out_path=os.path.join(out_dir, "text_short.mp4"),
                               max_frames=VIDEO_PROFILED_FRAMES, device=device)

    _, short_ms, sites = sync_sites(short)
    with prof.trace() as p:
        short()
    torch.cuda.synchronize()
    busy = prof.device_breakdown(p)
    n_chunks = -(-VIDEO_PROFILED_FRAMES // VIDEO_LANES)
    metrics.update(video_text_frames_per_sec=VIDEO_FRAMES / seconds,
                   video_text_host_syncs_per_chunk=len(sites) / n_chunks,
                   video_text_busy_share=busy.get("busy_share"))
    log(json.dumps({"video_text": f"cli --video car.mp4 {' '.join(flags)}: {VIDEO_FRAMES} "
                    f"frames in, {n_out} out at {out_fps} fps", "seconds": seconds,
                    "frames_per_sec": VIDEO_FRAMES / seconds, "max_memory_allocated": peak,
                    "first_chunk_card_vs_cpu_max_levels": text_diff,
                    "short_run": f"{VIDEO_PROFILED_FRAMES} frames, {n_chunks} chunks",
                    "short_run_ms_sync_debug": short_ms,
                    "host_syncs_per_chunk": len(sites) / n_chunks,
                    "host_sync_sites": sorted(set(sites)),
                    "profiled_busy_share": busy.get("busy_share"),
                    "profiled_window_ms": busy.get("window_ms"),
                    "profiled_kernel_ms_by_kind": busy.get("kernel_ms_by_kind"),
                    "degraded": run.degraded}))
    if text_diff > 1:
        raise AssertionError(f"text lane: card and CPU differ by {text_diff} levels")

    # (f) a batchable chain through the CLI on all frames, against the CPU
    flags = ["--grayscale", "--pixel-art", "--pixel-palette", "3", "--pixel-edges"]
    with _written_frames() as written:
        (path, _), seconds, counts, _ = drive(lambda: cli_video("pixel_art", flags))
    got = np.concatenate(written)
    req = cli.request_from_args(cli.build_parser().parse_args(["--out", "x", *flags]))
    cpu_reg = pipe.ModelRegistry(device=torch.device("cpu"))
    want = np.concatenate([to_uint8_device(pipe.apply_image(
        torch.from_numpy(np.stack(frames[i:i + VIDEO_LANES])).float() / 255.0, req, None,
        cpu_reg)).numpy() for i in range(0, VIDEO_FRAMES, VIDEO_LANES)])
    share = float((got != want).any(-1).mean())
    decoded(path, VIDEO_FRAMES)
    metrics["video_pixel_art_frames_per_sec"] = VIDEO_FRAMES / seconds
    log(json.dumps({"video_batchable_chain": f"cli --video car.mp4 {' '.join(flags)}, "
                    f"{VIDEO_FRAMES} frames", "seconds": seconds,
                    "frames_per_sec": VIDEO_FRAMES / seconds,
                    "share_of_pixels_differing_from_cpu": share, "launches": counts}))
    if share > PIXEL_TOL:
        raise AssertionError(f"batchable chain: {share} of the pixels differ from the CPU")

    # (g) MIP on the general path, frame by frame: two layers, each a
    # stylize call, with the fallback depth (no checkpoint)
    (path, run), seconds, counts, _ = drive(
        lambda: cli_video("mip", ["--depth", "mip", "--style", starry, "--steps",
                                  str(VIDEO_SHORT_STEPS)], 2),
        **gatys_launches(VIDEO_SHORT_STEPS, calls=2 * 2))
    decoded(path, 2)
    log(json.dumps({"video_mip": f"cli --depth mip, 2 frames, {VIDEO_SHORT_STEPS} steps",
                    "seconds": seconds, "launches": counts, "degraded": run.degraded}))
    if "depth_fallback" not in run.degraded:
        raise AssertionError(f"--depth mip without a checkpoint: degraded {run.degraded}")

    # (h) the dissolve on the card against the CPU, bit for bit
    prev, chunk = (torch.from_numpy(np.stack(f)) for f in (frames[:1], frames[1:1 + VIDEO_LANES]))
    same = {k: bool(torch.equal(vid._dissolve_chunk(prev.to(device), chunk.to(device), k).cpu(),
                                vid._dissolve_chunk(prev, chunk, k))) for k in (2, 5)}
    log(json.dumps({"video_dissolve": "card vs cpu, bit for bit", "k": same}))
    if not all(same.values()):
        raise AssertionError(f"dissolve: card and CPU differ: {same}")
    # (e) the masked-text lane: one DINO and one SAM encoder call for the
    # chunk (K4 once a global layer, N = 8 frames x 12 heads). The batch
    # extractor's first call, on the chunk, warms DINO and SAM up at these
    # shapes; its masks are held against the single-frame extractor's on
    # the same frames (at most MASK_TOL of a frame's pixels apart, as in
    # the text-location phase: the chunk's matmuls round otherwise, DINO's
    # top-900 queries come in another order, SAM's mask logits near 0 flip)
    dino, sam_params, vocab = chain
    mask_extractor = dino_sam.make_mask_extractor(dino, sam_params, vocab)
    batch_mask_extractor = dino_sam.make_batch_mask_extractor(dino, sam_params, vocab)
    frames_dev = torch.from_numpy(chunk0).to(device)
    batch_masks = batch_mask_extractor(frames_dev, TEXT_PROMPT)
    mask_diff = torch.stack([batch_masks[i] != mask_extractor(f, TEXT_PROMPT)
                             for i, f in enumerate(frames_dev)])
    masked = EffectRequest(text=TextEffectConfig(style_prompt=STYLE_PROMPT,
                                                 location_prompt=TEXT_PROMPT))
    with _written_frames() as written:
        _, seconds, counts, peak = drive(lambda: api.apply_video(
            VIDEO, masked, registry=pipe.ModelRegistry(
                device=device, batch_mask_extractor=batch_mask_extractor),
            out_path=os.path.join(out_dir, "masked.mp4"), max_frames=VIDEO_LANES,
            device=device), sam_attn=len(sam.BASE.global_layers))
    lane = np.concatenate(written)
    metrics.update(video_masked_chunk_ms=seconds * 1e3, video_masked_max_memory_allocated=peak)
    # each frame through its own pipeline call, (1) given the lane's mask of
    # that frame: the lane's Ghiasi batch and composite against a frame's;
    # (2) with the single-frame extractor: the composite feathers the mask
    # (edge_smoothing), so a pixel where the two extractors' masks differ
    # moves the output within the feathering radius around it, and only there
    own = np.concatenate([per_frame(masked, None, pipe.ModelRegistry(
        device=device, mask_extractor=lambda img, prompt, i=i, **kw: batch_masks[i]),
        chunk0[i:i + 1]) for i in range(VIDEO_LANES)])
    singles = per_frame(masked, None, pipe.ModelRegistry(device=device,
                                                         mask_extractor=mask_extractor), chunk0)
    k = int(masked.text.edge_smoothing) | 1
    near = torch.nn.functional.max_pool2d(mask_diff.float()[:, None], k, 1, k // 2)[:, 0]
    over = torch.from_numpy((_levels(lane, singles) > 1).any(-1)).to(device)
    share_mask = mask_diff.float().mean((1, 2)).tolist()
    share_own = [float((_levels(a, b) > 1).any(-1).mean()) for a, b in zip(lane, own)]
    share_single = over.float().mean((1, 2)).tolist()
    unexplained = int((over & (near == 0)).sum())
    log(json.dumps({"video_masked_text": f"api.apply_video --text-style {STYLE_PROMPT} "
                    f"--text-location {TEXT_PROMPT}, seeded DINO+SAM, {VIDEO_LANES} frames",
                    "chunk_ms": seconds * 1e3, "max_memory_allocated": peak, "launches": counts,
                    "mask_share_batch_vs_single_extractor": share_mask,
                    "share_over_1_level_vs_frames_given_the_lane_masks": share_own,
                    "share_over_1_level_vs_frames_with_the_single_extractor": share_single,
                    "pixels_over_1_level_outside_the_feathered_mask_difference": unexplained}))
    if (lane.shape != (VIDEO_LANES, *VIDEO_HW, 3) or max(share_mask) > MASK_TOL
            or max(share_own) > MASK_TOL or unexplained):
        raise AssertionError(f"masked lane {lane.shape}: masks {share_mask}, given the lane's "
                             f"masks {share_own}, unexplained pixels {unexplained}")
    return total, metrics


def _b64_file(path: str) -> str:
    import base64

    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode("ascii")


def _http(url: str, payload=None, timeout: float = 600.0):
    """GET ``url`` (POST ``payload`` as JSON when given) -> (status, reply)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _png_array(b64: str):
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _in_process_server(**kw):
    """``serve.make_server(port=0, device="cuda", **kw)`` answering on a
    thread; yields (server, url), and shuts it down after."""
    import threading

    from tbist_tpu_torch import serve

    srv = serve.make_server(port=0, device="cuda", **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(30)


def run_serve_path(device, smi: str, chain):
    """Phase 13: the HTTP server in this process, on a thread, with batching
    (max 8): (a) /healthz; (b) /v1/image style transfer, 400 steps at 512px,
    bit for bit against ``api.apply_image`` under cuDNN deterministic; (c)
    /v1/image text style under a location mask from the seeded DINO+SAM
    ``chain`` (K4 4 times an encoder call) against ``api.apply_image``; (d)
    a burst of 8 concurrent fast-text requests, batched, each within one
    level of a lone request; (e) /v1/video text style on 8 frames of
    car.mp4 against ``api.apply_video``; (f) 413 over ``max_body_mb``.
    Every count is zeroed just before each request and read just after;
    returns ({kernel: launches over the requests}, metrics)."""
    import concurrent.futures

    import numpy as np
    import torch

    from tbist_tpu_torch import api, kernels, serve
    from tbist_tpu_torch.effects import masking
    from tbist_tpu_torch.models import dino_sam, sam
    from tbist_tpu_torch.utils.request_schema import request_from_dict

    boat = _b64_file(os.path.join(ROOT, "data/content_imgs/boat.jpg"))
    starry = _b64_file(os.path.join(ROOT, "data/style_imgs/starry_night.jpg"))
    per_call = len(sam.BASE.global_layers)
    total = {name: 0 for name in kernels.launch_counts()}
    metrics = {"card": smi}

    def request(url, path, body, **launches):
        """One HTTP request with every count zeroed just before it and read
        just after; returns (status, reply, seconds)."""
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        status, reply = _http(url + path, body)
        seconds = time.perf_counter() - t0
        counts = kernels.launch_counts()
        _expect_launches(counts, **launches)
        for k, v in counts.items():
            total[k] += v
        if status != 200:
            raise AssertionError(f"{path}: {status} {reply.get('error')}")
        return reply, seconds

    with _in_process_server(batch_max=8) as (srv, url):
        # (a) what the server runs on
        status, health = _http(url + "/healthz")
        metrics["healthz"] = health
        if not (status == 200 and health["backend"] == "cuda" and health["devices"] == 1
                and health["batching"]["max_batch"] == 8):
            raise AssertionError(f"/healthz: {status} {health}")

        # (b) style transfer: K1 and K3 behind /v1/image, bit for bit
        body = {"image": boat, "style_image": starry,
                "request": {"style_transfer": True, "gatys": {"num_steps": STEPS}}}
        saved = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            reply, seconds = request(url, "/v1/image", body, **gatys_launches(STEPS))
            want = api.apply_image(serve._decode_image(boat), request_from_dict(body["request"]),
                                   style_image=serve._decode_image(starry), device=device)
        finally:
            torch.backends.cudnn.deterministic = saved
        got = _png_array(reply["image"])
        differing = int((got != np.asarray(want)).any(-1).sum())
        metrics.update(serve_gatys_s=seconds, serve_gatys_timings_s=reply["timings_s"],
                       serve_gatys_pixels_differing=differing)
        log(json.dumps({"serve_gatys": f"POST /v1/image style_transfer, {STEPS} steps at "
                        f"{SIZE}px", "seconds": seconds, "timings_s": reply["timings_s"],
                        "image": list(got.shape), "degraded": reply["degraded"],
                        "pixels_differing_from_api": differing}))
        if got.shape != (SIZE, SIZE, 3) or differing:
            raise AssertionError(f"/v1/image style transfer: {got.shape}, {differing} pixels "
                                 "differ from api.apply_image")

        # (c) the text style under the seeded DINO+SAM location mask (K4):
        # the registry each request builds looks its extractor up by name
        extractor = dino_sam.make_mask_extractor(*chain)
        real = masking.default_mask_extractor
        masking.default_mask_extractor = lambda device="cuda": extractor
        try:
            body = {"image": boat, "request": {"text": {"style_prompt": STYLE_PROMPT,
                                                        "location_prompt": TEXT_PROMPT}}}
            reply, seconds = request(url, "/v1/image", body, sam_attn=per_call)
            want = np.asarray(api.apply_image(serve._decode_image(boat),
                                              request_from_dict(body["request"]), device=device))
        finally:
            masking.default_mask_extractor = real
        got = _png_array(reply["image"])
        share = float((got != want).any(-1).mean())
        metrics.update(serve_masked_text_s=seconds, serve_masked_text_share_differing=share)
        log(json.dumps({"serve_masked_text": f"POST /v1/image text style {STYLE_PROMPT!r} "
                        f"under location {TEXT_PROMPT!r}, seeded SwinT-OGC + ViT-B",
                        "seconds": seconds, "image": list(got.shape),
                        "share_of_pixels_differing_from_api": share}))
        if got.shape != (SIZE, SIZE, 3) or share > MASK_TOL:
            raise AssertionError(f"/v1/image masked text: {share} of pixels differ")

        # (d) a burst of 8 concurrent fast-text requests through the batcher
        body = {"image": boat, "request": {"text": {"style_prompt": STYLE_PROMPT}}}
        before = srv.batcher.batches_run
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as ex:
            burst = list(ex.map(lambda _: _http(url + "/v1/image", body), range(8)))
        burst_s = time.perf_counter() - t0
        _expect_launches(kernels.launch_counts())
        batches = srv.batcher.batches_run - before
        lone, lone_s = request(url, "/v1/image", body)
        lone_img = _png_array(lone["image"]).astype(np.int16)
        levels = [int(np.abs(_png_array(r["image"]).astype(np.int16) - lone_img).max())
                  if s == 200 else -1 for s, r in burst]
        metrics.update(serve_burst_s=burst_s, serve_burst_batches=batches,
                       serve_lone_text_s=lone_s, batches_run=srv.batcher.batches_run)
        log(json.dumps({"serve_burst": f"8 concurrent POST /v1/image text style "
                        f"{STYLE_PROMPT!r}", "seconds": burst_s, "batches_run": batches,
                        "batch_sizes": [r.get("batch") for _, r in burst],
                        "lone_request_s": lone_s, "max_levels_from_lone": levels}))
        if batches >= 8 or min(levels) < 0 or max(levels) > 1:
            raise AssertionError(f"burst: {batches} batches, levels from lone {levels}")

        # (e) /v1/video: the text lane on 8 frames of car.mp4, against the
        # frames api.apply_video hands its writer
        vreq = {"text": {"style_prompt": STYLE_PROMPT}}
        with _written_frames() as served:
            reply, seconds = request(url, "/v1/video", {"video": _b64_file(VIDEO),
                                                        "request": vreq,
                                                        "max_frames": VIDEO_LANES})
        with _written_frames() as direct:
            api.apply_video(VIDEO, request_from_dict(vreq), max_frames=VIDEO_LANES,
                            out_path=os.path.join(ROOT, "build", "smoke_serve_video.mp4"),
                            device=device)
        served, direct = np.concatenate(served), np.concatenate(direct)
        video_levels = int(_levels(served, direct).max())
        metrics.update(serve_video_s=seconds, serve_video_max_levels=video_levels)
        log(json.dumps({"serve_video": f"POST /v1/video text style, {VIDEO_LANES} frames of "
                        "car.mp4", "seconds": seconds, "frames": list(served.shape),
                        "reply_mp4_bytes": len(reply["video"]) * 3 // 4,
                        "max_levels_from_api": video_levels}))
        if served.shape != (VIDEO_LANES, *VIDEO_HW, 3) or video_levels > 1:
            raise AssertionError(f"/v1/video: {served.shape}, {video_levels} levels from api")

    # (f) a body over --max-body-mb is refused before it is read
    with _in_process_server(max_body_mb=0.001) as (_, url):
        status, reply = _http(url + "/v1/image", {"image": boat, "request": {}})
    log(json.dumps({"serve_413": status, "error": reply.get("error")}))
    if status != 413 or "max-body-mb" not in reply.get("error", ""):
        raise AssertionError(f"oversized body: {status} {reply}")
    return total, metrics


def _serve_process(tag: str, flags, body, n_requests: int):
    """``python -m tbist_tpu_torch.serve`` in a process of its own on a free
    port: (seconds until /healthz answers, its /healthz, the seconds of each
    of ``n_requests`` POSTs of ``body`` to /v1/image). The server's log goes
    to build/serve_<tag>.log; the process is stopped after."""
    port = _free_port()
    url = f"http://127.0.0.1:{port}"
    log_path = os.path.join(ROOT, "build", f"serve_{tag}.log")
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "tbist_tpu_torch.serve", "--port",
                                 str(port), *flags], cwd=ROOT, stdout=logf,
                                stderr=subprocess.STDOUT)
        try:
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"serve {tag} exited with {proc.returncode}; see "
                                         f"{log_path}")
                try:
                    _, health = _http(url + "/healthz", timeout=5)
                    break
                except OSError:
                    if time.perf_counter() - t0 > 600:
                        raise
                    time.sleep(0.1)
            startup = time.perf_counter() - t0
            seconds = []
            for _ in range(n_requests):
                t1 = time.perf_counter()
                status, reply = _http(url + "/v1/image", body)
                seconds.append(time.perf_counter() - t1)
                if status != 200 or _png_array(reply["image"]).shape != (SIZE, SIZE, 3):
                    raise AssertionError(f"serve {tag}: {status} {reply.get('error')}")
        finally:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    return startup, health, seconds


def run_cold_warm(smi: str):
    """Phase 14: what a fresh server process pays for its first Gatys
    request (512px, 400 steps), with and without ``--warmup-size 512
    --warmup-programs gatys``. The kernel libraries were built by phase 2,
    so neither process runs nvcc; the VGG-19 draw is on disk
    (weights_cache/torch/) from the earlier phases."""
    body = {"image": _b64_file(os.path.join(ROOT, "data/content_imgs/boat.jpg")),
            "style_image": _b64_file(os.path.join(ROOT, "data/style_imgs/starry_night.jpg")),
            "request": {"style_transfer": True, "gatys": {"num_steps": STEPS}}}
    cold_start, _, (first, second) = _serve_process("cold", [], body, 2)
    warm_start, health, (warm_first,) = _serve_process(
        "warm", ["--warmup-size", str(SIZE), "--warmup-programs", "gatys"], body, 1)
    metrics = {"serve_startup_s": cold_start, "serve_first_request_s": first,
               "serve_second_request_s": second, "warmed_startup_s": warm_start,
               "warmup_s": health.get("warmup_s"), "warmed_first_request_s": warm_first,
               "card": smi}
    log(json.dumps({"serve_cold_warm": f"python -m tbist_tpu_torch.serve, POST /v1/image "
                    f"style_transfer {STEPS} steps at {SIZE}px; kernel libraries already built "
                    "(no nvcc in either process)", **metrics}))
    if not warm_first <= first:
        raise AssertionError(f"the warmed server's first request took {warm_first:.2f} s, the "
                             f"cold one's {first:.2f} s")
    return metrics


def run_ui(device):
    """Phase 15: ``ui.basic_cli.main`` with scripted input for mode 0 (the
    text style on boat.jpg), its PNG against ``api.apply_image``; and
    ``ui.gradio_app.build_demo`` raising ImportError without gradio."""
    import builtins

    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import api, kernels
    from tbist_tpu_torch.ui import basic_cli, gradio_app

    boat = os.path.join(ROOT, "data/content_imgs/boat.jpg")
    out_path = os.path.join(ROOT, "build", "smoke_basic_cli.png")
    answers = iter(["0", boat, STYLE_PROMPT, out_path])
    real = builtins.input
    builtins.input = lambda prompt="": next(answers)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    try:
        rc = basic_cli.main(["--device", "cuda"])
    finally:
        builtins.input = real
    _expect_launches(kernels.launch_counts())
    want = np.asarray(api.apply_image(boat, basic_cli._request_for(0, {"transfer": STYLE_PROMPT}),
                                      device=device))
    got = np.asarray(Image.open(out_path))
    differing = int((got != want).any(-1).sum())
    try:
        gradio_app.build_demo(device="cuda")
        gradio = "built"
    except ImportError as e:
        gradio = f"ImportError: {e}"
    log(json.dumps({"ui_basic_cli": f"mode 0, {STYLE_PROMPT!r} on boat.jpg", "rc": rc,
                    "image": list(got.shape), "pixels_differing_from_api": differing,
                    "gradio_build_demo": gradio}))
    if rc != 0 or got.shape != (SIZE, SIZE, 3) or differing or not gradio.startswith("Import"):
        raise AssertionError(f"ui: rc {rc}, {differing} pixels differ, build_demo {gradio}")


MODEL_FAMILIES = ("vgg", "ghiasi+mlp", "clip", "dino", "sam", "t5", "depth")


def model_load_s():
    """Seconds to resolve each model family on the card in this process,
    each twice: cold (the family's first resolution in the process) and
    warm (the second). Without checkpoints every family is a seeded draw:
    VGG-19 and Ghiasi+CLIP-MLP through their production loaders (VGG's
    seed cache emptied before the cold run, filled by it), the rest
    through their ``init_params`` at full width, moved to the card. Run it
    in a fresh process, as phase 16 does."""
    import tempfile

    import torch

    from tbist_tpu_torch.models import clip_text, sam, t5
    from tbist_tpu_torch.models import depth_anything as da
    from tbist_tpu_torch.utils.imageio import tree_to
    from tbist_tpu_torch.weights import dino_convert, ghiasi_convert, seed_cache
    from tbist_tpu_torch.weights import sam as wsam
    from tbist_tpu_torch.weights import vgg as vgg_weights

    device = torch.device("cuda")
    torch.ones(1, device=device).sum().item()  # the CUDA context, outside the times
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731

    def production(loader):
        loader.cache_clear()
        return loader(device=device)

    families = {
        "vgg": lambda: production(vgg_weights.get_params),
        "ghiasi+mlp": lambda: production(ghiasi_convert.get_params),
        "clip": lambda: tree_to(clip_text.init_params(gen()), device),
        "dino": lambda: dino_convert.to_device(dino_convert.init_params(gen()), device),
        "sam": lambda: wsam.init_params(gen(), sam.BASE, device=device),
        "t5": lambda: tree_to(t5.init_params(gen(), t5.BASE), device),
        "depth": lambda: tree_to(da.init_params(gen()), device),
    }
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        seed_cache._CACHE_DIR = tmp
        for name in MODEL_FAMILIES:
            times = []
            for _ in range(2):
                t0 = time.perf_counter()
                params = families[name]()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name] = {"cold": times[0], "warm": times[1],
                         "parameters": sum(t.numel() for t in _leaves(params))}
            del params
    return out


def run_weights(device, smi: str):
    """Phase 16: the weight runbook and the loads. ``verify_all.main([])``
    exits 0 with every family MISSING and 1 with ``--strict``; a synthetic
    torchvision-layout VGG-19 .pth PASSes through the port's loader on the
    card; then ``model_load_s`` in a fresh process."""
    import tempfile

    import torch

    from tbist_tpu_torch.models import vgg19
    from tbist_tpu_torch.weights import verify_all
    from tbist_tpu_torch.weights import vgg as vgg_weights

    rc, rc_strict = verify_all.main([]), verify_all.main(["--strict"])
    with open(os.path.join(verify_all.CACHE, "MANIFEST_torch.json")) as f:
        results = json.load(f)["results"]
    missing = all(v.startswith("MISSING") for v in results.values()) and len(results) == 6
    gen = torch.Generator().manual_seed(0)
    sd = {}
    convs = (spec for spec in vgg19.VGG19_LAYERS if len(spec) == 3)
    for idx, (_, cin, cout) in zip(vgg_weights._TORCH_FEATURE_IDX, convs):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * 0.05
        sd[f"features.{idx}.bias"] = torch.zeros(cout)
    saved = os.environ.get("TBIST_VGG19_PTH")
    rep = verify_all.Report()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        pth = os.path.join(tmp, "vgg19.pth")
        torch.save(sd, pth)
        try:
            vgg_ok = verify_all.verify_vgg(rep, pth, device)
        finally:  # the synthetic weights must not outlive this check
            if saved is None:
                os.environ.pop("TBIST_VGG19_PTH", None)
            else:
                os.environ["TBIST_VGG19_PTH"] = saved
            vgg_weights.get_params.cache_clear()
    proc = subprocess.run([sys.executable, "-c", "import json, chip_smoke; "
                           "print(json.dumps(chip_smoke.model_load_s()))"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"model_load_s: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    loads = json.loads(proc.stdout.strip().splitlines()[-1])
    log(json.dumps({"weights": "verify_all", "rc": rc, "rc_strict": rc_strict,
                    "results": results, "synthetic_vgg": rep.results.get("vgg"),
                    "model_load_s": loads, "card": smi}))
    if not (rc == 0 and rc_strict == 1 and missing and vgg_ok
            and rep.results["vgg"].startswith("PASS") and set(loads) == set(MODEL_FAMILIES)):
        raise AssertionError(f"weights: rc {rc}/{rc_strict}, {results}, vgg {rep.results}")
    return loads


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
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
# and K3 under channel attention and in the resumed segments; text-style:
# K4 where the style is composited under a DINO+SAM location mask; depth:
# K1 and K3 in depth-loss Gatys, both MIP plans and the batched lanes; video:
# K1 and K3 in the Gatys, mixing and depth-loss lanes and in MIP frame by
# frame, K4 in the masked-text lane's SAM encoder; serve: K1 and K3 behind
# /v1/image with style_transfer, K4 behind /v1/image with a location prompt)
PATHS = {"gram_fwd": "gatys, text-location, effects, depth, video, serve",
         "gram_bwd": "gatys, text-location, effects, depth, video, serve",
         "pool_bwd": "none",
         "relu_pool_bwd": "gatys, text-location, effects, depth, video, serve",
         "sam_attn": "sam, text-location, text-style, video, serve"}


T0 = time.perf_counter()


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
        text_counts, text_metrics, chain = run_text_location_path(device, smi, sam_params)
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

    with phase("text-style path"):
        from tbist_tpu_torch.models import dino_sam

        style_counts, style = run_text_style_path(device, smi,
                                                  dino_sam.make_mask_extractor(*chain))
        log(f"text-style path: text_style_ms {style['text_style_ms']:.2f} (bf16), "
            f"{style['text_style_f32_ms']:.2f} (f32), batch 8 "
            f"{style['batch8_ms_per_image']:.2f} ms per image, {style['host_syncs']} host syncs, "
            f"peak {style['peak_bytes_of_call']} bytes above what was held; clip_text_ms "
            f"{style['clip_text_ms']:.2f}, t5_generate_ms {style['t5_generate_ms']:.2f}; full "
            f"chain {style['chain_ms']:.1f} ms; on {smi}")

    with phase("depth path"):
        depth_counts, dm = run_depth_path(device, smi)
        log(f"depth path: depth_ms {dm['depth_ms']:.2f} (forward, 518²), forward + input "
            f"gradient {dm['depth_grad_ms']:.2f} ms (peak {dm['depth_grad_peak_bytes']} bytes "
            f"above what was held); depth_loss_iters_per_sec "
            f"{dm['depth_loss_iters_per_sec']:.2f} (host CPU {dm['host_cpu_ms_per_step']:.1f} ms "
            f"a step; max_memory_allocated "
            f"{dm['depth_loss_max_memory_allocated']} bytes; depth term "
            f"{dm['depth_term_after_step_1']:.4g} after step 1, {dm['depth_term_last']:.4g} "
            f"last); mip_ms {dm['mip_ms']:.1f}, mip_batched_ms {dm['mip_batched_ms']:.1f} "
            f"({STEPS // 4} steps); "
            f"launches {depth_counts}; on {smi}")

    with phase("video path"):
        video_counts, vm = run_video_path(device, smi, chain)
        log(f"video path: video_gatys_s {vm['video_gatys_s']:.1f} ({STEPS} steps, "
            f"{vm['video_gatys_frames_per_sec']:.3f} frames/s, "
            f"{vm['video_gatys_ms_per_step']:.1f} ms a step of {VIDEO_LANES} lanes, "
            f"max_memory_allocated {vm['video_gatys_max_memory_allocated']} bytes); "
            f"video_text_frames_per_sec {vm['video_text_frames_per_sec']:.1f} (host syncs "
            f"{vm['video_text_host_syncs_per_chunk']:.2f} a chunk, profiled busy share "
            f"{vm['video_text_busy_share']:.3f}); masked chunk {vm['video_masked_chunk_ms']:.0f} ms; "
            f"pixel art {vm['video_pixel_art_frames_per_sec']:.1f} frames/s; "
            f"launches {video_counts}; on {smi}")

    with phase("serve path"):
        serve_counts, sv = run_serve_path(device, smi, chain)
        log(f"serve path: /v1/image Gatys {sv['serve_gatys_s']:.2f} s ({STEPS} steps, "
            f"{sv['serve_gatys_pixels_differing']} pixels from api.apply_image), masked text "
            f"{sv['serve_masked_text_s'] * 1e3:.0f} ms, burst of 8 in {sv['serve_burst_batches']} "
            f"batches ({sv['serve_burst_s'] * 1e3:.0f} ms; a lone request "
            f"{sv['serve_lone_text_s'] * 1e3:.0f} ms), /v1/video 8 frames "
            f"{sv['serve_video_s']:.2f} s; launches {serve_counts}; on {smi}")
    del chain

    with phase("cold and warm"):
        cw = run_cold_warm(smi)
        log(f"serve cold: start-up {cw['serve_startup_s']:.2f} s, serve_first_request_s "
            f"{cw['serve_first_request_s']:.2f}, serve_second_request_s "
            f"{cw['serve_second_request_s']:.2f}; warmed (--warmup-size {SIZE} "
            f"--warmup-programs gatys): start-up {cw['warmed_startup_s']:.2f} s, warmup_s "
            f"{cw['warmup_s']}, first request {cw['warmed_first_request_s']:.2f} s; kernel "
            f"libraries already built, so no nvcc in either process; on {smi}")

    with phase("ui"):
        run_ui(device)

    with phase("weights"):
        loads = run_weights(device, smi)
        log("model_load_s (cold, warm): " + ", ".join(
            f"{k} {v['cold']:.3f}, {v['warm']:.3f}" for k, v in loads.items()) + f"; on {smi}")

    launches_by_path = {
        "gatys": {k: v for k, v in counts.items() if k != "sam_attn"},
        "sam": {"sam_attn": counts["sam_attn"]},
        "text-location": text_counts,
        "effects": effect_counts,
        "text-style": style_counts,
        "depth": depth_counts,
        "video": video_counts,
        "serve": serve_counts,
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
    log(f"total seconds {time.perf_counter() - T0:.1f}")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
