"""Smoke test of the PyTorch/CUDA port (``tbist_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

Phases, each fatal:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every kernel of ``tbist_tpu_torch/csrc`` with ``nvcc``, in parallel;
3. kernels: each kernel's wrapper at the main path's shapes (512px), f32 and
   bf16, held against its plain PyTorch version on the same inputs and
   timed with CUDA events beside its bound and a library yardstick;
4. agreement: ``stylize`` on the card against the plain CPU path (8 steps,
   64px, torch-seeded weights), plus an 8-step bf16 run;
5. main path: ``tbist_tpu_torch.cli.main`` — boat.jpg x starry_night.jpg,
   ``--style-transfer``, 400 L-BFGS steps at 512px, full VGG-19 width —
   with every launch counter zeroed just before and read just after.

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
# bf16 on the tensor cores, and HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6  # the H100's L2 cache
ITERS = 50
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
    from tbist_tpu_torch.optimize import gatys

    with gatys.full_f32():  # the plain versions in full f32
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


def run_main_path(size: int, steps: int):
    """Phase 5: the CLI at full width; returns (launch counts, metrics, peak bytes)."""
    import numpy as np
    import torch
    from PIL import Image

    from tbist_tpu_torch import cli, kernels
    from tbist_tpu_torch.utils.logging import RunMetrics

    out_path = os.path.join(ROOT, "build", "smoke_out.png")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    argv = ["--image", os.path.join(ROOT, "data/content_imgs/boat.jpg"),
            "--style", os.path.join(ROOT, "data/style_imgs/starry_night.jpg"),
            "--style-transfer", "--steps", str(steps), "--out", out_path,
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
    log(json.dumps({"main_path": "cli --style-transfer", "steps": steps,
                    "image": list(img.shape), "loss_first": float(hist[0]),
                    "loss_last": float(hist[-1]),
                    "iters_per_sec": metrics.extra["iters_per_sec"],
                    "seconds": metrics.timings_s["gatys"], "max_memory_allocated": peak,
                    "launches": counts, "degraded": metrics.degraded}))
    if img.shape != (size, size, 3):
        raise AssertionError(f"output image {img.shape}, expected {(size, size, 3)}")
    if hist.shape != (steps,) or not np.isfinite(hist).all() or not hist[-1] < hist[0]:
        raise AssertionError("loss history is not finite and decreasing")
    n_style = len(STYLE_LAYERS)
    want = {"gram_fwd": n_style * steps + n_style, "gram_bwd": n_style * steps,
            "relu_pool_bwd": len(POOL_CHANNELS) * steps, "pool_bwd": 0}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return counts, metrics, peak


SOURCES = {
    "gram_fwd": ("tbist_tpu_torch/csrc/gram.cu", "tbist_tpu/ops/pallas_gram.py:59"),
    "gram_bwd": ("tbist_tpu_torch/csrc/gram.cu", "tbist_tpu/ops/pallas_gram.py:87"),
    "pool_bwd": ("tbist_tpu_torch/csrc/pool_bwd.cu", "tbist_tpu/ops/pallas_pool.py:87"),
    "relu_pool_bwd": ("tbist_tpu_torch/csrc/pool_bwd.cu",
                      "tbist_tpu/ops/pallas_relu_pool.py:75"),
}


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
        conv_cl = check_conv_layout(device, SIZE)

    with phase("agreement"):
        check_agreement(device)

    with phase("main path"):
        counts, metrics, peak = run_main_path(SIZE, STEPS)
        log(f"main path: {metrics.extra['iters_per_sec']:.2f} iters/s at {SIZE}px, "
            f"{STEPS} steps, max_memory_allocated {peak / 2**30:.2f} GiB, on {smi}")

    rows = []
    for kname, (source, replaces) in SOURCES.items():
        s = summary[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[kname], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"], "parity": "agree",
            "work": "one step of the main path at 512px, f32: the sum over its shapes",
            "on_main_path": kname != "pool_bwd",
        })
    log(f"conv output channels-last at every style layer: {conv_cl}")
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
