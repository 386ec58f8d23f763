"""VGG-19's input gradients to conv5_1, each timed alone on a CUDA card in
two ways: cuDNN's own input gradient of ``F.conv2d`` (the
``convolution_backward`` that autograd runs when only the input takes a
gradient) and the forward convolution over the flipped weights that
``models.vgg19.TrunkConv`` runs. Channels-last operands as the trunk has
them, TF32 off. Run on a machine with a CUDA card, from the root of a
checkout::

    python tools/vgg_dgrad_ab.py [--sweep]

It times the 13 convs of a 512px image, batch 1, f32. Each case times both
ways in turns (native, flipped, flipped, native), ``ROUNDS`` times, with
CUDA events over ``ITERS`` launches after a warm-up. It prints one JSON
line: the card and its power limit, and per case the median ms of each way,
the bound (the case's FLOPs at the dtype's peak), each way's relative L2
error against the f64 input gradient on the card, the kernels each way
launches, and the route ``vgg19.flips`` gives it. ``--sweep`` adds the
other shapes the trunk runs and where the two ways cross: the 13 convs of a
batch of 8 video frames of 480x864, in bf16 at 512px, and as a quarter
width shard at 512px (padding (1, 0) with a column of halo on either side);
512 -> 512 convs at sides 16 to 96, and a 3-channel input at 128 to 1024.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tbist_tpu_torch.models import vgg19  # noqa: E402
from tbist_tpu_torch.utils.precision import full_f32  # noqa: E402

# H100 SXM at 700 W: f32 outside the tensor cores, and bf16 dense
PEAK = {torch.float32: 67e12, torch.bfloat16: 989e12}
ITERS = 40
ROUNDS = 4


def layers(batch: int, height: int, width: int, tag: str, dtype=torch.float32,
           padding=(1, 1)):
    """One case per conv to conv5_1 of a (batch, height, width) image; with
    padding (1, 0) each conv's input is two columns wider than its output,
    as a width shard's after the halo."""
    out = []
    halo = 2 - 2 * padding[1]
    for spec in vgg19.VGG19_LAYERS:
        if len(spec) == 1:
            height, width = height // 2, width // 2
            continue
        out.append({"case": tag, "layer": spec[0], "shape": (batch, height, width + halo),
                    "cin": spec[1], "cout": spec[2], "padding": padding, "dtype": dtype})
        if spec[0] == "conv5_1":
            return out


def native_dgrad(go, x, w, padding):
    return torch.ops.aten.convolution_backward(
        go, x, w, None, [1, 1], list(padding), [1, 1], False, [0, 0], 1,
        [True, False, False])[0]


def _ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def _rel(a, ref) -> float:
    return float(torch.linalg.norm((a.double() - ref).flatten()) / torch.linalg.norm(ref.flatten()))


def _kernels(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:60] for e in p.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def time_case(case, gen):
    dev, cl, dtype = gen.device, torch.channels_last, case["dtype"]
    (b, h, w_in), cin, cout, padding = case["shape"], case["cin"], case["cout"], case["padding"]
    x = torch.randn(b, cin, h, w_in, device=dev, generator=gen).to(dtype, memory_format=cl)
    w = (torch.randn(cout, cin, 3, 3, device=dev, generator=gen)
         * (2.0 / (9 * cin)) ** 0.5).to(dtype, memory_format=cl)
    w_out = w_in + 2 * padding[1] - 2
    go = torch.randn(b, cout, h, w_out, device=dev, generator=gen).to(dtype, memory_format=cl)
    flipped = vgg19.flipped_weight(w, dtype)
    flip_pad = (2 - padding[0], 2 - padding[1])
    ways = {"native": lambda: native_dgrad(go, x, w, padding),
            "flipped": lambda: F.conv2d(go, flipped, padding=flip_pad)}
    for fn in ways.values():
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    times = {k: [] for k in ways}
    for _ in range(ROUNDS):
        for k in ("native", "flipped", "flipped", "native"):
            times[k].append(_ms(ways[k]))
    ref = native_dgrad(go.double(), x.double(), w.double(), padding)
    flops = 2.0 * b * h * w_out * cin * cout * 9
    return {**case, "dtype": str(dtype).removeprefix("torch."),
            "native_ms": statistics.median(times["native"]),
            "flipped_ms": statistics.median(times["flipped"]),
            "bound_ms": flops / PEAK[dtype] * 1e3,
            "route": "flipped" if vgg19.flips(x) else "native",
            "native_rel_err": _rel(ways["native"](), ref),
            "flipped_rel_err": _rel(ways["flipped"](), ref),
            "native_kernels": _kernels(ways["native"]),
            "flipped_kernels": _kernels(ways["flipped"])}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("vgg_dgrad_ab: needs a CUDA device")
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(0)
    cases = layers(1, 512, 512, "512px")
    if args.sweep:
        cases += (layers(8, 480, 864, "video8") + layers(1, 512, 512, "bf16", torch.bfloat16)
                  + layers(1, 512, 128, "shard", padding=(1, 0)))
        cases += [{"case": "crossover", "layer": "sweep", "shape": (1, s, s), "cin": cin,
                   "cout": cout, "padding": (1, 1), "dtype": torch.float32}
                  for s, cin, cout in [(s, 512, 512) for s in (16, 24, 32, 40, 48, 64, 96)]
                  + [(s, 3, 64) for s in (128, 256, 1024)]]
    with full_f32():
        rows = [time_case(case, gen) for case in cases]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    totals = {}
    for r in rows:
        t = totals.setdefault(r["case"], {"native_ms": 0.0, "flipped_ms": 0.0, "routed_ms": 0.0,
                                          "bound_ms": 0.0})
        t["native_ms"] += r["native_ms"]
        t["flipped_ms"] += r["flipped_ms"]
        t["routed_ms"] += r[r["route"] + "_ms"]
        t["bound_ms"] += r["bound_ms"]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "totals": totals, "layers": rows}))


if __name__ == "__main__":
    main()
