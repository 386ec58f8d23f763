"""What the captured Gatys step costs and saves on a stream of photo shapes.

``optimize/gatys.py`` captures a step's loss and gradient as CUDA graphs the
first time ``stylize`` sees its key (the image's shape among it) and keeps
the last ``KEPT_STEP_GRAPHS``, each with its own memory pool. A server fed
users' photos sees many bucketed shapes (multiples of 32 under
``max_side``), so a first sight pays a capture. This sends style-transfer
requests through ``api.apply_image``, one after another, in two streams:

- ``512``: six shapes under a 512 max side, each once (six first sights,
  more than the graphs kept), then the last four again (kept: replays);
- ``1024``: four shapes under the default 1024 max side, each once, after
  which the card holds four graphs' pools at the largest size.

It prints one JSON line a request (seconds, captures, replays) and one a
stream (first sights' and repeats' seconds, the card's peak and reserved
memory). On a checkout without the step graph the same requests run
eagerly, for the comparison. Seeded VGG-19 weights; boat.jpg resized to
each shape, starry_night.jpg as the style. Needs a CUDA card::

    python tools/step_graph_shapes.py --steps 400
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAMS = {
    "512": [(384, 512), (512, 384), (288, 512), (512, 288), (512, 512), (352, 512)],
    "1024": [(768, 1024), (1024, 768), (576, 1024), (1024, 1024)],
}
REPEATS = {"512": 4, "1024": 0}  # the stream's last shapes sent again


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--streams", default="512,1024")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)

    import torch
    from PIL import Image

    from tbist_tpu_torch import api
    from tbist_tpu_torch.api import ModelRegistry
    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.utils.config import EffectRequest, GatysConfig
    from tbist_tpu_torch.weights import vgg as vgg_weights

    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    boat = Image.open(os.path.join(ROOT, "data/content_imgs/boat.jpg")).convert("RGB")
    style = Image.open(os.path.join(ROOT, "data/style_imgs/starry_night.jpg")).convert("RGB")
    reg = ModelRegistry(vgg_params=vgg_weights.get_params(device=device), device=device)

    def graphs():
        return (getattr(gatys.stylize, "captures", 0), getattr(gatys.stylize, "replays", 0))

    def send(hw, steps):
        req = EffectRequest(style_transfer=True, gatys=GatysConfig(num_steps=steps))
        before = graphs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.apply_image(boat.resize((hw[1], hw[0])), req, style_image=style, registry=reg,
                        device=device)
        seconds = time.perf_counter() - t0
        return seconds, [a - b for a, b in zip(graphs(), before)]

    send((256, 256), 3)  # the process's first request: a shape outside the streams
    for name in args.streams.split(","):
        shapes = STREAMS[name]
        torch.cuda.reset_peak_memory_stats()
        rows = []
        for i, hw in enumerate(shapes + shapes[len(shapes) - REPEATS[name]:]):
            seconds, (cap, rep) = send(hw, args.steps)
            rows.append({"stream": name, "shape": list(hw), "first_sight": i < len(shapes),
                         "seconds": seconds, "captures": cap, "replays": rep})
            print(json.dumps(rows[-1]), flush=True)
        first = [r["seconds"] for r in rows if r["first_sight"]]
        again = [r["seconds"] for r in rows if not r["first_sight"]]
        print(json.dumps({
            "stream": name, "steps": args.steps, "step_graph": hasattr(gatys, "StepGraph"),
            "first_sight_s": sum(first), "first_sight_mean_s": sum(first) / len(first),
            "repeat_mean_s": sum(again) / len(again) if again else None,
            "total_s": sum(first) + sum(again),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved(), "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
