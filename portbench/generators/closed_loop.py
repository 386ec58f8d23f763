"""One client, closed loop: the next request goes out when the last one has
returned its image, as a CLI, gradio or ``/v1/image`` user waits for one
image at a time.

A workload's ``params`` give the content and style files (with their
SHA-256, so that a changed file stops the run instead of changing the
yardstick), the side every image is center-cropped and resized to, how
many pairs a run draws, the warm-up request's steps and the traced steps.
The seed draws the order of the pairs; every seed sends requests of the
same size and the same steps, so the work does not depend on it.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
from PIL import Image

Pair = Tuple[str, str]


def draw_pairs(params: Dict, seed: int) -> List[Pair]:
    """``params["requests"]`` (content, style) pairs: the content x style
    grid in an order drawn from ``seed``, repeated as needed."""
    grid = [(c, s) for c in sorted(params["content"]) for s in sorted(params["style"])]
    rng = np.random.default_rng(seed)
    order = []
    while len(order) < params["requests"]:
        order.extend(rng.permutation(len(grid)).tolist())
    return [grid[i] for i in order[:params["requests"]]]


def square(img: Image.Image, side: int) -> Image.Image:
    """The largest centered square, resized to ``side`` (bicubic)."""
    w, h = img.size
    s = min(w, h)
    box = ((w - s) // 2, (h - s) // 2, (w - s) // 2 + s, (h - s) // 2 + s)
    return img.crop(box).resize((side, side), Image.BICUBIC)


def load_images(params: Dict, root: str) -> Dict[str, Image.Image]:
    """Every listed image, checked against its SHA-256 and made square: all
    of them in every run, so that set-up does the same work for any seed."""
    out = {}
    for group in ("content", "style"):
        for name, digest in params[group].items():
            path = os.path.join(root, params[f"{group}_dir"], name)
            with open(path, "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != digest:
                raise RuntimeError(f"{path}: not the image the workload names")
            with Image.open(path) as img:
                out[name] = square(img.convert("RGB"), params["side"])
    return out


def run(params: Dict, seed: int, seconds: float, root: str,
        send: Callable[[Image.Image, Image.Image, int], Tuple[object, Dict]],
        reader, sync: Callable[[], None], trace: bool) -> Dict:
    """Warm up with one request of ``params["warmup_steps"]`` steps, then
    the window: requests one after another from its start until one starts
    after ``seconds``; the window ends when the last one returns.

    ``send(content, style, steps)`` makes one request through the port and
    returns (image, timings); ``reader`` (``hooks.Reader``) keeps each
    window request's state for the check; with ``trace`` the first window
    request's traced steps are profiled."""
    images = load_images(params, root)
    pairs = draw_pairs(params, seed)
    c, s = pairs[0]
    send(images[c], images[s], params["warmup_steps"])
    sync()
    setup_end = time.perf_counter()
    records = []
    start = time.perf_counter()
    for i, (c, s) in enumerate(pairs):
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        reader.start_request(capture=True, trace=trace and i == 0)
        try:
            out, timings = send(images[c], images[s], params["steps"])
            error = None
        except Exception as exc:  # a failed request counts as failed, the loop goes on
            out, timings, error = None, {}, f"{type(exc).__name__}: {exc}"
        t1 = time.perf_counter()
        cap = reader.finish_request()
        records.append({"pair": (c, s), "pair_images": (images[c], images[s]),
                        "wall_s": t1 - t0, "timings": timings, "out": out,
                        "captures": cap, "error": error, "traced": trace and i == 0})
        end = t1
    else:
        raise RuntimeError(f"{len(pairs)} requests did not fill {seconds} s")
    return {"setup_end": setup_end, "window_s": end - start, "records": records}
