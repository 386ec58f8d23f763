"""Gatys requests: 512px style transfer through ``api.apply_image``, with or
without Depth Anything in the loss graph (the cells ``gatys512`` and
``depth_loss512``).

A workload whose ``"request"`` is ``"gatys"`` gets from here its seeded
weights (VGG-19, and Depth-Anything-V2-Small where the configuration has
one), the registry the port takes them from, its images and the order of
its (content, style) pairs, its reading points in the optimisation loop,
and its check against the plain reference (``check.py``,
``reference/gatys.py``).

Reading points, a contract. For the length of a run the benchmark wraps
two of the port's functions and calls through to them unchanged. A change
to the program that stops calling them through their modules (a local
binding, a fused or captured step) has to keep them, or bring a benchmark
change that reads the same state another way. A request in which they were
not reached as often as the request has steps ends the run without a
result (``problems``).

- ``optimize.lbfgs.update(grad, state, lr)``, called once a step with the
  step's gradient and the optimizer's state (on one card in
  ``optimize.gatys.stylize``; one lane per call in
  ``parallel.batched.lbfgs_lanes`` on a mesh). It counts the request's
  steps; keeps the update of each of the first ``check_steps`` + 1 steps
  and the gradient of the last of them; keeps the last step's gradient,
  update and the state the last update started from; and starts and
  stops the profiler around the traced steps.
- ``optimize.gatys.lane_losses`` and ``lane_losses_sharded``, called once
  a step with the clamped image the step differentiates. It counts the
  calls and keeps the last image.

What it keeps is the program's own output, for the check after the window.
Each request takes one host buffer (``_block``: pinned where the run has a
card, laid out as the tensors the warm-up request passed through the
reading points), and each tensor is copied into its place there on the
program's stream as it is kept: the copy runs on the card in the stream's
order, before any later write to the tensor (``update`` writes its history
in place), while the program goes on. So a request allocates host memory
once, the window holds no copy of its own between requests, and the card
holds no more than the program does.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from PIL import Image

from portbench import check, weights
from portbench.reference import gatys as ref

STATE_FIELDS = ("s_hist", "y_hist", "rho", "gamma", "prev_grad", "prev_step_vec")
Pair = Tuple[str, str]


# ---------------------------------------------------------------------------
# traffic: the pairs and their images
# ---------------------------------------------------------------------------


def draw_pairs(params: Dict, seed: int) -> List[Pair]:
    """``params["requests"]`` (content, style) pairs: the content x style
    grid in an order drawn from ``seed``, repeated as needed. Every seed
    sends requests of the same size and the same steps, so the work does
    not depend on it."""
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


def read_checked(root: str, folder: str, name: str, digest: str) -> Image.Image:
    """``root/folder/name`` as an RGB image, refused unless its SHA-256 is
    ``digest`` (a changed file stops the run instead of changing the
    yardstick)."""
    path = os.path.join(root, folder, name)
    with open(path, "rb") as f:
        data = f.read()
    if hashlib.sha256(data).hexdigest() != digest:
        raise RuntimeError(f"{path}: not the image the workload names")
    with Image.open(path) as img:
        return img.convert("RGB")


def load_images(params: Dict, root: str) -> Dict[str, Image.Image]:
    """Every listed image, checked and made square: all of them in every
    run, so that set-up does the same work for any seed."""
    return {name: square(read_checked(root, params[f"{group}_dir"], name, digest),
                         params["side"])
            for group in ("content", "style") for name, digest in params[group].items()}


def to_tensor(img, device):
    """The (1, H, W, 3) float image the port makes of a PIL image."""
    arr = np.asarray(img).astype(np.float32) / 255.0
    return torch.from_numpy(arr)[None].to(device)


# ---------------------------------------------------------------------------
# reading points
# ---------------------------------------------------------------------------


class Reader:
    """What the wrapped functions keep, for the request under way."""

    def __init__(self, steps: int, trace_steps: Optional[tuple] = None,
                 on_trace: Optional[Callable[[bool], None]] = None, check_steps: int = 0):
        self.steps = steps  # steps of a window request
        self.check_steps = check_steps  # updates 0..check_steps are kept
        self.trace_steps = trace_steps  # (first, end) update calls to profile
        self.on_trace = on_trace  # called with True to start, False to stop
        self.capturing = False
        self.trace_pending = False
        self.captured: Dict = {}
        self.updates = self.loss_calls = 0
        self.layout: Dict[str, Tuple[tuple, torch.dtype]] = {}  # seen in the warm-up
        self.slot: Dict[str, torch.Tensor] = {}

    def start_request(self, index: int, trace: bool = False) -> bool:
        """Capture the next request; profile its traced steps where
        ``trace`` and it is the first. Returns whether it is traced."""
        traced = trace and index == 0
        self.capturing, self.trace_pending = True, traced
        self.captured, self.updates, self.loss_calls = {"steps_u": []}, 0, 0
        self.slot = _block(self.layout)
        return traced

    def finish_request(self) -> Dict:
        """The request's captures on the host, with ``steps`` and
        ``problems``: what the reading points missed."""
        self.capturing = False
        out = {k: _to_host(v) for k, v in self.captured.items()}
        out["steps"] = self.updates
        out["problems"] = self.problems(out)
        self.captured, self.slot = {}, {}
        return out

    def problems(self, cap: Dict) -> List[str]:
        """Why ``cap`` cannot be checked: the reading points were bypassed."""
        out = []
        if self.updates != self.steps:
            out.append(f"optimize.lbfgs.update reached {self.updates} times "
                       f"in a request of {self.steps} steps")
        if self.loss_calls != self.steps:
            out.append(f"optimize.gatys.lane_losses(_sharded) reached {self.loss_calls} "
                       f"times in a request of {self.steps} steps")
        want = {"grad0", "gradk", "x_last", "grad_last", "step_last", "state_last"}
        missing = sorted(want - set(cap))
        if missing:
            out.append(f"no capture of {missing}")
        if len(cap.get("steps_u", [])) != self.check_steps + 1:
            out.append(f"{len(cap.get('steps_u', []))} of the first "
                       f"{self.check_steps + 1} updates captured")
        return out

    def _keep(self, key: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` as it stands now in the stream's order, in the request's
        buffer ``key``: valid once the stream has passed it (the request's
        image read-back syncs it)."""
        buf = self.slot[key]
        if t.device.type != "cuda":
            return buf.copy_(t.detach())
        with torch.cuda.device(t.device):
            buf.copy_(t.detach(), non_blocking=True)
        return buf

    def update(self, real, grad, state, lr=1.0):
        k = state.step
        self.updates += 1
        if self.trace_pending and self.trace_steps is not None:
            if k == self.trace_steps[0]:
                self.on_trace(True)
            elif k == self.trace_steps[1]:
                self.on_trace(False)
                self.trace_pending = False
        if not self.capturing:
            if k == 0:  # the warm-up request: the layout of a request's buffer
                self.layout.update({j: (tuple(grad.shape), grad.dtype)
                                    for j in ("grad0", "gradk", "grad_last", "step_last")})
                self.layout.update({f"u{j}": (tuple(grad.shape), grad.dtype)
                                    for j in range(self.check_steps + 1)})
                self.layout.update({f"state.{f}": (tuple(getattr(state, f).shape),
                                                   getattr(state, f).dtype)
                                    for f in STATE_FIELDS})
            return real(grad, state, lr=lr)
        last = k == self.steps - 1
        if k == 0:
            self.captured["grad0"] = self._keep("grad0", grad)
        if k == self.check_steps:
            self.captured["gradk"] = self._keep("gradk", grad)
        if last:
            self.captured["grad_last"] = self._keep("grad_last", grad)
            self.captured["state_last"] = dict(
                {f: self._keep(f"state.{f}", getattr(state, f)) for f in STATE_FIELDS}, step=k)
        step, new_state = real(grad, state, lr=lr)
        if k <= self.check_steps:
            self.captured["steps_u"].append(self._keep(f"u{k}", step))
        if last:
            self.captured["step_last"] = self._keep("step_last", step)
        return step, new_state

    def losses(self, real, cfg, params, imgs, *args, **kwargs):
        self.loss_calls += 1
        if not self.capturing and self.loss_calls == 1:
            self.layout["x_last"] = (tuple(imgs.shape), imgs.dtype)
        if self.capturing and self.loss_calls == self.steps:
            self.captured["x_last"] = self._keep("x_last", imgs)
        return real(cfg, params, imgs, *args, **kwargs)


def _block(layout: Dict[str, Tuple[tuple, torch.dtype]]) -> Dict[str, torch.Tensor]:
    """One host buffer a key of ``layout``, carved from one allocation
    (pinned where a card is used), each at a 64-byte boundary."""
    at, spans = 0, {}
    for k, (shape, dt) in layout.items():
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        spans[k] = (at, n)
        at += -(-n // 64) * 64
    raw = torch.empty(at, dtype=torch.uint8, pin_memory=torch.cuda.is_available())
    return {k: raw[a:a + n].view(layout[k][1]).view(layout[k][0])
            for k, (a, n) in spans.items()}


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.to("cpu")
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_host(x) for x in v]
    return v


@contextlib.contextmanager
def installed(reader: Reader):
    """Wrap the port's reading points for the block: module-level
    functions that call the reader's methods, one frame each."""
    from tbist_tpu_torch.optimize import gatys, lbfgs

    saved = [(lbfgs, "update", lbfgs.update), (gatys, "lane_losses", gatys.lane_losses),
             (gatys, "lane_losses_sharded", gatys.lane_losses_sharded)]
    upd, one, sharded = (s[2] for s in saved)
    on_update, on_losses = reader.update, reader.losses

    def update(grad, state, lr=1.0):
        return on_update(upd, grad, state, lr)

    def lane_losses(*a, **k):
        return on_losses(one, *a, **k)

    def lane_losses_sharded(*a, **k):
        return on_losses(sharded, *a, **k)

    lbfgs.update, gatys.lane_losses = update, lane_losses
    gatys.lane_losses_sharded = lane_losses_sharded
    try:
        yield reader
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# the request kind
# ---------------------------------------------------------------------------


def build_request(config: Dict, steps: int):
    from tbist_tpu_torch.api import DepthConfig, EffectRequest, GatysConfig

    g = dict(config["gatys"])
    g.update(num_steps=steps, content_layers=tuple(g["content_layers"]),
             style_layers=tuple(g["style_layers"]))
    req = config["request"]
    depth = DepthConfig(**req["depth"]) if req.get("depth") else None
    return EffectRequest(style_transfer=bool(req.get("style_transfer")), depth=depth,
                         gatys=GatysConfig(**g))


def depth_estimator(params, da: Dict):
    """The depth model the registry takes, under a range the trace reads."""
    from tbist_tpu_torch.models import depth_anything

    cfg = depth_anything.DAConfig(**{k: tuple(v) if isinstance(v, list) else v
                                     for k, v in da.items()})

    def estimate(image):
        with torch.profiler.record_function("portbench.depth_fwd"):
            return depth_anything.predict_depth(params, cfg, image)

    return estimate


class Session:
    """One run's Gatys requests: the seeded models in a registry, the
    pairs, the reading points and the check."""

    def __init__(self, config: Dict, params: Dict, seeds: List[int], dev: torch.device,
                 on_trace: Optional[Callable[[bool], None]], trace: bool):
        from tbist_tpu_torch import api

        self.config, self.params, self.dev = config, params, dev
        self.api = api
        self.vgg = weights.vgg19(seeds[0], dev)
        self.da = config.get("depth_anything")
        self.da_params = weights.depth_anything(self.da, seeds[1], dev) if self.da else None
        estimator = depth_estimator(self.da_params, self.da) if self.da else None
        self.registry = api.ModelRegistry(device=dev, vgg_params=self.vgg,
                                          depth_estimator=estimator)
        self.reader = Reader(params["steps"], tuple(params["trace_steps"]) if trace else None,
                             on_trace, params["check_steps"])
        self.images: Dict[str, Image.Image] = {}

    def installed(self):
        return installed(self.reader)

    def trace_units(self) -> int:
        """Steps in the traced slice."""
        return self.params["trace_steps"][1] - self.params["trace_steps"][0]

    def load(self, root: str) -> None:
        self.images = load_images(self.params, root)

    def draw(self, seed: int) -> List[Pair]:
        return draw_pairs(self.params, seed)

    def send(self, pair: Pair, steps: Optional[int] = None):
        m = self.api.RunMetrics()
        c, s = pair
        out = self.api.apply_image(self.images[c], build_request(self.config, steps or
                                                                 self.params["steps"]),
                                   style_image=self.images[s], registry=self.registry,
                                   metrics=m, device=self.dev)
        return out, {"program_s": m.timings_s.get(self.params["timing_key"]),
                     "hist": list(m.loss_history)}

    def warm_up(self, items: List[Pair]) -> None:
        """One short request at the cell's shapes (and the reading points'
        layout)."""
        self.send(items[0], self.params["warmup_steps"])

    def due(self, records: List[Dict]) -> int:
        """Requests the check has to compare: every one of the window."""
        return len(records)

    def problems(self, records: List[Dict]) -> List[str]:
        return sorted({p for r in records if r["error"] is None and r["out"] is not None
                       for p in r["captures"]["problems"]})

    def release(self) -> None:
        """Free the program's state before the check."""
        self.registry = None

    def check(self, records: List[Dict]) -> Tuple[Dict[str, float], int]:
        """Each completed request against the reference: the numbers at
        their worst request, and how many requests were checked."""
        config, rows = self.config, []
        ref_cfg = dict(config["gatys"],
                       w_depth=(config["request"].get("depth") or {}).get("w_depth", 0.0))
        with ref.precision(tf32=False):
            for r in records:
                if r["out"] is None or r["error"] is not None:
                    continue
                c, s = (to_tensor(self.images[n], self.dev) for n in r["item"])
                obj = ref.objective(ref_cfg, self.vgg, c, s, self.da_params, self.da)
                cap = dict(r["captures"], hist=r["timings"]["hist"])
                rows.append(check.request_numbers(obj, c, cap, r["out"],
                                                  config["gatys"]["learning_rate"],
                                                  config["gatys"]["lbfgs_memory"]))
        return check.worst(rows), len(rows)
