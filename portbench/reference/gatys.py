"""Plain Gatys objective and L-BFGS, in f32 with TF32 off (the precision
the configurations state), with ``torch`` alone.

The objective is the JAX package's (``tbist_tpu/optimize/gatys.py``
``_make_loss_fn``; Gatys et al., CVPR 2016, with the reference app's TV and
edge terms): on an NHWC image x in [0, 1],

    w_content · mean over conv4_2 of (F(x) - F(c))²
  + w_style · mean over the style layers of mean((G(x) - G(s))²),
        G = Fᵀ F / (C·H·W) of the pre-ReLU features
  + w_tv · (Σ|Δ_h n| + Σ|Δ_w n|) / (C·H·W) of the normalized image n,
        |d| differentiating as ``jnp.abs`` does (+1 at 0)
  + w_edge · mean of the two axes' MSE between the central differences of
        the grey (channel mean) normalized content and of the grey x
  + w_depth · mean((N(D(x)) - N(D(c)))²), D Depth Anything, N min-max.

L-BFGS is ``torch.optim.LBFGS``'s step without a line search (lr scales
the step, the first step is min(1, 1/||g||₁)·lr, a pair is kept only when
y·s > 1e-10) over the JAX package's circular buffer of m slots: the pair of
step k goes to slot (k-1) mod m, a skipped pair leaves the slot as it was,
and slots count from the newest backwards in slot order. The direction is
the two-loop recursion over the valid slots.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import torch

from portbench.reference import depth_anything, vgg19

VGG_MEAN = (0.485, 0.456, 0.406)
VGG_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def precision(tf32: bool = False):
    """TF32 off for cuBLAS and cuDNN in the block (on for the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(VGG_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(VGG_STD, device=x.device).reshape(1, 3, 1, 1)
    return (x - mean) / std


def _gram(f: torch.Tensor) -> torch.Tensor:
    _, c, h, w = f.shape
    m = f.reshape(c, h * w)
    return (m @ m.T) / (c * h * w)


def _abs(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d >= 0, d, -d)


def _grey_diffs(g: torch.Tensor):
    """Central differences of a (1, 1, H, W) grey image: d/dx, d/dy."""
    return (g[:, 0, 1:-1, 2:] - g[:, 0, 1:-1, :-2], g[:, 0, 2:, 1:-1] - g[:, 0, :-2, 1:-1])


def _norm_depth(d: torch.Tensor) -> torch.Tensor:
    lo, hi = torch.min(d), torch.max(d)
    return (d - lo) / torch.clamp(hi - lo, min=1e-12)


@dataclasses.dataclass
class Objective:
    """The loss of one request: its weights, and the targets the reference
    works out from the content and style images itself."""

    cfg: Dict  # the configuration's "gatys" entry
    vgg: Dict
    content: Dict[str, torch.Tensor]
    style: Dict[str, torch.Tensor]
    edge: tuple
    depth_fn: Optional[Callable] = None
    depth_target: Optional[torch.Tensor] = None


def objective(cfg: Dict, vgg_params, content: torch.Tensor, style: torch.Tensor,
              da_params=None, da: Optional[Dict] = None) -> Objective:
    """Targets of ``content`` and ``style`` ((1, H, W, 3) in [0, 1]) under
    ``cfg`` (the "gatys" entry of a configuration); ``da_params`` with
    ``da`` adds the depth term with weight ``cfg["w_depth"]``."""
    vgg = vgg19.plain_weights(vgg_params)
    layers = list(dict.fromkeys(list(cfg["content_layers"]) + list(cfg["style_layers"])))
    with torch.no_grad():
        cn = _normalize(_nchw(content))
        feats = vgg19.features(vgg, cn, layers)
        sf = vgg19.features(vgg, _normalize(_nchw(style)), cfg["style_layers"])
        grams = {l: _gram(sf[l]) for l in cfg["style_layers"]}
        edge = _grey_diffs(cn.mean(dim=1, keepdim=True))
        depth_fn = target = None
        if da_params is not None and cfg.get("w_depth", 0) > 0:
            def depth_fn(x):
                return depth_anything.depth(da_params, da, x)
            target = _norm_depth(depth_fn(_nchw(content)))
    return Objective(cfg, vgg, {l: feats[l] for l in cfg["content_layers"]}, grams, edge,
                     depth_fn, target)


def loss(obj: Objective, x: torch.Tensor) -> torch.Tensor:
    """The objective at the NHWC image ``x`` (already clamped)."""
    cfg = obj.cfg
    xi = _nchw(x)
    n = _normalize(xi)
    layers = list(dict.fromkeys(list(cfg["content_layers"]) + list(cfg["style_layers"])))
    feats = vgg19.features(obj.vgg, n, layers)
    total = torch.zeros((), device=x.device)
    if cfg["w_content"] > 0:
        c = sum(torch.mean(torch.square(feats[l] - obj.content[l])) for l in cfg["content_layers"])
        total = total + cfg["w_content"] * c / len(cfg["content_layers"])
    if cfg["w_style"] > 0:
        s = sum(torch.mean(torch.square(_gram(feats[l]) - obj.style[l]))
                for l in cfg["style_layers"])
        total = total + cfg["w_style"] * s / len(cfg["style_layers"])
    _, ch, h, w = n.shape
    if cfg["w_tv"] > 0:
        tv = (torch.sum(_abs(n[:, :, 1:] - n[:, :, :-1]))
              + torch.sum(_abs(n[:, :, :, 1:] - n[:, :, :, :-1])))
        total = total + cfg["w_tv"] * tv / (ch * h * w)
    if cfg["w_edge"] > 0:
        dx, dy = _grey_diffs(xi.mean(dim=1, keepdim=True))
        e = (torch.mean(torch.square(obj.edge[0] - dx))
             + torch.mean(torch.square(obj.edge[1] - dy))) / 2.0
        total = total + cfg["w_edge"] * e
    if obj.depth_fn is not None:
        d = _norm_depth(obj.depth_fn(xi))
        total = total + cfg["w_depth"] * torch.mean(torch.square(d - obj.depth_target))
    return total


def loss_grad(obj: Objective, x: torch.Tensor):
    """(loss, gradient) at ``x``."""
    x = x.detach().requires_grad_(True)
    value = loss(obj, x)
    (g,) = torch.autograd.grad(value, x)
    return value.detach(), g


def init_state(shape, m: int, device) -> Dict:
    """An empty L-BFGS state, with the port's ``LBFGSState`` fields."""
    z = dict(dtype=torch.float32, device=device)
    return {"step": 0, "s_hist": torch.zeros((m, *shape), **z),
            "y_hist": torch.zeros((m, *shape), **z), "rho": torch.zeros((m,), **z),
            "prev_grad": torch.zeros(shape, **z), "prev_step_vec": torch.zeros(shape, **z),
            "gamma": torch.ones((), **z)}


def lbfgs_step(g: torch.Tensor, st: Dict, lr: float = 1.0) -> torch.Tensor:
    """One update from state ``st`` (changed in place) and gradient ``g``;
    returns the additive step."""
    m = st["s_hist"].shape[0]
    if st["step"] == 0:
        t = min(1.0, 1.0 / float(torch.sum(torch.abs(g)))) * lr
        step = -t * g
    else:
        s, y = st["prev_step_vec"], g - st["prev_grad"]
        ys = float(torch.sum(y * s))
        slot = (st["step"] - 1) % m
        if ys > 1e-10:
            st["s_hist"][slot] = s
            st["y_hist"][slot] = y
            st["rho"][slot] = 1.0 / ys
            st["gamma"] = torch.tensor(ys / float(torch.sum(y * y)), device=g.device)
        order = [(slot - j) % m for j in range(m)]  # newest first
        rho = st["rho"].tolist()
        q, alpha = g.clone(), {}
        for i in order:
            if rho[i] != 0.0:
                alpha[i] = rho[i] * float(torch.sum(st["s_hist"][i] * q))
                q = q - alpha[i] * st["y_hist"][i]
        r = st["gamma"] * q
        for i in reversed(order):
            if rho[i] != 0.0:
                beta = rho[i] * float(torch.sum(st["y_hist"][i] * r))
                r = r + (alpha[i] - beta) * st["s_hist"][i]
        step = -lr * r
    st["step"] += 1
    st["prev_grad"], st["prev_step_vec"] = g, step
    return step


def stylize(obj: Objective, content: torch.Tensor, steps: int, m: int, lr: float = 1.0,
            check_steps: int = 0):
    """A free run of ``steps`` from ``content``: the same outputs the
    benchmark takes from the port's run (``requests.gatys.Reader``), for the control."""
    x = content.clone()
    st = init_state(tuple(x.shape), m, x.device)
    hist, cap = [], {"steps_u": []}
    for i in range(steps):
        x = x.clamp(0.0, 1.0)
        value, g = loss_grad(obj, x)
        hist.append(float(value))
        if i == 0:
            cap["grad0"] = g
        if i == check_steps:
            cap["gradk"] = g
        if i == steps - 1:
            cap["x_last"], cap["grad_last"] = x, g
            cap["state_last"] = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                                 for k, v in st.items()}
        step = lbfgs_step(g, st, lr)
        if i <= check_steps:
            cap["steps_u"].append(step)
        if i == steps - 1:
            cap["step_last"] = step
        x = x + step
    out = x.clamp(0.0, 1.0)
    cap["hist"] = hist
    cap["output_u8"] = torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
    return cap
