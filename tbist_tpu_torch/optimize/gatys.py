"""Gatys pixel-optimization style transfer, ported from
``tbist_tpu.optimize.gatys`` (``stylize`` :217-247, ``_stylize_jit`` :109-214).

Each step: clamp to [0, 1] → loss and its gradient (VGG-19 forward and
backward through kernels K1 and K3, and through the depth estimator when
the loss has the depth term of ``optimize.gatys_depth``) → optimizer
update. Feature targets and the style target Grams are computed once
before the loop. The loss history is a device tensor that the loop writes
and nobody reads until the run ends, so no step waits on the host.

On a card, a step's loss and its gradient with respect to the image run as
two captured CUDA graphs (``StepGraph``): one launch replays the forward
(VGG-19 with K1 and K3, the loss terms, the depth estimator), one the
backward, where the host would make some 1,500 launches a step with Depth
Anything in the loss. A graph is captured once per shape, loss
configuration, weights and depth estimator (``_step_key``), kept among the
last few (``StepGraphs``), and each request copies its own targets into
it. The optimizer's update stays eager. On the CPU the step runs eagerly.

Precision: float32 convolutions and matrix products run in full f32 for
the duration of ``stylize`` (TF32 off for cuDNN and cuBLAS), as the JAX
reference computes. ``cfg.dtype == "bfloat16"`` runs the VGG trunk in bf16
with the Gram matrices accumulated in f32.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import logging
import math
import threading
from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import torch

from tbist_tpu_torch.kernels.gram import GramFunction
from tbist_tpu_torch.models import channel_attention, vgg19
from tbist_tpu_torch.ops import losses, resize
from tbist_tpu_torch.ops.mip import normalize_depth
from tbist_tpu_torch.optimize import lbfgs
from tbist_tpu_torch.parallel import mesh as mesh_lib
from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD, GatysConfig
from tbist_tpu_torch.utils.imageio import resolve_device, upload
from tbist_tpu_torch.utils.logging import backward_span, span
from tbist_tpu_torch.utils.precision import full_f32

DepthFn = Callable[[torch.Tensor], torch.Tensor]

logger = logging.getLogger(__name__)

# optax.adam defaults
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def style_weight_from_strength(strength: float) -> float:
    """Strength -> w_style mapping of the depth component (Style_a3.py:184-188)."""
    if strength < 0:
        return 5e5
    return 5e5 * math.e ** (strength - 1.0 / strength)


def random_start(shape, seed: int, device) -> torch.Tensor:
    """The starting pixels of ``cfg.random_init``: standard normal from a
    ``torch.Generator`` seeded with ``seed``, drawn on the CPU."""
    return upload(torch.randn(tuple(shape), generator=torch.Generator().manual_seed(seed)),
                  device)


def params_on(vgg_params, device, dtype: torch.dtype):
    """The VGG parameters on ``device`` in the trunk's compute dtype.
    ``vgg_params`` may be a ``mesh.Replicas``, whose copy there is kept."""
    if isinstance(vgg_params, mesh_lib.Replicas):
        vgg_params = vgg_params.on(device)
    return {name: {k: vgg19.cast_weight(v.to(device), dtype) for k, v in p.items()}
            for name, p in vgg_params.items()}


def adam_update(grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, i: int,
                lr: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step ``i`` (from 0) of ``optax.adam(lr)``: bias-corrected moments, eps
    outside the sqrt. Returns (update, mu, nu)."""
    mu = (1 - _ADAM_B1) * grad + _ADAM_B1 * mu
    nu = (1 - _ADAM_B2) * torch.square(grad) + _ADAM_B2 * nu
    mu_hat = mu / (1 - _ADAM_B1 ** (i + 1))
    nu_hat = nu / (1 - _ADAM_B2 ** (i + 1))
    return (-lr) * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)), mu, nu


@functools.lru_cache(maxsize=None)
def _vgg_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """VGG's input mean and std on ``device``, made once: a tensor built from
    a Python tuple on a card is a copy the host waits for, and the loss
    normalizes every step."""
    return (torch.tensor(VGG_MEAN, dtype=torch.float32, device=device),
            torch.tensor(VGG_STD, dtype=torch.float32, device=device))


def _lane_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def lane_gram(feat: torch.Tensor) -> torch.Tensor:
    """Each lane's Gram of (B, H, W, C) features through K1 in one launch,
    normalized by c·h·w as ``losses.gram_matrix`` of that lane alone is."""
    b, h, w, c = feat.shape
    return GramFunction.apply(feat.reshape(b, h * w, c), 1.0 / (c * h * w))


def lane_losses(cfg: GatysConfig, params, imgs: torch.Tensor, content_feats, target_grads,
                style_grams: Dict[str, torch.Tensor], w_style,
                depth_fn: Optional[DepthFn] = None,
                target_depths: Optional[torch.Tensor] = None, *,
                step_graph: Optional["StepGraph"] = None) -> torch.Tensor:
    """(B,) Gatys objectives of the B images of ``imgs`` (``_stylize_jit``'s
    loss, and ``tbist_tpu/parallel/batched.py`` ``_per_frame_loss``): the
    B lanes run through VGG-19 as one batch, and each lane's loss is the
    one-image loss of that lane alone, means over its own pixels.

    ``params`` are on the device in the compute dtype; ``content_feats``
    and ``target_grads`` hold each lane's targets, ``style_grams`` the
    shared ones; ``w_style`` is a float or a (B,) tensor of per-lane
    weights. ``target_depths`` ((B, H, W), normalized) adds the depth term
    of ``depth_fn``, run on each lane alone.

    ``step_graph``, a step captured for these arguments with their targets
    loaded (``StepGraphs.held``), computes the loss by a replay of its
    forward, and the gradient by a replay of its backward."""
    if step_graph is not None:
        return _Replay.apply(step_graph, imgs)
    return _lane_losses(cfg, params, imgs, content_feats, target_grads, style_grams, w_style,
                        depth_fn, target_depths)


def _lane_losses(cfg: GatysConfig, params, imgs: torch.Tensor, content_feats, target_grads,
                 style_grams: Dict[str, torch.Tensor], w_style,
                 depth_fn: Optional[DepthFn] = None,
                 target_depths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lane_losses`` computed eagerly."""
    mean, std = _vgg_stats(imgs.device)
    normed = losses.normalize(imgs, mean, std)
    all_layers = tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))
    feats = vgg19.extract_features(params, normed, all_layers,
                                   torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    loss = torch.zeros(imgs.shape[0], dtype=torch.float32, device=imgs.device)
    if cfg.w_content > 0:
        c = sum(_lane_mean(torch.square(feats[l].float() - content_feats[l].float()))
                for l in cfg.content_layers)
        loss = loss + cfg.w_content * (c / len(cfg.content_layers))
    if cfg.w_style > 0:
        s = sum(_lane_mean(torch.square(lane_gram(feats[l]) - style_grams[l]))
                for l in cfg.style_layers)
        loss = loss + w_style * (s / len(cfg.style_layers))
    return _pixel_terms(cfg, loss, imgs, normed, target_grads, depth_fn, target_depths)


def _pixel_terms(cfg: GatysConfig, loss: torch.Tensor, imgs: torch.Tensor,
                 normed: torch.Tensor, target_grads, depth_fn: Optional[DepthFn],
                 target_depths: Optional[torch.Tensor]) -> torch.Tensor:
    """``loss`` plus the terms taken on the whole image: total variation,
    the edge term and the depth term."""
    if cfg.w_tv > 0:
        _, h, w, c = normed.shape
        tv = (_lane_sum(losses.abs_jax(normed[:, 1:] - normed[:, :-1]))
              + _lane_sum(losses.abs_jax(normed[:, :, 1:] - normed[:, :, :-1])))
        loss = loss + cfg.w_tv * (tv / (c * h * w))
    if cfg.w_edge > 0:
        diff = torch.square(target_grads - losses.gradient_images(losses.to_grayscale(imgs)))
        loss = loss + cfg.w_edge * ((_lane_mean(diff[..., 0]) + _lane_mean(diff[..., 1])) / 2.0)
    if target_depths is not None:
        d = torch.stack([normalize_depth(_traced_depth(depth_fn, imgs[i:i + 1]))
                         for i in range(imgs.shape[0])])
        loss = loss + cfg.w_depth * _lane_mean(torch.square(d - target_depths))
    return loss


def _traced_depth(depth_fn: DepthFn, img: torch.Tensor) -> torch.Tensor:
    """``depth_fn(img)``, its backward under the span ``depth.backward``
    while a profiler records."""
    depth = depth_fn(img)
    backward_span("depth.backward", depth, img)
    return depth


def sharded_features(cfg: GatysConfig, params, normed: torch.Tensor,
                     sharding: mesh_lib.WidthSharding, layers: Sequence[str]):
    """``{layer: [shard activations]}`` of the normalized batch ``normed``
    cut by ``sharding``; ``params`` holds one tree a shard, on its device."""
    return vgg19.extract_features_sharded(
        params, sharding.scatter(normed, 2), layers,
        torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)


def _columns(shards: Sequence[torch.Tensor]) -> int:
    return sum(s.shape[2] for s in shards)


def lane_losses_sharded(cfg: GatysConfig, params, imgs: torch.Tensor, content_feats,
                        target_grads, style_grams: Dict[str, torch.Tensor], w_style,
                        sharding: mesh_lib.WidthSharding,
                        depth_fn: Optional[DepthFn] = None,
                        target_depths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``lane_losses`` with the VGG-19 trunk over ``sharding`` (the sp
    axis): ``imgs`` stays whole on the first card, each shard's columns
    run on its own card (``params``: one tree a shard), and the sums over
    the image come back to the first card in shard order. A style layer's
    Gram is K1 on each shard with the whole image's norm, 1/(c·h·W), the
    shards' Grams summed; the content term divides by the whole image's
    count. ``content_feats`` holds each layer's shards (``sharded_features``
    of the content); ``style_grams`` and the pixel terms live on the first
    card."""
    first = imgs.device
    mean, std = _vgg_stats(first)
    normed = losses.normalize(imgs, mean, std)
    all_layers = tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))
    feats = sharded_features(cfg, params, normed, sharding, all_layers)
    loss = torch.zeros(imgs.shape[0], dtype=torch.float32, device=first)
    if cfg.w_content > 0:
        c = 0.0
        for l in cfg.content_layers:
            sq = mesh_lib.sum_on([_lane_sum(torch.square(f.float() - t.float()))
                                  for f, t in zip(feats[l], content_feats[l])], first)
            f0 = feats[l][0]
            c = c + sq / (f0.shape[1] * _columns(feats[l]) * f0.shape[3])
        loss = loss + cfg.w_content * (c / len(cfg.content_layers))
    if cfg.w_style > 0:
        s = 0.0
        for l in cfg.style_layers:
            b, h, _, ch = feats[l][0].shape
            norm = 1.0 / (ch * h * _columns(feats[l]))
            g = mesh_lib.sum_on([GramFunction.apply(f.reshape(b, h * f.shape[2], ch), norm)
                                 for f in feats[l]], first)
            s = s + _lane_mean(torch.square(g - style_grams[l]))
        loss = loss + w_style * (s / len(cfg.style_layers))
    return _pixel_terms(cfg, loss, imgs, normed, target_grads, depth_fn, target_depths)


def _capture(forward: Callable[[], None], backward: Callable[[], None], device: torch.device):
    """``forward`` and ``backward``, functions of no arguments that keep
    their results, captured as two CUDA graphs in one memory pool, the
    pattern of ``torch.cuda.make_graphed_callables``. One eager run of both
    first makes what their first call makes (handles, workspaces, flipped
    weights, cached resize weights), so that the capture allocates only the
    step's own tensors; it runs on the capture's side stream, where the
    autograd nodes it leaves behind then find the stream they were made on."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        forward()
        backward()
    pool = torch.cuda.graph_pool_handle()
    graphs = []
    for fn in (forward, backward):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, stream=side):
            fn()
        graphs.append(graph)
    torch.cuda.current_stream(device).wait_stream(side)
    return graphs


class StepGraph:
    """One step's loss and its gradient with respect to the image, captured
    (``_capture``) over fixed tensors: the image ``x``, the targets, the
    loss, the incoming gradient and the image's gradient. A replay reads
    and overwrites them in place; ``_Replay`` copies in and out."""

    def __init__(self, cfg: GatysConfig, params, img: torch.Tensor, content_feats,
                 target_grad: torch.Tensor, style_grams: Dict[str, torch.Tensor],
                 depth_fn: Optional[DepthFn], target_depth: Optional[torch.Tensor]):
        # what the graphs read by address, kept alive with them
        self.params, self.depth_fn = params, depth_fn
        self.x = img.detach().clone().requires_grad_(True)
        self.content_feats = {l: content_feats[l].clone() for l in cfg.content_layers}
        self.style_grams = {l: g.clone() for l, g in style_grams.items()}
        self.target_grad = target_grad.clone()
        self.target_depth = None if target_depth is None else target_depth.clone()
        self.grad_loss = torch.ones(img.shape[0], dtype=torch.float32, device=img.device)

        def forward():
            with torch.enable_grad():
                self.loss = _lane_losses(cfg, params, self.x, self.content_feats,
                                         self.target_grad, self.style_grams, cfg.w_style,
                                         depth_fn, self.target_depth)

        def backward():
            # the gradient of grad_loss·loss, not ``grad_outputs=grad_loss``:
            # a tensor there has autograd import sympy, seconds of set-up
            with torch.enable_grad():
                weighted = (self.loss * self.grad_loss).sum()
            (self.grad,) = torch.autograd.grad(weighted, self.x)

        # the cached resize weights the graphs read, kept alive with them
        self.resize_weights = []
        with resize.holding(self.resize_weights):
            self.fwd, self.bwd = _capture(forward, backward, img.device)

    def load(self, content_feats, style_grams: Dict[str, torch.Tensor],
             target_grad: torch.Tensor, target_depth: Optional[torch.Tensor]) -> None:
        """Copy a request's targets into the graphs' buffers."""
        for l, t in self.content_feats.items():
            t.copy_(content_feats[l])
        for l, t in self.style_grams.items():
            t.copy_(style_grams[l])
        self.target_grad.copy_(target_grad)
        if self.target_depth is not None:
            self.target_depth.copy_(target_depth)


class _Replay(torch.autograd.Function):
    """``StepGraph``'s loss at ``img`` by one replay of its forward, and
    the gradient by one of its backward. Both return copies: the next
    replay overwrites the graphs' outputs, and ``lbfgs.update`` keeps the
    gradient it is given until the next step."""

    @staticmethod
    def forward(ctx, graph: StepGraph, img: torch.Tensor) -> torch.Tensor:
        ctx.graph = graph
        graph.x.copy_(img)
        graph.fwd.replay()
        with _GRAPH_COUNT_LOCK:
            stylize.replays += 1
        return graph.loss.detach().clone()

    @staticmethod
    def backward(ctx, grad_loss: torch.Tensor):
        graph = ctx.graph
        graph.grad_loss.copy_(grad_loss)
        graph.bwd.replay()
        return None, graph.grad.clone()


def _step_key(cfg: GatysConfig, params, img: torch.Tensor, depth_fn: Optional[DepthFn],
              target_depth: Optional[torch.Tensor]) -> tuple:
    """What a captured step is fixed to: the image's shape, dtype and
    device, the loss's terms and weights (scalars of its kernels), the VGG
    weights it reads (by address, and version: a weight written in place
    makes its flipped copy anew) and the depth estimator (by identity)."""
    loss = (cfg.dtype, cfg.content_layers, cfg.style_layers, cfg.w_content, cfg.w_style,
            cfg.w_tv, cfg.w_edge)
    depth = None if target_depth is None else (id(depth_fn), cfg.w_depth)
    weights = tuple((t.data_ptr(), t._version) for p in params.values() for t in p.values())
    return tuple(img.shape), img.dtype, img.device, loss, depth, weights


def _engages(img: torch.Tensor) -> bool:
    """Whether ``stylize``'s loop captures its step: on a card."""
    return img.device.type == "cuda"


# captured steps kept (each holds its own memory pool)
KEPT_STEP_GRAPHS = 4


class StepGraphs:
    """The last ``KEPT_STEP_GRAPHS`` captured steps by ``_step_key``, each
    lent to one loop at a time. A key whose capture failed runs eagerly from
    then on."""

    def __init__(self):
        self._graphs: "collections.OrderedDict[tuple, StepGraph]" = collections.OrderedDict()
        self._lent: set = set()
        self._failed: set = set()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def held(self, cfg: GatysConfig, params, img: torch.Tensor, content_feats,
             target_grad: torch.Tensor, style_grams: Dict[str, torch.Tensor],
             depth_fn: Optional[DepthFn],
             target_depth: Optional[torch.Tensor]) -> Iterator[Optional[StepGraph]]:
        """The captured step for these arguments with their targets loaded,
        captured now if there is none; None where the loop runs eagerly (on
        the CPU, while another loop holds the key, after a failed capture)."""
        if not _engages(img):
            yield None
            return
        key = _step_key(cfg, params, img, depth_fn, target_depth)
        with self._lock:
            mine = key not in self._lent and key not in self._failed
            if mine:
                self._lent.add(key)
                graph = self._graphs.pop(key, None)
                while graph is None and len(self._graphs) >= KEPT_STEP_GRAPHS:
                    # dropping its graphs and buffers frees its pool
                    self._graphs.popitem(last=False)
        if not mine:
            yield None
            return
        try:
            if graph is None:
                graph = self._new(key, cfg, params, img, content_feats, target_grad,
                                  style_grams, depth_fn, target_depth)
            else:
                graph.load(content_feats, style_grams, target_grad, target_depth)
            yield graph
        finally:
            with self._lock:
                self._lent.discard(key)
                if graph is not None:
                    self._graphs[key] = graph

    def _new(self, key, cfg, params, img, *targets) -> Optional[StepGraph]:
        with span("step.capture"):
            try:
                graph = StepGraph(cfg, params, img.clamp(0.0, 1.0), *targets)
            except RuntimeError as err:  # the depth estimator is the caller's code
                logger.warning("gatys: the step cannot be captured as a CUDA graph, so it "
                               "runs eagerly: %s", err)
                with self._lock:
                    self._failed.add(key)
                return None
        with _GRAPH_COUNT_LOCK:
            stylize.captures += 1
        return graph


_GRAPH_COUNT_LOCK = threading.Lock()
step_graphs = StepGraphs()


def _attend(content_feats, cfg: GatysConfig, given, device):
    """SE channel attention over the content features of
    ``cfg.content_layers`` (``tbist_tpu/optimize/gatys.py:142-157``)."""
    feats = dict(content_feats)
    for layer in cfg.content_layers:
        params = (given or {}).get(layer)
        if params is None:
            gen = torch.Generator().manual_seed(channel_attention.layer_seed(cfg.seed, layer))
            params = channel_attention.init_params(gen, feats[layer].shape[-1])
        params = {k: upload(v, device).float() for k, v in params.items()}
        feats[layer] = channel_attention.apply(params, feats[layer])
    return feats


def stylize(
    content: torch.Tensor,
    styles: Sequence[torch.Tensor],
    cfg: GatysConfig,
    vgg_params,
    init: Optional[torch.Tensor] = None,
    device="cuda",
    channel_attention_params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    depth_fn: Optional[DepthFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Gatys optimization. Returns (image (1,H,W,3) in [0,1], loss
    history (num_steps,)), both on ``device``.

    ``styles`` holds one or two NHWC style images; two trigger style mixing
    with ``cfg.style_img_weight``. ``init`` overrides the starting pixels
    (checkpoint resume) while the targets stay those of ``content`` and
    ``styles``. ``cfg.random_init`` draws the start from a
    ``torch.Generator`` seeded with ``cfg.seed`` (``random_start``): the
    same distribution as the JAX package's ``jax.random.normal``, not the
    same numbers. ``cfg.channel_attention`` reweights the content features
    of ``cfg.content_layers`` with SE attention before the loop; each
    layer's weights are drawn from a generator seeded with ``cfg.seed`` and
    the layer's name (``channel_attention.layer_seed``), unless
    ``channel_attention_params`` gives them by layer. ``depth_fn``, an
    (1, H, W, 3) -> (H, W) depth estimator, adds ``cfg.w_depth`` times the
    MSE between the normalized depth of the image and of ``content``
    (computed once) when ``cfg.w_depth > 0``; the estimator stays in the
    graph.
    """
    if cfg.optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    params = params_on(vgg_params, device, compute_dtype)
    content = content.to(device, torch.float32)
    styles = [s.to(device, torch.float32) for s in styles]
    mean, std = _vgg_stats(device)
    all_layers = tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))

    with full_f32(), span("loop"):
        # --- feature targets (reference run_style_transfer.py:78-80) ---
        with torch.no_grad():
            normed_content = losses.normalize(content, mean, std)
            content_feats = vgg19.extract_features(
                params, normed_content, all_layers, compute_dtype
            )
            targets = {}
            if cfg.w_style > 0:
                style_feats = [
                    vgg19.extract_features(
                        params, losses.normalize(s, mean, std), cfg.style_layers,
                        compute_dtype,
                    )
                    for s in styles
                ]
                targets = losses.style_targets(
                    style_feats, cfg.style_layers, cfg.style_img_weight,
                    cfg.exact_reference_mixer,
                )
            target_grad = losses.gradient_images(losses.to_grayscale(normed_content))
            if cfg.channel_attention:
                content_feats = _attend(content_feats, cfg, channel_attention_params, device)
            target_depth = None
            if depth_fn is not None and cfg.w_depth > 0:
                target_depth = normalize_depth(depth_fn(content))[None]

        if init is not None:
            img = init.to(device, torch.float32)
        elif cfg.random_init:
            img = random_start(content.shape, cfg.seed, device)
        else:
            img = content.clone()

        hist = torch.zeros((cfg.num_steps,), dtype=torch.float32, device=device)
        if cfg.optimizer == "lbfgs":
            state = lbfgs.init_state(
                tuple(img.shape), cfg.lbfgs_memory, torch.float32, device
            )
        else:
            mu = torch.zeros_like(img)
            nu = torch.zeros_like(img)

        with step_graphs.held(cfg, params, img, content_feats, target_grad, targets, depth_fn,
                              target_depth) as graph:
            for i in range(cfg.num_steps):
                with span("step"):
                    img = img.clamp(0.0, 1.0).requires_grad_(True)  # per-closure clamp
                    with span("step.forward"):
                        loss = lane_losses(cfg, params, img, content_feats, target_grad,
                                           targets, cfg.w_style, depth_fn, target_depth,
                                           step_graph=graph)[0]
                    with span("step.backward"):
                        (grad,) = torch.autograd.grad(loss, img)
                    img = img.detach()
                    hist[i] = loss.detach()
                    with span("step.update"):
                        if cfg.optimizer == "lbfgs":
                            step_vec, state = lbfgs.update(grad, state, lr=cfg.learning_rate)
                        else:
                            step_vec, mu, nu = adam_update(grad, mu, nu, i, cfg.adam_lr)
                        img = img + step_vec

    return img.clamp(0.0, 1.0), hist


# Steps captured as a CUDA graph (``StepGraphs``), and steps replayed.
stylize.captures = 0
stylize.replays = 0
