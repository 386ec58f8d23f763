"""The Gatys step as a captured CUDA graph (``optimize.gatys.StepGraph``).

On the CPU: the loop runs eagerly there; the cache key; and the graph path
itself, with a stand-in for the capture whose replay runs the captured
function again, so that the buffers, the target loading, the copies out of
a replay and the counters are checked without a card. Marked ``gpu``: the
captured loop against the eager one on a card, at 64-128 px. Without the
JAX package."""

import dataclasses
import os
import subprocess
import sys
import types

import pytest
import torch

from tbist_tpu_torch import kernels
from tbist_tpu_torch.models import depth_anything, vgg19
from tbist_tpu_torch.optimize import gatys, lbfgs
from tbist_tpu_torch.utils import prof
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.utils.precision import full_f32

TINY_DA = depth_anything.DAConfig(patch=7, width=32, layers=2, heads=2, mlp_ratio=2,
                                  out_layers=(1, 1, 2, 2), neck_dims=(8, 8, 16, 16), fusion=8,
                                  head_hidden=8, pos_grid=6, input_size=42)
CONFIGS = {
    "gatys": GatysConfig(num_steps=4, w_style=1e4),
    "adam": GatysConfig(num_steps=4, w_style=1e4, optimizer="adam"),
    "depth": GatysConfig(num_steps=4, w_style=1e4, w_depth=5e4),
    "bf16": GatysConfig(num_steps=4, w_style=1e4, dtype="bfloat16"),
}


def _vgg(device="cpu"):
    return vgg19.init_params(torch.Generator().manual_seed(0), device=device)


def _depth_fn(device="cpu"):
    params = depth_anything.init_params(torch.Generator().manual_seed(1), TINY_DA, device=device)
    return lambda img: depth_anything.predict_depth(params, TINY_DA, img)


def _images(seed, side, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [torch.rand((1, side, side, 3), generator=g).to(device) for _ in range(2)]


def _run(name, vgg, depth_fn, seed, side=32, device="cpu"):
    content, style = _images(seed, side, device)
    cfg = CONFIGS[name]
    img, hist = gatys.stylize(content, [style], cfg, vgg, device=device,
                              depth_fn=depth_fn if cfg.w_depth > 0 else None)
    return img.cpu(), hist.cpu()


@pytest.fixture
def counters(monkeypatch):
    """A fresh cache and zeroed counters for the test."""
    monkeypatch.setattr(gatys, "step_graphs", gatys.StepGraphs())
    monkeypatch.setattr(gatys.stylize, "captures", 0)
    monkeypatch.setattr(gatys.stylize, "replays", 0)
    kernels.reset_launch_counts()
    vgg19.reset_dgrad_counts()


def _eager_capture(forward, backward, device):
    """A capture whose replays run ``forward`` and ``backward`` again: on
    the CPU it stands in for ``gatys._capture``."""
    forward()
    backward()
    return types.SimpleNamespace(replay=forward), types.SimpleNamespace(replay=backward)


@pytest.fixture
def stand_in(monkeypatch, counters):
    """The graph path on the CPU, through ``_eager_capture``."""
    monkeypatch.setattr(gatys, "_engages", lambda img: True)
    monkeypatch.setattr(gatys, "_capture", _eager_capture)


def _hand_loop(cfg, vgg, content, style, depth_fn):
    """``stylize``'s loop from its public parts, for L-BFGS and Adam."""
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    params = gatys.params_on(vgg, "cpu", dtype)
    mean, std = gatys._vgg_stats(torch.device("cpu"))
    layers = tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))
    with torch.no_grad(), full_f32():
        normed = gatys.losses.normalize(content, mean, std)
        feats = vgg19.extract_features(params, normed, layers, dtype)
        grams = gatys.losses.style_targets(
            [vgg19.extract_features(params, gatys.losses.normalize(style, mean, std),
                                    cfg.style_layers, dtype)],
            cfg.style_layers, cfg.style_img_weight, cfg.exact_reference_mixer)
        tgrad = gatys.losses.gradient_images(gatys.losses.to_grayscale(normed))
        tdepth = None if depth_fn is None else gatys.normalize_depth(depth_fn(content))[None]
        img, hist = content.clone(), []
        state = lbfgs.init_state(tuple(img.shape), cfg.lbfgs_memory)
        mu, nu = torch.zeros_like(img), torch.zeros_like(img)
        for i in range(cfg.num_steps):
            x = img.clamp(0.0, 1.0).requires_grad_(True)
            with torch.enable_grad():
                loss = gatys.lane_losses(cfg, params, x, feats, tgrad, grams, cfg.w_style,
                                         depth_fn, tdepth)[0]
                (grad,) = torch.autograd.grad(loss, x)
            hist.append(float(loss))
            if cfg.optimizer == "lbfgs":
                step, state = lbfgs.update(grad, state, lr=cfg.learning_rate)
            else:
                step, mu, nu = gatys.adam_update(grad, mu, nu, i, cfg.adam_lr)
            img = x.detach() + step
    return img.clamp(0.0, 1.0), torch.tensor(hist)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cpu_loop_is_eager_and_unchanged(counters, name):
    """On the CPU nothing is captured or replayed, and ``stylize`` gives
    bit for bit what its loop written out from the public parts gives."""
    vgg, depth_fn = _vgg(), _depth_fn()
    img, hist = _run(name, vgg, depth_fn, seed=0)
    assert gatys.stylize.captures == 0 and gatys.stylize.replays == 0
    content, style = _images(0, 32)
    cfg = CONFIGS[name]
    want_img, want_hist = _hand_loop(cfg, vgg, content, style,
                                     depth_fn if cfg.w_depth > 0 else None)
    assert torch.equal(hist, want_hist)
    assert torch.equal(img, want_img)


def _key_args(**change):
    """``_step_key``'s arguments for a 32px depth-loss step, with ``change``."""
    args = dict(cfg=CONFIGS["depth"], params=KEY_VGG, img=torch.zeros(1, 32, 32, 3),
                depth_fn=KEY_DEPTH, target_depth=torch.zeros(1, 32, 32))
    args.update(change)
    return args


KEY_VGG, KEY_DEPTH = _vgg(), _depth_fn()
KEY_CHANGES = {
    "shape": dict(img=torch.zeros(1, 64, 32, 3)),
    "dtype": dict(img=torch.zeros(1, 32, 32, 3, dtype=torch.float64)),
    "w_style": dict(cfg=dataclasses.replace(CONFIGS["depth"], w_style=2e4)),
    "style_layers": dict(cfg=dataclasses.replace(CONFIGS["depth"],
                                                 style_layers=("conv1_1", "conv2_1"))),
    "content_layers": dict(cfg=dataclasses.replace(CONFIGS["depth"],
                                                   content_layers=("conv3_2",))),
    "trunk_dtype": dict(cfg=dataclasses.replace(CONFIGS["depth"], dtype="bfloat16")),
    "w_depth": dict(cfg=dataclasses.replace(CONFIGS["depth"], w_depth=1.0)),
    "depth_estimator": dict(depth_fn=_depth_fn()),
    "no_depth_term": dict(target_depth=None),
    "weights": dict(params=_vgg()),
}


@pytest.mark.parametrize("change", sorted(KEY_CHANGES))
def test_step_key_separates(change):
    """Each part of the key (shape and dtype, the loss's layers and
    weights, the trunk's dtype, the depth estimator, the VGG weights)
    gives another key; the same arguments, in new containers, the same."""
    same = _key_args(params={n: dict(p) for n, p in KEY_VGG.items()},
                     cfg=dataclasses.replace(CONFIGS["depth"]))
    assert gatys._step_key(**same) == gatys._step_key(**_key_args())
    assert gatys._step_key(**_key_args(**KEY_CHANGES[change])) != gatys._step_key(**_key_args())


def test_step_key_follows_a_weight_written_in_place():
    vgg = _vgg()
    before = gatys._step_key(**_key_args(params=vgg))
    vgg["conv1_1"]["weight"].mul_(1.0)
    assert gatys._step_key(**_key_args(params=vgg)) != before


def test_bf16_trunk_reads_the_same_weights_each_request():
    """A bf16 trunk's weights are cast once per weight tensor, so that its
    requests share a key."""
    vgg = _vgg()
    a = gatys.params_on(vgg, "cpu", torch.bfloat16)
    b = gatys.params_on(vgg, "cpu", torch.bfloat16)
    assert all(a[n][k] is b[n][k] and a[n][k].dtype == torch.bfloat16
               for n in a for k in a[n])
    assert gatys.params_on(vgg, "cpu", torch.float32)["conv1_1"]["weight"] is \
        vgg["conv1_1"]["weight"]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_replays_match_eager_across_requests(stand_in, name):
    """Two requests of one key with different pairs: one capture, a replay
    a step, and each request's history and image bit for bit those of the
    eager loop (each request's targets were copied in); the trunk's
    input-gradient routes counted as eagerly, plus the one step the
    capture runs eagerly first (the stand-in records nothing itself)."""
    vgg, depth_fn = _vgg(), _depth_fn()
    got = [_run(name, vgg, depth_fn, seed) for seed in (0, 1)]
    steps = CONFIGS[name].num_steps
    assert gatys.stylize.captures == 1 and gatys.stylize.replays == 2 * steps
    routes = vgg19.dgrad_counts()
    vgg19.reset_dgrad_counts()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gatys, "_engages", lambda img: False)
        want = [_run(name, vgg, depth_fn, seed) for seed in (0, 1)]
    eager = vgg19.dgrad_counts()
    assert routes == {r: n + n // (2 * steps) for r, n in eager.items()}
    for (img, hist), (want_img, want_hist) in zip(got, want):
        assert torch.equal(hist, want_hist)
        assert torch.equal(img, want_img)
    assert not torch.equal(got[0][1], got[1][1])


def test_resume_segments_share_one_capture(stand_in, tmp_path):
    """``stylize_resumable``'s segments are ``stylize`` calls of one key:
    one capture, a replay a step."""
    from tbist_tpu_torch.optimize import checkpoint

    content, style = _images(0, 32)
    cfg = dataclasses.replace(CONFIGS["gatys"], num_steps=6)
    _, hist = checkpoint.stylize_resumable(content, [style], cfg, _vgg(), str(tmp_path / "ck"),
                                           segment_steps=2, device="cpu")
    assert len(hist) == 6
    assert gatys.stylize.captures == 1 and gatys.stylize.replays == 6


def test_gradient_given_to_update_is_a_copy(stand_in, monkeypatch):
    """Each gradient ``lbfgs.update`` gets is its own tensor, not the
    graph's, and keeps its values through the next step's replay."""
    kept, real = [], lbfgs.update

    def update(grad, state, lr=1.0):
        kept.append((grad, grad.clone()))
        return real(grad, state, lr=lr)

    monkeypatch.setattr(lbfgs, "update", update)
    buffers = []
    real_new = gatys.StepGraphs._new

    def new(self, *args):
        graph = real_new(self, *args)
        buffers.append(graph)
        return graph

    monkeypatch.setattr(gatys.StepGraphs, "_new", new)
    _run("gatys", _vgg(), None, seed=0)
    (graph,) = buffers
    owned = {t.data_ptr() for t in (graph.x, graph.grad, graph.loss, graph.grad_loss,
                                    graph.target_grad, *graph.content_feats.values(),
                                    *graph.style_grams.values())}
    assert len(kept) == CONFIGS["gatys"].num_steps
    for grad, values in kept:
        assert grad.data_ptr() not in owned
        assert torch.equal(grad, values)


def test_capture_leaves_sympy_unimported():
    """A tensor of ``grad_outputs`` has autograd import sympy, seconds of a
    process's set-up: the captured backward gives none (a fresh process,
    the stand-in capture)."""
    code = ("import sys, types, torch\n"
            "from tbist_tpu_torch.models import vgg19\n"
            "from tbist_tpu_torch.optimize import gatys\n"
            "from tbist_tpu_torch.utils.config import GatysConfig\n"
            "def capture(f, b, device):\n"
            "    f(); b()\n"
            "    return types.SimpleNamespace(replay=f), types.SimpleNamespace(replay=b)\n"
            "gatys._engages, gatys._capture = (lambda img: True), capture\n"
            "img = torch.rand(1, 32, 32, 3)\n"
            "gatys.stylize(img, [img], GatysConfig(num_steps=1, style_layers=('conv1_1',), "
            "content_layers=('conv1_2',)), vgg19.init_params(torch.Generator()), device='cpu')\n"
            "print(gatys.stylize.captures, 'sympy' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["1", "False"]


def test_failed_capture_runs_eagerly_once(counters, monkeypatch):
    """A step that cannot be captured (say, a depth estimator that reads
    back) runs eagerly, with a warning, and its key is not tried again."""
    tries = []

    def refuse(forward, backward, device):
        tries.append(device)
        raise RuntimeError("operation not permitted when stream is capturing")

    warned = []
    monkeypatch.setattr(gatys.logger, "warning", lambda msg, *a: warned.append(msg % a))
    monkeypatch.setattr(gatys, "_engages", lambda img: True)
    monkeypatch.setattr(gatys, "_capture", refuse)
    vgg = _vgg()
    got = [_run("gatys", vgg, None, seed=0) for _ in range(2)]
    assert len(tries) == 1 and gatys.stylize.captures == 0 and gatys.stylize.replays == 0
    assert len(warned) == 1 and "runs eagerly" in warned[0]
    monkeypatch.setattr(gatys, "_engages", lambda img: False)
    want = _run("gatys", vgg, None, seed=0)
    for img, hist in got:
        assert torch.equal(hist, want[1]) and torch.equal(img, want[0])


def test_the_oldest_capture_makes_room(stand_in, monkeypatch):
    """With ``KEPT_STEP_GRAPHS`` entries held, a new key drops the least
    recently used one; a key in use is not lent twice."""
    monkeypatch.setattr(gatys, "KEPT_STEP_GRAPHS", 2)
    vgg = _vgg()
    for side in (32, 64, 32, 96):
        _run("gatys", vgg, None, seed=0, side=side)
    assert gatys.stylize.captures == 3
    assert [k[0][1] for k in gatys.step_graphs._graphs] == [32, 96]
    cached = next(iter(gatys.step_graphs._graphs.values()))
    args = (CONFIGS["gatys"], gatys.params_on(vgg, "cpu", torch.float32),
            torch.rand(1, 32, 32, 3), cached.content_feats, cached.target_grad,
            cached.style_grams, None, None)
    with gatys.step_graphs.held(*args) as first, gatys.step_graphs.held(*args) as second:
        assert first is cached and second is None


@pytest.mark.parametrize("name,wrapper", [
    ("void (anonymous namespace)::gram_fwd_kernel<GramTile<64>, float, true>(float const*)",
     "gram_fwd"),
    ("void (anonymous namespace)::gram_reduce_kernel(float const*, float*, long)", None),
    ("void (anonymous namespace)::gram_bwd_kernel<GramTile<64>, float, false>(float const*)",
     "gram_bwd"),
    ("void (anonymous namespace)::pool_bwd_kernel<float, true>(float const*, long)",
     "relu_pool_bwd"),
    ("void (anonymous namespace)::pool_bwd_kernel<__nv_bfloat16, false>(long)", "pool_bwd"),
    ("_ZN12_GLOBAL__N_115pool_bwd_kernelIfLb1EEEvPKfS2_", "relu_pool_bwd"),
    ("_ZN12_GLOBAL__N_115pool_bwd_kernelIfLb0EEEvPKfS2_", "pool_bwd"),
    ("void at::native::vectorized_elementwise_kernel<4, float>(int, float)", None),
])
def test_traced_counts_name_the_wrapper(name, wrapper):
    """A device trace's kernel name counts for the wrapper that launches
    it, whatever the template arguments; other kernels count for none."""
    counts = kernels.traced_counts([name, name])
    assert counts == {k: 2 if k == wrapper else 0 for k in counts}
    assert set(counts) == set(kernels.launch_counts()) - {"sam_attn"}


def test_capture_holds_the_resize_weights_it_read(stand_in):
    """The depth estimator's resizes read cached weights by address; the
    captured step keeps each of them alive, whatever the bounded cache
    drops later."""
    from tbist_tpu_torch.ops import resize

    kept = []
    real_new = gatys.StepGraphs._new

    def new(self, *args):
        kept.append(real_new(self, *args))
        return kept[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gatys.StepGraphs, "_new", new)
        _run("depth", _vgg(), _depth_fn(), seed=0)
    (graph,) = kept
    assert graph.resize_weights
    assert resize._linear_weights_cached.cache_info().maxsize == 64
    for weights in graph.resize_weights:
        assert len(weights) == 3 and all(isinstance(t, torch.Tensor) for t in weights)
    outside = len(graph.resize_weights)
    resize.resize_bilinear(torch.rand(1, 8, 8, 3), (5, 7))
    assert len(graph.resize_weights) == outside


@pytest.mark.parametrize("kind", ["flip", "cast"])
def test_derived_weight_made_once_and_again_after_a_write(kind):
    """``vgg19``'s flipped and cast weights are made once per weight tensor
    and dtype, and made again once the weight is written in place."""
    make = vgg19.flipped_weight if kind == "flip" else vgg19.cast_weight
    weight = _vgg()["conv2_1"]["weight"]
    first = make(weight, torch.bfloat16)
    assert make(weight, torch.bfloat16) is first
    assert make(weight, torch.float64) is not first
    weight.mul_(2.0)
    again = make(weight, torch.bfloat16)
    assert again is not first and torch.equal(again, make(weight, torch.bfloat16))
    assert torch.equal(again.float(), 2.0 * first.float())


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch, counters):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _card_runs(name, cuda, seeds, side, graphed):
    """(runs, K1's and K3's kernels the card ran, from a device trace,
    routes picked on the host) of ``seeds``' requests at ``side`` px on the
    card, with or without the captured step."""
    vgg, depth_fn = _vgg(cuda), _depth_fn(cuda)
    with pytest.MonkeyPatch.context() as mp:
        if not graphed:
            mp.setattr(gatys, "_engages", lambda img: False)
        vgg19.reset_dgrad_counts()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
            runs = [_run(name, vgg, depth_fn, seed, side, cuda) for seed in seeds]
            torch.cuda.synchronize()
        return runs, kernels.traced_counts(prof.device_kernel_names(p)), vgg19.dgrad_counts()


def _max_diff(runs, want):
    """The largest differences of loss histories (relative) and images
    (absolute) between two lists of runs."""
    return (max(float(((h - wh).abs() / wh.abs()).max()) for (_, h), (_, wh) in zip(runs, want)),
            max(float((i - wi).abs().max()) for (i, _), (wi, _) in zip(runs, want)))


@pytest.mark.gpu
@pytest.mark.parametrize("name,side", [("gatys", 128), ("adam", 64), ("depth", 64),
                                       ("bf16", 64)])
def test_card_graphed_loop_matches_eager(cuda, name, side):
    """Two requests with different pairs on the card: one capture, a
    replay a step, the card running K1 and K3 as often as eagerly but for
    the one step the capture runs eagerly first, the routes picked on the
    host twice (that step and the capture's), and each request's loss
    history and image the eager loop's: bit for bit where
    the eager loop repeats itself bit for bit (cuDNN deterministic; the same
    kernels in the same order), else no farther from it than a second eager
    run is. With the depth term it does not: Depth Anything's resizes
    differentiate through ``index_select``, whose backward adds with
    atomics."""
    eager, e_counts, e_routes = _card_runs(name, cuda, (0, 1), side, graphed=False)
    again = _card_runs(name, cuda, (0, 1), side, graphed=False)[0]
    graphed, g_counts, g_routes = _card_runs(name, cuda, (0, 1), side, graphed=True)
    steps = CONFIGS[name].num_steps
    assert gatys.stylize.captures == 1 and gatys.stylize.replays == 2 * steps
    one_step = {"gram_fwd": e_counts["gram_bwd"] // (2 * steps),
                "gram_bwd": e_counts["gram_bwd"] // (2 * steps), "pool_bwd": 0,
                "relu_pool_bwd": e_counts["relu_pool_bwd"] // (2 * steps)}
    assert g_counts == {k: n + one_step[k] for k, n in e_counts.items()}
    assert g_routes == {r: n // steps for r, n in e_routes.items()}
    assert one_step["gram_fwd"] > 0 and one_step["relu_pool_bwd"] > 0
    spread, off = _max_diff(again, eager), _max_diff(graphed, eager)
    print(f"{name}: eager against eager {spread}, graphed against eager {off}")
    if name == "depth":
        assert all(o <= 4 * s for o, s in zip(off, spread))
    else:
        assert spread == (0.0, 0.0) and off == (0.0, 0.0)


@pytest.mark.gpu
@pytest.mark.parametrize("wait", ["item", "synchronize"])
def test_card_uncapturable_depth_runs_eagerly(cuda, monkeypatch, wait):
    """A depth estimator that waits for the card (reads a value back, or
    synchronizes) cannot be captured: the loop warns and runs eagerly, and
    the card goes on working."""
    warned = []
    monkeypatch.setattr(gatys.logger, "warning", lambda msg, *a: warned.append(msg % a))
    vgg, depth_fn = _vgg(cuda), _depth_fn(cuda)

    def waits(img):
        d = depth_fn(img)
        if wait == "item":
            return d * (1.0 + 0.0 * float(d.detach().mean()))
        torch.cuda.synchronize()
        return d

    img, hist = _run("depth", vgg, waits, seed=0, side=64, device=cuda)
    assert gatys.stylize.captures == 0 and len(warned) == 1
    assert torch.isfinite(hist).all() and torch.isfinite(img).all()
    _run("gatys", vgg, None, seed=0, side=64, device=cuda)
    assert gatys.stylize.captures == 1
