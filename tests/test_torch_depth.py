"""The port's depth slice on the CPU against the JAX package: Depth Anything
(``models/depth_anything``, ``weights/depth_convert``), the tie-splitting
gradient of ``normalize_depth``, depth-loss Gatys, MIP in both plans, the
pipeline's stage 7 and ``--depth`` through the CLI.

Depth Anything runs at the tiny configs of ``tests/test_depth_model.py``
(patch 7, grid 6) and ``tests/test_torch_parity.py`` (patch 14, grid 4) on
shared numpy weights of unit gain (each weight normal / sqrt(fan in),
LayerScale 1): at the seeded init's 0.02 the depth is about 5e-8 and a
relative tolerance would hold almost any function to it. The tests'
weights are the numpy draw of ``_np_params``; the seeded init is checked
for its shapes.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from tbist_tpu.compose import pipeline as jpl
from tbist_tpu.effects import depth as jdepth
from tbist_tpu.effects import masking as jmasking
from tbist_tpu.models import depth_anything as jda
from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.ops import mip as jmip
from tbist_tpu.optimize import gatys_depth as jgd
from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils import imageio as jio
from tbist_tpu.utils.logging import RunMetrics as JRunMetrics
from tbist_tpu_torch import api, cli
from tbist_tpu_torch.compose import pipeline
from tbist_tpu_torch.effects import depth, masking
from tbist_tpu_torch.models import depth_anything as tda
from tbist_tpu_torch.ops import mip
from tbist_tpu_torch.optimize import gatys_depth
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils import imageio as tio
from tbist_tpu_torch.utils.config import DepthConfig, EffectRequest, GatysConfig, TextEffectConfig
from tbist_tpu_torch.utils.logging import RunMetrics
from tbist_tpu_torch.weights import depth_convert
from tbist_tpu_torch.weights.vgg import from_jax_params as vgg_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOAT = os.path.join(ROOT, "data/content_imgs/boat.jpg")
STARRY = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")

TINY = dict(patch=7, width=32, layers=2, heads=2, mlp_ratio=2, out_layers=(1, 1, 2, 2),
            neck_dims=(8, 8, 16, 16), fusion=8, head_hidden=8, pos_grid=6, input_size=42)
JCFG, TCFG = jda.DAConfig(**TINY), tda.DAConfig(**TINY)
TOL = 1e-5  # of max|want|, f32 forward


def _np_params(cfg, seed):
    """Random numpy weights in the JAX layout at ``cfg``, with the shapes of
    JAX's init (by ``eval_shape``): each weight normal / sqrt(fan in) (HWIO
    and (in, out) both have fan in = prod(shape[:-1])), LayerScale 1,
    LayerNorm scales about 1, the rest normal × 0.1."""
    rng = np.random.default_rng(seed)

    def fill(tree, key=None):
        if isinstance(tree, dict):
            return {k: fill(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [fill(v) for v in tree]
        a = rng.standard_normal(tree.shape)
        if key in ("ls1", "ls2"):
            a = np.ones(tree.shape)
        elif key.endswith("w") and a.ndim >= 2:
            a = a / np.sqrt(np.prod(a.shape[:-1]))
        elif key == "scale":
            a = 1 + 0.1 * a
        else:
            a = 0.1 * a
        return a.astype(np.float32)

    return fill(jax.eval_shape(lambda k: jda.init_params(k, cfg), jax.random.key(0)))


NP_PARAMS = _np_params(JCFG, 0)
JPARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
TPARAMS = depth_convert.from_jax_params(NP_PARAMS)
VGG_J = jax.jit(jvgg.init_params)(jax.random.key(0))  # the goldens' weights (to 6e-8)
VGG_T = vgg_from_jax(jax.tree.map(np.asarray, VGG_J))
# the JAX side jitted: op by op it takes seconds a call
j_encode = jax.jit(jda.encode, static_argnums=1)
j_predict = jax.jit(jda.predict_depth, static_argnums=1)
j_predict_grad = jax.jit(jax.grad(lambda p, im: jnp.mean(jda.predict_depth(p, JCFG, im)),
                                  argnums=1))


@pytest.fixture(autouse=True)
def _uncached_ac_matrices(monkeypatch):
    """The JAX package's ``_ac_matrix`` lru-caches jnp arrays, so the first
    jit trace that builds one caches a tracer that leaks into the next
    trace. The tests call it uncached."""
    monkeypatch.setattr(jda, "_ac_matrix", jda._ac_matrix.__wrapped__)


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ---------------------------------------------------------------------------
# Depth Anything
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(42, 42), (84, 42), (28, 56)])
def test_encode_taps_match_jax(hw):
    """(84, 42) and (28, 56) resize the 6x6 position table bicubically
    (up to 12x6; down to 4 rows, antialiased), (42, 42) keeps it."""
    x = _rand(1, (1, *hw, 3))
    want = j_encode(JPARAMS, JCFG, jnp.asarray(x))
    got = tda.encode(TPARAMS, TCFG, torch.from_numpy(x))
    assert len(got) == len(TCFG.out_layers)
    for g, w in zip(got, want):
        _close(g, w, TOL)


def test_predict_depth_and_its_input_gradient_match_jax():
    x = _rand(2, (1, 50, 70, 3))
    want = j_predict(JPARAMS, JCFG, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tda.predict_depth(TPARAMS, TCFG, xt)
    assert got.shape == (50, 70) and float(np.std(np.asarray(want))) > 1e-3
    _close(got, want, TOL)
    gwant = j_predict_grad(JPARAMS, jnp.asarray(x))
    (gt,) = torch.autograd.grad(got.mean(), xt)
    _close(gt, gwant, 1e-4)


def _hwio(seed, k, c_in, c_out):
    return np.random.default_rng(seed).standard_normal((k, k, c_in, c_out)).astype(np.float32)


@pytest.mark.parametrize("grid", [6, 7])
@pytest.mark.parametrize("kind", ["convT4", "convT2", "conv_s2"])
def test_reassemble_convs_match_jax(kind, grid):
    """The transposed convs (k = s = 4, 2; the kernel flipped into torch's
    layout) and the stride-2 "SAME" conv (XLA pads (0, 1) on an even side,
    (1, 1) on an odd one) alone."""
    c = 5
    x = _rand(3, (1, grid, grid, c))
    b = _rand(4, (c,))
    if kind == "conv_s2":
        w = _hwio(5, 3, c, c)
        want = jda._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2)
        tw = depth_convert.from_jax_params({"down_w": w})["down_w"]
        got = tda.conv_same(torch.from_numpy(x), tw, torch.from_numpy(b), stride=2)
    else:
        s = int(kind[-1])
        w = _hwio(5, s, c, c)
        want = jda._conv_transpose(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), s)
        tw = depth_convert.from_jax_params({"up_w": w})["up_w"]
        got = tda.conv_transpose_same(torch.from_numpy(x), tw, torch.from_numpy(b), s)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * max(1.0, np.abs(want).max())


def _hf_conv(x, w, b=None, stride=1):
    pad = (w.shape[2] - 1) // 2  # HF's padding=1 for every 3x3, stride 2 included
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=pad).permute(0, 2, 3, 1)


def _hf_conv_t(x, w, b, stride):
    return F.conv_transpose2d(x.permute(0, 3, 1, 2), w.flip(2, 3), b,
                              stride=stride).permute(0, 2, 3, 1)


def hf_orientation(monkeypatch):
    """The port's Depth Anything with HF's orientation: reassemble kernels
    not flipped, and the stride-2 conv padded (1, 1) on every grid."""
    monkeypatch.setattr(tda, "conv_same", _hf_conv)
    monkeypatch.setattr(tda, "conv_transpose_same", _hf_conv_t)


def test_hf_orientation_misses_jax(monkeypatch):
    """Pins the finding about the reference: on the same weights the JAX
    package does not compute HF's Depth Anything (on an even grid)."""
    hf_orientation(monkeypatch)
    x = _rand(2, (1, 50, 70, 3))
    want = np.asarray(j_predict(JPARAMS, JCFG, jnp.asarray(x)))
    got = tda.predict_depth(TPARAMS, TCFG, torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 100 * TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def _hf_state_dict(cfg, seed):
    """Random numpy weights under HF ``DepthAnythingForDepthEstimation``'s
    keys and shapes at ``cfg``, weights of unit gain, LayerScale 1."""
    rng = np.random.default_rng(seed)
    d, f, hh = cfg.width, cfg.fusion, cfg.head_hidden
    sd = {}

    def w(key, *shape, fan_in=None):
        fan = fan_in or int(np.prod(shape[1:]))
        sd[key] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def b(key, n):
        sd[key] = (rng.standard_normal(n) * 0.1).astype(np.float32)

    def ln(prefix, n):
        sd[f"{prefix}.weight"] = (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
        b(f"{prefix}.bias", n)

    emb = "backbone.embeddings"
    w(f"{emb}.patch_embeddings.projection.weight", d, 3, cfg.patch, cfg.patch)
    b(f"{emb}.patch_embeddings.projection.bias", d)
    sd[f"{emb}.cls_token"] = rng.standard_normal((1, 1, d)).astype(np.float32) * 0.1
    sd[f"{emb}.position_embeddings"] = (rng.standard_normal((1, 1 + cfg.pos_grid ** 2, d))
                                        * 0.1).astype(np.float32)
    for i in range(cfg.layers):
        p = f"backbone.encoder.layer.{i}"
        ln(f"{p}.norm1", d)
        ln(f"{p}.norm2", d)
        for n in ("query", "key", "value"):
            w(f"{p}.attention.attention.{n}.weight", d, d)
            b(f"{p}.attention.attention.{n}.bias", d)
        w(f"{p}.attention.output.dense.weight", d, d)
        b(f"{p}.attention.output.dense.bias", d)
        sd[f"{p}.layer_scale1.lambda1"] = np.ones(d, np.float32)
        sd[f"{p}.layer_scale2.lambda1"] = np.ones(d, np.float32)
        w(f"{p}.mlp.fc1.weight", d * cfg.mlp_ratio, d)
        b(f"{p}.mlp.fc1.bias", d * cfg.mlp_ratio)
        w(f"{p}.mlp.fc2.weight", d, d * cfg.mlp_ratio)
        b(f"{p}.mlp.fc2.bias", d)
    ln("backbone.layernorm", d)
    for i, (c, s) in enumerate(zip(cfg.neck_dims, (4, 2, 1, 2))):
        p = f"neck.reassemble_stage.layers.{i}"
        w(f"{p}.projection.weight", c, d, 1, 1)
        b(f"{p}.projection.bias", c)
        if i < 2:
            w(f"{p}.resize.weight", c, c, s, s, fan_in=c * s * s)
            b(f"{p}.resize.bias", c)
        elif i == 3:
            w(f"{p}.resize.weight", c, c, 3, 3)
            b(f"{p}.resize.bias", c)
        w(f"neck.convs.{i}.weight", f, c, 3, 3)
        p = f"neck.fusion_stage.layers.{i}"
        for r in ("residual_layer1", "residual_layer2"):
            for k in ("convolution1", "convolution2"):
                w(f"{p}.{r}.{k}.weight", f, f, 3, 3)
                b(f"{p}.{r}.{k}.bias", f)
        w(f"{p}.projection.weight", f, f, 1, 1)
        b(f"{p}.projection.bias", f)
    for n, (o, i) in enumerate(((hh, f), (hh, hh), (1, hh)), start=1):
        k = 1 if n == 3 else 3
        w(f"head.conv{n}.weight", o, i, k, k)
        b(f"head.conv{n}.bias", o)
    return sd


def _leaves(tree):
    if isinstance(tree, dict):
        return [(f"{k}.{p}", v) for k, sub in sorted(tree.items()) for p, v in _leaves(sub)]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{p}", v) for i, sub in enumerate(tree) for p, v in _leaves(sub)]
    return [("", tree)]


HF_CFG = dict(patch=14, width=32, layers=4, heads=4, mlp_ratio=2, out_layers=(1, 2, 3, 4),
              neck_dims=(8, 16, 32, 32), fusion=16, head_hidden=8, pos_grid=4, input_size=56)


def test_convert_hf_state_dict_matches_jax_leaf_for_leaf():
    sd = _hf_state_dict(tda.DAConfig(**HF_CFG), 0)
    got = _leaves(depth_convert.convert_hf_state_dict(sd, tda.DAConfig(**HF_CFG)))
    want = _leaves(depth_convert.from_jax_params(
        jax.tree.map(np.asarray, jda.convert_hf_state_dict(sd, jda.DAConfig(**HF_CFG)))))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=k)


def test_hf_model_against_the_port_and_jax(monkeypatch):
    """A tiny HF ``DepthAnythingForDepthEstimation`` (grid 4, even) at unit
    gain: the port equals the JAX package on HF's weights, and misses HF by
    over 100x the tolerance; with HF's orientation it equals HF."""
    transformers = pytest.importorskip("transformers")
    cfg = tda.DAConfig(**HF_CFG)
    backbone = transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=4, mlp_ratio=2, patch_size=14,
        image_size=56, out_indices=[1, 2, 3, 4], reshape_hidden_states=False)
    hf = transformers.DepthAnythingForDepthEstimation(transformers.DepthAnythingConfig(
        backbone_config=backbone, patch_size=14, reassemble_hidden_size=32,
        reassemble_factors=[4, 2, 1, 0.5], neck_hidden_sizes=[8, 16, 32, 32],
        fusion_hidden_size=16, head_hidden_size=8)).eval()
    sd = _hf_state_dict(cfg, 1)
    missing, unexpected = hf.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                             strict=False)
    assert not unexpected and all("mask_token" in k for k in missing)
    x = np.random.default_rng(7).standard_normal((1, 56, 56, 3)).astype(np.float32) * 0.5
    with torch.no_grad():
        want_hf = hf(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2))).predicted_depth.numpy()
    jcfg = jda.DAConfig(**HF_CFG)
    want_jax = np.asarray(jax.jit(lambda p, im: jda.depth_head(
        p, jcfg, jda.encode(p, jcfg, im), (4, 4), (56, 56)))(
            jda.convert_hf_state_dict(sd, jcfg), jnp.asarray(x)))
    params = depth_convert.convert_hf_state_dict(sd, cfg)

    def port():
        with torch.no_grad():
            xt = torch.from_numpy(x)
            return tda.depth_head(params, cfg, tda.encode(params, cfg, xt), (4, 4),
                                  (56, 56)).numpy()

    got = port()
    _close(got, want_jax, TOL)
    assert np.abs(got - want_hf).max() > 100 * 1e-4 * np.abs(want_hf).max()
    hf_orientation(monkeypatch)
    _close(port(), want_hf, 1e-4)


def test_init_params_shapes_match_jax_and_are_frozen():
    got = _leaves(tda.init_params(torch.Generator().manual_seed(0), TCFG))
    want = _leaves(depth_convert.from_jax_params(NP_PARAMS))
    assert [(k, tuple(g.shape)) for k, g in got] == [(k, tuple(w.shape)) for k, w in want]
    assert all(not g.requires_grad and g.dtype == torch.float32 for _, g in got)
    n = sum(g.numel() for _, g in _leaves(tda.init_params(torch.Generator().manual_seed(0))))
    assert 24.5e6 < n < 25.1e6  # Depth-Anything-V2-Small


def test_missing_checkpoint_falls_back_and_a_broken_one_raises(tmp_path, monkeypatch):
    depth.default_depth_estimator.cache_clear()
    depth_convert.get_depth_estimator.cache_clear()
    try:
        monkeypatch.setenv("TBIST_DEPTH_PTH", str(tmp_path / "absent.pth"))
        degraded.reset()
        assert depth.default_depth_estimator("cpu") is depth._fallback_depth
        assert degraded.flags_for(["depth_estimator"]) == ["depth_fallback"]
        depth.default_depth_estimator.cache_clear()
        broken = tmp_path / "broken.pth"
        broken.write_bytes(b"not a checkpoint")
        monkeypatch.setenv("TBIST_DEPTH_PTH", str(broken))
        with pytest.raises(Exception) as exc:
            depth.default_depth_estimator("cpu")
        assert not isinstance(exc.value, FileNotFoundError)
    finally:
        depth.default_depth_estimator.cache_clear()
        depth_convert.get_depth_estimator.cache_clear()


# ---------------------------------------------------------------------------
# normalize_depth: ties split the gradient evenly, as in JAX
# ---------------------------------------------------------------------------


def test_normalize_depth_gradient_splits_ties_as_jax():
    d = np.maximum(np.random.default_rng(0).standard_normal((9, 11)), 0.0).astype(np.float32)
    d[2, 3] = d[5, 7] = d[8, 10] = d.max()  # three tied maxima, ~half the map tied at 0
    w = np.random.default_rng(1).standard_normal(d.shape).astype(np.float32)
    want = jax.grad(lambda z: jnp.sum(jmip.normalize_depth(z) * w))(jnp.asarray(d))
    dt = torch.from_numpy(d).requires_grad_(True)
    (got,) = torch.autograd.grad((mip.normalize_depth(dt) * torch.from_numpy(w)).sum(), dt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# depth-loss Gatys
# ---------------------------------------------------------------------------


def _pair(path, max_side=64):
    img = tio.load_image(path)
    return (jio.to_device(img, bucket=32, max_side=max_side),
            tio.to_device(img, bucket=32, max_side=max_side, device="cpu"))


@pytest.mark.parametrize("estimator", ["fallback", "depth_anything"])
def test_depth_loss_gatys_matches_jax(estimator):
    """The golden case (``test_golden.py`` ``depth_loss_6step``: 64px, the
    fallback depth) and 3 steps with the tiny Depth Anything in the graph.

    The fallback's loss histories agree to 1e-6 over 3 steps; from the 4th
    the two f32 trajectories separate (up to 4.7% in one loss value) while
    the images stay within 1.5e-3 of each other: the min-max normalization's
    gradient is a cancelling sum whose f32 rounding (about 1e-4 relative,
    JAX's and the port's alike against f64) L-BFGS without a line search
    amplifies."""
    jc, tc = _pair(BOAT)
    js, ts = _pair(STARRY)
    if estimator == "fallback":
        steps, agree, jfn, tfn = 6, 3, jdepth._fallback_depth, depth._fallback_depth
    else:
        steps = agree = 3
        jfn = functools.partial(jda.predict_depth, JPARAMS, JCFG)
        tfn = functools.partial(tda.predict_depth, TPARAMS, TCFG)
    jm, tm = JRunMetrics(), RunMetrics()
    jout = jgd.stylize_with_depth(jc, js, jconfig.GatysConfig(num_steps=steps, w_style=1e4,
                                                              w_depth=5e4), jfn, VGG_J, jm)
    tout = gatys_depth.stylize_with_depth(tc, ts, GatysConfig(num_steps=steps, w_style=1e4,
                                                              w_depth=5e4), tfn, VGG_T, tm,
                                          device="cpu")
    assert len(tm.loss_history) == steps
    np.testing.assert_allclose(tm.loss_history[:agree], jm.loss_history[:agree], rtol=1e-3)
    if estimator == "fallback":
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=5e-3)
        golden = np.load(os.path.join(ROOT, "tests/golden/depth_loss_6step.npy"))
        err = np.abs(tout[0].numpy() - golden)
        assert err.max() < 5e-2 and err.mean() < 5e-3, (err.max(), err.mean())
    else:
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-3)
        # the depth term is live: without it the steps go elsewhere
        plain = gatys_depth.stylize_with_depth(tc, ts, GatysConfig(num_steps=steps, w_style=1e4),
                                               tfn, VGG_T, device="cpu")
        assert np.abs(plain.numpy() - tout.numpy()).max() > 1e-4


# ---------------------------------------------------------------------------
# MIP
# ---------------------------------------------------------------------------


def _mip_inputs():
    return _rand(3, (1, 32, 32, 3)), _rand(4, (1, 32, 32, 3))


@pytest.mark.parametrize("batched", [False, True])
def test_style_mip_matches_jax(batched, monkeypatch):
    """One step, as ``tests/test_parallel.py`` holds JAX's two plans: past
    it the masked layers' flat regions decide. JAX's jitted normalize
    leaves ±1-ulp noise across a flat region, so its TV gradient there is
    sign noise, which the port (exact zeros, JAX's |x|' = +1 at 0) does
    not reproduce; step 2 then differs by 0.04."""
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")  # JAX's plans without sharding
    img, sty = _mip_inputs()
    jout = jdepth.style_mip(jnp.asarray(img), jnp.asarray(sty), 2,
                            jconfig.GatysConfig(num_steps=1, w_style=1e3, w_edge=0.0),
                            jdepth._fallback_depth, VGG_J, batched=batched)
    tout = depth.style_mip(torch.from_numpy(img), torch.from_numpy(sty), 2,
                           GatysConfig(num_steps=1, w_style=1e3, w_edge=0.0),
                           depth._fallback_depth, VGG_T, batched=batched, device="cpu")
    assert tout.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-3)


def test_style_mip_plans_agree():
    img, sty = (torch.from_numpy(a) for a in _mip_inputs())
    cfg = GatysConfig(num_steps=3, w_style=1e3, w_edge=0.0)
    seq, bat = (depth.style_mip(img, sty, 2, cfg, depth._fallback_depth, VGG_T, batched=b,
                                device="cpu") for b in (False, True))
    np.testing.assert_allclose(bat.numpy(), seq.numpy(), atol=2e-3)


@pytest.mark.parametrize("batched", [False, True])
def test_mip_roundtrip_golden_through_style_mip(batched):
    """With no optimization step each plan returns the layers as they were,
    so ``style_mip`` reconstructs ``test_golden.py``'s ``mip_roundtrip``."""
    _, content = _pair(BOAT)
    out = depth.style_mip(content, content, 3, GatysConfig(num_steps=0),
                          depth._fallback_depth, VGG_T, batched=batched, device="cpu")
    want = np.load(os.path.join(ROOT, "tests/golden/mip_roundtrip.npy"))
    err = np.abs(out[0].numpy() - want)
    assert err.max() < 5e-2 and err.mean() < 5e-3, (err.max(), err.mean())


# ---------------------------------------------------------------------------
# the pipeline's stage 7 and the CLI
# ---------------------------------------------------------------------------


def test_registry_resolves_the_depth_estimator():
    reg = pipeline.ModelRegistry(device="cpu").ensure("depth_estimator")
    assert reg.depth_estimator is depth._fallback_depth  # no checkpoint in the repository
    assert "depth_estimator" in reg.resolved_by_loader
    assert pipeline.needed_components(EffectRequest(depth=DepthConfig())) == [
        "vgg_params", "depth_estimator"]


def test_stage_7_under_a_location_mask_matches_jax(monkeypatch):
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    jc, tc = _pair(BOAT, 32)
    js, ts = _pair(STARRY, 32)
    jreq = jconfig.EffectRequest(text=jconfig.TextEffectConfig(location_prompt="boat"),
                                 depth=jconfig.DepthConfig(),
                                 gatys=jconfig.GatysConfig(num_steps=2))
    treq = EffectRequest(text=TextEffectConfig(location_prompt="boat"), depth=DepthConfig(),
                         gatys=GatysConfig(num_steps=2))
    jreg = jpl.ModelRegistry(vgg_params=VGG_J, mask_extractor=jmasking._fallback_location_mask,
                             depth_estimator=jdepth._fallback_depth)
    treg = pipeline.ModelRegistry(device="cpu", vgg_params=VGG_T,
                                  mask_extractor=masking._fallback_location_mask,
                                  depth_estimator=depth._fallback_depth)
    jout = jpl.apply_image(jc, jreq, jpl.EffectInputs(style_image=js), jreg)
    m = RunMetrics()
    tout = pipeline.apply_image(tc, treq, pipeline.EffectInputs(style_image=ts), treg, m)
    assert tout.shape == tc.shape and len(m.loss_history) == 2
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-3)
    unchanged = float((tout == tc).all(-1).float().mean())  # outside the mask
    assert 0 < unchanged < 1
    assert pipeline.apply_image(tc, treq, None, treg) is None  # no style image


@pytest.mark.parametrize("flags", [["--depth", "depth_loss"],
                                   ["--depth", "mip", "--mip-layers", "2"]])
def test_cli_depth_runs_on_cpu_and_equals_the_pipeline(flags, tmp_path):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    Image.open(BOAT).convert("RGB").resize((48, 40)).save(content)
    Image.open(STARRY).convert("RGB").resize((40, 40)).save(style)
    argv = ["--image", str(content), "--style", str(style), *flags, "--steps", "2",
            "--device", "cpu", "--out", str(tmp_path / "o.png")]
    m = RunMetrics()
    assert cli.main(argv, metrics=m) == 0
    assert "depth_fallback" in m.degraded and len(m.loss_history) == 2
    png = np.asarray(Image.open(tmp_path / "o.png"))
    assert png.shape == (40, 48, 3)
    req = cli.request_from_args(cli.build_parser().parse_args(argv))
    want = api.apply_image(str(content), req, style_image=str(style), device="cpu")
    np.testing.assert_array_equal(png, np.asarray(want))
