"""The port's resumable Gatys (``optimize/checkpoint``) on the CPU: against
the JAX package's ``stylize_resumable``, the behaviours
``tests/test_aux.py`` checks for it, and the files it writes."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.optimize import checkpoint as jckpt
from tbist_tpu.utils import imageio as jio
from tbist_tpu_torch.optimize import checkpoint as ckpt
from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.utils import imageio as tio
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.utils.logging import RunMetrics
from tbist_tpu_torch.weights.vgg import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vgg_params():
    """He-init VGG-19 weights drawn with numpy in the JAX package's tree
    (traced for its shapes only), shared by both packages."""
    rng = np.random.default_rng(0)

    def leaf(a):
        if len(a.shape) < 4:
            return np.zeros(a.shape, np.float32)
        fan_in = a.shape[0] * a.shape[1] * a.shape[2]
        return (rng.standard_normal(a.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    jparams = jax.tree.map(leaf, jax.eval_shape(jvgg.init_params, jax.random.key(0)))
    return jparams, from_jax_params(jparams)


JPARAMS, PARAMS = _vgg_params()
# boat x starry_night at 32px (on random pixels L-BFGS without a line search
# amplifies float noise between the packages within a few steps)
CONTENT_NP, STYLE_NP = (
    np.array(jio.to_device(tio.load_image(os.path.join(ROOT, p)), bucket=32, max_side=32))
    for p in ("data/content_imgs/boat.jpg", "data/style_imgs/starry_night.jpg"))
CONTENT, STYLE = torch.from_numpy(CONTENT_NP), torch.from_numpy(STYLE_NP)


def _run(cfg, path, segment_steps, metrics=None):
    return ckpt.stylize_resumable(CONTENT, [STYLE], cfg, PARAMS, str(path), segment_steps,
                                  device="cpu", metrics=metrics)


def test_matches_jax_in_segments(tmp_path):
    cfg = GatysConfig(num_steps=6, w_style=1e3)
    from tbist_tpu.utils.config import GatysConfig as JGatysConfig

    jout, jhist = jckpt.stylize_resumable(
        jnp.asarray(CONTENT_NP), [jnp.asarray(STYLE_NP)], JGatysConfig(num_steps=6, w_style=1e3),
        JPARAMS, str(tmp_path / "jax"), segment_steps=3)
    out, hist = _run(cfg, tmp_path / "port", 3)
    assert len(hist) == len(jhist) == 6
    np.testing.assert_allclose(hist, jhist, rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-2)
    assert sorted(os.listdir(tmp_path / "port")) == ["step_3", "step_6"]
    # the L-BFGS history restarts at each segment: not one unsegmented run
    _, whole = gatys.stylize(CONTENT, [STYLE], cfg, PARAMS, device="cpu")
    np.testing.assert_allclose(hist[:3], whole[:3].numpy(), rtol=1e-6)
    assert not np.allclose(hist[3:], whole[3:].numpy(), rtol=1e-6)


def test_segments_resume_and_complete(tmp_path):
    cfg = GatysConfig(num_steps=6, w_style=1e3)
    metrics = RunMetrics()
    out1, hist1 = _run(cfg, tmp_path / "run", 3, metrics)
    assert len(hist1) == 6 and ckpt.latest_step(str(tmp_path / "run")) == 6
    assert metrics.extra == {"resumed_at_step": 0, "segments": 2}
    # re-invoking a finished run restores and does no extra work
    metrics = RunMetrics()
    out2, hist2 = _run(cfg, tmp_path / "run", 3, metrics)
    assert hist2 == [] and metrics.extra == {"resumed_at_step": 6, "segments": 0}
    torch.testing.assert_close(out1, out2, rtol=0, atol=1e-6)


def test_partial_then_resume(tmp_path):
    _run(GatysConfig(num_steps=2, w_style=1e3), tmp_path / "run", 2)
    assert ckpt.latest_step(str(tmp_path / "run")) == 2
    saved = ckpt.load_state(str(tmp_path / "run"), 2)["pixels"]
    _, hist = _run(GatysConfig(num_steps=4, w_style=1e3), tmp_path / "run", 2)
    assert len(hist) == 2  # only the remaining segment ran
    assert ckpt.latest_step(str(tmp_path / "run")) == 4
    # it started from the saved pixels, with the original targets
    _, want = gatys.stylize(CONTENT, [STYLE], GatysConfig(num_steps=2, w_style=1e3), PARAMS,
                            init=saved, device="cpu")
    np.testing.assert_allclose(hist, want.numpy(), rtol=1e-6)


@pytest.mark.parametrize("num_steps,segment_steps", [(5, 3), (1, 4)])
def test_no_overshoot_on_uneven_segments(tmp_path, num_steps, segment_steps):
    _, hist = _run(GatysConfig(num_steps=num_steps, w_style=1e3), tmp_path / "run",
                   segment_steps)
    assert len(hist) == num_steps
    assert ckpt.latest_step(str(tmp_path / "run")) == num_steps


def test_random_init_honored_on_fresh_start(tmp_path):
    cfg = GatysConfig(num_steps=2, w_style=1e3, random_init=True)
    direct, _ = gatys.stylize(CONTENT, [STYLE], cfg, PARAMS, device="cpu")
    seg, _ = _run(cfg, tmp_path / "run", 2)
    torch.testing.assert_close(direct, seg, rtol=0, atol=1e-6)
    plain, _ = gatys.stylize(CONTENT, [STYLE], dataclasses.replace(cfg, random_init=False),
                             PARAMS, device="cpu")
    assert not torch.allclose(plain, seg, atol=1e-3)


def test_state_files(tmp_path):
    path = str(tmp_path / "d")
    assert ckpt.latest_step(path) is None
    pix = torch.rand((1, 4, 4, 3))
    ckpt.save_state(path, pix, None, 7)
    ckpt.save_state(path, pix * 0.5, {"k": 1}, 7)  # replaces the step's file
    ckpt.save_state(path, pix, None, 12)
    open(os.path.join(path, "step_x"), "w").close()  # not a step
    assert sorted(os.listdir(path)) == ["step_12", "step_7", "step_x"]  # no temporary left
    assert ckpt.latest_step(path) == 12
    state = ckpt.load_state(path, 7)
    torch.testing.assert_close(state["pixels"], pix * 0.5)
    assert state["step"] == 7 and state["opt_state"] == {"k": 1}
