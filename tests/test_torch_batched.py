"""The port's batched lanes on the CPU against the JAX package: the lanes'
L-BFGS (``parallel/batched.lbfgs_lanes``, one ``lbfgs.update`` a lane)
against both of JAX's batch formulations, and ``parallel/batched``'s
targets, steps, per-lane style weights, depth term and Adam lanes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.effects import depth as jdepth
from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.ops import mip as jmip
from tbist_tpu.optimize import lbfgs as jlbfgs
from tbist_tpu.parallel import batched as jbatched
from tbist_tpu.utils import config as jconfig
from tbist_tpu_torch.effects import depth
from tbist_tpu_torch.models import vgg19
from tbist_tpu_torch.ops import losses
from tbist_tpu_torch.optimize import gatys, lbfgs
from tbist_tpu_torch.parallel import batched
from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD, GatysConfig
from tbist_tpu_torch.weights.vgg import from_jax_params

VGG_J = jax.jit(jvgg.init_params)(jax.random.key(0))
VGG_T = from_jax_params(jax.tree.map(np.asarray, VGG_J))


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


FRAMES, STYLE, STYLE2 = _rand(1, (2, 32, 32, 3)), _rand(2, (1, 32, 32, 3)), _rand(3, (1, 32, 32, 3))


def _close(got, want, rtol, atol_of_max=0.0):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_of_max * np.abs(want).max())


# ---------------------------------------------------------------------------
# batch-first L-BFGS
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [2, 3])
def test_update_batch_matches_both_jax_formulations(b):
    """The lanes' L-BFGS at B = 2 against JAX's ``update_batch``, at B = 3
    against ``vmap(update)`` (``parallel/batched.py``'s choice); 6 steps
    through a 3-slot ring, with random gradients. Lane 0's gradient repeats
    at step 4 (y = 0), so that lane skips its pair while the others keep
    theirs."""
    shape, m = (4, 5, 3), 3
    rng = np.random.default_rng(b)
    grads = [rng.standard_normal((b, *shape)).astype(np.float32) for _ in range(6)]
    grads[3][0] = grads[2][0]
    if b == 2:
        jstate = jlbfgs.init_batch_state(b, shape, m)

        def jstep(g, s):
            return jlbfgs.update_batch(g, s, lr=0.7)
    else:
        jstate = jax.vmap(lambda _: jlbfgs.init_state(shape, m))(jnp.arange(b))
        jstep = jax.jit(jax.vmap(lambda g, s: jlbfgs.update(g, s, lr=0.7)))
    tstates = [lbfgs.init_state(shape, m) for _ in range(b)]
    for i, g in enumerate(grads):
        rho = [t.rho.clone() for t in tstates]
        jvec, jstate = jstep(jnp.asarray(g), jstate)
        tvec = batched.lbfgs_lanes(torch.from_numpy(g), tstates, lr=0.7)
        _close(tvec, jvec, 1e-5, 1e-5)
        if i == 3:  # the slot of step 4: lane 0 kept its old pair, lane 1 took its new one
            assert torch.equal(tstates[0].rho, rho[0]) and not torch.equal(tstates[1].rho, rho[1])
    _close(torch.stack([t.gamma for t in tstates]), jstate.gamma, 1e-5)
    _close(torch.stack([t.rho for t in tstates]), jstate.rho, 1e-5)
    assert all(t.step == 6 for t in tstates)


def test_update_batch_lane_equals_update():
    """One lane of the lanes' L-BFGS is ``update`` on that lane alone, bit
    for bit: the other lane's state and gradient do not reach it."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((2, 6, 7, 3)).astype(np.float32) for _ in range(5)]
    bstates = [lbfgs.init_state((6, 7, 3), 4) for _ in range(2)]
    sstate = lbfgs.init_state((6, 7, 3), 4)
    for g in grads:
        bvec = batched.lbfgs_lanes(torch.from_numpy(g), bstates, lr=1.0)
        svec, sstate = lbfgs.update(torch.from_numpy(g[1]), sstate)
        assert torch.equal(bvec[1], svec)


# ---------------------------------------------------------------------------
# the lanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_styles", [1, 2])
def test_init_batch_matches_jax(n_styles):
    styles = [STYLE, STYLE2][:n_styles]
    jcfg, tcfg = jconfig.GatysConfig(style_img_weight=0.3), GatysConfig(style_img_weight=0.3)
    _, jcf, jtg, jsg = jbatched.init_batch(jcfg, VGG_J, jnp.asarray(FRAMES),
                                           tuple(jnp.asarray(s) for s in styles))
    state, tcf, ttg, tsg = batched.init_batch(tcfg, VGG_T, torch.from_numpy(FRAMES),
                                              [torch.from_numpy(s) for s in styles], device="cpu")
    for layer in tcfg.style_layers:
        _close(tsg[layer], jsg[layer], 1e-5, 1e-6)
    for layer in tcf:  # JAX's vmap keeps each frame's own batch axis of 1
        _close(tcf[layer], np.asarray(jcf[layer])[:, 0], 1e-5, 1e-5)
    _close(ttg, np.asarray(jtg)[:, 0], 1e-5, 1e-6)
    assert state.step == 0 and torch.equal(state.images, torch.from_numpy(FRAMES))


def test_lane_gram_is_each_lanes_gram():
    feats = torch.from_numpy(_rand(4, (3, 8, 6, 5)))
    got = gatys.lane_gram(feats)
    for i in range(3):
        torch.testing.assert_close(got[i], losses.gram_matrix(feats[i:i + 1])[0])


def test_depth_targets_match_jax():
    want = jax.vmap(lambda f: jmip.normalize_depth(jdepth._fallback_depth(f[None])))(
        jnp.asarray(FRAMES))
    got = batched.depth_targets(depth._fallback_depth, torch.from_numpy(FRAMES))
    assert got.shape == (2, 32, 32)
    _close(got, want, 0, 1e-5)  # the blurs agree to a few ulp, normalized to [0, 1]


@pytest.mark.parametrize("case", ["w_style", "depth", "adam"])
def test_run_matches_jax(case):
    """Two steps of two lanes with their losses: per-lane style weights
    (MIP's plan), the depth term against each frame's own target, Adam."""
    kw = dict(num_steps=2, w_style=1e3)
    w_style = depth_fn = jdepth_fn = None
    if case == "w_style":
        w_style = [1e3, 5e3]
    elif case == "depth":
        kw["w_depth"] = 5e4
        depth_fn, jdepth_fn = depth._fallback_depth, jdepth._fallback_depth
    else:
        kw["optimizer"] = "adam"
    jout, jhist = jbatched.run(jconfig.GatysConfig(**kw), VGG_J, jnp.asarray(FRAMES),
                               (jnp.asarray(STYLE),),
                               w_style=None if w_style is None else jnp.asarray(w_style),
                               return_history=True, depth_fn=jdepth_fn)
    tout, thist = batched.run(GatysConfig(**kw), VGG_T, torch.from_numpy(FRAMES),
                              [torch.from_numpy(STYLE)], w_style=w_style, return_history=True,
                              depth_fn=depth_fn, device="cpu")
    assert thist.shape == (2, 2) and tout.shape == (2, 32, 32, 3)
    _close(thist, jhist, 1e-4)
    _close(tout, jout, 0, 1e-3)


def test_per_lane_style_weights_equal_separate_runs():
    """``tests/test_parallel.py``'s check: one run with a (B,) style weight
    equals a run of each lane alone with its weight (3 steps). Its 2e-4
    becomes 5e-4: on the CPU, oneDNN convolves a batch of 2 in another
    order than a batch of 1 (conv3_1 differs by 3e-6), and after 3 L-BFGS
    steps two of 3072 values differ by 2.8e-4."""
    base = GatysConfig(num_steps=3, w_style=1e3)
    frames, style = torch.from_numpy(FRAMES), [torch.from_numpy(STYLE)]
    mixed = batched.run(base, VGG_T, frames, style, w_style=[1e3, 5e3], device="cpu")
    for i, w in enumerate((1e3, 5e3)):
        single = batched.run(dataclasses.replace(base, w_style=w), VGG_T, frames[i:i + 1], style,
                             device="cpu")
        np.testing.assert_allclose(mixed[i].numpy(), single[0].numpy(), atol=5e-4)


def test_train_step_losses_are_each_lanes_objective():
    """A lane's loss is the single-image objective: the content and style
    terms of ``ops.losses`` on that lane alone, and each lane's gradient
    ignores the other lanes."""
    cfg = GatysConfig(w_style=1e3, w_tv=0.0, w_edge=0.0)
    frames = torch.from_numpy(FRAMES)
    state, cf, tg, sg = batched.init_batch(cfg, VGG_T, frames, [torch.from_numpy(STYLE)],
                                           device="cpu")
    _, values = batched.train_step(cfg, VGG_T, state, cf, tg, sg)

    for i in range(2):
        feats = vgg19.extract_features(VGG_T, losses.normalize(frames[i:i + 1], VGG_MEAN, VGG_STD),
                                       cfg.content_layers + cfg.style_layers)
        want = (cfg.w_content * losses.content_loss(feats, {k: v[i:i + 1] for k, v in cf.items()},
                                                    cfg.content_layers)
                + cfg.w_style * losses.style_loss_from_targets(feats, sg, cfg.style_layers))
        torch.testing.assert_close(values[i], want, rtol=1e-5, atol=0)
