"""The port's device mesh (``tbist_tpu_torch.parallel.mesh``) on the CPU
against the JAX package's on the 8 CPU devices of ``tests/conftest.py``.

The port's production mesh is None on the CPU, so each test that shards
lays a mesh of ``cpu`` entries out by patching ``production_mesh``: the
same decomposition (width plans, halos, sums in shard order, lane splits,
threads a dp row) as over cards. Inputs are numpy draws from seeds; the
weights are shared through the converters. The ``gpu`` cases at the end
need two cards and skip inside the test where there are fewer."""

import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tbist_tpu.compose import pipeline as jpipe
from tbist_tpu.effects import depth as jdepth
from tbist_tpu.effects import style as jstyle
from tbist_tpu.effects import text_transfer as jtt
from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.parallel import batched as jbatched
from tbist_tpu.parallel import mesh as jmesh
from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils.logging import RunMetrics as JMetrics
from tbist_tpu.video import video as jvid
from tbist_tpu.weights import ghiasi_convert as jgc
from tbist_tpu_torch.compose import pipeline as tpipe
from tbist_tpu_torch.effects import depth as tdepth
from tbist_tpu_torch.effects import style as tstyle
from tbist_tpu_torch.effects import text_transfer as tt
from tbist_tpu_torch.kernels import _build
from tbist_tpu_torch.models import ghiasi, vgg19
from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.parallel import batched, mesh
from tbist_tpu_torch.utils import config as tconfig
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.utils.logging import RunMetrics
from tbist_tpu_torch.video import video as tvid
from tbist_tpu_torch.weights import ghiasi_convert
from tbist_tpu_torch.weights.vgg import from_jax_params

JPARAMS = jvgg.init_params(jax.random.key(0))
TPARAMS = from_jax_params(jax.tree.map(np.asarray, JPARAMS))


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.fixture
def cpu_mesh(monkeypatch):
    """Patch the port's production mesh to ``n`` cpu entries (honouring
    TBIST_DISABLE_MESH as the real one does); returns the layouts asked for."""
    asked = []

    def install(n=8):
        def fake(device="cuda", dp_only=False, sp_only=False):
            asked.append("dp" if dp_only else "sp" if sp_only else "both")
            if os.environ.get("TBIST_DISABLE_MESH") == "1":
                return None
            devs = ["cpu"] * n
            if dp_only:
                return mesh.make_mesh(devs, dp=n, sp=1)
            if sp_only:
                return mesh.make_mesh(devs, dp=1, sp=n)
            return mesh.make_mesh(devs)

        monkeypatch.setattr(mesh, "production_mesh", fake)
        return asked

    return install


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setenv("TBIST_GHIASI_BF16", "0")


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_factor_and_make_mesh_match_jax():
    for n in range(1, 17):
        assert mesh._factor(n) == jmesh._factor(n)
    m = mesh.make_mesh(["cpu"] * 8)
    jm = jmesh.make_mesh(8)
    assert m.shape == dict(jm.shape) and m.size == 8
    assert mesh.make_mesh(["cpu"] * 8, dp=8, sp=1).shape == {"dp": 8, "sp": 1}
    with pytest.raises(ValueError):
        mesh.make_mesh(["cpu"] * 6, dp=4, sp=2)


@pytest.mark.parametrize("w, parts, align, min_width, want", [
    (64, 4, 16, 0, ((0, 16), (16, 32), (32, 48), (48, 64))),
    (512, 4, 16, 0, ((0, 128), (128, 256), (256, 384), (384, 512))),
    (80, 3, 16, 0, ((0, 32), (32, 64), (64, 80))),  # unequal: 2, 2, 1 blocks
    (88, 4, 16, 0, ((0, 32), (32, 48), (48, 64), (64, 88))),  # the 8 extra columns go last
    (64, 8, 16, 0, ((0, 16), (16, 32), (32, 48), (48, 64))),  # 4 blocks: 4 shards, not 8
    (12, 4, 16, 0, ((0, 12),)),  # no whole block: one shard
    (64, 8, 4, 8, tuple((i, i + 8) for i in range(0, 64, 8))),  # Ghiasi: 2 blocks a shard
    (1030, 4, 4, 8, ((0, 260), (260, 516), (516, 772), (772, 1030))),
])
def test_width_plan(w, parts, align, min_width, want):
    plan = mesh.width_plan(w, parts, align, min_width)
    assert plan == want
    assert plan[0][0] == 0 and plan[-1][1] == w
    assert all(a % align == 0 for a, _ in plan)
    assert all(b == a2 for (_, b), (a2, _) in zip(plan, plan[1:]))
    assert (mesh.width_sharding(w, ["cpu"] * parts, align, min_width) is None) == (len(plan) == 1)


def test_split_lanes_and_pad_to_multiple():
    assert mesh.split_lanes(5, 2) == [(0, 3), (3, 5)]
    assert mesh.split_lanes(5, 8) == [(i, i + 1) for i in range(5)]
    x = torch.arange(6.0).reshape(3, 2)
    got, pad = mesh.pad_to_multiple(x, 4)
    want, jpad = jmesh.pad_to_multiple(jnp.asarray(x.numpy()), 4)
    assert pad == jpad == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("edge, k", [("zeros", 1), ("reflect", 1), ("reflect", 4)])
def test_halo_conv_and_gradient_match_unsharded(edge, k):
    """A (2k+1)² conv over 4 unequal width shards with halos against the
    conv of the whole image padded the same way: output and input gradient."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((2, 3, 10, 40))).double()
    w = torch.from_numpy(rng.standard_normal((5, 3, 2 * k + 1, 2 * k + 1))).double()
    g = torch.from_numpy(rng.standard_normal((2, 5, 10, 40))).double()

    def pad_h(t):
        return F.pad(t, (0, 0, k, k), mode="reflect" if edge == "reflect" else "constant")

    xa = x.clone().requires_grad_(True)
    whole = F.conv2d(F.pad(xa, (k, k, k, k), mode="reflect" if edge == "reflect" else "constant"),
                     w)
    (whole * g).sum().backward()
    xb = x.clone().requires_grad_(True)
    plan = ((0, 8), (8, 24), (24, 32), (32, 40))
    shards = mesh.scatter_width(xb, plan, ["cpu"] * 4, 3)
    outs = [F.conv2d(pad_h(s), w) for s in mesh.halo(shards, k, dim=3, edge=edge)]
    assert [o.shape[3] for o in outs] == [b - a for a, b in plan]
    got = mesh.gather_width(outs, "cpu", 3)
    (got * g).sum().backward()
    torch.testing.assert_close(got, whole, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(xb.grad, xa.grad, rtol=1e-12, atol=1e-12)


def test_production_mesh_cards_and_disable_flag(monkeypatch):
    """The real ``production_mesh``: None for a CPU caller, below two cards
    and under TBIST_DISABLE_MESH=1, as JAX's; otherwise every card, the
    caller's first, in the asked layout."""
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    assert jmesh.production_mesh() is None
    monkeypatch.delenv("TBIST_DISABLE_MESH")
    assert jmesh.production_mesh().devices.size == 8
    assert mesh.production_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh.production_mesh("cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    m = mesh.production_mesh("cuda")
    assert m.shape == {"dp": 1, "sp": 4} and m.devices[0][0] == torch.device("cuda", 0)
    assert mesh.production_mesh("cuda", dp_only=True).shape == {"dp": 4, "sp": 1}
    m = mesh.production_mesh("cuda:2", sp_only=True)
    assert [d.index for d in m.devices[0]] == [2, 3, 0, 1]
    assert mesh.production_mesh("cpu") is None
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    assert mesh.production_mesh("cuda") is None
    monkeypatch.setenv("TBIST_DISABLE_MESH", "0")
    assert mesh.production_mesh("cuda") is not None


def test_replicated_keeps_one_copy_a_device():
    calls = []
    fn = mesh.Replicated(lambda p, x, k=0: calls.append(p) or p["w"] * torch.as_tensor(x) + k,
                         {"w": torch.ones(2)})
    assert torch.equal(fn(torch.full((2,), 3.0), k=1), torch.full((2,), 4.0))
    fn(np.ones(2))  # a host input runs where the params were given
    assert calls[0] is calls[1] and fn.on("cpu") is calls[0]


def test_replicas_key_a_bare_cuda_device_by_its_index(monkeypatch):
    """``on("cuda")`` is the current card's entry: a tree that lies on
    ``cuda`` (as ``resolve_device`` gives it) is home on ``cuda:0`` and is
    not copied again for either name (a copy would raise here, where torch
    has no CUDA)."""
    tree = {"w": torch.ones(2)}
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(mesh, "tree_device", lambda t: torch.device("cuda"))
    reps = mesh.Replicas(tree)
    assert reps.home == torch.device("cuda", 0)
    assert reps.on("cuda") is tree and reps.on(torch.device("cuda", 0)) is tree


def test_replicas_of_shares_one_replicas_a_tree():
    """Every caller of the same tree gets the same ``Replicas`` (so one copy
    a card); another tree its own; a ``Replicas`` passes through."""
    a, b = {"w": torch.ones(2)}, {"w": torch.ones(2)}
    ra = mesh.replicas_of(a)
    assert mesh.replicas_of(a) is ra and mesh.replicas_of(ra) is ra
    assert mesh.replicas_of(b) is not ra and ra.on("cpu") is a


def test_launch_counts_under_threads():
    """``count_launch`` loses no update with more threads than cores and a
    short switch interval (the backward engine's threads count at once)."""
    class Wrapper:
        launches = 0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(Wrapper)
                                                    for _ in range(2000)])
                   for _ in range(min(2 * len(os.sched_getaffinity(0)) + 2, 34))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert Wrapper.launches == 2000 * len(threads)


# ---------------------------------------------------------------------------
# sp Gatys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [64, 88])
def test_sharded_loss_and_gradient_match_unsharded(width):
    """One Gatys loss-and-gradient evaluation with VGG-19's trunk over 4 (and
    4 unequal) width shards against the unsharded one: rtol 1e-5 on the
    loss, 1e-4 relative L2 on the gradient; each shard's 13 trunk input
    gradients, padding (1, 0), are ``TrunkConv``'s."""
    cfg = GatysConfig(w_style=1e3)
    content, style = torch.from_numpy(_rand(1, (1, 32, width, 3))), torch.from_numpy(
        _rand(2, (1, 32, 32, 3)))
    img = torch.from_numpy(_rand(3, (1, 32, width, 3)))
    sharding = mesh.width_sharding(width, ["cpu"] * 4, mesh.VGG_ALIGN)
    assert len(sharding.plan) == 4
    vals, grads = [], []
    for sh in (None, sharding):
        _, cf, tg, sg = batched.init_batch(cfg, TPARAMS, content, [style], "cpu", sh)
        x = img.clone().requires_grad_(True)
        vgg19.reset_dgrad_counts()
        if sh is None:
            loss = gatys.lane_losses(cfg, TPARAMS, x, cf, tg, sg, cfg.w_style)
        else:
            assert [f.shape[2] for f in cf["conv4_2"]] == [(b - a) // 8 for a, b in sh.plan]
            loss = gatys.lane_losses_sharded(cfg, batched.shard_params(TPARAMS, sh, torch.float32),
                                             x, cf, tg, sg, cfg.w_style, sh)
        (g,) = torch.autograd.grad(loss.sum(), x)
        assert sum(vgg19.dgrad_counts().values()) == 13 * (1 if sh is None else len(sh.plan))
        vals.append(loss.detach())
        grads.append(g)
    torch.testing.assert_close(vals[1], vals[0], rtol=1e-5, atol=0)
    assert float(torch.linalg.norm(grads[1] - grads[0]) / torch.linalg.norm(grads[0])) < 1e-4


def _spy_run(monkeypatch, seen):
    real = batched.run

    def spy(cfg, vp, frames, styles, *a, **kw):
        seen.append(kw.get("mesh"))
        return real(cfg, vp, frames, styles, *a, **kw)

    monkeypatch.setattr(batched, "run", spy)


@pytest.mark.parametrize("mixing", [False, True])
def test_sp_gatys_history_matches_jax_sharded(monkeypatch, cpu_mesh, mixing):
    """Single-image Gatys and two-style mixing, width sharded (the port: 4
    shards of 16 columns over an 8-entry sp mesh; JAX: GSPMD over its 8
    devices), at ``tests/test_parallel.py:449-492``'s sizes: the loss
    histories agree at JAX's rtol 1e-2. (Pixels are no invariant across
    differently partitioned L-BFGS runs, as JAX's test says.)"""
    asked = cpu_mesh()
    monkeypatch.setenv("TBIST_GATYS_SP_MIN_WIDTH", "64")
    content = _rand(1, (1, 32, 64, 3))
    styles = [_rand(2, (1, 32, 32, 3))] + ([_rand(3, (1, 32, 32, 3))] if mixing else [])
    kw = dict(num_steps=2, optimizer="lbfgs", max_side=64, style_img_weight=0.3)
    seen = []
    _spy_run(monkeypatch, seen)
    jm, tm = JMetrics(), RunMetrics()
    jout = jstyle.style_transfer(jnp.asarray(content), [jnp.asarray(s) for s in styles],
                                 jconfig.GatysConfig(**kw), JPARAMS, metrics=jm)
    tout = tstyle.style_transfer(torch.from_numpy(content), [torch.from_numpy(s) for s in styles],
                                 GatysConfig(**kw), TPARAMS, metrics=tm, device="cpu")
    assert asked == ["sp"] and seen[0].shape == {"dp": 1, "sp": 8}
    assert len(tm.loss_history) == 2
    np.testing.assert_allclose(tm.loss_history, jm.loss_history, rtol=1e-2)
    assert tout.shape == jout.shape


def test_sp_gates_fall_back_to_the_per_image_program(monkeypatch, cpu_mesh):
    """JAX's gates, case for case (``tests/test_parallel.py:494-517`` and
    ``tbist_tpu/effects/style.py:48-70``): channel attention, a random
    start, a batch of two, a width below the threshold and a width that does
    not divide by sp stay on ``optimize.gatys``; each case is checked against
    JAX's own gate."""
    cpu_mesh()
    monkeypatch.setenv("TBIST_GATYS_SP_MIN_WIDTH", "64")
    seen = []
    _spy_run(monkeypatch, seen)
    style = torch.from_numpy(_rand(2, (1, 32, 32, 3)))
    base = dict(num_steps=1, max_side=128)
    # (1, 32, 40) buckets to 32 columns, below the threshold; every bucket
    # divides by 8, so the width % sp gate is held on the gate itself
    cases = [((1, 32, 64), dict(channel_attention=True)), ((1, 32, 64), dict(random_init=True)),
             ((2, 32, 64), {}), ((1, 32, 40), {})]
    uneven = torch.from_numpy(_rand(1, (1, 32, 68, 3)))
    assert tstyle._sp_mesh(uneven, GatysConfig(**base), "cpu") is None
    assert jstyle._sp_mesh(jnp.asarray(uneven.numpy()), jconfig.GatysConfig(**base)) is None
    assert tstyle._sp_mesh(uneven[..., :64, :], GatysConfig(**base), "cpu") is not None
    for (b, h, w), extra in cases:
        content = torch.from_numpy(_rand(1, (b, h, w, 3)))
        cfg = GatysConfig(**base, **extra)
        assert jstyle._sp_mesh(jnp.asarray(content.numpy()), jconfig.GatysConfig(**base, **extra)
                               ) is None
        out = tstyle.style_transfer(content, [style], cfg, TPARAMS, device="cpu")
        assert seen == [] and out.shape == content.shape, ((b, h, w), extra)
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    tstyle.style_transfer(torch.from_numpy(_rand(1, (1, 32, 64, 3))), [style],
                          GatysConfig(**base), TPARAMS, device="cpu")
    assert seen == []


# ---------------------------------------------------------------------------
# sp Ghiasi and the dp fast-text batch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ghiasi_params():
    g, m = jgc.get_params()
    jp = (jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, m))
    return jp, ghiasi_convert.from_jax_params(*jp)


def test_sp_ghiasi_within_one_level_of_jax(monkeypatch, cpu_mesh, ghiasi_params, f32):
    """``perform_transfer`` on a 64-wide image: the port over 8 shards of 8
    columns, JAX over its 8-device sp mesh; f32, within one uint8 level. The
    gates (below the threshold, width not a multiple of sp, ``use_mesh``)
    keep the unsharded forward, as JAX's."""
    cpu_mesh()
    (jg, jm), (g, m) = ghiasi_params
    monkeypatch.setenv("TBIST_SP_MIN_WIDTH", "64")
    calls = []
    real = ghiasi.apply_sharded
    monkeypatch.setattr(ghiasi, "apply_sharded",
                        lambda p, shards, *a, **k: calls.append(len(shards)) or real(p, shards,
                                                                                    *a, **k))
    img = _rand(3, (1, 64, 64, 3))
    kw = dict(text_encoder=tt.fallback_text_embedding)
    got = tt.perform_transfer(torch.from_numpy(img), "mosaic", g, m, **kw).numpy()
    assert calls == [8]
    want = np.asarray(jtt.perform_transfer(jnp.asarray(img), "mosaic", jg, jm,
                                           text_encoder=jtt.fallback_text_embedding))
    assert np.abs(np.round(got * 255) - np.round(want * 255)).max() <= 1
    one = tt.perform_transfer(torch.from_numpy(img), "mosaic", g, m, use_mesh=False, **kw)
    assert calls == [8] and np.abs(np.round(got * 255) - np.round(one.numpy() * 255)).max() <= 1
    for shape, thresh in (((1, 64, 64, 3), "128"), ((1, 64, 68, 3), "64")):
        monkeypatch.setenv("TBIST_SP_MIN_WIDTH", thresh)
        out = tt.perform_transfer(torch.from_numpy(_rand(4, shape)), "mosaic", g, m, **kw)
        assert calls == [8] and out.shape == shape


def test_sp_ghiasi_bf16_within_the_cpu_bf16_bounds(monkeypatch, cpu_mesh, ghiasi_params):
    """bf16 activations over 8 shards against the unsharded bf16 forward,
    within the bounds the CPU's bf16 keeps against f32
    (``tests/test_torch_text.py``): a conv's output one bf16 step apart on
    one shard moves the seeded network's output at this size."""
    cpu_mesh()
    monkeypatch.setenv("TBIST_SP_MIN_WIDTH", "64")
    _, (g, m) = ghiasi_params
    img = torch.from_numpy(_rand(5, (1, 64, 64, 3)))
    kw = dict(text_encoder=tt.fallback_text_embedding)
    err = (tt.perform_transfer(img, "mosaic", g, m, **kw)
           - tt.perform_transfer(img, "mosaic", g, m, use_mesh=False, **kw)).abs()
    assert err.max() < 0.05 and err.mean() < 0.005


def test_dp_text_batch_matches_jax_mesh(monkeypatch, cpu_mesh, ghiasi_params, f32):
    """``perform_transfer_batch`` of 3 images: padded to 4, then to 8 for dp
    8, one row a card, gathered in order; against JAX's dp run (atol 2e-4)
    and the port without a mesh (atol 1e-5, ``tests/test_batching.py:54``)."""
    cpu_mesh()
    (jg, jm), (g, m) = ghiasi_params
    rows = []
    real = tt._transfer
    monkeypatch.setattr(tt, "_transfer", lambda gp, mp, x, e: rows.append(x.shape[0])
                        or real(gp, mp, x, e))
    imgs = _rand(8, (3, 24, 24, 3))
    prompts = ["x", "y", "z"]
    got = tt.perform_transfer_batch(torch.from_numpy(imgs), prompts, g, m,
                                    text_encoder=tt.fallback_text_embedding).numpy()
    assert rows == [1] * 8 and got.shape == (3, 24, 24, 3)
    want = np.asarray(jtt.perform_transfer_batch(jnp.asarray(imgs), prompts, jg, jm,
                                                 text_encoder=jtt.fallback_text_embedding))
    np.testing.assert_allclose(got, want, atol=2e-4)
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    one = tt.perform_transfer_batch(torch.from_numpy(imgs), prompts, g, m,
                                    text_encoder=tt.fallback_text_embedding).numpy()
    assert rows[-1] == 4
    np.testing.assert_allclose(got, one, atol=1e-5)


# ---------------------------------------------------------------------------
# dp lanes: batched.run and MIP
# ---------------------------------------------------------------------------


def test_dp_lanes_match_jax_mesh():
    """4 frames over JAX's 4-device dp mesh against the port's lanes split
    over 3 dp rows (2, 1, 1) and over a 2x2 mesh (each row's lanes sharded
    2-way in width), 2 steps: the outputs at JAX's atol 2e-4
    (``tests/test_parallel.py:41-67``), the histories at rtol 1e-4 (as
    ``tests/test_torch_batched.py`` holds the unsharded lanes). At 3 steps
    the port's lanes and JAX's part by 0.1 with or without a mesh: L-BFGS
    with no line search amplifies the two frameworks' last bits."""
    cfg = dict(num_steps=2, w_style=1e3)
    frames, style = _rand(1, (4, 32, 32, 3)), _rand(2, (1, 32, 32, 3))
    jm = jmesh.make_mesh(4, dp=4, sp=1)
    jframes = jax.device_put(jnp.asarray(frames), jmesh.batch_sharding(jm))
    want, jhist = jbatched.run(jconfig.GatysConfig(**cfg), JPARAMS, jframes,
                               (jnp.asarray(style),), return_history=True)
    for m in (mesh.make_mesh(["cpu"] * 3, dp=3, sp=1), mesh.make_mesh(["cpu"] * 4, dp=2, sp=2)):
        got, hist = batched.run(GatysConfig(**cfg), TPARAMS, torch.from_numpy(frames),
                                [torch.from_numpy(style)], return_history=True, device="cpu",
                                mesh=m)
        assert hist.shape == (2, 4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
        np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-4)


def test_mip_takes_the_batched_plan_on_a_mesh(monkeypatch, cpu_mesh):
    """``style_mip(batched=None)``: the batched plan with the layers over dp
    exactly when a production mesh exists (JAX ``effects/depth.py:111-113``),
    one step against JAX's mesh run at its atol 2e-3."""
    asked = cpu_mesh()
    seen = []
    _spy_run(monkeypatch, seen)
    img, style = _rand(3, (1, 32, 32, 3)), _rand(4, (1, 32, 32, 3))
    kw = dict(num_steps=1, w_style=1e3, w_edge=0.0)
    got = tdepth.style_mip(torch.from_numpy(img), torch.from_numpy(style), 3, GatysConfig(**kw),
                           tdepth._fallback_depth, TPARAMS, device="cpu")
    assert asked == ["dp"] and len(seen) == 1 and seen[0].shape == {"dp": 8, "sp": 1}
    want = np.asarray(jdepth.style_mip(jnp.asarray(img), jnp.asarray(style), 3,
                                       jconfig.GatysConfig(**kw), jdepth._fallback_depth,
                                       JPARAMS))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    tdepth.style_mip(torch.from_numpy(img), torch.from_numpy(style), 3, GatysConfig(**kw),
                     tdepth._fallback_depth, TPARAMS, device="cpu")
    assert len(seen) == 1  # the sequential plan: no batched run


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame_batch, dp", [(9, 8), (2, 8), (8, 1), (8, 3), (1, 4), (0, 1)])
def test_chunk_size_matches_jax(frame_batch, dp):
    assert tvid._chunk_size(frame_batch, dp) == jvid._chunk_size(frame_batch, dp)


def _video(tmp_path, n, size=(48, 32), seed=0):
    """``tests/test_torch_video.py``'s seeded clip: a drifting gradient plus noise."""
    import cv2

    rng = np.random.default_rng(seed)
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.random(3) * 255
    out = cv2.VideoWriter(str(tmp_path / "in.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8.0, size)
    for i in range(n):
        f = base + 90 * np.sin((xx[..., None] + 3 * i) / 7 + np.arange(3)) \
            + 60 * np.cos(yy[..., None] / 5) + rng.normal(0, 8, (h, w, 3))
        out.write(np.clip(f, 0, 255).astype(np.uint8))
    out.release()
    return str(tmp_path / "in.mp4")


def _written(monkeypatch, mod):
    chunks = []
    real = mod._StreamWriter.__call__
    monkeypatch.setattr(mod._StreamWriter, "__call__",
                        lambda self, c: chunks.append(np.array(c)) or real(self, c))
    return chunks


def _both(monkeypatch, tmp_path, in_path, make, jin=None, tin=None, jreg=None, treg=None):
    jchunks, tchunks = _written(monkeypatch, jvid), _written(monkeypatch, tvid)
    assert jvid.apply_video(in_path, make(jconfig), jin or jpipe.EffectInputs(), jreg,
                            out_path=str(tmp_path / "j.mp4"))
    assert tvid.apply_video(in_path, make(tconfig), tin or tpipe.EffectInputs(),
                            treg or tpipe.ModelRegistry(device="cpu"),
                            out_path=str(tmp_path / "t.mp4"), device="cpu")
    return np.concatenate(jchunks), np.concatenate(tchunks), tchunks


def _levels(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def test_video_text_lanes_split_over_dp(monkeypatch, tmp_path, cpu_mesh, f32):
    """The BGR text lane on a 5-entry dp mesh: 7 frames in chunks of
    ``_chunk_size(3, 5)`` = 5 frames, a frame a card (and 2 on the last
    chunk), against JAX's 8-device lane within one level. The masked lane
    (a stub extractor, a thread a card) likewise; each card's extractor
    call sees its own frames."""
    cpu_mesh(5)
    in_path = _video(tmp_path, 7)

    def make(c, **text):
        return c.EffectRequest(text=c.TextEffectConfig(style_prompt="mosaic", **text),
                               video=c.VideoConfig(frame_batch=3))

    want, got, chunks = _both(monkeypatch, tmp_path, in_path, make)
    assert [c.shape[0] for c in chunks] == [5, 2]
    assert _levels(got, want).max() <= 1

    def mask_of(f):
        luma = f.astype(np.float32).mean(-1)
        return luma > luma.mean()

    calls = []

    def tbatch(frames, prompt):
        calls.append(frames.shape[0])
        return torch.stack([torch.from_numpy(mask_of(f)) for f in frames.numpy()])

    jreg = jpipe.ModelRegistry(batch_mask_extractor=lambda frames, prompt: jnp.stack(
        [jnp.asarray(mask_of(f)) for f in np.asarray(frames)]))
    treg = tpipe.ModelRegistry(device="cpu", batch_mask_extractor=tbatch)
    want, got, _ = _both(monkeypatch, tmp_path, in_path,
                         lambda c: make(c, location_prompt="boat"), jreg=jreg, treg=treg)
    assert sorted(calls) == [1] * 7
    assert _levels(got, want).max() <= 1


def test_video_gatys_lane_splits_over_dp(monkeypatch, tmp_path, cpu_mesh):
    """The Gatys lane on a 2-entry dp mesh: 5 frames of 32x32 split 3 and 2,
    2 L-BFGS steps, within 2 levels of JAX's 8-device lane (the tolerance
    of ``tests/test_torch_video.py``'s unsharded lane, on its clip) and
    within one of the port's lane without a mesh; the registry's VGG-19 tree
    has one ``Replicas``, shared by every chunk."""
    asked = cpu_mesh(2)
    in_path = _video(tmp_path, 5, size=(32, 32))
    s1 = np.random.default_rng(1).random((1, 32, 32, 3)).astype(np.float32)
    gcfg = dict(num_steps=2, w_style=1e3, w_edge=0.0, shape_bucket=32, max_side=32)

    def make(c):
        return c.EffectRequest(gatys=c.GatysConfig(**gcfg), video=c.VideoConfig(frame_batch=8),
                               style_transfer=True)

    seen = []
    _spy_run(monkeypatch, seen)
    treg = tpipe.ModelRegistry(vgg_params=TPARAMS, device="cpu")
    want, got, _ = _both(monkeypatch, tmp_path, in_path, make,
                         jpipe.EffectInputs(style_image=jnp.asarray(s1)),
                         tpipe.EffectInputs(style_image=torch.from_numpy(s1)),
                         jpipe.ModelRegistry(vgg_params=JPARAMS), treg)
    assert seen[0].shape == {"dp": 2, "sp": 1}
    assert mesh.replicas_of(treg.vgg_params) is mesh.replicas_of(treg.vgg_params)
    assert _levels(got, want).max() <= 2
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    _, one, _ = _both(monkeypatch, tmp_path, in_path, make,
                      jpipe.EffectInputs(style_image=jnp.asarray(s1)),
                      tpipe.EffectInputs(style_image=torch.from_numpy(s1)),
                      jpipe.ModelRegistry(vgg_params=JPARAMS), treg)
    assert seen[-1] is None and asked[-1] == "dp"
    assert _levels(got, one).max() <= 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.gpu
def test_peer_copies_and_halo_gradient_across_cards(two_cards):
    """A halo'd conv over shards on two cards (peer copies, one autograd
    graph over both) against the same on one card: bit for bit."""
    d0, d1 = two_cards
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 16, 8, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 16, 3, 3)).astype(np.float32))
    outs = {}
    for devs in ((d0, d0), (d0, d1)):
        xa = x.to(d0).requires_grad_(True)
        shards = mesh.scatter_width(xa, ((0, 32), (32, 64)), devs, 3)
        y = [F.conv2d(s, w.to(s.device), padding=(1, 0)) for s in mesh.halo(shards, 1, 3)]
        assert [t.device for t in y] == list(devs)
        out = mesh.gather_width(y, d0, 3)
        out.square().sum().backward()
        outs[devs[1]] = (out.detach().cpu(), xa.grad.cpu())
    assert torch.equal(outs[d0][0], outs[d1][0]) and torch.equal(outs[d0][1], outs[d1][1])


@pytest.mark.gpu
def test_gram_and_relu_pool_kernels_on_the_second_card(two_cards):
    """K1 (both directions) and K3 on ``cuda:1`` against their plain versions
    there, with the launches counted."""
    from tbist_tpu_torch.kernels import gram, launch_counts, relu_pool, reset_launch_counts

    _, d1 = two_cards
    g = torch.Generator(device=d1).manual_seed(0)
    x = torch.randn((2, 4096, 128), generator=g, device=d1)
    m = torch.randn((2, 128, 128), generator=g, device=d1)
    reset_launch_counts()
    got = gram.gram_fwd(x, 1e-3)
    assert got.device == d1
    torch.testing.assert_close(got, gram.gram_fwd_plain(x, 1e-3), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gram.gram_bwd(x, m), gram.gram_bwd_plain(x, m), rtol=1e-5,
                               atol=1e-4)
    pre = (torch.rand((1, 32, 64, 64), generator=g, device=d1) * 4).round() / 4 - 0.5
    out = torch.clamp_min(relu_pool.pool_fwd(pre), 0)
    gy = torch.randn(out.shape, generator=g, device=d1)
    torch.testing.assert_close(relu_pool.relu_pool_bwd(pre, out, gy),
                               relu_pool.pool_bwd_plain(pre, out, gy, relu=True),
                               rtol=0, atol=1e-6)
    torch.cuda.synchronize(d1)
    counts = launch_counts()
    assert counts["gram_fwd"] == counts["gram_bwd"] == counts["relu_pool_bwd"] == 1


@pytest.mark.gpu
def test_sam_attention_kernel_on_the_second_card(two_cards):
    """K4 on ``cuda:1`` against its plain version there at the N = 24 that
    each of four cards runs in the masked video lane (2 frames x 12 heads
    of SAM ViT-B's 64x64-token global attention, d 64), with its launch
    counted; the tolerance of ``chip_smoke.py``'s K4 lines."""
    from tbist_tpu_torch.kernels import launch_counts, reset_launch_counts, sam_attn
    from tbist_tpu_torch.utils.precision import full_f32

    _, d1 = two_cards
    n, h, w, d = 24, 64, 64, 64
    g = torch.Generator(device=d1).manual_seed(0)
    q = torch.randn((n, h * w, d), generator=g, device=d1) * d ** -0.5
    k, v = (torch.randn((n, h * w, d), generator=g, device=d1) for _ in range(2))
    bh = torch.randn((n, h * w, h), generator=g, device=d1)
    bw = torch.randn((n, h * w, w), generator=g, device=d1)
    reset_launch_counts()
    with full_f32():
        got = sam_attn.attention_with_rel_bias(q, k, v, bh, bw, h, w)
        want = sam_attn.attention_with_rel_bias_plain(q, k, v, bh, bw, h, w)
    torch.cuda.synchronize(d1)
    assert got.device == d1 and launch_counts()["sam_attn"] == 1
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
