"""The port's spans (``utils/logging.span``) on the CPU: none is built while
no profiler records, each step's phases nest where the loops put them
(``gatys.stylize`` and ``batched.run``, with and without the depth term),
and a profiler changes no number the loops compute."""

import pytest
import torch

from tbist_tpu_torch.models import depth_anything as tda
from tbist_tpu_torch.models import vgg19
from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.parallel import batched
from tbist_tpu_torch.utils import logging as tlog
from tbist_tpu_torch.utils.config import GatysConfig

STEPS = 3
SIDE = 32
# the tiny Depth Anything of tests/test_torch_depth.py
TINY = dict(patch=7, width=32, layers=2, heads=2, mlp_ratio=2, out_layers=(1, 1, 2, 2),
            neck_dims=(8, 8, 16, 16), fusion=8, head_hidden=8, pos_grid=6, input_size=42)
PHASES = ("tbist.step.forward", "tbist.step.backward", "tbist.step.update")


@pytest.fixture(scope="module")
def inputs():
    g = torch.Generator().manual_seed(0)
    content = torch.rand((1, SIDE, SIDE, 3), generator=g)
    style = torch.rand((1, SIDE, SIDE, 3), generator=g)
    vgg = vgg19.init_params(torch.Generator().manual_seed(0))
    cfg = tda.DAConfig(**TINY)
    dparams = tda.init_params(torch.Generator().manual_seed(1), cfg)

    def depth_fn(img):
        return tda.predict_depth(dparams, cfg, img)

    return content, style, vgg, depth_fn


def _stylize(inputs, depth):
    content, style, vgg, depth_fn = inputs
    cfg = GatysConfig(num_steps=STEPS, w_style=1e4, w_depth=5e4 if depth else 0.0)
    return gatys.stylize(content, [style], cfg, vgg, device="cpu",
                         depth_fn=depth_fn if depth else None)


def _batched(inputs, depth):
    content, style, vgg, depth_fn = inputs
    frames = torch.cat([content, torch.flip(content, dims=[2])])
    cfg = GatysConfig(num_steps=STEPS, w_style=1e4, w_depth=5e4 if depth else 0.0)
    return batched.run(cfg, vgg, frames, [style], return_history=True,
                       depth_fn=depth_fn if depth else None, device="cpu")


def _profiled(fn):
    """(``fn()``, the ``tbist.*`` ranges as (name, start, end), by start)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        out = fn()
    ranges = sorted(((e.name, e.time_range.start, e.time_range.end) for e in p.events()
                     if e.name.startswith(tlog.SPAN_PREFIX)), key=lambda r: r[1])
    return out, ranges


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(ranges, name):
    return [r for r in ranges if r[0] == name]


@pytest.mark.parametrize("loop", [_stylize, _batched])
@pytest.mark.parametrize("depth", [False, True])
def test_no_profiler_builds_no_range(inputs, monkeypatch, loop, depth):
    """With no profiler recording, no span reaches ``record_function``."""

    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tlog.span("step") is tlog.span("loop")  # the one shared no-op
    loop(inputs, depth)


@pytest.mark.parametrize("loop", [_stylize, _batched])
@pytest.mark.parametrize("depth", [False, True])
def test_steps_nest_their_phases(inputs, loop, depth):
    """One ``tbist.loop`` holds the 3 ``tbist.step`` ranges, each of them
    exactly one forward, backward and update."""
    _, ranges = _profiled(lambda: loop(inputs, depth))
    (outer,) = _named(ranges, "tbist.loop")
    steps = _named(ranges, "tbist.step")
    assert len(steps) == STEPS and all(_inside(s, outer) for s in steps)
    for name in PHASES:
        found = _named(ranges, name)
        assert len(found) == STEPS, name
        assert all(sum(_inside(r, s) for r in found) == 1 for s in steps), name
    lanes = 2 if loop is _batched else 1
    forward = _named(ranges, "tbist.depth.forward")
    backward = _named(ranges, "tbist.depth.backward")
    if not depth:
        assert not forward and not backward
        return
    # the target once a lane, then once a step and a lane
    assert len(forward) == lanes + STEPS * lanes
    assert len(backward) == STEPS * lanes
    step_bwd = _named(ranges, "tbist.step.backward")
    assert all(any(_inside(b, s) for s in step_bwd) for b in backward)
    step_fwd = _named(ranges, "tbist.step.forward")
    assert sum(any(_inside(f, s) for s in step_fwd) for f in forward) == STEPS * lanes


@pytest.mark.parametrize("loop", [_stylize, _batched])
@pytest.mark.parametrize("depth", [False, True])
def test_profiler_changes_no_number(inputs, loop, depth):
    """The image and the loss history bit for bit with and without a
    profiler recording the spans."""
    plain = loop(inputs, depth)
    traced, ranges = _profiled(lambda: loop(inputs, depth))
    assert ranges
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_pipeline_stage_ranges(inputs):
    """Each stage that ``utils/prof.py``'s effects path runs through the
    pipeline opens its own ``tbist.stage.<name>``, once, in the chain's
    order; a stage that does not run opens none."""
    from tbist_tpu_torch.compose import pipeline
    from tbist_tpu_torch.utils.config import EffectRequest, PixelArtConfig

    content, style, _, _ = inputs
    req = EffectRequest(grayscale=True, pixel_art=PixelArtConfig(), color_palette=True)
    out, ranges = _profiled(lambda: pipeline.apply_image(
        content, req, pipeline.EffectInputs(color_palette_image=style)))
    assert out is not None
    stages = [r for r in ranges if r[0].startswith("tbist.stage.")]
    assert [r[0] for r in stages] == ["tbist.stage.pixel_art", "tbist.stage.color_palette"]
    assert stages[0][2] <= stages[1][1]


def test_stopping_the_profiler_inside_a_span():
    """The benchmark stops its profiler inside ``lbfgs.update``, with the
    step's spans open: leaving them afterwards raises nothing."""
    p = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with tlog.span("step"):  # entered before the profiler starts: a no-op
        p.start()
        with tlog.span("step.update"):
            torch.ones(4).add_(1)
            p.stop()
    assert not torch.autograd.profiler._is_profiler_enabled
    names = [e.name for e in p.events()]
    assert "tbist.step.update" in names and "tbist.step" not in names


def test_backward_span_needs_a_graph_and_a_profiler():
    """No hook is registered on a tensor without a graph, nor while no
    profiler records."""
    x = torch.ones(3, requires_grad=True)
    y = x * 2
    tlog.backward_span("depth.backward", y, x)  # no profiler
    assert not y._backward_hooks
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        z = torch.ones(3)
        tlog.backward_span("depth.backward", z, z)  # no graph: returns quietly
        tlog.backward_span("depth.backward", y, x)
    assert y._backward_hooks


def test_prof_reads_the_program_ranges(inputs):
    """``utils/prof.program_ranges``: each range's calls, host ms and device
    ms a step (no kernels on the CPU)."""
    from tbist_tpu_torch.utils import prof

    with prof.trace() as p:
        _stylize(inputs, True)
    rows = prof.program_ranges(p, STEPS)
    for name in ("tbist.step",) + PHASES:
        assert rows[name]["calls"] == pytest.approx(1.0), name
    assert rows["tbist.loop"]["calls"] == pytest.approx(1 / STEPS)
    assert rows["tbist.depth.forward"]["calls"] == pytest.approx((1 + STEPS) / STEPS)
    assert rows["tbist.step.forward"]["host_ms"] > rows["tbist.depth.forward"]["host_ms"] / 2
    assert all(r["host_ms"] > 0 and r["device_ms"] == 0 for r in rows.values())


def test_prof_device_ops_leave_out_range_mirrors():
    """A profiled range's mirror on the device timeline is no operation."""
    import types

    from tbist_tpu_torch.utils import prof

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [types.SimpleNamespace(name="tbist.step", device_type=cuda, is_user_annotation=True),
              types.SimpleNamespace(name="gram_fwd_kernel", device_type=cuda,
                                    is_user_annotation=False),
              types.SimpleNamespace(name="aten::mul", device_type=cpu, is_user_annotation=False)]
    p = types.SimpleNamespace(events=lambda: events)
    assert [e.name for e in prof.device_ops(p)] == ["gram_fwd_kernel"]
