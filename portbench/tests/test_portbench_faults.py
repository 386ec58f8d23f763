"""A run with the timed path broken underneath comes out not correct.

Each test skips the look for a card and drives the rest of a run of a cell
at a tiny size on the CPU (``run.execute``), with one fault planted in the
port: a step that returns its state unchanged, half of each image left out
of the loss's means, the exchange between cards left out of the sharded
path, and the returned image altered where it is made; and the L-BFGS
history broken after a sound first step. The sound runs beside them come
out sound (``sound_at_tiny``).
"""

import pytest
import torch

from portbench.tests.test_portbench_harness import execute


def _numbers(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell", ["gatys512", "depth_loss512"])
def test_step_returning_its_state_unchanged(monkeypatch, cell):
    from tbist_tpu_torch.optimize import lbfgs

    real = lbfgs.update

    def unchanged(grad, state, lr=1.0):
        step, state = real(grad, state, lr=lr)
        return torch.zeros_like(step), state

    monkeypatch.setattr(lbfgs, "update", unchanged)
    rc, out, _ = execute(cell)
    assert rc == 0 and out["correct"] is False
    assert _numbers(out)["step0_rel"] == pytest.approx(1.0)


def _memory_cut_to_two(monkeypatch, lbfgs):
    real = lbfgs.init_state
    monkeypatch.setattr(lbfgs, "init_state", lambda shape, memory_size, *a, **k:
                        real(shape, 2, *a, **k))


def _history_dropped(monkeypatch, lbfgs):
    real = lbfgs.update

    def dropped(grad, state, lr=1.0):
        step, state = real(grad, state, lr=lr)
        for t in (state.s_hist, state.y_hist, state.rho):
            t.zero_()
        return step, state

    monkeypatch.setattr(lbfgs, "update", dropped)


def _descent_after_the_first_step(monkeypatch, lbfgs):
    real = lbfgs.update

    def descent(grad, state, lr=1.0):
        first = state.step == 0
        step, state = real(grad, state, lr=lr)
        if not first:
            step = -lr * state.gamma * grad
            state.prev_step_vec = step
        return step, state

    monkeypatch.setattr(lbfgs, "update", descent)


@pytest.mark.parametrize("cell", ["gatys512", "depth_loss512"])
@pytest.mark.parametrize("fault", [_memory_cut_to_two, _history_dropped,
                                   _descent_after_the_first_step])
def test_lbfgs_history_broken_after_the_first_step(monkeypatch, cell, fault):
    """A first step as it should be, then an update that does not use the
    configuration's m = 10 pairs: the memory cut to 2, the history dropped
    after every step, or plain descent along the scaled gradient. The start
    reads sound; the steps that follow do not."""
    from tbist_tpu_torch.optimize import lbfgs

    fault(monkeypatch, lbfgs)
    rc, out, _ = execute(cell)
    assert rc == 0 and out["correct"] is False
    n = _numbers(out)
    assert n["step0_rel"] <= out["checks"]["step0_rel"]["limit"]
    held = [k for k in ("stepk_rel", "stepk_median_rel") if k in out["checks"]]
    assert held and all(n[k] > 10 * out["checks"][k]["limit"] for k in held), n


def test_reading_points_bypassed(monkeypatch, capsys):
    """A program that no longer calls ``lbfgs.update`` through its module
    (a step bound locally, fused or captured) ends the run without a
    result, and says so."""
    from tbist_tpu_torch.optimize import gatys, lbfgs

    monkeypatch.setattr(gatys, "lbfgs", type("bound", (), {
        "init_state": staticmethod(lbfgs.init_state), "update": staticmethod(lbfgs.update)}))
    rc, out, _ = execute("gatys512")
    assert rc != 0 and out is None
    assert "reading points bypassed" in capsys.readouterr().err


@pytest.mark.parametrize("cell", ["gatys512", "depth_loss512"])
def test_half_of_each_image_left_out(monkeypatch, cell):
    from tbist_tpu_torch.optimize import gatys

    def half_mean(x):
        flat = x.reshape(x.shape[0], -1)
        return flat[:, : flat.shape[1] // 2].mean(dim=1)

    monkeypatch.setattr(gatys, "_lane_mean", half_mean)
    rc, out, _ = execute(cell)
    assert rc == 0 and out["correct"] is False
    assert _numbers(out)["loss0_rel"] > out["checks"]["loss0_rel"]["limit"]


def test_answer_altered_where_it_is_made(monkeypatch):
    from tbist_tpu_torch.utils import imageio

    real = imageio.to_uint8_device

    def altered(x):
        u8 = real(x).clone()
        u8.view(-1)[17] = 255 - u8.view(-1)[17]
        return u8

    monkeypatch.setattr(imageio, "to_uint8_device", altered)
    rc, out, _ = execute("gatys512")
    assert rc == 0 and out["correct"] is False
    assert _numbers(out)["output_levels_off"] == 1


@pytest.fixture
def cpu_sp_mesh(monkeypatch):
    """The production mesh as four ``cpu`` entries on sp, and a width from
    which one image shards, so that the mesh cell's path runs sharded."""
    from tbist_tpu_torch.parallel import mesh

    def fake(device="cuda", dp_only=False, sp_only=False):
        devs = ["cpu"] * 4
        return mesh.make_mesh(devs, dp=4, sp=1) if dp_only else mesh.make_mesh(devs, dp=1, sp=4)

    monkeypatch.setattr(mesh, "production_mesh", fake)
    monkeypatch.setenv("TBIST_GATYS_SP_MIN_WIDTH", "16")
    shards = []
    real = mesh.width_sharding
    monkeypatch.setattr(mesh, "width_sharding",
                        lambda *a, **k: shards.append(real(*a, **k)) or shards[-1])
    return shards


@pytest.mark.parametrize("fault", [None, "halo", "sum"])
def test_exchange_between_cards_left_out(monkeypatch, cpu_sp_mesh, fault):
    """``gatys512``'s requests where the production mesh is four cards, as
    ``effects/style.py`` runs them on a four-card host: sound, the sharded
    run is correct; with each shard's halo taken as zeros (no neighbour's
    columns), or the shards' sums left on their own cards (the first
    shard's alone), it is not."""
    from tbist_tpu_torch.parallel import mesh

    if fault == "halo":
        real = mesh.halo
        monkeypatch.setattr(mesh, "halo", lambda shards, k, dim, edge="zeros": [
            real([s], k, dim, edge)[0] for s in shards])
    elif fault == "sum":
        monkeypatch.setattr(mesh, "sum_on", lambda tensors, device: tensors[0].to(device))
    from portbench.tests import test_portbench_harness as h

    rc, out, _ = h.run.execute(["--workload", "gatys512", "--seed", "3000000001",
                                "--seconds", "0.001"], device="cpu",
                               overrides=h.tiny("gatys512", side=64))
    assert rc == 0
    assert cpu_sp_mesh and cpu_sp_mesh[-1] is not None and len(cpu_sp_mesh[-1].devices) == 4
    if fault is None:
        assert h.sound_at_tiny(out), out["checks"]
    else:
        assert out["correct"] is False and not h.sound_at_tiny(out), out["checks"]
