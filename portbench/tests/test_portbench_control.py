"""The control on the card: the plain reference with TF32 on, put in the
port's place, comes out not correct under each cell's limits, at 128px and
16 steps, the first 12 followed update by update (``control.py`` reads it
at the cells' own size); the sound reference in f32 with TF32 off, put
there the same way, comes out correct. The location check's control, at
the CPU tests' tiny widths (``control_location.py`` reads it at the cell's
own size), comes out not correct."""

import pytest

from portbench import check, control, run


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["gatys512", "depth_loss512"])
def test_tf32_control_is_not_correct(card, cell):
    ov = {"params": {"side": 128, "steps": 16, "check_steps": 12}}
    limits = run.load("workloads", cell)["limits"]
    for seed in (3800000001, 3800000002, 3800000003):
        out, _ = control.control_reading(cell, seed, device=str(card), overrides=ov)
        assert not check.judge(out["control"], limits), out["control"]
        assert check.judge(out["reference"], limits), out["reference"]


@pytest.mark.gpu
def test_tf32_location_control_is_not_correct(card):
    """The location check's control on the card, at the tiny widths of the
    CPU tests: the reference with TF32 on, in the program's place, fails
    the cell's limits on every seed."""
    from portbench import control_location
    from portbench.tests.test_portbench_location import TINY

    limits = run.load("workloads", "text_location")["limits"]
    for seed in (3800000001, 3800000002, 3800000003):
        rows = control_location.control_readings(seed, device=str(card), photos=3,
                                                 overrides=TINY)
        assert not check.judge(check.worst([r["numbers"] for r in rows]), limits)
