"""``program_spans``: the idle time of a hand-built trace put down to the
program's step phases, on one card and on two."""

import types

import pytest

from portbench import program_spans, readers, tracing


def _trace(kernels, host_ops, steps=2, cards=1):
    return tracing.Trace(kernels=kernels, copies=[], host_ops=host_ops, ranges_us={},
                         steps=steps, cards=cards)


def _idle_us(trace):
    b = tracing.busy(trace)
    return trace.cards * b["window_us"] - sum(b["per_card_us"].values())


# a step from 0 to 100 us: forward 0-40 (the depth forward 20-30 inside),
# backward 40-70 (the depth backward 45-55 inside), update 75-95; ranges
# opened before the window hold it (a stage, the loop)
STEP = [(0.0, 100.0, "tbist.step"), (0.0, 40.0, "tbist.step.forward"),
        (20.0, 30.0, "tbist.depth.forward"), (40.0, 70.0, "tbist.step.backward"),
        (45.0, 55.0, "tbist.depth.backward"), (75.0, 95.0, "tbist.step.update")]
OUTER = [(-50.0, 300.0, "tbist.stage.text"), (-40.0, 300.0, "tbist.loop")]


def _steps(n):
    return OUTER + [(s + 100 * k, e + 100 * k, name) for k in range(n) for s, e, name in STEP]


def test_each_phase_gets_the_gaps_that_begin_in_it():
    # kernels leave gaps beginning at 10 (fwd), 25 (depth fwd), 50 (depth
    # bwd), 60 (bwd), 80 (update), 97 (the step outside its phases)
    kernels = [("k", 0, s, e) for s, e in
               [(0, 10), (12, 25), (29, 50), (52, 60), (65, 80), (90, 97), (99, 100)]]
    t = _trace(kernels, _steps(1), steps=1)
    got = program_spans.idle_ms_per_step(t)
    want_us = {"fwd": 2, "depth_fwd": 4, "depth_bwd": 2, "bwd": 5, "update": 10, "other": 2}
    assert got == pytest.approx({k: want_us.get(k, 0) / 1e3 for k in got})
    assert sum(got.values()) * 1e3 * t.steps == pytest.approx(_idle_us(t))


def test_partition_matches_the_idle_share_on_two_cards():
    """The phases' sum times the steps is the idle share times the window,
    with a card idle from the window's start and the other until its end."""
    k0 = [("k", 0, s, e) for s, e in [(5, 30), (41, 44), (80, 130), (150, 160)]]
    k1 = [("k", 1, s, e) for s, e in [(20, 60), (120, 199)]]
    t = _trace(k0 + k1, _steps(2), steps=2, cards=2)
    got = program_spans.idle_ms_per_step(t)
    ctx = types.SimpleNamespace(trace=t)
    window = tracing.busy(t)["window_us"]
    assert sum(got.values()) * 1e3 * t.steps == pytest.approx(
        readers.idle_share(ctx) / 100 * window)
    assert sum(got.values()) * 1e3 * t.steps * t.cards == pytest.approx(_idle_us(t))
    assert all(v >= 0 for v in got.values())


def test_a_card_without_operations_is_idle_all_window():
    t = _trace([("k", 0, 0.0, 40.0), ("k", 0, 60.0, 100.0)], _steps(1), steps=1, cards=2)
    got = program_spans.idle_ms_per_step(t)
    # card 1: 0-100 idle, all of it begun at 0, inside the forward
    assert got["fwd"] == pytest.approx(100 / 2 / 1e3)
    assert got["bwd"] == pytest.approx(20 / 2 / 1e3)  # card 0's gap at 40


def test_innermost_is_the_latest_start():
    # two ranges open at 50: the step's backward (from 40) and a later,
    # longer one (from 45 to 99); the later start wins though it ends later
    host = OUTER + [(0.0, 100.0, "tbist.step"), (40.0, 70.0, "tbist.step.backward"),
                    (45.0, 99.0, "tbist.step.update")]
    t = _trace([("k", 0, 0.0, 50.0), ("k", 0, 60.0, 100.0)], host, steps=1)
    assert program_spans.idle_ms_per_step(t)["update"] == pytest.approx(10 / 1e3)
    # of two with one start, the shorter
    host = OUTER + [(0.0, 100.0, "tbist.step"), (45.0, 99.0, "tbist.step.update"),
                    (45.0, 70.0, "tbist.step.backward")]
    t = _trace([("k", 0, 0.0, 50.0), ("k", 0, 60.0, 100.0)], host, steps=1)
    assert program_spans.idle_ms_per_step(t)["bwd"] == pytest.approx(10 / 1e3)


def test_a_gap_under_no_program_range_is_other():
    # the update of the first traced step: its range was entered before the
    # profiler started, so the trace has no range there; aten ops do not count
    host = [(0.0, 30.0, "aten::mul"), (30.0, 100.0, "tbist.step"),
            (30.0, 60.0, "tbist.step.forward")]
    t = _trace([("k", 0, 0.0, 10.0), ("k", 0, 20.0, 40.0), ("k", 0, 50.0, 100.0)], host,
               steps=1)
    got = program_spans.idle_ms_per_step(t)
    assert got["other"] == pytest.approx(10 / 1e3) and got["fwd"] == pytest.approx(10 / 1e3)


def test_a_range_begun_long_before_the_gap_is_found():
    """A step's range begun more than 4,000 host ops before a gap (the
    look-back of ``tracing.idle_gaps``) still takes the gap."""
    n = 5000
    host = [(0.0, 1e6, "tbist.step"), (1.0, 2e5, "tbist.step.backward")]
    host += [(2.0 + i, 2.5 + i, "aten::mul") for i in range(n)]
    t = _trace([("k", 0, 0.0, 1.0), ("k", 0, 9000.0, 9010.0), ("k", 0, 3e5, 1e6)], host,
               steps=1)
    got = program_spans.idle_ms_per_step(t)
    assert got["bwd"] == pytest.approx((9000 - 1 + 3e5 - 9010) / 1e3)
    assert got["other"] == 0
    # the host-op look-back misses the backward at the second gap
    assert dict(tracing.idle_gaps(t))["card 0: nothing traced"] == pytest.approx(3e5 - 9010)


def test_nothing_to_read_without_the_programs_ranges_or_a_trace():
    host = [(0.0, 100.0, "aten::mul"), (0.0, 100.0, "portbench.depth_fwd")]
    t = _trace([("k", 0, 0.0, 10.0), ("k", 0, 20.0, 40.0)], host, steps=1)
    assert program_spans.idle_ms_per_step(t) is None
    assert program_spans.idle_ms_per_step(_trace([], STEP)) is None
    assert program_spans.read(types.SimpleNamespace(trace=None), "fwd") is None
    assert program_spans.read(types.SimpleNamespace(trace=t), "fwd") is None
