"""The location cell's readers: the device ranges, K4's roofline, the
launches, busy and idle time a request, the idle time put down to the
chain's phases (``location_spans``) and the boxes a request, on hand-built
traces; and a tiny traced run of the cell on the CPU."""

import types

import pytest

from portbench import location_spans, readers, run, tracing
from portbench.tests.test_portbench_location import execute, request_clock  # noqa: F401
from portbench.work import peaks, sam_attn


def _trace(kernels, host_ops=(), ranges_us=None, steps=1, cards=1):
    return tracing.Trace(kernels=list(kernels), copies=[], host_ops=list(host_ops),
                         ranges_us=ranges_us or {}, steps=steps, cards=cards)


def _read(name, trace, **ctx):
    return run.module("metrics", name).read(types.SimpleNamespace(trace=trace, **ctx))


def _idle_us(trace):
    b = tracing.busy(trace)
    return trace.cards * b["window_us"] - sum(b["per_card_us"].values())


# a request from 0 to 100 us inside the text stage: DINO queued 0-30, SAM's
# encoder 30-50, the host waits for DINO's logits 50-70, the decode 70-90,
# then the pipeline's stages after the mask 90-100
REQUEST = [(0.0, 30.0, "tbist.location.dino"), (30.0, 50.0, "tbist.location.sam_encode"),
           (50.0, 70.0, "tbist.location.collect"), (70.0, 90.0, "tbist.location.sam_decode")]
OUTER = [(-10.0, 300.0, "tbist.stage.text"), (-5.0, 300.0, "aten::to")]


def _requests(n):
    return OUTER + [(s + 100 * k, e + 100 * k, name) for k in range(n) for s, e, name in REQUEST]


def test_each_phase_gets_the_gaps_that_begin_in_it():
    # gaps begin at 10 (dino), 35 (encode), 55 (collect), 80 (decode), 95
    # (after the chain)
    kernels = [("k", 0, s, e) for s, e in
               [(0, 10), (12, 35), (40, 55), (68, 80), (85, 95), (99, 100)]]
    t = _trace(kernels, _requests(1))
    got = location_spans.idle_ms_per_request(t)
    want_us = {"dino": 2, "sam": 5 + 5, "collect": 13, "other": 4}
    assert got == pytest.approx({k: want_us[k] / 1e3 for k in got})
    assert sum(got.values()) * 1e3 * t.steps == pytest.approx(_idle_us(t))
    for phase in ("dino", "sam", "collect"):
        assert _read(f"idle_{phase}_ms_per_request", t) == pytest.approx(got[phase])


def test_phases_and_the_rest_add_up_to_the_idle_share_on_two_requests_and_cards():
    k0 = [("k", 0, s, e) for s, e in [(5, 30), (41, 44), (80, 92), (97, 130), (150, 160),
                                      (170, 190)]]
    k1 = [("k", 1, s, e) for s, e in [(20, 60), (120, 199)]]
    t = _trace(k0 + k1, _requests(2), steps=2, cards=2)
    got = location_spans.idle_ms_per_request(t)
    window = tracing.busy(t)["window_us"]
    share = _read("device_idle_share.location", t)
    assert share == pytest.approx(readers.idle_share(types.SimpleNamespace(trace=t)))
    assert sum(got.values()) * 1e3 * t.steps == pytest.approx(share / 100 * window)
    assert sum(got.values()) * 1e3 * t.steps * t.cards == pytest.approx(_idle_us(t))
    assert all(v >= 0 for v in got.values()) and got["other"] > 0


def test_nothing_to_read_without_the_location_ranges_or_a_trace():
    """A program without the location spans (its text stage's range alone)
    reads nothing, and does not raise."""
    t = _trace([("k", 0, 0.0, 10.0), ("k", 0, 20.0, 40.0)], OUTER)
    assert location_spans.idle_ms_per_request(t) is None
    assert location_spans.idle_ms_per_request(_trace([], _requests(1))) is None
    for phase in ("dino", "sam", "collect"):
        assert _read(f"idle_{phase}_ms_per_request", t) is None
        assert _read(f"idle_{phase}_ms_per_request", None) is None


@pytest.mark.parametrize("name,rng", [("dino_ms_per_request", "portbench.dino"),
                                      ("sam_encoder_ms_per_request", "portbench.sam_encoder"),
                                      ("sam_decoder_ms_per_request", "portbench.sam_decoder")])
def test_device_time_under_the_harness_ranges(name, rng):
    t = _trace([("k", 0, 0.0, 1.0)], ranges_us={rng: 386_000.0, "portbench.other": 5.0},
               steps=10)
    assert _read(name, t) == pytest.approx(38.6)
    assert _read(name, _trace([("k", 0, 0.0, 1.0)], steps=10)) is None
    assert _read(name, None) is None


def test_k4_work_at_sam_vit_b():
    sam = run.load("configs", "gdino_swint_sam_vitb_mask")["sam"]
    # four global layers, 12 heads at one image, T = 64^2, d = 64
    assert sam_attn.k4_flops(sam) == 4 * 4 * 12 * 4096 ** 2 * 64
    h100 = peaks.peaks_for("NVIDIA H100 80GB HBM3")
    bound = sam_attn.k4_bound_s(sam, h100)
    assert bound == pytest.approx(3 * 206.158e9 / 495e12, rel=1e-5)  # 1.249 ms
    # ten requests, each four K4 launches of 1.28 ms and a combine of 0.01 ms
    kernels = [("void sam_attn_kernel<64>(float const*)", 0, 0.0, 1280.0)] * 40
    kernels += [("sam_attn_combine_kernel", 0, 0.0, 10.0)] * 10
    kernels += [("ampere_sgemm_128x64_nn", 0, 0.0, 5000.0)]
    t = _trace(kernels, steps=10)
    got = _read("k4_roofline", t, config={"sam": sam}, peaks=h100)
    assert got == pytest.approx(100 * 10 * bound / (40 * 1280e-6 + 10 * 10e-6))
    assert 20 < got < 30
    assert _read("k4_roofline", _trace(kernels[-1:], steps=10), config={"sam": sam},
                 peaks=h100) is None


def test_launches_and_busy_time_a_request():
    t = _trace([("a", 0, 0.0, 1000.0), ("b", 0, 500.0, 3000.0), ("c", 0, 5000.0, 6000.0)],
               steps=2)
    assert _read("launches_per_request.location", t) == pytest.approx(1.5)
    assert _read("device_busy_ms_per_request.location", t) == pytest.approx(2.0)
    for name in ("launches_per_request.location", "device_busy_ms_per_request.location",
                 "device_idle_share.location"):
        assert _read(name, None) is None


def test_boxes_a_request():
    rec = [{"error": None, "out": 1, "captures": {"boxes": 3}},
           {"error": None, "out": 1, "captures": {"boxes": 2}},
           {"error": "RuntimeError: x", "out": None, "captures": {}}]
    reader = run.module("metrics", "boxes_per_request")
    assert reader.read(types.SimpleNamespace(records=rec)) == pytest.approx(2.5)
    assert reader.read(types.SimpleNamespace(records=rec[2:])) is None


def test_a_tiny_traced_run_of_the_cell():
    """On the CPU, with no device trace, the traced run reports the boxes
    and no device metric; the port's published decoder is correct."""
    rc, out, _ = execute(trace=1)
    assert rc == 0 and out["correct"] is True, out["checks"]
    want = {m["name"] for m in run.cell_metrics("text_location", True)}
    assert len(want) == 11 and set(out["metrics"]) <= want
    assert out["metrics"]["boxes_per_request"] == {"value": 3.0, "unit": "boxes"}
