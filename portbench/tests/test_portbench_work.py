"""The counts of work: K1's and K3's bounds against ``chip_smoke.py``'s,
VGG-19's convolutions, Depth Anything's and a step's FLOPs."""

import pytest

from portbench import run
from portbench.work import flops, peaks

H100 = peaks.peaks_for("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("kind,ms", [("gram_fwd", 0.072), ("gram_bwd", 0.144),
                                     ("pool_bwd", 0.094)])
def test_kernel_bounds_match_chip_smoke(kind, ms):
    """A 512px step's least K1 and K3 times at the published peaks, as
    ``chip_smoke.py`` states them (PERF.md's kernel table)."""
    got = flops.kernel_bound_s(kind, 512, 512, H100["float32"], H100["bytes"]) * 1e3
    assert got == pytest.approx(ms, abs=5e-4)


def test_kernel_bounds_agree_with_chip_smoke_functions():
    """The same shapes and counts as ``chip_smoke.gram_shapes``,
    ``pool_shapes`` and ``bound_ms`` (read here, never by the benchmark)."""
    import chip_smoke

    assert flops.gram_shapes(512, 512, flops.GRAM_CHANNELS) == chip_smoke.gram_shapes(512)
    assert flops.pool_shapes(512, 512, flops.POOL_CHANNELS) == chip_smoke.pool_shapes(512)
    for b, n, c in chip_smoke.gram_shapes(512):
        nbytes, ops = flops.gram_fwd_work(b, n, c)
        want = chip_smoke.bound_ms(b * (n * c * 4 + c * c * 4), b * n * c * (c + 1), "float32")
        assert flops.bound_s(nbytes, ops, H100["float32"], H100["bytes"]) * 1e3 == \
            pytest.approx(want[0])


def test_vgg_convolutions():
    convs = flops.vgg_convs(512, 512, ["conv4_2", "conv5_1"])
    assert [c[0] for c in convs][-1] == "conv5_1" and len(convs) == 13
    assert convs[0] == ("conv1_1", 512, 512, 3, 64)
    assert convs[-1] == ("conv5_1", 32, 32, 512, 512)
    _, f = flops.vgg_conv_work(512, 512, ["conv4_2", "conv5_1"])
    # 189.4 GFLOP forward, the same again for the input gradient
    assert f == pytest.approx(2 * 189.39e9, rel=1e-3)


def test_depth_anything_flops():
    da = run.load("configs", "vgg19_dav2s_depth_512")["depth_anything"]
    got = flops.depth_anything_flops(da)
    t, d = 37 * 37 + 1, 384
    vit = 12 * (2 * t * d * 3 * d + 2 * t * d * d + 2 * t * d * 4 * d * 2)
    attn = 12 * 4 * t * t * d
    assert got["forward"] > vit + attn + 2 * 37 * 37 * d * 3 * 14 * 14
    assert got["forward"] == pytest.approx(115e9, rel=0.05)
    assert got["input_gradient"] == pytest.approx(got["forward"] + attn)


def test_step_flops():
    plain = run.load("configs", "vgg19_gatys_512")
    depth = run.load("configs", "vgg19_dav2s_depth_512")
    a, b = flops.step_flops(plain, 512, 512), flops.step_flops(depth, 512, 512)
    assert a == pytest.approx(392.4e9, rel=1e-3)
    da = flops.depth_anything_flops(depth["depth_anything"])
    assert b - a == pytest.approx(da["forward"] + da["input_gradient"])


def test_peaks():
    assert H100["float32"] == 67e12 and H100["bytes"] == 3.35e12
    assert peaks.peaks_for("NVIDIA H100 PCIe")["float32"] == 51e12
