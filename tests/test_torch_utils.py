"""The port's utils against the JAX package's: configs field by field,
the shape-bucketing policy, and the host↔device image boundary."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils import imageio as jio
from tbist_tpu_torch.utils import config as tconfig
from tbist_tpu_torch.utils import imageio as tio

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

CONFIG_CLASSES = [
    "GatysConfig", "TextEffectConfig", "PixelArtConfig", "ColorPaletteConfig",
    "DepthConfig", "MaskCompositeConfig", "VideoConfig", "EffectRequest",
]


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_fields_and_defaults_match_jax(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert tf == jf
    jd, td = dataclasses.asdict(jcls()), dataclasses.asdict(tcls())
    assert td == jd
    assert tcls.__dataclass_params__.frozen == jcls.__dataclass_params__.frozen


def test_config_constants_match_jax():
    for name in ("VGG_MEAN", "VGG_STD", "CONTENT_LAYERS_DEFAULT", "STYLE_LAYERS_DEFAULT"):
        assert getattr(tconfig, name) == getattr(jconfig, name)


def test_bucket_shape_matches_jax_over_grid():
    for h in (1, 15, 16, 17, 31, 47, 48, 63, 64, 100, 257, 511, 512, 513, 700, 1500):
        for w in (1, 20, 33, 64, 255, 512, 1023, 2048):
            for bucket in (8, 32):
                for max_side in (None, 64, 512, 1024):
                    assert tio.bucket_shape(h, w, bucket, max_side) == jio.bucket_shape(
                        h, w, bucket, max_side
                    ), (h, w, bucket, max_side)


@pytest.mark.parametrize("max_side", [64, 512])
@pytest.mark.parametrize(
    "path", ["content_imgs/boat.jpg", "style_imgs/starry_night.jpg", "content_imgs/sea.png"]
)
def test_to_device_matches_jax(path, max_side):
    img = tio.load_image(os.path.join(DATA, path))
    want = np.asarray(jio.to_device(img, bucket=32, max_side=max_side), np.float32)
    got = tio.to_device(img, bucket=32, max_side=max_side, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize(
    "src,dst", [((16, 16), (24, 20)), ((64, 96), (80, 80)), ((37, 29), (12, 30)), ((8, 8), (5, 7))]
)
def test_image_resize_bilinear_matches_jax(src, dst):
    x = np.random.default_rng(0).random((2, *src, 5), dtype=np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 5), "bilinear"))
    got = tio.image_resize_bilinear(torch.from_numpy(x), dst)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_to_float_to_uint8_from_device_match_jax():
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, (9, 7, 4), dtype=np.uint8)
    gray = rng.integers(0, 256, (9, 7), dtype=np.uint8)
    for arr in (rgba, gray):
        np.testing.assert_array_equal(tio.to_float(arr), jio.to_float(arr))
    x = rng.random((1, 9, 7, 3), dtype=np.float32) * 1.2 - 0.1
    x[0, 0, 0] = [0.5 / 255, 1.5 / 255, 2.5 / 255]  # halfway cases round to even
    want = np.asarray(jio.from_device(jnp.asarray(x)))
    got = np.asarray(tio.from_device(torch.from_numpy(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.to_uint8(torch.from_numpy(x)), jio.to_uint8(x))


def test_save_image_round_trip(tmp_path):
    x = torch.from_numpy(np.random.default_rng(2).random((1, 8, 6, 3), dtype=np.float32))
    path = str(tmp_path / "x.png")
    tio.save_image(x, path)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), tio.to_uint8(x))


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        tio.to_device(np.zeros((4, 4, 3), np.uint8))
    assert tio.resolve_device("cpu") == torch.device("cpu")


def test_prof_kinds_and_cpu_trace():
    from tbist_tpu_torch.utils import prof

    assert prof.kind_of("void (anonymous namespace)::gram_bwd_kernel<float>") == "K1 gram (gram.cu)"
    for name in ("void (anonymous namespace)::gram_fwd_kernel<(anonymous namespace)::Tile<128, "
                 "256, 8, 8, 16, 2>, float, true>(float const*, float*, long, int, long, int)",
                 "(anonymous namespace)::gram_reduce_kernel(float const*, float*, int, int)"):
        assert prof.kind_of(name) == "K1 gram (gram.cu)"
    assert prof.kind_of("pool_bwd_kernel<float, true>") == "K3 relu-pool bwd (pool_bwd.cu)"
    assert prof.kind_of("gemv2N_kernel<int, int, float2, float2>") == "convolution (cuDNN)"
    assert prof.kind_of("sm80_xmma_gemm_f32f32_tn_n") == "matmul (cuBLAS)"
    for name in ("void (anonymous namespace)::sam_attn_kernel<8>(float const*, float const*)",
                 "(anonymous namespace)::sam_attn_combine_kernel(float const*, float const*, "
                 "float const*, float*, int, long, int)"):
        assert prof.kind_of(name) == "K4 sam attention (sam_attn.cu)"
    assert prof.kind_of("void cunn_SoftMaxForward<4, float>") == "softmax"
    assert prof.kind_of("something_new") == "other"
    with prof.trace() as p:
        torch.ones(4).sum()
    assert prof.device_breakdown(p) == {"device_events": 0}
