"""The port's mask ops (``ops/resize``, ``ops/filters``, ``ops/masks``) on the
CPU: against the JAX package on the same numpy inputs, and against the
goldens ``feathered_composite``, ``merge_k31`` and ``merge_k95`` within
``tests/test_golden.py``'s limits."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.ops import filters as jfilters
from tbist_tpu.ops import masks as jmasks
from tbist_tpu.ops import resize as jresize
from tbist_tpu_torch.ops import filters, masks, resize
from tbist_tpu_torch.utils import imageio as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# blur_mask rounds to 8-bit steps: a value within float rounding of a step
# boundary may land one step (1/255) apart in the two packages
STEP = 1.0 / 255.0


def _rand(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _mask(seed, shape):
    return np.random.default_rng(seed).random(shape) > 0.6


@pytest.mark.parametrize("out_hw", [(7, 23), (13, 17), (30, 5)])
def test_resize_nearest_and_bilinear_match_jax(out_hw):
    x = _rand(0, (2, 13, 17, 3))
    np.testing.assert_array_equal(resize.resize_nearest(torch.from_numpy(x), out_hw).numpy(),
                                  np.asarray(jresize.resize_nearest(jnp.asarray(x), out_hw)))
    for align in (False, True):
        got = resize.resize_bilinear(torch.from_numpy(x), out_hw, align).numpy()
        want = np.asarray(jresize.resize_bilinear(jnp.asarray(x), out_hw, align))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_center_crop_to_match_follows_content():
    c, s = _rand(1, (1, 10, 12, 3)), _rand(2, (1, 7, 15, 3))
    m2 = _mask(3, (10, 12))
    got = resize.center_crop_to_match(*(torch.from_numpy(a) for a in (c, s, m2)))
    want = jresize.center_crop_to_match(*(jnp.asarray(a) for a in (c, s, m2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c2, s2 = resize.center_crop_to_match(torch.from_numpy(c), torch.from_numpy(s))
    assert c2.shape == s2.shape == (1, 7, 12, 3)


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 8, 9, 31, 95])
def test_gaussian_kernel_matches_cv2(ksize):
    k = ksize + (ksize % 2 == 0)
    want = cv2.getGaussianKernel(k, 0).ravel().astype(np.float32)
    np.testing.assert_allclose(filters.gaussian_kernel_1d(ksize), want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(filters.gaussian_kernel_1d(ksize),
                               jfilters.gaussian_kernel_1d(ksize), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("ksize,shape", [(5, (2, 16, 20, 3)), (31, (1, 9, 40, 1)),
                                         (95, (1, 64, 64, 1))])
def test_gaussian_blur_matches_jax(ksize, shape):
    # (31, 9 rows): the reflect pad of 15 exceeds the 9 rows, as np.pad allows
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    got = filters.gaussian_blur(torch.from_numpy(x), ksize).numpy()
    want = np.asarray(jfilters.gaussian_blur(jnp.asarray(x), ksize))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ksize", [5, 9, 31])
def test_blur_masks_match_jax_and_single(ksize):
    m = _mask(5, (3, 24, 30))
    got = filters.blur_masks(torch.from_numpy(m), ksize).numpy()
    want = np.asarray(jfilters.blur_masks(jnp.asarray(m), ksize))
    assert np.abs(got - want).max() <= STEP + 1e-6
    assert np.mean(got != want) <= 1e-3
    for i in range(3):
        np.testing.assert_array_equal(filters.blur_mask(torch.from_numpy(m[i]), ksize).numpy(),
                                      got[i])


@pytest.mark.parametrize("edge", [0, 9])
def test_composite_by_mask_matches_jax(edge):
    c, s = _rand(6, (1, 20, 26, 3)), _rand(7, (1, 18, 30, 3))
    m = _mask(8, (20, 26))
    got = masks.composite_by_mask(torch.from_numpy(c), torch.from_numpy(s),
                                  torch.from_numpy(m), edge).numpy()
    want = np.asarray(jmasks.composite_by_mask(jnp.asarray(c), jnp.asarray(s),
                                               jnp.asarray(m), edge))
    assert got.shape == want.shape == (1, 18, 26, 3)
    np.testing.assert_allclose(got, want, atol=1e-5 + STEP * np.abs(c - s.mean()).max())


def test_composite_by_masks_batch_equals_per_frame():
    c, s = _rand(9, (3, 16, 20, 3)), _rand(10, (3, 16, 20, 3))
    m = _mask(11, (3, 16, 20))
    for edge in (0, 5):
        got = masks.composite_by_masks_batch(torch.from_numpy(c), torch.from_numpy(s),
                                             torch.from_numpy(m), edge)
        for i in range(3):
            one = masks.composite_by_mask(torch.from_numpy(c[i:i + 1]),
                                          torch.from_numpy(s[i:i + 1]),
                                          torch.from_numpy(m[i]), edge)
            torch.testing.assert_close(got[i:i + 1], one, rtol=0, atol=0)


def _stencil(size=40):
    yy, xx = np.mgrid[0:size, 0:size]
    half = size // 2
    return ((yy - half) ** 2 + (xx - half) ** 2 < (0.4 * size) ** 2) & (
        ((yy // 6) + (xx // 6)) % 2 == 0)


@pytest.mark.parametrize("blur,step", [(31, 1.0), (15, 0.5), (9, 0.3)])
def test_merge_content_style_masks_matches_jax(blur, step):
    seg = _mask(12, (48, 56))
    got = masks.merge_content_style_masks(torch.from_numpy(seg), torch.from_numpy(_stencil()),
                                          blur, step).numpy()
    want = np.asarray(jmasks.merge_content_style_masks(jnp.asarray(seg),
                                                       jnp.asarray(_stencil()), blur, step))
    assert got.shape == (48, 56) and got.max() == pytest.approx(1.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_emoji_composite_and_batch_match_jax():
    c, s = _rand(13, (2, 40, 44, 3)), _rand(14, (2, 40, 44, 3))
    seg = _mask(15, (2, 40, 44))
    emoji = _stencil(24)
    got = masks.emoji_composite_batch(torch.from_numpy(c), torch.from_numpy(s),
                                      torch.from_numpy(seg), torch.from_numpy(emoji), 15, 0.5)
    want = np.asarray(jmasks.emoji_composite_batch(jnp.asarray(c), jnp.asarray(s),
                                                   jnp.asarray(seg), jnp.asarray(emoji), 15, 0.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    one = masks.emoji_composite(torch.from_numpy(c[1:]), torch.from_numpy(s[1:]),
                                torch.from_numpy(seg[1]), torch.from_numpy(emoji), 15, 0.5)
    torch.testing.assert_close(one, got[1:], rtol=0, atol=0)


def _golden_inputs():
    def load(rel):
        return tio.to_device(tio.load_image(os.path.join(ROOT, "data", rel)),
                             bucket=32, max_side=64, device="cpu")

    content, style = load("content_imgs/boat.jpg"), load("style_imgs/starry_night.jpg")
    luma = content[0].mean(-1)
    seg = luma > luma.mean()
    yy, xx = np.mgrid[0:172, 0:172]
    ring = ((yy - 86) ** 2 + (xx - 86) ** 2 < 70**2) & (((yy // 12) + (xx // 12)) % 2 == 0)
    return content, style, seg, torch.from_numpy(ring)


@pytest.mark.parametrize("name", ["feathered_composite", "merge_k31", "merge_k95"])
def test_goldens(name):
    content, style, seg, ring = _golden_inputs()
    if name == "feathered_composite":
        got = masks.composite_by_mask(content, style, seg, 9)[0]
    elif name == "merge_k31":
        got = masks.merge_content_style_masks(seg, ring, 31, 1.0)
    else:
        got = masks.merge_content_style_masks(seg, ring, 95, 0.5)
    err = np.abs(got.numpy() - np.load(os.path.join(ROOT, "tests/golden", f"{name}.npy")))
    assert err.max() < 5e-2 and err.mean() < 5e-3, (name, err.max(), err.mean())
