"""The port's cheap effects on the CPU against the JAX package: grayscale and
Reinhard (``ops/colorspace``, ``effects/basic``), Canny, the palette
quantizer and k-means (``ops/canny``, ``ops/palette``), pixel art, MIP
binning with the fallback depth, SE channel attention, their goldens, the
pipeline stages and the CLI flags."""

import ast
import dataclasses
import filecmp
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tbist_tpu import cli as jcli
from tbist_tpu.effects import basic as jbasic
from tbist_tpu.effects import depth as jdepth
from tbist_tpu.effects import pixel_art as jpa
from tbist_tpu.models import channel_attention as jca
from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.ops import canny as jcanny
from tbist_tpu.ops import colorspace as jcs
from tbist_tpu.ops import mip as jmip
from tbist_tpu.ops import palette as jpal
from tbist_tpu.optimize import gatys as jgatys
from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils import imageio as jio
from tbist_tpu_torch import cli
from tbist_tpu_torch.compose import pipeline
from tbist_tpu_torch.effects import basic, depth, pixel_art
from tbist_tpu_torch.models import channel_attention
from tbist_tpu_torch.ops import canny, colorspace, mip, palette
from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.utils import imageio as tio
from tbist_tpu_torch.utils.config import EffectRequest, GatysConfig, PixelArtConfig
from tbist_tpu_torch.weights.vgg import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOAT = os.path.join(ROOT, "data/content_imgs/boat.jpg")
STARRY = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")
SUNSET = os.path.join(ROOT, "data/style_imgs/sunset.png")
PIXEL_TOL = 1e-3  # share of pixels two implementations may disagree on


def _pair(path, max_side=64):
    """The same image through both packages' loaders (bucketed to 32)."""
    j = jio.to_device(tio.load_image(path), bucket=32, max_side=max_side)
    return j, torch.from_numpy(np.array(j, np.float32))


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).random(shape) * scale).astype(np.float32)


def _differing(a, b):
    """Pixels (last axis = channels) whose values differ beyond float noise."""
    return int((np.abs(np.asarray(a) - np.asarray(b)) > 1e-6).any(-1).sum())


# ---------------------------------------------------------------------------
# grayscale and Reinhard
# ---------------------------------------------------------------------------


def test_grayscale_matches_jax():
    x = _rand(0, (2, 24, 40, 3))
    want = np.asarray(jbasic.grayscale(jnp.asarray(x)))
    got = basic.grayscale(torch.from_numpy(x))
    assert got.shape == (2, 24, 40, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    gray = colorspace.rgb_to_grayscale(torch.from_numpy(x), keep_rgb=False)
    np.testing.assert_allclose(gray.numpy(), np.asarray(jcs.rgb_to_grayscale(x, False)),
                               atol=1e-5)


@pytest.mark.parametrize("src_shape,tgt_shape", [
    ((1, 32, 32, 3), (1, 32, 32, 3)),
    ((2, 32, 48, 3), (1, 40, 24, 3)),  # batched source, target of another size
    ((20, 30, 3), (1, 1, 1, 3)),  # unbatched source, one-pixel target (std 0)
])
def test_reinhard_matches_jax(src_shape, tgt_shape):
    src, tgt = _rand(1, src_shape), _rand(2, tgt_shape)
    src[..., 0] *= 0.5  # distinct channel statistics
    want = np.asarray(jcs.reinhard_color_transfer(jnp.asarray(src), jnp.asarray(tgt)))
    got = basic.color_palette_transfer(torch.from_numpy(src), torch.from_numpy(tgt))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_reinhard_batch_is_per_image():
    src, tgt = _rand(3, (2, 16, 16, 3)), _rand(4, (1, 24, 24, 3))
    both = basic.color_palette_transfer(torch.from_numpy(src), torch.from_numpy(tgt))
    for i in range(2):
        one = basic.color_palette_transfer(torch.from_numpy(src[i : i + 1]),
                                           torch.from_numpy(tgt))
        torch.testing.assert_close(both[i : i + 1], one, rtol=0, atol=1e-6)


def test_ruderman_round_trip():
    x = torch.from_numpy(_rand(5, (4, 4, 3)) * 0.9 + 0.05)
    back = colorspace.ruderman_to_rgb(colorspace.rgb_to_ruderman(x))
    torch.testing.assert_close(back, x, rtol=0, atol=1e-4)  # the log's eps shifts it


# ---------------------------------------------------------------------------
# Canny
# ---------------------------------------------------------------------------


def _gray_inputs():
    boat = np.asarray(_pair(BOAT)[0][0]) @ np.float32([0.299, 0.587, 0.114]) * 255
    blocks = np.kron(np.random.default_rng(6).integers(0, 4, (8, 10)), np.ones((5, 5)))
    return {"boat": boat.astype(np.float32), "noise": _rand(7, (33, 47), 255.0),
            "blocks": (blocks * 60.0).astype(np.float32), "thin": _rand(8, (1, 9), 255.0)}


@pytest.mark.parametrize("name,low,high", [("boat", 50.0, 100.0), ("noise", 150.0, 300.0),
                                           ("blocks", 50.0, 100.0), ("thin", 20.0, 40.0)])
def test_canny_matches_jax(name, low, high):
    g = _gray_inputs()[name]
    want = np.asarray(jcanny.canny(jnp.asarray(g), low, high))
    got = canny.canny(torch.from_numpy(g)[None], low, high)[0].numpy()
    n_diff = int((got != want).sum())
    print(f"canny {name} {low}/{high}: {n_diff} of {g.size} pixels differ, "
          f"{int(want.sum())} edges")
    assert n_diff <= PIXEL_TOL * g.size


def test_sobel_bits_match_jax():
    g = _gray_inputs()["noise"]
    gx, gy = canny.sobel(torch.from_numpy(g)[None])
    np.testing.assert_array_equal(gx[0].numpy(),
                                  np.asarray(jcanny._conv2d_same(jnp.asarray(g), jcanny._SOBEL_X)))
    np.testing.assert_array_equal(gy[0].numpy(),
                                  np.asarray(jcanny._conv2d_same(jnp.asarray(g), jcanny._SOBEL_Y)))


def test_canny_batch_is_per_frame():
    gs = _gray_inputs()
    frames = torch.from_numpy(np.stack([gs["noise"], gs["noise"][::-1].copy()]))
    both = canny.canny(frames, 50.0, 100.0)
    for i in range(2):
        torch.testing.assert_close(both[i], canny.canny(frames[i : i + 1], 50.0, 100.0)[0])


def test_dilate_padding_agrees_with_reduce_window_on_nonnegative_values():
    """max_pool2d pads with -inf and reduce_window (init 0) with 0: equal on
    values >= 0, the only values the hysteresis gives it; on a negative
    border they would differ."""
    m = (_rand(9, (1, 12, 14)) > 0.7).astype(np.float32)
    want = np.asarray(jcanny._dilate3(jnp.asarray(m[0])))
    np.testing.assert_array_equal(canny.dilate3(torch.from_numpy(m))[0].numpy(), want)
    neg = -np.ones((1, 5, 5), np.float32)
    assert float(canny.dilate3(torch.from_numpy(neg)).max()) == -1.0
    assert float(np.asarray(jcanny._dilate3(jnp.asarray(neg[0]))).max()) == 0.0


@pytest.mark.parametrize("value", [-20, 0, 1, 37.5, 50, 100, 250])
def test_remap_threshold_matches_jax(value):
    assert canny.remap_threshold(value) == jcanny.remap_threshold(value)


# ---------------------------------------------------------------------------
# palette: quantizer, k-means, strips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interpolate", [False, True])
def test_quantize_matches_jax(interpolate):
    img = _rand(10, (1, 40, 40, 3), 255.0)
    strip = jpa.palette_strip(jpa.get_palette(11), interpolate).astype(np.float32)
    want = np.asarray(jpal.quantize_to_palette(jnp.asarray(img), jnp.asarray(strip)))
    for pal in (strip, pixel_art.first_occurrences(strip)):  # the full strip and its colors
        got = palette.quantize_to_palette(torch.from_numpy(img), torch.from_numpy(pal)).numpy()
        assert (got == want).all(-1).mean() >= 1 - PIXEL_TOL


def _jax_init_idx(n, k, seed=0):
    """The centres' indices ``kmeans`` draws for ``jax.random.key(seed)``."""
    return torch.from_numpy(np.array(jax.random.choice(jax.random.key(seed), n, (k,),
                                                        replace=False)))


@pytest.mark.parametrize("k", [1, 6, 10])
def test_kmeans_matches_jax_with_its_init(k):
    img = np.array(_pair(BOAT)[0][0])
    flat = img.reshape(-1, 3) * np.float32(255.0)
    jc, jl = jpal.kmeans(jnp.asarray(flat), k, jax.random.key(0))
    tc, tl = palette.kmeans(torch.from_numpy(flat), k, init_idx=_jax_init_idx(len(flat), k))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    assert (tl.numpy() == np.asarray(jl)).mean() >= 1 - PIXEL_TOL
    want = jpal.palette_from_image(img, k, jax.random.key(0))
    got = palette.palette_from_image(torch.from_numpy(img), k,
                                     init_idx=_jax_init_idx(len(flat), k))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_kmeans_empty_cluster_keeps_its_centre_and_draw_is_seeded():
    x = torch.tensor([[0.0, 0, 0], [0, 0, 0], [10, 10, 10]])
    centres, labels = palette.kmeans(x, 2, init_idx=torch.tensor([0, 1]), iters=1)
    # both start at the origin: the first takes every tie, the second stays put
    torch.testing.assert_close(centres, torch.tensor([[10 / 3] * 3, [0.0] * 3]))
    assert labels.tolist() == [1, 1, 0]
    centres, labels = palette.kmeans(x, 2, init_idx=torch.tensor([0, 1]))
    torch.testing.assert_close(centres, torch.tensor([[10.0] * 3, [0.0] * 3]))
    a, b = palette.draw_init_idx(1000, 8), palette.draw_init_idx(1000, 8)
    assert a.tolist() == b.tolist() and len(set(a.tolist())) == 8
    assert a.tolist() != palette.draw_init_idx(1000, 8, seed=1).tolist()


def test_init_idx_draw_is_uniform_over_ordered_samples():
    """Over 2400 seeds every ordered pair of distinct indices of 4 comes up
    about 200 times, as from ``jax.random.choice(key, 4, (2,),
    replace=False)``: 5 standard deviations either way."""
    counts = {}
    for seed in range(2400):
        pair = tuple(palette.draw_init_idx(4, 2, seed).tolist())
        counts[pair] = counts.get(pair, 0) + 1
    assert len(counts) == 12 and all(a != b for a, b in counts)
    assert all(130 <= c <= 270 for c in counts.values()), counts
    assert palette.draw_init_idx(5, 5).sort().values.tolist() == list(range(5))


@pytest.mark.parametrize("interpolate", [False, True])
@pytest.mark.parametrize("number", [0, 11, 69])
def test_render_palette_strip_matches_jax(interpolate, number):
    pal = pixel_art.get_palette(number)
    np.testing.assert_array_equal(pal, jpa.get_palette(number))
    np.testing.assert_array_equal(palette.render_palette_strip(pal, (3, 100), interpolate),
                                  jpal.render_palette_strip(pal, (3, 100), interpolate))
    np.testing.assert_array_equal(pixel_art.palette_strip(pal, interpolate),
                                  jpa.palette_strip(pal, interpolate))


def test_palettes_json_is_the_jax_packages():
    ours = os.path.join(ROOT, "tbist_tpu_torch/effects/data/palettes.json")
    assert filecmp.cmp(ours, os.path.join(ROOT, "tbist_tpu/effects/data/palettes.json"),
                       shallow=False)
    assert len(pixel_art.load_palette_list()) == 70


# ---------------------------------------------------------------------------
# pixel art
# ---------------------------------------------------------------------------

PIXEL_CASES = {
    "palette": dict(pixel_size=0.25, use_palette=True, palette_number=5),
    "edges": dict(edge_detect=True, edge_threshold=50),
    "palette_edges": dict(use_palette=True, palette_number=3, edge_detect=True),
    "interpolate": dict(use_palette=True, palette_number=7, interpolate=True, pixel_size=0.3,
                        edge_detect=True, edge_threshold=80),
    "from_image": dict(use_palette=True, palette_from_image=True, palette_num_colors=8,
                       edge_detect=True),
    "tiny": dict(pixel_size=0.01, edge_detect=True),  # a 1x1 small image
}


@pytest.mark.parametrize("case", list(PIXEL_CASES))
def test_pixel_art_matches_jax(case):
    j, t = _pair(BOAT)
    kw = PIXEL_CASES[case]
    want = np.asarray(jpa.pixel_art(j, jconfig.PixelArtConfig(**kw)))
    init = _jax_init_idx(t.shape[1] * t.shape[2], 8) if kw.get("palette_from_image") else None
    got = pixel_art.pixel_art(t, PixelArtConfig(**kw), init_idx=init).numpy()
    n_diff = _differing(got, want)
    print(f"pixel art {case}: {n_diff} of {t.shape[1] * t.shape[2]} pixels differ")
    assert got.shape == t.shape and n_diff <= PIXEL_TOL * t.shape[1] * t.shape[2]


def test_pixel_art_zero_slider_disables_edges():
    _, t = _pair(BOAT)
    off = pixel_art.pixel_art(t, PixelArtConfig(edge_detect=True, edge_threshold=0))
    torch.testing.assert_close(off, pixel_art.pixel_art(t, PixelArtConfig()))
    assert not torch.equal(off, pixel_art.pixel_art(t, PixelArtConfig(edge_detect=True)))


# ---------------------------------------------------------------------------
# MIP and the fallback depth
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 5])
def test_mip_matches_jax(n):
    j, t = _pair(BOAT)
    jd = jdepth._fallback_depth(j)
    td = depth._fallback_depth(t)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(mip.normalize_depth(td * 3 + 1).numpy(),
                               np.asarray(jmip.normalize_depth(jd * 3 + 1)), atol=1e-6)
    np.testing.assert_array_equal(mip.create_bins(n), jmip.create_bins(n))
    np.testing.assert_array_equal(mip.bin_masks(td, n).numpy(), np.asarray(jmip.bin_masks(jd, n)))
    layers = mip.generate_layers(t, td, n)
    np.testing.assert_allclose(layers.numpy(), np.asarray(jmip.generate_layers(j, jd, n)),
                               atol=1e-6)
    np.testing.assert_allclose(mip.reconstruct(layers * 1.5, td, n).numpy(),
                               np.asarray(jmip.reconstruct(jmip.generate_layers(j, jd, n) * 1.5,
                                                           jd, n)), atol=1e-6)


# ---------------------------------------------------------------------------
# the goldens (tests/test_golden.py's cases and limits)
# ---------------------------------------------------------------------------


def _golden_case(name):
    _, content = _pair(BOAT)
    if name == "reinhard":
        return basic.color_palette_transfer(content, _pair(STARRY)[1])[0]
    if name == "pixel_art":
        cfg = PixelArtConfig(pixel_size=0.25, use_palette=True, palette_number=5)
        return pixel_art.pixel_art(content, cfg)[0]
    d = depth._fallback_depth(content)
    return mip.reconstruct(mip.generate_layers(content, d, 3), d, 3)


@pytest.mark.parametrize("name", ["reinhard", "pixel_art", "mip_roundtrip"])
def test_golden(name):
    want = np.load(os.path.join(ROOT, "tests/golden", f"{name}.npy"))
    err = np.abs(_golden_case(name).numpy() - want)
    assert err.max() < 5e-2 and err.mean() < 5e-3, (name, err.max(), err.mean())


# ---------------------------------------------------------------------------
# channel attention
# ---------------------------------------------------------------------------


def _jax_ca_params(seed, layer, channels):
    """The SE weights the JAX package draws for ``layer`` (gatys.py:147-153)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), 1),
                             zlib.crc32(layer.encode()))
    return jca.init_params(key, channels)


def test_channel_attention_apply_matches_jax():
    jp = _jax_ca_params(101, "conv4_2", 64)
    x = _rand(11, (2, 6, 5, 64), 3.0)
    want = np.asarray(jca.apply(jp, jnp.asarray(x)))
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in jp.items()}
    np.testing.assert_allclose(channel_attention.apply(tp, torch.from_numpy(x)).numpy(), want,
                               atol=1e-6)
    bf = channel_attention.apply(tp, torch.from_numpy(x).bfloat16())
    assert bf.dtype == torch.float32  # promoted, as in JAX


def test_channel_attention_draw_is_seeded_by_layer():
    def draw(seed, layer):
        gen = torch.Generator().manual_seed(channel_attention.layer_seed(seed, layer))
        return channel_attention.init_params(gen, 512)

    a, b = draw(101, "conv4_2"), draw(101, "conv4_2")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1"], draw(101, "conv5_2")["fc1"])
    assert not torch.equal(a["fc1"], draw(7, "conv4_2")["fc1"])
    assert a["fc1"].shape == (512, 256) and a["fc2"].shape == (256, 512)
    assert float(a["fc1"].abs().max()) <= 512 ** -0.5
    assert float(a["fc2"].abs().max()) <= 256 ** -0.5
    assert float(a["fc1"].abs().max()) > 0.9 * 512 ** -0.5  # the whole range is used


def _vgg_params():
    """He-init VGG-19 weights drawn with numpy in the JAX package's tree
    (traced for its shapes only), shared by both packages."""
    rng = np.random.default_rng(0)

    def leaf(a):
        if len(a.shape) < 4:
            return np.zeros(a.shape, np.float32)
        fan_in = a.shape[0] * a.shape[1] * a.shape[2]
        return (rng.standard_normal(a.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    jparams = jax.tree.map(leaf, jax.eval_shape(jvgg.init_params, jax.random.key(0)))
    return jparams, from_jax_params(jparams)


def test_gatys_with_channel_attention_matches_jax():
    jparams, tparams = _vgg_params()
    (jc, tc), (js, ts) = _pair(BOAT, 32), _pair(STARRY, 32)
    kw = dict(num_steps=4, w_style=1e4, channel_attention=True)
    jout, jhist = jgatys.stylize(jc, [js], jconfig.GatysConfig(**kw), jparams)
    ca = {"conv4_2": {k: torch.from_numpy(np.array(v, np.float32))
                      for k, v in _jax_ca_params(101, "conv4_2", 512).items()}}
    tout, thist = gatys.stylize(tc, [ts], GatysConfig(**kw), tparams, device="cpu",
                                channel_attention_params=ca)
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), rtol=1e-3)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-2)
    drawn, _ = gatys.stylize(tc, [ts], GatysConfig(**kw), tparams, device="cpu")
    assert not torch.allclose(drawn, tout, atol=1e-4)  # its own draw: other weights


# ---------------------------------------------------------------------------
# inputs the caller already holds on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # one card: on a host with several, the mesh would shard these runs
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    return torch.device("cuda")


@pytest.mark.gpu
def test_upload_keeps_card_tensors_and_pins_host_ones(cuda):
    on_card = torch.arange(6, device=cuda)
    assert tio.upload(on_card, cuda) is on_card
    host = tio.upload(np.arange(6), cuda)
    assert host.device.type == "cuda" and host.tolist() == list(range(6))
    assert tio.upload(on_card, "cpu").tolist() == list(range(6))


@pytest.mark.gpu
def test_kmeans_init_idx_on_card_matches_cpu(cuda):
    img = np.array(_pair(BOAT)[0][0])
    init = _jax_init_idx(img.shape[0] * img.shape[1], 6)
    want = palette.palette_from_image(torch.from_numpy(img), 6, init_idx=init)
    got = palette.palette_from_image(torch.from_numpy(img).to(cuda), 6, init_idx=init.to(cuda))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_gatys_channel_attention_weights_on_card(cuda):
    _, tparams = _vgg_params()
    (_, tc), (_, ts) = _pair(BOAT, 32), _pair(STARRY, 32)
    cfg = GatysConfig(num_steps=2, w_style=1e4, channel_attention=True)
    ca = {"conv4_2": {k: torch.from_numpy(np.array(v, np.float32))
                      for k, v in _jax_ca_params(101, "conv4_2", 512).items()}}
    _, want = gatys.stylize(tc, [ts], cfg, tparams, device="cpu", channel_attention_params=ca)
    ca_card = {layer: {k: v.to(cuda) for k, v in p.items()} for layer, p in ca.items()}
    out, hist = gatys.stylize(tc, [ts], cfg, tparams, device=cuda,
                              channel_attention_params=ca_card)
    assert out.device.type == "cuda"
    np.testing.assert_allclose(hist.cpu().numpy(), want.numpy(), rtol=1e-3)


# ---------------------------------------------------------------------------
# the pipeline's stages 1, 3 and 6, and the CLI
# ---------------------------------------------------------------------------


def test_pipeline_stages_1_3_6():
    _, t = _pair(BOAT)
    _, target = _pair(SUNSET)
    reg = pipeline.ModelRegistry(device="cpu")
    gray = pipeline.apply_image(t, EffectRequest(grayscale=True), None, reg)
    torch.testing.assert_close(gray, basic.grayscale(t))
    pcfg = PixelArtConfig(use_palette=True, palette_number=3, edge_detect=True)
    req = EffectRequest(grayscale=True, pixel_art=pcfg, color_palette=True)
    assert pipeline.apply_image(t, req, None, reg) is None  # no palette target
    out = pipeline.apply_image(t, req, pipeline.EffectInputs(color_palette_image=target), reg)
    want = basic.color_palette_transfer(pixel_art.pixel_art(basic.grayscale(t), pcfg), target)
    torch.testing.assert_close(out, want)
    from_image = dataclasses.replace(pcfg, palette_from_image=True, palette_num_colors=5)
    assert pipeline.apply_image(t, EffectRequest(pixel_art=from_image), None, reg) is None
    got = pipeline.apply_image(t, EffectRequest(pixel_art=from_image),
                               pipeline.EffectInputs(pixel_palette_image=target), reg)
    pal = palette.palette_from_image(target[0], 5)  # drawn with seed 0, as the stage does
    torch.testing.assert_close(got, pixel_art.pixel_art(t, from_image, palette=pal))
    # the last model of the JAX registry: without a checkpoint, the fallback
    assert reg.ensure("depth_estimator").depth_estimator is depth._fallback_depth


def _small_inputs(tmp_path):
    paths = {}
    for src, name, size in ((BOAT, "c.png", (64, 64)), (SUNSET, "p.png", (48, 80))):
        Image.open(src).convert("RGB").resize(size).save(tmp_path / name)
        paths[name[0]] = str(tmp_path / name)
    return paths


@pytest.mark.parametrize("flags", [
    ["--grayscale"],
    ["--color-palette", "{p}"],
    ["--pixel-art", "--pixel-palette", "3", "--pixel-edges"],
    ["--text-location", "boat", "--pixel-art", "--pixel-palette", "3", "--pixel-edges"],
    ["--grayscale", "--pixel-art", "--pixel-interpolate", "--pixel-palette", "9",
     "--color-palette", "{p}"],
])
def test_cli_matches_jax_cli(flags, tmp_path):
    paths = _small_inputs(tmp_path)
    flags = [f.format(p=paths["p"]) for f in flags]
    outs = []
    for mod, name in ((cli, "t.png"), (jcli, "j.png")):
        argv = ["--image", paths["c"], "--out", str(tmp_path / name), *flags]
        assert mod.main(argv + (["--device", "cpu"] if mod is cli else [])) == 0
        outs.append(np.asarray(Image.open(tmp_path / name)).astype(int))
    assert outs[0].shape == (64, 64, 3)
    n_diff = int((outs[0] != outs[1]).any(-1).sum())
    print(f"cli {' '.join(flags)}: {n_diff} of 4096 pixels differ from the JAX CLI's")
    assert n_diff <= PIXEL_TOL * 64 * 64
    args = cli.build_parser().parse_args(["--image", "x", "--out", "y", *flags])
    jargs = jcli.build_parser().parse_args(["--image", "x", "--out", "y", *flags])
    assert repr(cli.request_from_args(args)) == repr(jcli.request_from_args(jargs))


def test_cli_pixel_from_image_runs(tmp_path):
    paths = _small_inputs(tmp_path)
    out = tmp_path / "o.png"
    assert cli.main(["--image", paths["c"], "--pixel-art", "--pixel-from-image", paths["p"],
                     "--pixel-colors", "6", "--pixel-edges", "--device", "cpu",
                     "--out", str(out)]) == 0
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package, at the top or inside a function."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(ROOT, "tbist_tpu_torch"))
             for f in fs if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [(path, n) for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "tbist_tpu", "flax", "optax")]
    assert len(files) > 40 and bad == []
