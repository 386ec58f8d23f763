"""The port's two UIs (``tbist_tpu_torch.ui``) on the CPU: the requests they
build against the JAX package's, field by field; the gradio demo through
tests/fake_gradio.py; the terminal app with scripted input."""

import dataclasses
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import fake_gradio
from tbist_tpu.effects import pixel_art as jpa
from tbist_tpu.ui import basic_cli as jbasic
from tbist_tpu.ui import gradio_app as jgradio
from tbist_tpu_torch import api
from tbist_tpu_torch.ui import basic_cli as tbasic
from tbist_tpu_torch.ui import gradio_app as tgradio

BOAT = "data/content_imgs/boat.jpg"

# the widget values of tests/test_ui.py's request-builder cases
_WIDGETS = dict(
    text_style="night", text_location="boat", text_texture="fire",
    edge_smoothing=5.0, emoji_blur=95, emoji_step=0.5,
    emoji_strength=1.5, pixel_effects=[], pixel_size=0.4,
    palette_idx=0, palette_interp=False, edge_threshold=50,
    palette_from_image=False, palette_n_colors=10, style_weight=0.5,
    channel_attention=False, depth_mode=jgradio.DEPTH_EFFECTS[1],
    mip_n=2, interp_frames=0, slowmo=0.0,
)
_BUILDS = [
    dict(effects=[], text_effects=[]),
    dict(effects=[jgradio.MAIN_EFFECTS[1]],
         text_effects=[jgradio.TEXT_EFFECTS[0], jgradio.TEXT_EFFECTS[2]]),
    dict(effects=[jgradio.MAIN_EFFECTS[6]], text_effects=[],
         depth_mode=jgradio.DEPTH_EFFECTS[0]),
    dict(effects=[jgradio.MAIN_EFFECTS[6]], text_effects=[],
         depth_mode=jgradio.DEPTH_EFFECTS[1]),
    dict(effects=[jgradio.MAIN_EFFECTS[4]], text_effects=[], style_weight=0.8),
    dict(effects=list(jgradio.MAIN_EFFECTS), text_effects=list(jgradio.TEXT_EFFECTS),
         pixel_effects=list(jgradio.PIXEL_EFFECTS), palette_from_image=True,
         channel_attention=True, interp_frames=2, slowmo=0.5),
]


def test_constants_match_jax():
    assert tbasic.MODES == jbasic.MODES
    for name in ("MAIN_EFFECTS", "TEXT_EFFECTS", "PIXEL_EFFECTS", "DEPTH_EFFECTS"):
        assert getattr(tgradio, name) == getattr(jgradio, name)


@pytest.mark.parametrize("mode", range(9))
def test_request_for_matches_jax(mode):
    prompts = {"transfer": "t", "location": "l", "texture": "x"}
    assert (dataclasses.asdict(tbasic._request_for(mode, prompts))
            == dataclasses.asdict(jbasic._request_for(mode, prompts)))


@pytest.mark.parametrize("case", range(len(_BUILDS)))
def test_build_request_matches_jax(case):
    args = {**_WIDGETS, **_BUILDS[case]}
    assert (dataclasses.asdict(tgradio._build_request(**args))
            == dataclasses.asdict(jgradio._build_request(**args)))


@pytest.mark.parametrize("interpolate", [False, True])
def test_palette_list_display_matches_jax(interpolate):
    got = tgradio.palette_list_display(size=(8, 64), interpolate=interpolate)
    want = jgradio.palette_list_display(size=(8, 64), interpolate=interpolate)
    assert len(got) == len(want) == len(jpa.load_palette_list()) == 70
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_palette_preview_matches_jax():
    for idx in range(len(jpa.load_palette_list())):
        for interp in (False, True):
            np.testing.assert_array_equal(
                tgradio.palette_preview(idx, interp, False, None, 10, size=(8, 64)),
                jgradio.palette_preview(idx, interp, False, None, 10, size=(8, 64)))
    blank = tgradio.palette_preview(None, False, False, None, 10)
    np.testing.assert_array_equal(blank, jgradio.palette_preview(None, False, False, None, 10))


def test_palette_preview_from_image():
    """From an uploaded image: one colour is the mean (the same strip as the
    JAX package's); two colours keep the red cluster, as tests/test_ui.py
    checks. The k-means start is the port's own draw, so a strip of more
    colours than one need not equal JAX's."""
    img = np.zeros((16, 16, 3), np.uint8)
    img[:, 8:] = (200, 40, 40)
    got = tgradio.palette_preview(0, False, True, img, 1, size=(8, 64), device="cpu")
    np.testing.assert_array_equal(got, jgradio.palette_preview(0, False, True, img, 1,
                                                               size=(8, 64)))
    got = tgradio.palette_preview(0, False, True, img, 2, size=(8, 64), device="cpu")
    colors = np.unique(got.reshape(-1, 3), axis=0)
    assert got.shape == (8, 64, 3) and len(colors) <= 3 and any(c[0] > 150 for c in colors)


def test_build_demo_without_gradio_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio fails
    with pytest.raises(ImportError, match="gradio is not installed"):
        tgradio.build_demo(device="cpu")


def test_basic_cli_mode0_matches_api(tmp_path, monkeypatch, capsys):
    out = tmp_path / "o.png"
    small = tmp_path / "boat32.png"
    Image.open(BOAT).convert("RGB").resize((32, 32)).save(small)
    answers = iter(["0", str(small), "mosaic", str(out)])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert tbasic.main(["--device", "cpu"]) == 0
    assert "saved" in capsys.readouterr().out
    want = api.apply_image(str(small), tbasic._request_for(0, {"transfer": "mosaic"}),
                           device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out)), np.asarray(want))


def test_basic_cli_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    answers = iter(["7", BOAT, BOAT, ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbasic.main([])


@pytest.fixture(scope="module")
def demo(request):
    sys.modules["gradio"] = fake_gradio
    request.addfinalizer(lambda: sys.modules.pop("gradio", None))
    return tgradio.build_demo(device="cpu")


class TestDemo:
    """The demo through the fake-gradio shim, as tests/test_gradio_ui.py
    drives the JAX package's."""

    def test_widgets_match_jax(self, demo):
        sys.modules["gradio"] = fake_gradio
        jdemo = jgradio.build_demo()
        spec = lambda d: [(type(c).__name__, c.label, c.value if not isinstance(
            c.value, np.ndarray) else None, c.kwargs.get("choices")) for c in d.components]
        assert spec(demo) == spec(jdemo)
        assert [(e.kind, len(e.inputs), len(e.outputs)) for e in demo.events] == [
            (e.kind, len(e.inputs), len(e.outputs)) for e in jdemo.events]

    def test_every_event_fires_with_defaults(self, demo):
        assert demo.events, "no events registered"
        for ev in demo.events:
            fake_gradio.fire(ev)  # fire() asserts output arity

    def test_depth_preview_runs_on_the_device(self, demo, tmp_path):
        p = tmp_path / "in.png"
        Image.fromarray((np.random.default_rng(0).random((24, 24, 3)) * 255)
                        .astype(np.uint8)).save(p)
        (ev,) = [e for e in demo.events if e.kind == "click" and len(e.inputs) == 2]
        layers = fake_gradio.fire(ev, {demo.find("Input image"): str(p),
                                       demo.find("MIP layers"): 3})
        assert len(layers) == 3 and all(l.shape == (24, 24, 3) for l in layers)

    def test_grayscale_image_roundtrip(self, demo, tmp_path):
        rgb = np.zeros((24, 24, 3), np.uint8)
        rgb[:, :, 0] = 200  # strongly red, so that grayscale visibly changes it
        p = tmp_path / "in.png"
        Image.fromarray(rgb).save(p)
        (ev,) = [e for e in demo.events if len(e.inputs) == 30]
        img, video = fake_gradio.fire(ev, {demo.find("Input image"): str(p),
                                           demo.find("Effects"): ["Convert Output to Grayscale"]})
        assert video is None
        assert isinstance(img, np.ndarray) and img.shape == (24, 24, 3)
        assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] == img[..., 2]).all()
        assert 40 < int(img[..., 0].mean()) < 80

    def test_run_with_no_image_returns_none(self, demo):
        (ev,) = [e for e in demo.events if len(e.inputs) == 30]
        img, video = fake_gradio.fire(ev, {demo.find("Effects"): ["Convert Output to Grayscale"]})
        assert img is None and video is None
