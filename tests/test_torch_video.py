"""The port's video pipeline (``tbist_tpu_torch.video``) on the CPU against
``tbist_tpu.video.video``: decode, the cross-dissolve (bitwise), fps and
frame counts, the routing, every lane (the text style, the masked text
style, the Gatys lanes with one style, two styles and the depth loss), the
batchable chain, the general per-frame path, and the streaming helpers.

Both packages read the same cv2-written videos, made from a seed. The JAX
side runs on its 8 CPU devices and pads its chunks to the mesh; the frames
each side hands its stream writer (a spy) are compared, frame by frame."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.compose import pipeline as jpipe
from tbist_tpu.effects import depth as jdepth
from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.utils import config as jconfig
from tbist_tpu.video import video as jvid
from tbist_tpu_torch import api
from tbist_tpu_torch.compose import pipeline as tpipe
from tbist_tpu_torch.effects import depth as tdepth
from tbist_tpu_torch.parallel import batched
from tbist_tpu_torch.utils import config as tconfig
from tbist_tpu_torch.video import video as tvid
from tbist_tpu_torch.weights.vgg import from_jax_params

JPARAMS = jvgg.init_params(jax.random.key(0))
TPARAMS = from_jax_params(jax.tree.map(np.asarray, JPARAMS))


def _write_video(path, n=5, size=(48, 32), fps=8.0, seed=0):
    """A smooth seeded gradient that drifts a few pixels a frame, plus noise."""
    rng = np.random.default_rng(seed)
    w, h = size
    yy, xx = np.mgrid[0:h, 0:w]
    base = rng.random(3) * 255
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    for i in range(n):
        f = base + 90 * np.sin((xx[..., None] + 3 * i) / 7 + np.arange(3)) \
            + 60 * np.cos(yy[..., None] / 5) + rng.normal(0, 8, (h, w, 3))
        out.write(np.clip(f, 0, 255).astype(np.uint8))
    out.release()
    return path


@pytest.fixture
def video(tmp_path):
    return lambda n=5, size=(48, 32), fps=8.0: _write_video(str(tmp_path / "in.mp4"), n, size,
                                                           fps)


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setenv("TBIST_GHIASI_BF16", "0")


def _spy(monkeypatch, mod):
    """The uint8 chunks ``mod``'s stream writer receives, in order."""
    chunks = []
    real = mod._StreamWriter.__call__

    def spy(self, chunk):
        chunks.append(np.array(chunk))
        return real(self, chunk)

    monkeypatch.setattr(mod._StreamWriter, "__call__", spy)
    return chunks


def _style(seed, size=32):
    return np.random.default_rng(seed).random((1, size, size, 3)).astype(np.float32)


def _run_both(monkeypatch, tmp_path, in_path, make_req, jinputs=None, tinputs=None,
              jreg=None, treg=None):
    """Both packages' apply_video on one video: (JAX frames, port frames),
    each the concatenation of what its stream writer received."""
    jchunks, tchunks = _spy(monkeypatch, jvid), _spy(monkeypatch, tvid)
    jout = jvid.apply_video(in_path, make_req(jconfig), jinputs or jpipe.EffectInputs(), jreg,
                            out_path=str(tmp_path / "j.mp4"))
    tout = tvid.apply_video(in_path, make_req(tconfig), tinputs or tpipe.EffectInputs(),
                            treg or tpipe.ModelRegistry(device="cpu"),
                            out_path=str(tmp_path / "t.mp4"), device="cpu")
    assert jout and tout and os.path.exists(tout)
    return np.concatenate(jchunks), np.concatenate(tchunks)


def _levels(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


# ---------------------------------------------------------------------------
# host I/O and the dissolve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk, rgb, max_frames", [(3, True, None), (4, False, None),
                                                    (4, True, 5)])
def test_read_frames_and_chunks_match_jax(video, chunk, rgb, max_frames):
    path = video(n=7)
    got = list(tvid.read_frame_chunks(path, chunk, max_frames, rgb=rgb))
    want = list(jvid.read_frame_chunks(path, chunk, max_frames, rgb=rgb))
    assert [c.shape[0] for c in got] == [c.shape[0] for c in want]
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    frames, fps = tvid.read_frames(path, max_frames)
    jframes, jfps = jvid.read_frames(path, max_frames)
    assert fps == jfps == tvid.probe_fps(path)
    np.testing.assert_array_equal(np.stack(frames), np.stack(jframes))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_dissolve_matches_jax_bitwise(k):
    """``_dissolve_chunk`` equals the JAX package's jitted dissolve (one
    rounding for a product and the sum) and ``cross_dissolve`` its eager one
    (three roundings), bit for bit; the two differ at k = 2 and 5."""
    rng = np.random.default_rng(k)
    prev = (rng.random((1, 20, 30, 3)) * 256).astype(np.uint8)
    chunk = (rng.random((5, 20, 30, 3)) * 256).astype(np.uint8)
    got = tvid._dissolve_chunk(torch.from_numpy(prev), torch.from_numpy(chunk), k).numpy()
    want = np.asarray(jvid._dissolve_chunk_jit(jnp.asarray(prev), jnp.asarray(chunk), k))
    assert got.shape == (5 * (k + 1), 20, 30, 3)
    np.testing.assert_array_equal(got, want)
    frames = list(np.concatenate([prev, chunk]))
    np.testing.assert_array_equal(np.stack(tvid.cross_dissolve(frames, k)),
                                  np.stack(jvid.cross_dissolve(frames, k)))
    assert tvid.cross_dissolve(frames, 0) is frames


@pytest.mark.parametrize("k, bsz", [(2, 3), (3, 4)])
def test_dissolve_carried_across_chunks(k, bsz):
    """Unpadded chunks with the boundary frame carried emit what one
    dissolve over the whole video emits, and what the JAX package's padded
    streaming dissolve emits."""
    rng = np.random.default_rng(10 + k)
    stack = (rng.random((7, 12, 10, 3)) * 256).astype(np.uint8)
    got, prev = [], None
    for i in range(0, 7, bsz):
        out, prev = tvid._dissolve_step(prev, torch.from_numpy(stack[i:i + bsz]), k, i == 0)
        got.append(out.numpy())
    got = np.concatenate(got)
    whole, _ = tvid._dissolve_step(None, torch.from_numpy(stack), k, True)
    assert got.shape == (7 + 6 * k, 12, 10, 3)
    np.testing.assert_array_equal(got, whole.numpy())
    want, prev = [], None
    for i in range(0, 7, bsz):
        chunk, pad = jvid._pad_chunk(stack[i:i + bsz], bsz, 1, first=i == 0)
        out, prev = jvid._dissolve_step(prev, jnp.asarray(chunk), k, pad, first=i == 0)
        want.append(np.asarray(out))
    np.testing.assert_array_equal(got, np.concatenate(want))
    one, _ = tvid._dissolve_step(None, torch.from_numpy(stack[:1]), k, True)
    np.testing.assert_array_equal(one.numpy(), stack[:1])


def test_prefetch_order_error_and_close():
    assert list(tvid._Prefetch(iter(range(20)), depth=2)) == list(range(20))

    def boom():
        yield 1
        raise RuntimeError("decode failed")

    p = tvid._Prefetch(boom())
    assert next(p) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(p)

    released = []

    def slow():
        try:
            yield from range(1000)
        finally:
            released.append(True)

    p = tvid._Prefetch(slow(), depth=2)
    assert next(p) == 0
    p.close()  # a full queue and an unfinished generator must not hang
    assert not p._t.is_alive()
    assert released == [True]


def test_fetch_pipeline_keeps_order_and_reraises():
    got = []
    fetch = tvid._FetchPipeline(got.append, window=2)
    for i in range(7):
        fetch.submit(torch.full((1, 2, 2, 3), i, dtype=torch.uint8))
    fetch.close()
    assert [int(c[0, 0, 0, 0]) for c in got] == list(range(7))

    def fail(_):
        raise OSError("disk full")

    fetch = tvid._FetchPipeline(fail)
    fetch.submit(torch.zeros((1, 2, 2, 3), dtype=torch.uint8))
    with pytest.raises(OSError, match="disk full"):
        fetch.close()


def test_stream_writer_opens_lazily(tmp_path):
    path = str(tmp_path / "o.mp4")
    w = tvid._StreamWriter(path, 8.0)
    assert w._wr is None and not os.path.exists(path)
    w(np.zeros((2, 32, 48, 3), np.uint8))
    w(np.full((1, 32, 48, 3), 255, np.uint8))
    w.close()
    frames, fps = tvid.read_frames(path)
    assert len(frames) == 3 and frames[0].shape == (32, 48, 3) and fps == 8.0


# ---------------------------------------------------------------------------
# requests: routing, fps and frame counts, invalid input
# ---------------------------------------------------------------------------

_ROUTES = ("_is_pure_style_request", "_is_pure_mixing_request", "_is_pure_masked_text_request",
           "_is_pure_depth_request", "_is_pure_text_transfer_request", "_is_batchable_chain")


@pytest.mark.parametrize("make", [
    lambda c: c.EffectRequest(style_transfer=True),
    lambda c: c.EffectRequest(style_transfer=True, grayscale=True),
    lambda c: c.EffectRequest(style_mixing=True),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(style_prompt="mosaic")),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(style_prompt="m", location_prompt="b")),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(style_prompt="m", texture_prompt="f")),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(style_prompt="m", location_prompt="b",
                                                      mask_square=True)),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(style_prompt="m", location_prompt="b",
                                                      mask_crop=(1, 0, 0, 0))),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(style_prompt="m", location_prompt="b",
                                                      mask_resize=(64, 64))),
    lambda c: c.EffectRequest(text=c.TextEffectConfig(location_prompt="b")),
    lambda c: c.EffectRequest(depth=c.DepthConfig(mode="depth_loss")),
    lambda c: c.EffectRequest(depth=c.DepthConfig(mode="mip")),
    lambda c: c.EffectRequest(grayscale=True, pixel_art=c.PixelArtConfig(), color_palette=True),
    lambda c: c.EffectRequest(),
])
def test_routing_matches_jax(make):
    for name in _ROUTES:
        assert getattr(tvid, name)(make(tconfig)) == getattr(jvid, name)(make(jconfig)), name


@pytest.mark.parametrize("n, fps, interp, slowmo", [(3, 8.0, 2, 0.0), (4, 8.0, 0, 0.5),
                                                    (3, 30.0, 2, 0.5), (2, 8.0, 0, 0.1)])
def test_fps_and_frame_count_match_jax(monkeypatch, tmp_path, video, n, fps, interp, slowmo):
    """--interp-frames and --slowmo: k frames between each pair, fps · (k+1),
    floored under slow motion, and at least 1 (8 fps at 0.1x floors to 0)."""
    in_path = video(n=n, fps=fps)

    def make(c):
        return c.EffectRequest(grayscale=True, video=c.VideoConfig(
            interpolation_frames=interp, slowmo=slowmo, frame_batch=2))

    want, got = _run_both(monkeypatch, tmp_path, in_path, make)
    assert got.shape[0] == want.shape[0] == n + (n - 1) * interp
    assert _levels(got, want).max() <= 1
    frames, out_fps = tvid.read_frames(str(tmp_path / "t.mp4"))
    assert len(frames) == got.shape[0]
    assert out_fps == jvid.probe_fps(str(tmp_path / "j.mp4"))
    assert out_fps == (max(1, int(fps * (interp + 1) * slowmo)) if slowmo else fps * (interp + 1))


def test_invalid_request_leaves_no_partial_file(tmp_path, video):
    """A colour palette with no palette image: None, and no mp4 on disk (the
    first chunk has been encoded when the request turns out invalid)."""
    in_path = video(n=4)
    out_path = str(tmp_path / "out.mp4")
    req = tconfig.EffectRequest(color_palette=True, video=tconfig.VideoConfig(frame_batch=2))
    assert tvid.apply_video(in_path, req, out_path=out_path, device="cpu") is None
    assert not os.path.exists(out_path)
    assert jvid.apply_video(in_path, jconfig.EffectRequest(color_palette=True),
                            out_path=str(tmp_path / "j.mp4")) is None


def test_missing_video_returns_none():
    req = tconfig.EffectRequest(grayscale=True)
    assert tvid.apply_video(None, req, device="cpu") is None
    assert tvid.apply_video("", req, device="cpu") is None
    assert api.apply_video(None, req, device="cpu") is None


# ---------------------------------------------------------------------------
# the lanes against the JAX package
# ---------------------------------------------------------------------------


def test_text_lane_matches_jax(monkeypatch, tmp_path, video, f32):
    """The feed-forward text style in BGR, 7 frames in chunks of 3 with 2
    dissolve frames, f32 on both sides: within 1 level. The streamed frames
    equal the buffered lane's."""
    in_path = video(n=7)
    spy = []
    real = tvid._batched_text_transfer
    monkeypatch.setattr(tvid, "_batched_text_transfer",
                        lambda *a, **kw: spy.append(kw.get("bgr")) or real(*a, **kw))

    def make(c):
        return c.EffectRequest(text=c.TextEffectConfig(style_prompt="mosaic"),
                               video=c.VideoConfig(frame_batch=3, interpolation_frames=2))

    want, got = _run_both(monkeypatch, tmp_path, in_path, make)
    assert spy == [True] and got.shape[0] == 7 + 6 * 2  # the lane, in BGR
    assert _levels(got, want).max() <= 1
    frames, _ = tvid.read_frames(in_path)
    buffered = tvid._batched_text_transfer(frames, make(tconfig), device="cpu")
    assert len(buffered) == 7
    np.testing.assert_array_equal(np.stack(buffered)[..., ::-1], got[::3])


def _mask_of(frame_u8):
    luma = frame_u8.astype(np.float32).mean(-1)
    return luma > luma.mean()


def _u8(image):
    arr = np.asarray(image.cpu() if isinstance(image, torch.Tensor) else image)
    arr = arr[0] if arr.ndim == 4 else arr
    return (np.clip(arr, 0, 1) * 255).astype(np.uint8) if arr.dtype.kind == "f" else arr


@pytest.mark.parametrize("location, texture, n", [("boat", None, 5), ("boat", "fire", 3),
                                                  (None, "fire", 3)])
def test_masked_text_lane_matches_jax(monkeypatch, tmp_path, video, f32, location, texture, n):
    """Location, location + texture and texture-only masks with stub
    extractors (a luma threshold), f32: within 1 level of the JAX lane. One
    batch extractor call a chunk; the texture-only mask is computed once."""
    in_path = video(n=n)
    calls = []

    def make(c):
        return c.EffectRequest(
            text=c.TextEffectConfig(style_prompt="mosaic", location_prompt=location,
                                    texture_prompt=texture, emoji_blur_strength=31),
            video=c.VideoConfig(frame_batch=2))

    def tbatch(frames, prompt):
        calls.append(tuple(frames.shape))
        return torch.stack([torch.from_numpy(_mask_of(f)) for f in frames.numpy()])

    jreg = jpipe.ModelRegistry(
        mask_extractor=lambda image, prompt: jnp.asarray(_mask_of(_u8(image))),
        batch_mask_extractor=lambda frames, prompt: jnp.stack(
            [jnp.asarray(_mask_of(f)) for f in np.asarray(frames)]))
    treg = tpipe.ModelRegistry(device="cpu", batch_mask_extractor=tbatch)
    merges = []
    real_merge = tvid.mask_ops.merge_content_style_masks
    monkeypatch.setattr(tvid.mask_ops, "merge_content_style_masks",
                        lambda *a: merges.append(1) or real_merge(*a))
    want, got = _run_both(monkeypatch, tmp_path, in_path, make, jreg=jreg, treg=treg)
    assert got.shape[0] == n
    assert _levels(got, want).max() <= 1
    assert calls == ([(2, 32, 48, 3)] * (n // 2) + [(1, 32, 48, 3)] * (n % 2) if location
                     else [])
    assert len(merges) == (0 if not texture else 1 if not location else n)


def test_lanes_flag_their_fallbacks(tmp_path, video):
    """A lane reports the fallbacks its loaders resolved, as the image path
    does: here the batch extractor's border prior and the seeded text style."""
    from tbist_tpu_torch.effects import masking
    from tbist_tpu_torch.models import clip_text
    from tbist_tpu_torch.utils.logging import RunMetrics
    from tbist_tpu_torch.weights import ghiasi_convert

    for loader in (ghiasi_convert.get_params, clip_text.get_default_encoder,
                   masking.default_batch_mask_extractor):
        loader.cache_clear()
    metrics = RunMetrics()
    req = tconfig.EffectRequest(text=tconfig.TextEffectConfig(style_prompt="mosaic",
                                                              location_prompt="boat"))
    assert tvid.apply_video(video(n=2), req, out_path=str(tmp_path / "o.mp4"),
                            metrics=metrics, device="cpu")
    assert {"mask_fallback", "ghiasi_seeded", "clip_text_fallback"} <= set(metrics.degraded)


@pytest.mark.parametrize("lane", ["style", "mixing", "depth"])
def test_gatys_lanes_match_jax(monkeypatch, tmp_path, video, lane):
    """One style, two-style mixing and the depth loss (the fallback depth) on
    5 frames of 32x32, 2 L-BFGS steps, one chunk of 5 lanes: within 2 levels
    of the JAX lanes. The lane hands batched.run the styles and depth term."""
    in_path = video(n=5, size=(32, 32))
    s1, s2 = _style(1), _style(2)
    gatys = dict(num_steps=2, w_style=1e3, w_edge=0.0, style_img_weight=0.3, shape_bucket=32,
                 max_side=32)

    def make(c):
        kw = {"style": dict(style_transfer=True), "mixing": dict(style_mixing=True),
              "depth": dict(depth=c.DepthConfig(mode="depth_loss", w_depth=50.0))}[lane]
        return c.EffectRequest(gatys=c.GatysConfig(**gatys), video=c.VideoConfig(frame_batch=8),
                               **kw)

    if lane == "mixing":
        jin = jpipe.EffectInputs(style_image1=jnp.asarray(s1), style_image2=jnp.asarray(s2))
        tin = tpipe.EffectInputs(style_image1=torch.from_numpy(s1),
                                 style_image2=torch.from_numpy(s2))
    else:
        jin, tin = jpipe.EffectInputs(style_image=jnp.asarray(s1)), tpipe.EffectInputs(
            style_image=torch.from_numpy(s1))
    seen = {}
    real_run = batched.run

    def spy_run(cfg, params, frames, styles, w_style=None, **kw):
        seen.update(n=frames.shape[0], styles=len(styles), w_depth=cfg.w_depth,
                    depth_fn=kw.get("depth_fn"))
        return real_run(cfg, params, frames, styles, w_style, **kw)

    monkeypatch.setattr(batched, "run", spy_run)
    jreg = jpipe.ModelRegistry(vgg_params=JPARAMS, depth_estimator=jdepth._fallback_depth)
    treg = tpipe.ModelRegistry(vgg_params=TPARAMS, device="cpu",
                               depth_estimator=tdepth._fallback_depth)
    want, got = _run_both(monkeypatch, tmp_path, in_path, make, jin, tin, jreg, treg)
    assert got.shape == (5, 32, 32, 3)
    assert seen["n"] == 5 and seen["styles"] == (2 if lane == "mixing" else 1)
    if lane == "depth":
        assert seen["depth_fn"] is tdepth._fallback_depth and seen["w_depth"] == 50.0
    assert _levels(got, want).max() <= 2


def test_batchable_chain_matches_jax(monkeypatch, tmp_path, video):
    """Grayscale + pixel art + colour palette, one apply_image call a chunk
    of real frames, 1 dissolve frame: within 1 level on all but 0.1% of the
    pixels."""
    in_path = video(n=5)
    pal = _style(3, 16)
    calls = []
    real_apply = tpipe.apply_image
    monkeypatch.setattr(tpipe, "apply_image",
                        lambda image, *a, **kw: calls.append(image.shape[0])
                        or real_apply(image, *a, **kw))

    def make(c):
        return c.EffectRequest(
            grayscale=True, color_palette=True,
            pixel_art=c.PixelArtConfig(pixel_size=0.5, use_palette=True, palette_number=3,
                                       edge_detect=True, edge_threshold=50),
            video=c.VideoConfig(frame_batch=2, interpolation_frames=1))

    want, got = _run_both(monkeypatch, tmp_path, in_path, make,
                          jpipe.EffectInputs(color_palette_image=jnp.asarray(pal)),
                          tpipe.EffectInputs(color_palette_image=torch.from_numpy(pal)))
    assert calls == [2, 2, 1]  # no pad frame
    assert got.shape[0] == 9
    diff = _levels(got, want)
    assert diff.max() <= 1 or np.mean(diff > 1) <= 1e-3, diff.max()


def test_general_path_mip_matches_jax(monkeypatch, tmp_path, video):
    """MIP (the fallback depth, 2 layers, 1 step) runs frame by frame on the
    general path: within 2 levels of the JAX package's."""
    in_path = video(n=2, size=(32, 32))
    calls = []
    real_apply = tpipe.apply_image
    monkeypatch.setattr(tpipe, "apply_image",
                        lambda image, *a, **kw: calls.append(image.shape[0])
                        or real_apply(image, *a, **kw))
    s = _style(4)

    def make(c):
        return c.EffectRequest(depth=c.DepthConfig(mode="mip", mip_layers=2),
                               gatys=c.GatysConfig(num_steps=1, shape_bucket=32, max_side=32),
                               video=c.VideoConfig(frame_batch=2))

    want, got = _run_both(monkeypatch, tmp_path, in_path, make,
                          jpipe.EffectInputs(style_image=jnp.asarray(s)),
                          tpipe.EffectInputs(style_image=torch.from_numpy(s)),
                          jpipe.ModelRegistry(vgg_params=JPARAMS,
                                              depth_estimator=jdepth._fallback_depth),
                          tpipe.ModelRegistry(vgg_params=TPARAMS, device="cpu",
                                              depth_estimator=tdepth._fallback_depth))
    assert calls == [1, 1]
    assert _levels(got, want).max() <= 2
