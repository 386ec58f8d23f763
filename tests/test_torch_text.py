"""The port's feed-forward text path on the CPU against the JAX package:
the numpy threefry draws, CLIP-MLP, Ghiasi (f32 and bf16), the fallback
embedding, ``perform_transfer_batch``, the CLIP text tower and tokenizer,
the micro-batcher, the pipeline's five text modes, the golden
``text_chain`` and the CLI/API drives of ``--text-style`` and
``--text-texture``."""

import gzip
import os
import threading
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tbist_tpu import cli as jcli
from tbist_tpu.compose import pipeline as jpl
from tbist_tpu.effects import masking as jmasking
from tbist_tpu.effects import text_transfer as jtt
from tbist_tpu.models import clip_mlp as jclip_mlp
from tbist_tpu.models import clip_text as jclip_text
from tbist_tpu.models import ghiasi as jghiasi
from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils import imageio as jio
from tbist_tpu.weights import ghiasi_convert as jgc
from tbist_tpu_torch import api, cli
from tbist_tpu_torch.api import batching
from tbist_tpu_torch.compose import pipeline
from tbist_tpu_torch.effects import masking
from tbist_tpu_torch.effects import text_transfer as tt
from tbist_tpu_torch.models import clip_mlp, clip_text, ghiasi
from tbist_tpu_torch.utils import threefry
from tbist_tpu_torch.utils import imageio as tio
from tbist_tpu_torch.utils.config import EffectRequest, TextEffectConfig
from tbist_tpu_torch.utils.logging import RunMetrics
from tbist_tpu_torch.weights import ghiasi_convert

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOAT = os.path.join(ROOT, "data/content_imgs/boat.jpg")
PROMPTS = ["mosaic", "boat", "fire", "water", "a painting of flames", "Starry Night!"]


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's seeded (ghiasi, clip_mlp) params as numpy trees."""
    g, m = jgc.get_params()
    return jax.tree.map(np.asarray, g), jax.tree.map(np.asarray, m)


@pytest.fixture(scope="module")
def params(jax_params):
    return ghiasi_convert.from_jax_params(*jax_params)


@pytest.fixture
def fresh_loaders():
    """Clear the cached loaders, so that they mark their degraded flags
    anew (another test file may have reset the flags after they ran)."""
    for loader in (ghiasi_convert.get_params, clip_text.get_default_encoder,
                   masking.default_emoji_extractor):
        loader.cache_clear()


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setenv("TBIST_GHIASI_BF16", "0")


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _content(max_side=64):
    return np.array(jio.to_device(tio.load_image(BOAT), bucket=32, max_side=max_side), np.float32)


def _stencil():
    """test_golden.py's checkered ring stencil."""
    yy, xx = np.mgrid[0:172, 0:172]
    return ((yy - 86) ** 2 + (xx - 86) ** 2 < 70**2) & (((yy // 12) + (xx // 12)) % 2 == 0)


# ---------------------------------------------------------------------------
# JAX's PRNG in numpy, and the weights
# ---------------------------------------------------------------------------


def test_threefry_matches_jax_bits_keys_and_uniforms():
    k = jax.random.key(7)
    np.testing.assert_array_equal(threefry.split(threefry.key(7), 5),
                                  np.asarray(jax.random.key_data(jax.random.split(k, 5))))
    np.testing.assert_array_equal(threefry.fold_in(threefry.key(7), 3),
                                  np.asarray(jax.random.key_data(jax.random.fold_in(k, 3))))
    np.testing.assert_array_equal(threefry.random_bits(threefry.key(7), (3, 5)),
                                  np.asarray(jax.random.bits(k, (3, 5), jnp.uint32)))
    want = np.asarray(jax.random.uniform(k, (999,), jnp.float32, -0.3, 0.3))
    np.testing.assert_array_equal(threefry.uniform(threefry.key(7), (999,), np.float32(-0.3),
                                                   np.float32(0.3)), want)


def test_seeded_init_equals_jax_params(jax_params):
    g, m = ghiasi_convert.seeded_init()
    jg, jm = jax_params
    for want, got in ((jg, g), (jm, m)):
        leaves_w, leaves_g = jax.tree.leaves(want), jax.tree.leaves(got)
        assert len(leaves_w) == len(leaves_g)
        for a, b in zip(leaves_w, leaves_g):
            np.testing.assert_array_equal(b, a)
    assert len(jax.tree.leaves((jg, jm))) == 94


def test_reference_state_dicts_convert_as_jax(jax_params):
    """Synthetic reference checkpoints through both converters."""
    rng = np.random.default_rng(0)
    sd = {}
    for i, (kind, _, cin, cout, k, _) in enumerate(jghiasi.LAYERS):
        convs = ("conv1", "conv2") if kind == "res" else ("conv",)
        for c in convs:
            ci = cout if c == "conv2" else cin
            sd[f"layers.{i}.{c}.weight"] = rng.standard_normal((cout, ci, k, k)).astype(np.float32)
            sd[f"layers.{i}.{c}.bias"] = rng.standard_normal(cout).astype(np.float32)
        fcs = (("fc_gamma1", "fc_beta1", "fc_gamma2", "fc_beta2") if kind == "res"
               else ("fc_gamma", "fc_beta") if kind == "up" else ())
        for f in fcs:
            sd[f"layers.{i}.{f}.weight"] = rng.standard_normal((cout, 100)).astype(np.float32)
            sd[f"layers.{i}.{f}.bias"] = rng.standard_normal(cout).astype(np.float32)
    want, _ = ghiasi_convert.from_jax_params(jax.tree.map(np.asarray, jgc.convert_ghiasi(sd)))
    got = ghiasi_convert.convert_ghiasi(sd)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    msd = {f"model.{i}.{w}": rng.standard_normal(s).astype(np.float32)
           for i, (a, b) in zip((0, 2, 4, 6, 8), zip(jclip_mlp.SIZES[:-1], jclip_mlp.SIZES[1:]))
           for w, s in (("weight", (b, a)), ("bias", (b,)))}
    jm = jgc.convert_clip_mlp(msd)
    for p, q in zip(ghiasi_convert.convert_clip_mlp(msd), jm):
        np.testing.assert_array_equal(p["weight"].numpy(), np.asarray(q["kernel"]))
        np.testing.assert_array_equal(p["bias"].numpy(), np.asarray(q["bias"]))


# ---------------------------------------------------------------------------
# CLIP-MLP, Ghiasi, the fallback embedding
# ---------------------------------------------------------------------------


def test_clip_mlp_matches_jax(jax_params, params):
    x = np.random.default_rng(1).standard_normal((3, 512)).astype(np.float32)
    want = np.asarray(jclip_mlp.apply(jax_params[1], jnp.asarray(x)))
    got = clip_mlp.apply(params[1], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert got.shape == (3, 100)


@pytest.mark.parametrize("shape", [(1, 64, 64), (2, 32, 48)])
def test_ghiasi_f32_matches_jax(shape, jax_params, params):
    x = _rand(2, (*shape, 3))
    style = np.random.default_rng(3).uniform(-1, 1, (shape[0], 100)).astype(np.float32)
    want = np.asarray(jax.jit(jghiasi.apply)(jax_params[0], jnp.asarray(x), jnp.asarray(style)))
    got = ghiasi.apply(params[0], torch.from_numpy(x), torch.from_numpy(style))
    assert got.shape == (*shape, 3) and got.dtype == torch.float32
    err = np.abs(got.numpy() - want).max()
    print(f"ghiasi f32 {shape}: max|Δ| {err:.2e} against JAX")
    assert err <= 1e-5


def test_ghiasi_bf16_within_jax_tests_bounds_of_f32(params):
    x = torch.from_numpy(_rand(4, (1, 64, 64, 3)))
    style = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (1, 100)).astype(np.float32))
    f32 = ghiasi.apply(params[0], x, style)
    bf16 = ghiasi.apply(params[0], x, style, compute_dtype=torch.bfloat16)
    err = (bf16 - f32).abs()
    print(f"ghiasi bf16 vs f32 at 64px: max {err.max():.4f} mean {err.mean():.5f}")
    assert bf16.dtype == torch.float32
    assert err.max() < 0.05 and err.mean() < 0.005


def test_fallback_embedding_matches_jax():
    assert zlib.crc32(b"boat") >= 2**31
    for p in PROMPTS:
        want = np.asarray(jtt.fallback_text_embedding(p))
        got = tt.fallback_text_embedding(p)
        assert got.shape == (1, 512) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0, err_msg=p)
    raw = threefry.normal(threefry.key(zlib.crc32(b"boat")), (1, 512))
    want = np.asarray(jax.random.normal(jax.random.key(zlib.crc32(b"boat")), (1, 512),
                                        jnp.float32))
    assert (raw == want).mean() > 0.95  # XLA's erf_inv polynomial, bit for bit mostly
    np.testing.assert_allclose(raw, want, atol=5e-7, rtol=0)


def test_compute_dtype_reads_the_environment(monkeypatch):
    monkeypatch.delenv("TBIST_GHIASI_BF16", raising=False)
    assert tt.compute_dtype() == torch.bfloat16
    monkeypatch.setenv("TBIST_GHIASI_BF16", "0")
    assert tt.compute_dtype() == torch.float32


def test_perform_transfer_matches_jax(f32, jax_params, params):
    x = _content(32)
    want = np.asarray(jtt.perform_transfer(jnp.asarray(x), "mosaic", *jax_params,
                                           text_encoder=jtt.fallback_text_embedding,
                                           use_mesh=False))
    got = tt.perform_transfer(torch.from_numpy(x), "mosaic", *params,
                              text_encoder=tt.fallback_text_embedding)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_perform_transfer_batch_matches_sequential_and_pads_invisibly(params):
    imgs = torch.from_numpy(_rand(6, (3, 24, 24, 3)))
    prompts = ["fire", "water colors", "fire"]
    kw = dict(text_encoder=tt.fallback_text_embedding)
    batched = tt.perform_transfer_batch(imgs, prompts, *params, **kw)
    assert batched.shape == (3, 24, 24, 3)
    for i, p in enumerate(prompts):
        single = tt.perform_transfer(imgs[i : i + 1], p, *params, **kw)
        torch.testing.assert_close(batched[i], single[0], atol=1e-4, rtol=0)
    # 3 rows run padded to 4; 2 rows run unpadded: the shared rows agree.
    unpadded = tt.perform_transfer_batch(imgs[:2], prompts[:2], *params, **kw)
    torch.testing.assert_close(batched[:2], unpadded, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        tt.perform_transfer_batch(torch.zeros(2, 8, 8, 3), ["one"], *params, **kw)


# ---------------------------------------------------------------------------
# the CLIP text tower and its tokenizer
# ---------------------------------------------------------------------------


def test_clip_tower_matches_jax_on_two_blocks(monkeypatch):
    """JAX's seeded tower cut to 2 blocks and a 512-token vocab (the EOT
    is the largest id of a row, as CLIP's 49407 is)."""
    monkeypatch.setattr(jclip_text, "LAYERS", 2)
    monkeypatch.setattr(jclip_text, "VOCAB", 512)
    jp = jclip_text.init_params(jax.random.key(0))
    toks = np.zeros((2, clip_text.CONTEXT), np.int32)
    toks[0, :5] = [510, 320, 125, 39, 511]
    toks[1, :3] = [510, 7, 511]
    want = np.asarray(jax.jit(jclip_text.encode_tokens)(jp, jnp.asarray(toks)))
    got = clip_text.encode_tokens(clip_text.from_jax_params(jax.tree.map(np.asarray, jp)),
                                  torch.from_numpy(toks))
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    print(f"clip tower 2 blocks: max|Δ|/max {rel:.2e}")
    assert got.shape == (2, 512) and rel <= 1e-5


def _bpe_file(tmp_path):
    path = tmp_path / "bpe.txt.gz"
    lines = ["#version: 0.2", "h e", "he l", "hel l", "hell o</w>", "b o", "bo a", "boa t</w>",
             "f i", "fi r", "fir e</w>"]
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("use_regex", [True, False])
def test_tokenizer_ids_match_jax(use_regex, tmp_path, monkeypatch):
    bpe = _bpe_file(tmp_path)
    if not use_regex:  # both packages on their ASCII branch
        import builtins

        real_import = builtins.__import__

        def no_regex(name, *a, **k):
            if name == "regex":
                raise ImportError("no regex")
            return real_import(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_regex)
    want_tok = jclip_text.ClipTokenizer(bpe)
    got_tok = clip_text.ClipTokenizer(bpe)
    assert type(got_tok.pat) is type(want_tok.pat)
    for text in ["hello boat", "Fire &amp; boat's   hull", "xyz 42!", "hello" * 30]:
        np.testing.assert_array_equal(got_tok.tokenize(text), want_tok.tokenize(text), err_msg=text)


def test_default_encoder_falls_back_and_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("TBIST_CLIP_PTH", str(tmp_path / "none.pth"))
    clip_text.get_default_encoder.cache_clear()
    from tbist_tpu_torch.utils import degraded

    assert clip_text.get_default_encoder("cpu") is tt.fallback_text_embedding
    assert "clip_text_fallback" in degraded.flags_for(["text_transfer"])


# ---------------------------------------------------------------------------
# the micro-batcher
# ---------------------------------------------------------------------------


def _req(d):
    return jconfig.EffectRequest(**d)


@pytest.mark.parametrize("extra", [
    {}, {"grayscale": True}, {"text": {"location_prompt": "dog"}},
    {"text": {"texture_prompt": "fire"}}, {"style_transfer": True}, {"pixel_art": True},
    {"color_palette": True}, {"depth": True}, {"style_mixing": True}, {"text": None},
])
def test_eligible_truth_table_matches_jax(extra):
    from tbist_tpu.api import batching as jbatching
    from tbist_tpu_torch.utils import config as tconfig

    def build(cfg):
        text = {"style_prompt": "fire", **(extra.get("text") or {})}
        return cfg.EffectRequest(
            text=None if "text" in extra and extra["text"] is None else cfg.TextEffectConfig(**text),
            grayscale=extra.get("grayscale", False),
            pixel_art=cfg.PixelArtConfig() if extra.get("pixel_art") else None,
            style_transfer=extra.get("style_transfer", False),
            style_mixing=extra.get("style_mixing", False),
            color_palette=extra.get("color_palette", False),
            depth=cfg.DepthConfig() if extra.get("depth") else None,
        )

    assert batching.eligible(build(tconfig)) == jbatching.eligible(build(jconfig))
    assert batching.eligible(build(tconfig)) == (extra == {})


@pytest.fixture
def batcher_factory(params, monkeypatch):
    monkeypatch.setattr(tt, "default_params", lambda device="cuda": params)
    made = []

    def make(**kw):
        b = batching.FastTextBatcher(device="cpu", **kw)
        made.append(b)
        return b

    yield make
    for b in made:
        b.close()


def test_batcher_coalesces_concurrent_requests(batcher_factory, params):
    b = batcher_factory(max_batch=4, window_ms=400.0)
    imgs = _rand(7, (4, 24, 24, 3))
    results = [None] * 4

    def worker(i):
        results[i] = b.submit(imgs[i], "fire")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert b.batches_run == 1 and b.requests_served == 4 and b.last_batch_sizes == [4]
    want = tt.perform_transfer_batch(torch.from_numpy(imgs), ["fire"] * 4, *params).numpy()
    for i in range(4):
        np.testing.assert_allclose(results[i], want[i], atol=1e-4)


def test_batcher_groups_shapes_and_dtypes(batcher_factory):
    b = batcher_factory(max_batch=4, window_ms=400.0)
    img = _rand(8, (16, 16, 3))
    inputs = {"s": img, "u": (img * 255).astype(np.uint8), "b": _rand(9, (24, 24, 3))}
    out = {}

    def worker(key):
        out[key] = b.submit(inputs[key], "water")

    threads = [threading.Thread(target=worker, args=(k,)) for k in inputs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert b.batches_run == 3  # one call per shape and dtype group
    assert out["b"].shape == (24, 24, 3)
    np.testing.assert_allclose(out["s"], out["u"], atol=2e-2)


def test_batcher_error_reaches_every_waiter(batcher_factory, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("synthetic failure")

    real = tt.perform_transfer_batch
    monkeypatch.setattr(tt, "perform_transfer_batch", boom)
    b = batcher_factory(max_batch=2, window_ms=100.0)
    errs = []

    def worker():
        try:
            b.submit(_rand(10, (24, 24, 3)), "x")
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert errs == ["synthetic failure"] * 2
    monkeypatch.setattr(tt, "perform_transfer_batch", real)
    assert b.submit(_rand(10, (24, 24, 3)), "fire").shape == (24, 24, 3)  # the worker lives on
    with pytest.raises(ValueError):
        b.submit(np.zeros((8, 8), np.float32), "x")


def test_batcher_uint8_and_quantized_results(batcher_factory):
    u8 = (_rand(11, (24, 24, 3)) * 255).astype(np.uint8)
    plain = batcher_factory(max_batch=1)
    out_u8, out_f = plain.submit(u8, "fire"), plain.submit(u8.astype(np.float32) / 255.0, "fire")
    np.testing.assert_allclose(out_u8, out_f, atol=1e-6)
    quant = batcher_factory(max_batch=1, quantize_uint8=True)
    out_q = quant.submit(u8, "fire")
    assert out_q.dtype == np.uint8
    np.testing.assert_array_equal(out_q, tio.to_uint8(out_u8))


# ---------------------------------------------------------------------------
# the pipeline, the golden, the CLI and the API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prompts", [
    {"style_prompt": "mosaic"},
    {"style_prompt": "mosaic", "location_prompt": "boat"},
    {"style_prompt": "mosaic", "texture_prompt": "fire"},
    {"location_prompt": "boat", "texture_prompt": "fire"},
    {"texture_prompt": "fire"},
])
def test_pipeline_text_modes_match_jax(prompts, f32, jax_params, params):
    x = _content(32)
    stencil = _stencil()
    jreg = jpl.ModelRegistry(
        text_transfer=lambda img, p: jtt.perform_transfer(
            img, p, *jax_params, text_encoder=jtt.fallback_text_embedding, use_mesh=False),
        mask_extractor=jmasking._fallback_location_mask,
        emoji_extractor=lambda p: jnp.asarray(stencil))
    want = np.asarray(jpl.apply_image(jnp.asarray(x), jconfig.EffectRequest(
        text=jconfig.TextEffectConfig(**prompts)), registry=jreg))
    reg = pipeline.ModelRegistry(
        device="cpu",
        text_transfer=lambda img, p: tt.perform_transfer(
            img, p, *params, text_encoder=tt.fallback_text_embedding),
        mask_extractor=masking._fallback_location_mask,
        emoji_extractor=lambda p: torch.from_numpy(stencil))
    metrics = RunMetrics()
    got = pipeline.apply_image(torch.from_numpy(x), EffectRequest(
        text=TextEffectConfig(**prompts)), registry=reg, metrics=metrics)
    assert got.shape == want.shape and metrics.degraded == []
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("prompts", [
    {"texture_prompt": "fire"},
    {"location_prompt": "boat", "texture_prompt": "fire"},
])
@pytest.mark.parametrize("effect", ["pixel_art", "color_palette"])
def test_pipeline_texture_branches_of_masked_apply_match_jax(prompts, effect):
    """Stages 3 and 6 under a texture stencil, alone and inside the location
    mask, against JAX's pipeline. The composite's blur, step and strength
    differ from the text config's emoji values, so using one set in place of
    the other shows."""
    x = _content(64)
    palette_img = _rand(12, (1, 40, 56, 3))
    stencil = _stencil()
    comp = dict(blur_strength=31, step_size_multiplier=0.8, style_strength=1.2)
    text = dict(prompts, emoji_blur_strength=61, emoji_step_size=0.3, emoji_style_strength=2.0)
    fx = {"pixel_art": dict(pixel_size=0.3)} if effect == "pixel_art" else {"color_palette": True}

    def request(cfg):
        kw = {"pixel_art": cfg.PixelArtConfig(**fx["pixel_art"])} if effect == "pixel_art" else fx
        return cfg.EffectRequest(text=cfg.TextEffectConfig(**text),
                                 composite=cfg.MaskCompositeConfig(**comp), **kw)

    from tbist_tpu_torch.utils import config as tconfig

    jreg = jpl.ModelRegistry(mask_extractor=jmasking._fallback_location_mask,
                             emoji_extractor=lambda p: jnp.asarray(stencil))
    want = np.asarray(jpl.apply_image(
        jnp.asarray(x), request(jconfig), registry=jreg,
        inputs=jpl.EffectInputs(color_palette_image=jnp.asarray(palette_img))))
    reg = pipeline.ModelRegistry(device="cpu", mask_extractor=masking._fallback_location_mask,
                                 emoji_extractor=lambda p: torch.from_numpy(stencil))
    got = pipeline.apply_image(
        torch.from_numpy(x), request(tconfig), registry=reg,
        inputs=pipeline.EffectInputs(color_palette_image=torch.from_numpy(palette_img)))
    assert got.shape == want.shape == x.shape
    # the stencil changed the image and left part of it as it was
    unchanged = np.all(np.abs(want - x) < 1e-6, axis=-1)
    assert 0 < unchanged.mean() < 1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_golden_text_chain_through_the_port(f32, fresh_loaders):
    """test_golden.py's text_chain case, through the port's own loaders."""
    x = _content(64)
    reg = pipeline.ModelRegistry(device="cpu", mask_extractor=masking._fallback_location_mask,
                                 emoji_extractor=lambda p: torch.from_numpy(_stencil()))
    req = EffectRequest(text=TextEffectConfig(style_prompt="mosaic", location_prompt="boat",
                                              texture_prompt="fire"))
    metrics = RunMetrics()
    got = pipeline.apply_image(torch.from_numpy(x), req, registry=reg, metrics=metrics)[0].numpy()
    assert {"ghiasi_seeded", "clip_text_fallback"} <= set(metrics.degraded)
    want = np.load(os.path.join(ROOT, "tests/golden/text_chain.npy"))
    err = np.abs(got - want)
    print(f"text_chain: max {err.max():.2e} mean {err.mean():.2e} against the golden")
    assert err.max() < 5e-2 and err.mean() < 5e-3
    jreg = jpl.ModelRegistry(
        text_transfer=lambda img, p: jtt.perform_transfer(img, p, use_mesh=False),
        mask_extractor=jmasking._fallback_location_mask,
        emoji_extractor=lambda p: jnp.asarray(_stencil()))
    jout = np.asarray(jpl.apply_image(jnp.asarray(x), jconfig.EffectRequest(
        text=jconfig.TextEffectConfig(style_prompt="mosaic", location_prompt="boat",
                                      texture_prompt="fire")), registry=jreg)[0])
    assert np.abs(got - jout).max() <= 1e-4


def test_registry_resolves_text_models_and_refuses_depth():
    reg = pipeline.ModelRegistry(device="cpu").ensure("text_transfer", "emoji_extractor")
    assert reg.text_transfer is tt.perform_transfer
    assert reg.emoji_extractor is masking._fallback_emoji_stencil  # no T5 files here
    assert {"text_transfer", "emoji_extractor"} <= reg.resolved_by_loader
    # depth resolves too now: without a checkpoint, to the fallback
    from tbist_tpu_torch.effects import depth

    assert reg.ensure("depth_estimator").depth_estimator is depth._fallback_depth


def test_emoji_stencil_matches_jax():
    for p in ["fire", "  water", "", "42"]:
        np.testing.assert_array_equal(masking._fallback_emoji_stencil(p).numpy(),
                                      np.asarray(jmasking._fallback_emoji_stencil(p)))


def _small_boat(tmp_path):
    path = tmp_path / "c.png"
    Image.open(BOAT).convert("RGB").resize((64, 64)).save(path)
    return str(path)


@pytest.mark.parametrize("flags", [
    ["--text-style", "mosaic"],
    ["--text-texture", "fire"],
    ["--text-style", "mosaic", "--text-location", "boat", "--text-texture", "fire"],
])
def test_cli_text_flags_run_and_match_the_pipeline(flags, tmp_path, fresh_loaders):
    image = _small_boat(tmp_path)
    out = tmp_path / "o.png"
    metrics = RunMetrics()
    assert cli.main(["--image", image, "--out", str(out), "--device", "cpu", *flags],
                    metrics=metrics) == 0
    args = cli.build_parser().parse_args(["--image", image, "--out", "x", *flags])
    jargs = jcli.build_parser().parse_args(["--image", image, "--out", "x", *flags])
    req = cli.request_from_args(args)
    assert repr(req) == repr(jcli.request_from_args(jargs))
    want = api.apply_image(image, req, device="cpu")
    np.testing.assert_array_equal(np.asarray(Image.open(out)), np.asarray(want))
    expect = ({"ghiasi_seeded", "clip_text_fallback"} if "--text-style" in flags else set()) | (
        {"emoji_fallback"} if "--text-texture" in flags else set())
    assert expect <= set(metrics.degraded)


def test_cli_full_chain_f32_matches_jax_cli(tmp_path, f32):
    image = _small_boat(tmp_path)
    flags = ["--text-style", "mosaic", "--text-location", "boat", "--text-texture", "fire"]
    outs = []
    for mod, name in ((cli, "t.png"), (jcli, "j.png")):
        argv = ["--image", image, "--out", str(tmp_path / name), *flags]
        assert mod.main(argv + (["--device", "cpu"] if mod is cli else [])) == 0
        outs.append(np.asarray(Image.open(tmp_path / name)).astype(int))
    assert np.abs(outs[0] - outs[1]).max() <= 1


def test_api_texture_only_without_image(fresh_loaders):
    metrics = RunMetrics()
    req = EffectRequest(text=TextEffectConfig(texture_prompt="fire"))
    out = api.apply_image(None, req, metrics=metrics, device="cpu")
    want = masking._fallback_emoji_stencil("fire").numpy()
    np.testing.assert_array_equal(np.asarray(out), np.repeat(want[..., None], 3, -1) * 255)
    assert "emoji_fallback" in metrics.degraded
    assert api.apply_image(None, EffectRequest(text=TextEffectConfig(style_prompt="x")),
                           device="cpu") is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_ghiasi_on_card_matches_cpu(cuda, params, f32):
    x = torch.from_numpy(_rand(12, (2, 64, 64, 3)))
    want = tt.perform_transfer(x, "mosaic", *params, text_encoder=tt.fallback_text_embedding)
    card = tio.tree_to(params, cuda)
    got = tt.perform_transfer(x.to(cuda), "mosaic", *card, text_encoder=tt.fallback_text_embedding)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_ghiasi_bf16_on_card_within_one_level_of_f32(cuda, params, monkeypatch):
    x = torch.from_numpy(_content(256)).to(cuda)
    card = tio.tree_to(params, cuda)
    kw = dict(text_encoder=tt.fallback_text_embedding)
    monkeypatch.setenv("TBIST_GHIASI_BF16", "0")
    f32_out = tio.to_uint8_device(tt.perform_transfer(x, "mosaic", *card, **kw)).int()
    monkeypatch.setenv("TBIST_GHIASI_BF16", "1")
    bf16_out = tio.to_uint8_device(tt.perform_transfer(x, "mosaic", *card, **kw)).int()
    assert int((bf16_out - f32_out).abs().max()) <= 1
