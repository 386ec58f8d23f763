"""The port's text→mask chain on the CPU: ``models/dino_sam.py``,
``effects/masking.py``, the pipeline's text stage and the CLI, against the
JAX package on shared numpy weights (the tiny configs of
``tests/test_dino_sam.py``) and the same inputs. Tests marked ``gpu`` run
the chain on the card and skip here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tbist_tpu import cli as jcli
from tbist_tpu.compose import pipeline as jpipeline
from tbist_tpu.effects import masking as jmasking
from tbist_tpu.models import bert as jbert
from tbist_tpu.models import dino as jdino
from tbist_tpu.models import dino_sam as jds
from tbist_tpu.models import sam as jsam
from tbist_tpu.models import swin as jswin
from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils import imageio as jio
from tbist_tpu_torch import api, cli
from tbist_tpu_torch.compose import pipeline
from tbist_tpu_torch.effects import masking
from tbist_tpu_torch.models import bert as tbert
from tbist_tpu_torch.models import dino as tdino
from tbist_tpu_torch.models import dino_sam as tds
from tbist_tpu_torch.models import sam as tsam
from tbist_tpu_torch.models import swin as tswin
from tbist_tpu_torch.utils import imageio as tio
from tbist_tpu_torch.utils.config import EffectRequest, GatysConfig, TextEffectConfig
from tbist_tpu_torch.utils.logging import RunMetrics
from tbist_tpu_torch.weights import dino_convert
from tbist_tpu_torch.weights import sam as wsam
from tbist_tpu_torch.weights import vgg as wvgg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOAT = os.path.join(ROOT, "data/content_imgs/boat.jpg")
STARRY = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")

SWIN_KW = dict(embed_dim=8, depths=(1, 1, 1, 1), heads=(1, 2, 4, 8), window=4, mlp_ratio=2,
               out_indices=(1, 2, 3))
BERT_KW = dict(vocab=128, hidden=32, layers=2, heads=2, ffn=64, max_pos=64, type_vocab=2)
DINO_KW = dict(d_model=16, heads=2, levels=4, points=2, enc_layers=2, dec_layers=2, ffn=32,
               num_queries=20, fusion_heads=2, fusion_dim=32)
SAM_KW = dict(img_size=64, patch=16, width=32, layers=2, heads=2, window=2, global_layers=(1,),
              embed_dim=32, decoder_heads=2, decoder_layers=2, mlp_dim=64, num_mask_tokens=4)
VOCAB = {"[CLS]": 0, "[SEP]": 1, "[UNK]": 2, "boat": 3, ".": 4}
JKW = dict(cfg=jdino.DinoConfig(**DINO_KW), swin_cfg=jswin.SwinConfig(**SWIN_KW),
           bert_cfg=jbert.BertConfig(**BERT_KW), det_hw=(64, 64))
TKW = dict(cfg=tdino.DinoConfig(**DINO_KW), swin_cfg=tswin.SwinConfig(**SWIN_KW),
           bert_cfg=tbert.BertConfig(**BERT_KW), det_hw=(64, 64))
# the port's SAM decoder in the JAX package's form, which these tests hold it
# to (tests/test_torch_sam_published.py holds the published form)
JSAM, TSAM = jsam.SamConfig(**SAM_KW), tsam.JaxDecoderConfig(**SAM_KW)
# thresholded masks: at most this share of pixels may differ from the JAX
# package's (a logit within float rounding of 0 can land on either side)
MASK_TOL = 1e-3


def _randomize(init, seed):
    """Random values of unit-ish scale in the structure ``init()`` returns
    (traced for its shapes only, so nothing is drawn by JAX): matrices
    normal / sqrt(fan-in), LayerNorm scales near 1, other vectors normal
    × 0.1, so that no layer is an identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if len(a.shape) >= 2:
            return rng.standard_normal(a.shape).astype(np.float32) / np.float32(
                np.sqrt(np.prod(a.shape[:-1])))
        noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return (1.0 + noise) if getattr(path[-1], "key", None) == "scale" else noise

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init))


@pytest.fixture(scope="module")
def models():
    """(JAX dino, JAX sam, port dino, port sam) on shared random weights."""
    dtree = _randomize(lambda: jdino.init_params(jax.random.key(0), JKW["cfg"], JKW["swin_cfg"],
                                                 JKW["bert_cfg"]), 0)
    stree = _randomize(lambda: jsam.init_params(jax.random.key(1), JSAM), 1)
    j = jax.tree.map(jnp.asarray, (dtree, stree))
    return j[0], j[1], dino_convert.from_jax_params(dtree), wsam.from_jax_params(stree)


@pytest.fixture
def no_thresholds(monkeypatch):
    """Seeded logits keep every query and token, as the JAX tests do."""
    for mod in (jds, tds):
        monkeypatch.setattr(mod, "BOX_THRESHOLD", -1.0)
        monkeypatch.setattr(mod, "TEXT_THRESHOLD", -1.0)


def _img(seed, shape=(64, 64, 3)):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# host side, exact
# ---------------------------------------------------------------------------

WORDPIECE_VOCAB = {"[CLS]": 0, "[SEP]": 1, "[UNK]": 2, "boat": 3, ".": 4, "sail": 5, "##ing": 6,
                   "a": 7, ",": 8, "cafe": 9, "猫": 10, "un": 11, "##afford": 12}


@pytest.mark.parametrize("prompt", ["a boat .", "sailing", "xylophone", "BOAT", "boat.",
                                    "boat,sailing.", "unaffordable", "café", "猫猫",
                                    "fire\t猫 truck...", "a\x00 red​ BOAT!"])
def test_tokenizer_matches_jax(prompt):
    assert (tds._simple_bert_tokenize(prompt, WORDPIECE_VOCAB)
            == jds._simple_bert_tokenize(prompt, WORDPIECE_VOCAB))


def test_decode_phrase_and_filter_phrases_match_jax():
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "boat", ".", ",", "!", "?", "'", "sail", "##ing",
             "red", "thing", "##s", "it", "n't", "s"]
    inv = dict(enumerate(words))
    for toks in (["boat"], ["boat", "."], ["red", "boat", ",", "sail", "##ing", "!"],
                 ["sail", "##ing", "thing", "##s", "?"], ["it", "'", "s"], ["[SEP]"]):
        ids = [words.index(t) for t in toks]
        assert tds._decode_phrase(ids, inv) == jds._decode_phrase(ids, inv)
    ids = [2, 12, 4, 5, 3]  # [CLS] red boat . [SEP]
    logits = np.random.default_rng(3).random((40, len(ids))).astype(np.float32)
    logits[:, 0] = 0.99  # [CLS] above the threshold: never in a phrase
    logits[5] = 0.1  # an empty phrase drops the box
    got, want = tds.filter_phrases(logits, ids, inv), jds.filter_phrases(logits, ids, inv)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) == int(got[0].sum()) > 0
    assert tds.filter_phrases(np.zeros((0, 5), np.float32), ids, inv)[1] == []


@pytest.mark.parametrize("hw", [(480, 640), (100, 1000), (512, 512), (1333, 90), (20, 30),
                                (600, 450), (400, 600)])
@pytest.mark.parametrize("size", [800, 256, 32])
def test_detection_size_matches_jax(hw, size):
    assert tds._detection_size(*hw, size, 1333) == jds._detection_size(*hw, size, 1333)


@pytest.mark.parametrize("kw", [{}, dict(left=5, right=10, top=2, bottom=3), dict(square=True),
                                dict(resize=True, height=16, width=24),
                                dict(resize=True, height=96, width=50, left=3, square=True),
                                dict(left=100, top=100)])
def test_preprocess_image_matches_jax(kw):
    img = _img(4, (40, 60, 3))
    got, got_off = tds.preprocess_image(img, return_offsets=True, **kw)
    want, want_off = jds.preprocess_image(img, return_offsets=True, **kw)
    assert got.dtype == np.uint8 and got_off == want_off and got.shape == want.shape
    if kw.get("height") == 96:
        # 57 -> 96 rows puts many exact values on a half level, where the two
        # resizes' float roundings (4.6e-5 apart) round to neighbouring levels
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1 and np.mean(diff > 0) < 0.01
    else:  # crops are exact, and so is this shrink
        np.testing.assert_array_equal(got, want)
    gray = np.zeros((8, 8), np.uint8)
    assert tds.preprocess_image(gray).shape == (8, 8, 3)


# ---------------------------------------------------------------------------
# the chain at tiny configs
# ---------------------------------------------------------------------------


def test_detect_matches_jax(models, no_thresholds):
    jd, _, td, _ = models
    img = _img(7)
    boxes, phrases = tds.detect(td, img, "boat", vocab=VOCAB, **TKW)
    jboxes, jphrases = jds.detect(jd, img, "boat", vocab=VOCAB, **JKW)
    assert boxes.shape == (20, 4) and len(phrases) == 20
    np.testing.assert_allclose(boxes, jboxes, rtol=1e-4, atol=1e-5)


def test_extract_mask_matches_jax_and_the_sequential_chain(models, no_thresholds):
    jd, js, td, ts = models
    img = _img(7)
    mask = tds.extract_mask(td, ts, img, "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    assert isinstance(mask, torch.Tensor) and mask.shape == (64, 64) and mask.dtype == torch.bool
    want = np.asarray(jds.extract_mask(jd, js, img, "boat", sam_cfg=JSAM, vocab=VOCAB, **JKW))
    assert 0 < float(mask.float().mean()) < 1  # 20 random boxes cover most of the image
    assert np.mean(mask.numpy() != want) <= MASK_TOL
    # the overlapped chain equals detect() then predict_boxes() on the port
    boxes, _ = tds.detect(td, img, "boat", vocab=VOCAB, **TKW)
    masks = tsam.predict_boxes(ts, TSAM, img, tds._boxes_to_xyxy(boxes, 64, 64))
    np.testing.assert_array_equal(mask.numpy(), masks.any(0))


def test_extract_masks_batch_matches_per_frame(models, no_thresholds):
    _, _, td, ts = models
    frames = np.stack([_img(11 + i) for i in range(3)])
    batch = tds.extract_masks_batch(td, ts, frames, "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    assert batch.shape == (3, 64, 64) and batch.dtype == torch.bool
    for i in range(3):
        single = tds.extract_mask(td, ts, frames[i], "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
        assert np.mean(batch[i].numpy() != single.numpy()) <= MASK_TOL


def test_extract_masks_batch_with_mixed_box_counts(models, monkeypatch):
    """A threshold between the frames' scores keeps a different number of
    boxes per frame: padded boxes must not leak into a frame."""
    _, _, td, ts = models
    frames = np.stack([_img(21 + i) for i in range(3)])
    monkeypatch.setattr(tds, "TEXT_THRESHOLD", -1.0)
    ids, out = tds._detect_dispatch_batch(td, torch.from_numpy(frames), "boat", VOCAB, **TKW)
    best = torch.sigmoid(out["pred_logits"]).amax(-1).numpy()  # (3, 20)
    thr = float(np.sort(best[1])[10])  # frame 1 keeps about half its boxes
    monkeypatch.setattr(tds, "BOX_THRESHOLD", thr)
    batch = tds.extract_masks_batch(td, ts, frames, "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    counts = []
    for i in range(3):
        boxes, _ = tds.detect(td, frames[i], "boat", vocab=VOCAB, **TKW)
        counts.append(boxes.shape[0])
        single = tds.extract_mask(td, ts, frames[i], "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
        assert np.mean(batch[i].numpy() != single.numpy()) <= MASK_TOL
    assert len(set(counts)) > 1 and max(counts) > 0


def test_zero_detections_give_all_false_masks(models, monkeypatch):
    _, _, td, ts = models
    monkeypatch.setattr(tds, "BOX_THRESHOLD", 2.0)  # impossible
    frames = np.stack([_img(31), _img(32)])
    batch = tds.extract_masks_batch(td, ts, frames, "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    assert batch.shape == (2, 64, 64) and not bool(batch.any())
    single = tds.extract_mask(td, ts, frames[0], "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    assert single.shape == (64, 64) and not bool(single.any())


def test_detection_and_segmentation_size_knobs(models, no_thresholds, monkeypatch):
    _, _, td, ts = models
    seen_det, seen_seg = [], []
    real_forward, real_encode = tdino.forward, tsam.encode_uint8

    def spy_forward(params, cfg, image, *a, **k):
        seen_det.append(tuple(image.shape[1:3]))
        return real_forward(params, cfg, image, *a, **k)

    def spy_encode(params, cfg, image):
        seen_seg.append(cfg.img_size)
        return real_encode(params, cfg, image)

    monkeypatch.setattr(tdino, "forward", spy_forward)
    monkeypatch.setattr(tsam, "encode_uint8", spy_encode)
    kw = {k: v for k, v in TKW.items() if k != "det_hw"}  # let the knobs drive the sizes
    img = _img(41)
    mask = tds.extract_mask(td, ts, img, "boat", sam_cfg=TSAM, vocab=VOCAB, det_size=32,
                            det_max=1333, seg_size=32, **kw)
    assert mask.shape == (64, 64) and seen_det[-1] == (32, 32) and seen_seg[-1] == 32
    batch = tds.extract_masks_batch(td, ts, np.stack([img, _img(42)]), "boat", sam_cfg=TSAM,
                                    vocab=VOCAB, det_size=32, det_max=1333, **kw)
    assert batch.shape == (2, 64, 64) and seen_det[-1] == (32, 32)


def test_text_feature_cache_keys_on_vocab(models):
    _, _, td, _ = models
    tds.clear_text_feature_cache()
    v2 = {"[CLS]": 1, "[SEP]": 0, "[UNK]": 2, "boat": 4, ".": 3}
    kw = dict(cfg=TKW["cfg"], bert_cfg=TKW["bert_cfg"])
    a = tds._text_features(td, "boat.", VOCAB, **kw)
    b = tds._text_features(td, "boat.", v2, **kw)
    assert a[0] != b[0] and tds._text_features(td, "boat.", VOCAB, **kw) is a
    assert any(p is td and v is VOCAB for (_, p, v) in tds._TEXT_FEAT_CACHE.values())
    tds.clear_text_feature_cache()


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_fallback_location_mask_equals_jax(kind):
    img = tio.to_device(tio.load_image(BOAT), device="cpu")
    jimg = jio.to_device(tio.load_image(BOAT))
    if kind == "uint8":
        img = jimg = (np.asarray(jimg[0]) * 255).astype(np.uint8)
    got = masking._fallback_location_mask(img, "boat")
    assert got.dtype == torch.bool and got.shape == (512, 512)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmasking._fallback_location_mask(
        jimg, "boat")))


@pytest.mark.parametrize("opts", [dict(mask_crop=(5, 10, 2, 3)), dict(mask_square=True),
                                  dict(mask_resize=(16, 24)),
                                  dict(mask_crop=(0, 7, 4, 0), mask_square=True,
                                       mask_resize=(33, 21))])
def test_extract_location_mask_preprocess_matches_jax(opts):
    rng = np.random.default_rng(0)
    arr = rng.random((1, 40, 60, 3)).astype(np.float32)
    arr[:, 12:30, 20:45] = 0.9  # an object the fallback finds
    cfg = jconfig.TextEffectConfig(location_prompt="thing", **opts)
    tcfg = TextEffectConfig(location_prompt="thing", **opts)
    want = np.asarray(jmasking.extract_location_mask(jmasking._fallback_location_mask,
                                                     jnp.asarray(arr), cfg))
    got = masking.extract_location_mask(masking._fallback_location_mask, torch.from_numpy(arr),
                                        tcfg)
    assert got.shape == (40, 60) and 0 < int(got.sum()) < 40 * 60
    np.testing.assert_array_equal(got.numpy(), want)


def test_detection_kwargs_match_jax():
    for kw in ({}, dict(detection_size=400), dict(detection_size=400, segmentation_size=512),
               dict(segmentation_size=512), dict(segmentation_size=1024)):
        assert (masking._detection_kwargs(TextEffectConfig(**kw))
                == jmasking._detection_kwargs(jconfig.TextEffectConfig(**kw)))


def test_default_extractors_fall_back_and_flag(monkeypatch, tmp_path):
    from tbist_tpu_torch.utils import degraded

    monkeypatch.setenv("TBIST_DINO_PTH", str(tmp_path / "missing.pth"))
    tds.get_loaded_params.cache_clear()
    masking.default_mask_extractor.cache_clear()
    masking.default_batch_mask_extractor.cache_clear()
    degraded.reset()
    try:
        assert masking.default_mask_extractor("cpu") is masking._fallback_location_mask
        assert degraded.flags_for(["mask_extractor"]) == ["mask_fallback"]
        batch = masking.default_batch_mask_extractor("cpu")
        frames = np.stack([_img(51), _img(52)])
        got = batch(frames, "boat")
        assert got.shape == (2, 64, 64)
        for i in range(2):
            torch.testing.assert_close(got[i], masking._fallback_location_mask(frames[i], "boat"))
        with pytest.raises(FileNotFoundError, match="no GroundingDINO checkpoint"):
            tds.get_loaded_params.__wrapped__("cpu")
    finally:
        tds.get_loaded_params.cache_clear()
        masking.default_mask_extractor.cache_clear()
        masking.default_batch_mask_extractor.cache_clear()


def test_seeded_extractor_through_the_pipeline_matches_the_chain(models, no_thresholds):
    """The injected DINO+SAM extractor through apply_image: float input maps
    to uint8 as in the JAX package, the mask visualisation is the chain's."""
    _, _, td, ts = models
    img = _img(61)
    x = torch.from_numpy(img.astype(np.float32) / 255.0)[None]
    reg = pipeline.ModelRegistry(device="cpu", mask_extractor=_tiny_extractor(td, ts))
    out = pipeline.apply_image(x, EffectRequest(text=TextEffectConfig(location_prompt="boat")),
                               None, reg)
    as_uint8 = (np.clip(x[0].numpy(), 0, 1) * 255).astype(np.uint8)  # the JAX package's map
    want = tds.extract_mask(td, ts, as_uint8, "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    assert out.shape == (1, 64, 64, 3)
    torch.testing.assert_close(out[0, ..., 0], want.float())


def _tiny_extractor(td, ts):
    def extractor(image, prompt, **kw):
        return tds.extract_mask(td, ts, tds._as_uint8_frame(image), prompt, sam_cfg=TSAM,
                                vocab=VOCAB, **TKW, **kw)
    return extractor


# ---------------------------------------------------------------------------
# pipeline and CLI
# ---------------------------------------------------------------------------


def test_cli_text_location_matches_jax_cli(tmp_path):
    outs = []
    for mod, name in ((cli, "t.png"), (jcli, "j.png")):
        argv = ["--image", BOAT, "--text-location", "boat", "--out", str(tmp_path / name)]
        assert mod.main(argv + (["--device", "cpu"] if mod is cli else [])) == 0
        outs.append(np.asarray(Image.open(tmp_path / name)))
    assert outs[0].shape == (512, 512, 3)
    np.testing.assert_array_equal(outs[0], outs[1])
    args = cli.build_parser().parse_args(
        ["--image", "x", "--out", "y", "--text-location", "boat", "--detection-size", "400",
         "--segmentation-size", "512", "--mask-crop", "1", "2", "3", "4", "--mask-square",
         "--mask-resize", "30", "40"])
    jargs = jcli.build_parser().parse_args(
        ["--image", "x", "--out", "y", "--text-location", "boat", "--detection-size", "400",
         "--segmentation-size", "512", "--mask-crop", "1", "2", "3", "4", "--mask-square",
         "--mask-resize", "30", "40"])
    assert (cli.request_from_args(args).text.__dict__
            == jcli.request_from_args(jargs).text.__dict__)


def test_pipeline_text_location_with_style_transfer_matches_jax():
    jparams = jvgg.init_params(jax.random.key(0))
    tparams = wvgg.from_jax_params(jax.tree.map(np.asarray, jparams))
    jc = jio.to_device(tio.load_image(BOAT), bucket=32, max_side=64)
    js = jio.to_device(tio.load_image(STARRY), bucket=32, max_side=64)
    tc, ts = (torch.from_numpy(np.array(a)) for a in (jc, js))
    jreq = jconfig.EffectRequest(text=jconfig.TextEffectConfig(location_prompt="boat"),
                                 style_transfer=True,
                                 gatys=jconfig.GatysConfig(num_steps=2, w_style=1e4))
    treq = EffectRequest(text=TextEffectConfig(location_prompt="boat"), style_transfer=True,
                         gatys=GatysConfig(num_steps=2, w_style=1e4))
    want = jpipeline.apply_image(
        jc, jreq, jpipeline.EffectInputs(style_image=js),
        jpipeline.ModelRegistry(vgg_params=jparams,
                                mask_extractor=jmasking._fallback_location_mask))
    metrics = RunMetrics()
    got = pipeline.apply_image(
        tc, treq, pipeline.EffectInputs(style_image=ts),
        pipeline.ModelRegistry(vgg_params=tparams, device="cpu",
                               mask_extractor=masking._fallback_location_mask), metrics)
    assert got.shape == tc.shape and len(metrics.loss_history) == 2
    assert metrics.degraded == []  # injected models are never flagged
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)
    assert not torch.equal(got, tc)  # stylized under the mask


@pytest.mark.parametrize("flag", [["--text-style", "mosaic"], ["--text-texture", "fire"]])
def test_cli_other_text_flags_still_exit_2(flag, tmp_path):
    """The other two text flags exited 2 until the feed-forward text style
    and the emoji texture were ported: now they run beside --text-location
    with rc 0 (tests/test_torch_text.py holds them against the JAX
    package). The test keeps its old name so that earlier test records
    still match it."""
    image, out = tmp_path / "c.png", tmp_path / "o.png"
    Image.open(BOAT).convert("RGB").resize((64, 64)).save(image)
    assert cli.main(["--image", str(image), "--out", str(out), "--device", "cpu",
                     "--text-location", "boat", *flag]) == 0
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)


def _small_images(tmp_path):
    paths = []
    for src, name in ((BOAT, "c.png"), (STARRY, "s.png")):
        Image.open(src).convert("RGB").resize((64, 64)).save(tmp_path / name)
        paths.append(str(tmp_path / name))
    return paths


def test_cli_aot_cache_is_a_no_op(tmp_path):
    content, style = _small_images(tmp_path)
    out = tmp_path / "o.png"
    rc = cli.main(["--aot-cache", "--style-transfer", "--image", content, "--style", style,
                   "--steps", "2", "--device", "cpu", "--out", str(out)])
    assert rc == 0 and np.asarray(Image.open(out)).shape == (64, 64, 3)


def test_cli_resume_dir_is_ignored_where_jax_ignores_it(tmp_path):
    content, style = _small_images(tmp_path)
    out = tmp_path / "o.png"
    rc = cli.main(["--resume-dir", str(tmp_path / "d"), "--mixing", "--image", content,
                   "--style", style, "--style2", style, "--steps", "2", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0 and out.exists()


def test_cli_resume_dir_exits_2_where_jax_would_resume(tmp_path):
    """Where the JAX CLI resumes (--style-transfer, --image, --style), the
    port's does too and exits 0: a second call with more steps resumes at
    the first's last step and writes the new last step. (The name is kept
    from when the port refused this case with exit 2.)"""
    content, style = _small_images(tmp_path)
    argv = ["--resume-dir", str(tmp_path / "d"), "--style-transfer", "--image", content,
            "--style", style, "--device", "cpu", "--out", str(tmp_path / "o.png"),
            "--segment-steps", "2"]
    assert cli.main(argv + ["--steps", "2"]) == 0
    assert os.listdir(tmp_path / "d") == ["step_2"]
    metrics = RunMetrics()
    assert cli.main(argv + ["--steps", "3"], metrics=metrics) == 0
    assert sorted(os.listdir(tmp_path / "d")) == ["step_2", "step_3"]
    assert metrics.extra == {"resumed_at_step": 2, "segments": 1}
    assert len(metrics.loss_history) == 1
    assert np.asarray(Image.open(tmp_path / "o.png")).shape == (64, 64, 3)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    req = EffectRequest(text=TextEffectConfig(location_prompt="boat"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.apply_image(BOAT, req)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.get_mask_extractor.__wrapped__()
    with pytest.raises(RuntimeError, match="device='cpu'"):  # not a fallback
        masking.default_mask_extractor.__wrapped__()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tds.get_batch_mask_extractor.__wrapped__()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # one card: on a host with several, the mesh would shard these runs
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    return torch.device("cuda")


@pytest.mark.gpu
def test_extract_mask_on_card_matches_cpu(cuda, models, no_thresholds):
    _, _, td, ts = models
    img = _img(71)
    cpu = tds.extract_mask(td, ts, img, "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    card = tds.extract_mask(dino_convert.to_device(td, cuda), wsam.to_device(ts, cuda), img,
                            "boat", sam_cfg=TSAM, vocab=VOCAB, **TKW)
    assert card.device.type == "cuda"
    assert np.mean(card.cpu().numpy() != cpu.numpy()) <= MASK_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True])
def test_dino_on_card_matches_cpu(cuda, models, full):
    """Tiny weights at 64x64, and full SwinT-OGC width at 256x320."""
    if full:
        params, kw = dino_convert.init_params(torch.Generator().manual_seed(0)), {}
        hw, vocab = (256, 320), {"[CLS]": 101, "[SEP]": 102, ".": 1012, "boat": 3000}
    else:
        params, kw = models[2], {k: v for k, v in TKW.items() if k != "det_hw"}
        hw, vocab = (64, 64), VOCAB
    img = torch.from_numpy(_img(72, (*hw, 3)))
    outs = []
    for dev in ("cpu", cuda):
        p = dino_convert.to_device(params, dev)
        _, out = tds._detect_dispatch(p, img.to(dev), "boat", vocab, det_hw=hw, **kw)
        outs.append({k: v.cpu() for k, v in out.items()})
        tds.clear_text_feature_cache()
    same = outs[0]["topk_index"] == outs[1]["topk_index"]
    assert float(same.float().mean()) > 0.99
    # relative to the largest magnitude: seeded logits are about N(0, 16²),
    # so an element near 0 has no meaningful relative error of its own
    for key in ("topk_scores", "pred_logits", "pred_boxes"):
        a, b = outs[0][key][same], outs[1][key][same]
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-3, key


@pytest.mark.gpu
@pytest.mark.parametrize("full", [False, True])
def test_detect_dispatch_makes_no_host_sync(cuda, models, full):
    """Tiny weights at 64x64, and full SwinT-OGC width at 800x1056 (the
    query selection then sorts 17,546 scores, a path of its own)."""
    if full:
        td = dino_convert.init_params(torch.Generator().manual_seed(0), device=cuda)
        kw, hw, vocab = {}, (480, 640), {"[CLS]": 101, "[SEP]": 102, ".": 1012, "boat": 3000}
    else:
        td, kw, hw, vocab = dino_convert.to_device(models[2], cuda), TKW, (64, 64), VOCAB
    img = torch.from_numpy(_img(73, (*hw, 3))).to(cuda)
    tds._detect_dispatch(td, img, "boat", vocab, **kw)  # builds the per-shape constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, out = tds._detect_dispatch(td, img, "boat", vocab, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_queries = 900 if full else 20
    assert out["pred_logits"].shape == (1, n_queries, len(ids))
    tds.clear_text_feature_cache()
