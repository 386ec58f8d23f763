"""The port's Gatys stylization end to end on the CPU: against the JAX
package's ``stylize``, the committed golden, and through the CLI."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.optimize import gatys as jgatys
from tbist_tpu.utils import config as jconfig
from tbist_tpu.utils import imageio as jio
from tbist_tpu_torch import api, cli
from tbist_tpu_torch.compose import pipeline
from tbist_tpu_torch.optimize import gatys as tgatys
from tbist_tpu_torch.utils import imageio as tio
from tbist_tpu_torch.utils.config import DepthConfig, EffectRequest, GatysConfig
from tbist_tpu_torch.utils.logging import RunMetrics
from tbist_tpu_torch.utils.precision import full_f32
from tbist_tpu_torch.weights.vgg import from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOAT = os.path.join(ROOT, "data/content_imgs/boat.jpg")
STARRY = os.path.join(ROOT, "data/style_imgs/starry_night.jpg")
PICASSO = os.path.join(ROOT, "data/style_imgs/picasso.jpg")

JPARAMS = jvgg.init_params(jax.random.key(0))
TPARAMS = from_jax_params(jax.tree.map(np.asarray, JPARAMS))


def _pair(path, max_side=64):
    img = tio.load_image(path)
    return (jio.to_device(img, bucket=32, max_side=max_side),
            tio.to_device(img, bucket=32, max_side=max_side, device="cpu"))


def _compare(jcfg, tcfg, styles, hist_rtol, img_atol):
    jc, tc = _pair(BOAT)
    js, ts = zip(*[_pair(p) for p in styles])
    jout, jhist = jgatys.stylize(jc, list(js), jcfg, JPARAMS)
    tout, thist = tgatys.stylize(tc, list(ts), tcfg, TPARAMS, device="cpu")
    assert tout.shape == tc.shape and thist.shape == (tcfg.num_steps,)
    assert float(tout.min()) >= 0 and float(tout.max()) <= 1
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), rtol=hist_rtol)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=img_atol)
    return tout, thist


def test_lbfgs_matches_jax_and_golden():
    tout, thist = _compare(jconfig.GatysConfig(num_steps=8, w_style=1e4),
                           GatysConfig(num_steps=8, w_style=1e4), [STARRY], 1e-3, 1e-3)
    assert thist[-1] < thist[0]
    _check_golden(tout, "gatys_8step")


def test_adam_matches_jax():
    _compare(jconfig.GatysConfig(num_steps=4, w_style=1e4, optimizer="adam"),
             GatysConfig(num_steps=4, w_style=1e4, optimizer="adam"), [STARRY], 1e-3, 2e-2)


def _check_golden(out, name):
    golden = np.load(os.path.join(ROOT, "tests/golden", f"{name}.npy"))
    err = np.abs(out[0].numpy() - golden)  # test_golden.py's limits
    assert err.max() < 5e-2 and err.mean() < 5e-3, (name, err.max(), err.mean())


def test_two_style_mixing_matches_jax_and_golden():
    # After 3 steps one conv1_2 pool window holds an exact tie in the port's
    # conv output and a one-ulp difference in XLA's, so the two split that
    # window's gradient differently; the images then differ by a few 1e-3
    # while the loss histories still agree.
    tout, _ = _compare(jconfig.GatysConfig(num_steps=8, w_style=1e4, style_img_weight=0.3),
                       GatysConfig(num_steps=8, w_style=1e4, style_img_weight=0.3),
                       [STARRY, PICASSO], 1e-3, 1e-2)
    _check_golden(tout, "mixing_2style")


def test_random_init_and_channel_attention():
    _, tc = _pair(BOAT, 32)
    cfg = GatysConfig(num_steps=2, w_style=1e4, random_init=True)
    a, _ = tgatys.stylize(tc, [tc], cfg, TPARAMS, device="cpu")
    b, _ = tgatys.stylize(tc, [tc], cfg, TPARAMS, device="cpu")
    c, _ = tgatys.stylize(tc, [tc], dataclasses.replace(cfg, random_init=False), TPARAMS,
                          device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)  # seeded
    assert not torch.allclose(a, c, atol=1e-3)
    ca = dataclasses.replace(cfg, channel_attention=True)
    d, hist = tgatys.stylize(tc, [tc], ca, TPARAMS, device="cpu")
    e, _ = tgatys.stylize(tc, [tc], ca, TPARAMS, device="cpu")
    torch.testing.assert_close(d, e, rtol=0, atol=0)  # the SE weights are seeded too
    assert d.shape == tc.shape and bool(torch.isfinite(hist).all())
    assert not torch.allclose(a, d, atol=1e-4)  # the attention changes the result


def test_full_f32_restores_tf32_flags():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_api_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    req = EffectRequest(style_transfer=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.apply_image(BOAT, req, style_image=STARRY)
    with pytest.raises(NotImplementedError, match="slice 7"):
        api.apply_video(BOAT, req)


def test_pipeline_stages():
    _, tc = _pair(BOAT, 32)
    reg = pipeline.ModelRegistry(vgg_params=TPARAMS, device="cpu")
    req = EffectRequest(style_transfer=True, gatys=GatysConfig(num_steps=2, w_style=1e4))
    assert pipeline.apply_image(tc, req, pipeline.EffectInputs(), reg) is None
    metrics = RunMetrics()
    out = pipeline.apply_image(tc, req, pipeline.EffectInputs(style_image=tc), reg, metrics)
    assert out.shape == tc.shape and len(metrics.loss_history) == 2
    assert "gatys" in metrics.timings_s and metrics.degraded == []
    # stage 1 runs first, and without a location mask stage 4 takes its output
    gray = pipeline.apply_image(tc, dataclasses.replace(req, grayscale=True),
                                pipeline.EffectInputs(style_image=tc), reg)
    gray_in = pipeline.apply_image(tc, EffectRequest(grayscale=True), None, reg)
    torch.testing.assert_close(
        gray, pipeline.apply_image(gray_in, req, pipeline.EffectInputs(style_image=tc), reg))
    alone = pipeline.apply_image(tc, EffectRequest(grayscale=True), None, reg)
    torch.testing.assert_close(alone, tc @ torch.tensor([0.299, 0.587, 0.114])[:, None]
                               .expand(3, 3))
    # stage 7 runs too (tests/test_torch_depth.py); without a style image it returns None
    assert pipeline.apply_image(tc, EffectRequest(depth=DepthConfig()), None, reg) is None


def test_cli_drives_the_port_on_cpu(tmp_path):
    paths = []
    for src, name in ((BOAT, "c.png"), (STARRY, "s.png")):
        Image.open(src).convert("RGB").resize((64, 64)).save(tmp_path / name)
        paths.append(str(tmp_path / name))
    out = tmp_path / "out.png"
    rc = cli.main(["--image", paths[0], "--style", paths[1], "--style-transfer",
                   "--device", "cpu", "--steps", "2", "--out", str(out)])
    assert rc == 0
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)


# --aot-cache is a no-op, and --resume-dir counts only where the JAX CLI
# resumes (tests/test_torch_dino_sam.py)
@pytest.mark.parametrize("flag", [["--video", "x.mp4"], ["--video", "x.mp4", "--depth", "depth_loss"],
                                  ["--video", "x.mp4", "--depth", "mip"],
                                  ["--video", "x.mp4", "--text-style", "mosaic"]])
def test_cli_unported_flags_exit_2(flag, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--image", BOAT, "--out", "o.png", "--device", "cpu", *flag])
    assert exc.value.code == 2
    assert "not ported" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--pixel-art"], ["--grayscale"],
                                  ["--resume-dir", "{tmp}/d", "--style-transfer", "--style",
                                   "{s}", "--steps", "2", "--segment-steps", "1"],
                                  ["--channel-attention", "--style-transfer", "--style", "{s}",
                                   "--steps", "2"]])
def test_cli_ported_flags_run_on_cpu(flag, tmp_path):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    Image.open(BOAT).convert("RGB").resize((64, 64)).save(content)
    Image.open(STARRY).convert("RGB").resize((64, 64)).save(style)
    flag = [f.format(tmp=tmp_path, s=style) for f in flag]
    out = tmp_path / "o.png"
    metrics = RunMetrics()
    assert cli.main(["--image", str(content), "--out", str(out), "--device", "cpu", *flag],
                    metrics=metrics) == 0
    assert np.asarray(Image.open(out)).shape == (64, 64, 3)
    if "--style-transfer" in flag:
        assert len(metrics.loss_history) == 2
