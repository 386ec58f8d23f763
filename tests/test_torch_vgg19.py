"""The port's VGG-19 and its weight loading against the JAX package, on
weights carried over with ``from_jax_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.ops import losses as jl
from tbist_tpu_torch.models import vgg19 as tvgg
from tbist_tpu_torch.ops import losses as tl
from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.weights import vgg as tweights

JPARAMS = jvgg.init_params(jax.random.key(0))
NP_PARAMS = jax.tree.map(np.asarray, JPARAMS)
TPARAMS = tweights.from_jax_params(NP_PARAMS)
LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2", "conv5_1")
RTOL = 1e-4


def _img(seed, h=32, w=32):
    return np.random.default_rng(seed).random((1, h, w, 3), dtype=np.float32)


def _assert_close(got, want, rtol=RTOL):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_layer_tables_match_jax():
    assert tvgg.VGG19_LAYERS == jvgg.VGG19_LAYERS
    assert tvgg.CONV_NAMES == jvgg.CONV_NAMES


def test_from_jax_params_layout():
    p = TPARAMS["conv2_1"]
    assert tuple(p["weight"].shape) == (128, 64, 3, 3)
    assert p["weight"].is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        p["weight"].permute(2, 3, 1, 0).numpy(), NP_PARAMS["conv2_1"]["kernel"]
    )


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])  # 36x44 drops odd rows at pool3
def test_features_match_jax(hw):
    x = _img(1, *hw)
    want = jvgg.extract_features(JPARAMS, jnp.asarray(x), LAYERS)
    got = tvgg.extract_features(TPARAMS, torch.from_numpy(x), LAYERS)
    assert set(got) == set(LAYERS)
    for name in LAYERS:
        assert got[name].is_contiguous()
        assert tuple(got[name].shape) == want[name].shape
        _assert_close(got[name].numpy(), np.asarray(want[name]))


def test_early_stop_and_unknown_layer():
    x = torch.from_numpy(_img(2))
    assert set(tvgg.extract_features(TPARAMS, x, ("conv2_1",))) == {"conv2_1"}
    with pytest.raises(ValueError):
        tvgg.extract_features(TPARAMS, x, ("conv9_9",))


STYLE_LAYERS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")


def _style_loss_and_gradient_against_jax(side, layers=STYLE_LAYERS):
    # a darker content than style: the Gram difference that scales the
    # gradient is then not a cancellation of two near-equal Grams
    x, s = 0.5 * _img(3, side, side), _img(4, side, side)
    s_feats = jvgg.extract_features(JPARAMS, jnp.asarray(s), layers)

    def jloss(img):
        return jl.style_loss(jvgg.extract_features(JPARAMS, img, layers), [s_feats], layers)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(x))
    ts_feats = tvgg.extract_features(TPARAMS, torch.from_numpy(s), layers)
    xt = torch.tensor(x, requires_grad=True)
    tv = tl.style_loss(tvgg.extract_features(TPARAMS, xt, layers), [ts_feats], layers)
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    _assert_close(tg.numpy(), np.asarray(jg))


def test_style_loss_input_gradient_matches_jax():
    _style_loss_and_gradient_against_jax(32)


@pytest.mark.parametrize("side,layers,flipped,native", [
    (64, STYLE_LAYERS, 1, 12),
    (128, STYLE_LAYERS[:3], 3, 2),
])
def test_flipped_input_gradient_matches_jax(side, layers, flipped, native):
    """The style loss's value and input gradient against
    ``jax.value_and_grad`` where trunk convs take the flipped forward (64
    input channels and 64² pixels or more): conv1_2 at 64px; conv1_2,
    conv2_1 and conv2_2 at 128px. At 128px the trunk stops at conv3_1: one
    conv3_2 output lies within f32 rounding of 0, so its relu mask differs
    from f64's, and the gradients of conv4_1's and conv5_1's terms with
    it, on either route."""
    tvgg.reset_dgrad_counts()
    _style_loss_and_gradient_against_jax(side, layers)
    assert tvgg.dgrad_counts() == {"flipped": flipped, "native": native}


def test_bf16_trunk_stays_near_f32():
    x = torch.from_numpy(_img(5))
    f32 = tvgg.extract_features(TPARAMS, x, LAYERS)
    bf16 = tvgg.extract_features(TPARAMS, x, LAYERS, torch.bfloat16)
    for name in LAYERS:
        assert bf16[name].dtype == torch.bfloat16
        err = (bf16[name].float() - f32[name]).abs().max() / f32[name].abs().max()
        assert err < 5e-2, (name, float(err))


TRUNK_CONVS = [s for s in tvgg.VGG19_LAYERS if len(s) == 3][:13]  # conv1_1 .. conv5_1


def _autograd_conv(x, p, padding):
    """The trunk's conv with autograd's own backward, NHWC in and out."""
    return F.conv2d(x.permute(0, 3, 1, 2), p["weight"], p["bias"],
                    padding=padding).permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("padding", [(1, 1), (1, 0)], ids=["same", "halo"])
@pytest.mark.parametrize("name,cin,cout", TRUNK_CONVS, ids=[s[0] for s in TRUNK_CONVS])
def test_trunk_conv_input_gradient_by_either_route(name, cin, cout, padding, batch, dtype):
    """Each trunk conv at its published channels, as the whole image
    (padding 1) and as a width shard (padding (1, 0)): ``TrunkConv``'s
    forward is ``F.conv2d`` bit for bit, its input gradient autograd's (f64
    to 1e-12, f32 to rtol 1e-5), and weight and bias get none. ``_conv``
    counts the route ``flips`` names for frozen weights, and takes
    autograd's own, uncounted, for a weight that takes a gradient."""
    g = torch.Generator().manual_seed(cin * cout + batch)
    w = torch.randn(cout, cin, 3, 3, generator=g, dtype=dtype) * (2.0 / (9 * cin)) ** 0.5
    p = {"weight": w.contiguous(memory_format=torch.channels_last),
         "bias": torch.randn(cout, generator=g, dtype=dtype)}
    x = torch.randn(batch, 6, 7, cin, generator=g, dtype=dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    xb = x.clone().requires_grad_(True)
    yb = _autograd_conv(xb, p, padding)
    gy = torch.randn(yb.shape, generator=g, dtype=dtype)
    yb.backward(gy)

    xa = x.clone().requires_grad_(True)
    trained = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    ya = tvgg.TrunkConv.apply(xa.permute(0, 3, 1, 2), trained["weight"], trained["bias"],
                              padding).permute(0, 2, 3, 1)
    assert torch.equal(ya, yb)
    ya.backward(gy)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=tol, atol=tol * xb.grad.abs().max())
    assert trained["weight"].grad is None and trained["bias"].grad is None

    tvgg.reset_dgrad_counts()
    xa = x.clone().requires_grad_(True)
    tvgg._conv(xa, p, dtype, padding).backward(gy)
    flip = tvgg.flips(xa.permute(0, 3, 1, 2))
    assert tvgg.dgrad_counts() == {"flipped": int(flip), "native": int(not flip)}
    torch.testing.assert_close(xa.grad, xb.grad, rtol=tol, atol=tol * xb.grad.abs().max())

    tvgg.reset_dgrad_counts()
    trained = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xc = x.clone().requires_grad_(True)
    yc = tvgg._conv(xc, trained, dtype, padding)
    assert torch.equal(yc, yb)
    yc.backward(gy)
    assert tvgg.dgrad_counts() == {"flipped": 0, "native": 0}
    assert trained["weight"].grad is not None and trained["bias"].grad is not None
    torch.testing.assert_close(xc.grad, xb.grad, rtol=0, atol=0)


def test_flips_keeps_conv1_1_and_conv5_1_native_at_512px():
    """The route at the 13 trunk shapes of a 512px image: conv1_1 (3 input
    channels) and conv5_1 (32²) by cuDNN's own input gradient, the other 11
    by the flipped forward; at 1024px conv1_1 alone."""
    for side, native in ((512, {"conv1_1", "conv5_1"}), (1024, {"conv1_1"})):
        got = set()
        for name, cin, _ in TRUNK_CONVS:
            s = side >> (int(name[4]) - 1)
            if not tvgg.flips(torch.empty(1, cin, s, s, device="meta")):
                got.add(name)
        assert got == native, side


def test_flipped_weight_is_made_once_a_weight_and_dtype():
    """The flipped weights are kept for each weight tensor and dtype, and
    made again once the weight is written in place."""
    w = TPARAMS["conv2_1"]["weight"].clone(memory_format=torch.channels_last)
    a = tvgg.flipped_weight(w, torch.float32)
    assert tvgg.flipped_weight(w, torch.float32) is a
    assert tuple(a.shape) == (64, 128, 3, 3)
    assert a.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(a, w.flip(2, 3).transpose(0, 1), rtol=0, atol=0)
    b = tvgg.flipped_weight(w, torch.bfloat16)
    assert b.dtype == torch.bfloat16 and tvgg.flipped_weight(w, torch.float32) is a
    w.mul_(2)
    c = tvgg.flipped_weight(w, torch.float32)
    assert c is not a
    torch.testing.assert_close(c, 2 * a, rtol=0, atol=0)


def test_one_gatys_step_makes_13_trunk_input_gradients():
    """A step of ``gatys.stylize`` to conv5_1 at 128px takes the 13 input
    gradients of its trunk, conv1_2, conv2_1 and conv2_2 by the flipped
    forward (64² pixels or more); the targets, without a gradient, take
    none."""
    content, style = torch.from_numpy(_img(6, 128, 128)), torch.from_numpy(_img(7, 128, 128))
    tvgg.reset_dgrad_counts()
    gatys.stylize(content, [style], GatysConfig(num_steps=1), TPARAMS, device="cpu")
    assert tvgg.dgrad_counts() == {"flipped": 3, "native": 10}


def test_torch_generator_init_is_he_scaled_and_seeded():
    a = tvgg.init_params(torch.Generator().manual_seed(0))
    b = tvgg.init_params(torch.Generator().manual_seed(0))
    for name, cin, cout in (s for s in tvgg.VGG19_LAYERS if len(s) == 3):
        assert tuple(a[name]["weight"].shape) == (cout, cin, 3, 3)
        torch.testing.assert_close(a[name]["weight"], b[name]["weight"], rtol=0, atol=0)
        std = a[name]["weight"].std().item()
        assert abs(std / np.sqrt(2.0 / (9 * cin)) - 1) < 0.2


class TestGetParams:
    @pytest.fixture(autouse=True)
    def _isolated(self, tmp_path, monkeypatch):
        monkeypatch.setattr(tweights, "_CACHE_DIR", str(tmp_path))
        monkeypatch.delenv("TBIST_VGG19_PTH", raising=False)
        tweights.get_params.cache_clear()
        degraded.reset()
        yield
        tweights.get_params.cache_clear()
        degraded.reset()

    def _flat(self):
        return {f"{n}.{k}": v for n, p in NP_PARAMS.items() for k, v in p.items()}

    def test_torch_seeded_fallback_is_marked_degraded(self):
        params = tweights.get_params(seed=3, device="cpu")
        want = tvgg.init_params(torch.Generator().manual_seed(3))
        torch.testing.assert_close(params["conv1_1"]["weight"], want["conv1_1"]["weight"])
        assert degraded.flags_for(["vgg_params"]) == ["vgg_seeded"]

    def test_seeded_npz_from_the_jax_package(self, tmp_path):
        leaves = jax.tree.leaves(NP_PARAMS)
        np.savez(tmp_path / "vgg19_seeded_s0.npz", **{str(i): l for i, l in enumerate(leaves)})
        params = tweights.get_params(seed=0, device="cpu")
        torch.testing.assert_close(params["conv3_2"]["weight"], TPARAMS["conv3_2"]["weight"])
        assert degraded.flags_for(["vgg_params"]) == ["vgg_seeded"]

    def test_converted_npz_then_pth_win(self, tmp_path):
        np.savez(tmp_path / "vgg19.npz", **self._flat())
        params = tweights.get_params(device="cpu")
        torch.testing.assert_close(params["conv5_1"]["weight"], TPARAMS["conv5_1"]["weight"])
        assert degraded.flags_for(["vgg_params"]) == []

        idx = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
        sd = {}
        for n, i in zip(tvgg.CONV_NAMES, idx):
            sd[f"features.{i}.weight"] = 2 * TPARAMS[n]["weight"].contiguous()
            sd[f"features.{i}.bias"] = TPARAMS[n]["bias"] + 1
        torch.save(sd, tmp_path / "vgg19.pth")
        tweights.get_params.cache_clear()
        params = tweights.get_params(device="cpu")
        torch.testing.assert_close(params["conv1_2"]["weight"], 2 * TPARAMS["conv1_2"]["weight"])
        assert params["conv1_2"]["weight"].is_contiguous(memory_format=torch.channels_last)
