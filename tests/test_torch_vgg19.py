"""The port's VGG-19 and its weight loading against the JAX package, on
weights carried over with ``from_jax_params``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.models import vgg19 as jvgg
from tbist_tpu.ops import losses as jl
from tbist_tpu_torch.models import vgg19 as tvgg
from tbist_tpu_torch.ops import losses as tl
from tbist_tpu_torch.utils import degraded
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


def test_style_loss_input_gradient_matches_jax():
    # a darker content than style: the Gram difference that scales the
    # gradient is then not a cancellation of two near-equal Grams
    x, s = 0.5 * _img(3), _img(4)
    layers = ("conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv5_1")
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


def test_bf16_trunk_stays_near_f32():
    x = torch.from_numpy(_img(5))
    f32 = tvgg.extract_features(TPARAMS, x, LAYERS)
    bf16 = tvgg.extract_features(TPARAMS, x, LAYERS, torch.bfloat16)
    for name in LAYERS:
        assert bf16[name].dtype == torch.bfloat16
        err = (bf16[name].float() - f32[name]).abs().max() / f32[name].abs().max()
        assert err < 5e-2, (name, float(err))


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
