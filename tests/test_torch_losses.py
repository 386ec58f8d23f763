"""The port's losses against ``tbist_tpu.ops.losses``: values and input
gradients on the same seeded numpy inputs, both sides in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.ops import losses as jl
from tbist_tpu.ops import mixing as jmix
from tbist_tpu_torch.ops import losses as tl
from tbist_tpu_torch.ops import mixing as tmix

RTOL = 1e-5  # f32 sums in another order on each side
LAYERS = ("conv1_1", "conv2_1")


def _arr(rng, *shape, lo=-1.0, hi=1.0):
    return (rng.random(shape, dtype=np.float32) * (hi - lo) + lo).astype(np.float32)


def _feats(seed, s1=(12, 10), s2=(6, 5)):
    rng = np.random.default_rng(seed)
    return {"conv1_1": _arr(rng, 1, *s1, 8), "conv2_1": _arr(rng, 1, *s2, 16)}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d, grad=False):
    return {k: torch.tensor(v, requires_grad=grad) for k, v in d.items()}


def _check_value_and_grad(jfn, tfn, inputs, rtol=RTOL, atol=1e-7):
    """jfn/tfn map a list of f32 arrays/tensors to a scalar; compare the
    value and the gradient w.r.t. every input."""
    jv, jg = jax.value_and_grad(lambda *a: jfn(*a), argnums=tuple(range(len(inputs))))(
        *[jnp.asarray(x) for x in inputs]
    )
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    tv = tfn(*ts)
    tg = torch.autograd.grad(tv, ts)
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv), rtol=rtol)
    for a, b in zip(tg, jg):
        scale = np.abs(np.asarray(b)).max()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol, atol=atol * max(1.0, scale))


def test_normalize():
    rng = np.random.default_rng(0)
    x = _arr(rng, 2, 5, 4, 3, lo=0.0)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    want = np.asarray(jl.normalize(jnp.asarray(x), mean, std))
    got = tl.normalize(torch.from_numpy(x), mean, std).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_content_loss():
    a, b = _feats(1), _feats(2)
    _check_value_and_grad(
        lambda x, y: jl.content_loss({"conv1_1": x, "conv2_1": y}, _j(b), LAYERS),
        lambda x, y: tl.content_loss({"conv1_1": x, "conv2_1": y}, _t(b), LAYERS),
        [a["conv1_1"], a["conv2_1"]],
    )


@pytest.mark.parametrize("shape", [(1, 8, 6, 16), (2, 5, 4, 64), (1, 16, 16, 128)])
def test_gram_matrix(shape):
    x = _arr(np.random.default_rng(3), *shape)
    _check_value_and_grad(
        lambda x: jnp.sum(jl.gram_matrix(x) * jnp.arange(shape[-1], dtype=jnp.float32)),
        lambda x: torch.sum(tl.gram_matrix(x) * torch.arange(shape[-1], dtype=torch.float32)),
        [x],
    )
    got = tl.gram_matrix(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], shape[3], shape[3])
    np.testing.assert_allclose(got.numpy(), np.asarray(jl.gram_matrix(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-7)


def test_gram_matrix_matches_pallas_kernel_in_interpret_mode():
    """As tests/test_aux.py::TestPallasGramParity runs the Pallas kernel."""
    from jax.experimental.pallas import tpu as pltpu

    from tbist_tpu.ops import pallas_gram

    x = _arr(np.random.default_rng(4), 1, 16, 16, 128)
    w = _arr(np.random.default_rng(5), 128, 128)
    with pltpu.force_tpu_interpret_mode():
        jv, jg = jax.value_and_grad(
            lambda x: jnp.sum(pallas_gram.gram_matrix(x)[0] * w)
        )(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tv = torch.sum(tl.gram_matrix(xt)[0] * torch.from_numpy(w))
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-7 * np.abs(np.asarray(jg)).max())


def test_gram_matrix_bf16_accumulates_in_f32():
    x = _arr(np.random.default_rng(6), 1, 8, 8, 32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tl.gram_matrix(xb)
    assert got.dtype == torch.float32
    want = np.asarray(jl.gram_matrix(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


def test_style_loss_one_style():
    a, s = _feats(7), _feats(8)
    _check_value_and_grad(
        lambda x, y: jl.style_loss({"conv1_1": x, "conv2_1": y}, [_j(s)], LAYERS),
        lambda x, y: tl.style_loss({"conv1_1": x, "conv2_1": y}, [_t(s)], LAYERS),
        [a["conv1_1"], a["conv2_1"]],
    )


@pytest.mark.parametrize("exact", [False, True])
def test_style_loss_two_style_mixing(exact):
    a, s1 = _feats(9), _feats(10)
    s2 = _feats(11, s1=(16, 8), s2=(8, 4))
    _check_value_and_grad(
        lambda x, y: jl.style_loss({"conv1_1": x, "conv2_1": y}, [_j(s1), _j(s2)], LAYERS,
                                   0.3, exact),
        lambda x, y: tl.style_loss({"conv1_1": x, "conv2_1": y}, [_t(s1), _t(s2)], LAYERS,
                                   0.3, exact),
        [a["conv1_1"], a["conv2_1"]],
    )


@pytest.mark.parametrize("exact", [False, True])
def test_mix_features(exact):
    rng = np.random.default_rng(12)
    f1, f2 = _arr(rng, 1, 12, 10, 4), _arr(rng, 1, 6, 16, 4)
    want = np.asarray(jmix.mix_features(jnp.asarray(f1), jnp.asarray(f2), 0.25, exact))
    got = tmix.mix_features(torch.from_numpy(f1), torch.from_numpy(f2), 0.25, exact)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)


def test_total_variation_loss():
    x = _arr(np.random.default_rng(13), 1, 9, 7, 3)
    _check_value_and_grad(jl.total_variation_loss, tl.total_variation_loss, [x])


def test_to_grayscale_and_gradient_images():
    x = _arr(np.random.default_rng(14), 2, 9, 7, 3)
    w = _arr(np.random.default_rng(15), 2, 7, 5, 2)
    _check_value_and_grad(
        lambda x: jnp.sum(jl.gradient_images(jl.to_grayscale(x)) * w),
        lambda x: torch.sum(tl.gradient_images(tl.to_grayscale(x)) * torch.from_numpy(w)),
        [x],
    )


def test_edge_loss():
    rng = np.random.default_rng(16)
    a, b = _arr(rng, 1, 7, 5, 2), _arr(rng, 1, 7, 5, 2)
    _check_value_and_grad(jl.edge_loss, tl.edge_loss, [a, b])


def test_depth_loss():
    rng = np.random.default_rng(17)
    a, b = _arr(rng, 1, 9, 7), _arr(rng, 1, 9, 7)
    _check_value_and_grad(jl.depth_loss, tl.depth_loss, [a, b])
