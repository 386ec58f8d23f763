"""Kernels K1-K4 of the port.

Here on the CPU the wrappers take their plain PyTorch versions; those are
held against the JAX package's Pallas kernels in interpret mode and
against ``jax.grad`` of the reshape-max, with exact ties and zeros. Tests
marked ``gpu`` hold each CUDA kernel against its plain version and skip
where there is no card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu_torch import kernels
from tbist_tpu_torch.kernels import gram, pool, relu_pool, sam_attn
from tbist_tpu_torch.utils.precision import full_f32

SHAPES = [(1, 16, 12, 8), (2, 8, 6, 3), (1, 4, 4, 64)]


def _quarters(seed, shape, lo, hi):
    """Values on quarter steps, so windows hold exact ties (and zeros)."""
    x = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return np.round(x * 4) / 4


def _auto_pool(x):
    b, h, w, c = x.shape
    return jnp.max(x.reshape(b, h // 2, 2, w // 2, 2, c), axis=(2, 4))


def _torch_value_and_grad(fn, x, w):
    xt = torch.tensor(x, requires_grad=True)
    out = fn(xt)
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), xt)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_max_pool_2x2_even_matches_jax(shape):
    from jax.experimental.pallas import tpu as pltpu

    from tbist_tpu.ops import pallas_pool

    x = _quarters(5, shape, 0.0, 1.0)
    w = np.random.default_rng(6).standard_normal(
        (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    ).astype(np.float32)
    f, g = _torch_value_and_grad(pool.max_pool_2x2_even, x, w)

    def loss(fn):
        return lambda x: jnp.sum(fn(x) * w)

    np.testing.assert_array_equal(f, np.asarray(_auto_pool(jnp.asarray(x))))
    np.testing.assert_allclose(g, np.asarray(jax.grad(loss(_auto_pool))(jnp.asarray(x))),
                               atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        gp = np.asarray(jax.grad(loss(pallas_pool.max_pool_2x2_even))(jnp.asarray(x)))
    np.testing.assert_allclose(g, gp, atol=1e-6)
    # ties split: some window must have shared its gradient
    assert np.any((g != 0) & (np.abs(g) < np.abs(w).repeat(2, 1).repeat(2, 2)))


@pytest.mark.parametrize("shape", SHAPES)
def test_relu_max_pool_2x2_even_matches_jax(shape):
    from jax.experimental.pallas import tpu as pltpu

    from tbist_tpu.ops import pallas_relu_pool

    pre = _quarters(7, shape, -0.5, 0.5)  # exact ties AND exact zeros
    w = np.random.default_rng(8).standard_normal(
        (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    ).astype(np.float32)
    f, g = _torch_value_and_grad(relu_pool.relu_max_pool_2x2_even, pre, w)

    def auto(p):
        return _auto_pool(jax.nn.relu(p))

    def loss(fn):
        return lambda p: jnp.sum(fn(p) * w)

    np.testing.assert_array_equal(f, np.asarray(auto(jnp.asarray(pre))))
    np.testing.assert_allclose(g, np.asarray(jax.grad(loss(auto))(jnp.asarray(pre))), atol=1e-6)
    with pltpu.force_tpu_interpret_mode():
        gp = np.asarray(jax.grad(loss(pallas_relu_pool.relu_max_pool_2x2_even))(jnp.asarray(pre)))
    np.testing.assert_allclose(g, gp, atol=1e-6)
    assert np.all(g[pre <= 0] == 0)  # relu'(0) = 0


def test_relu_pool_negative_pre_blocks_gradient():
    pre = -torch.ones((1, 4, 4, 8), requires_grad=True)
    out = relu_pool.relu_max_pool_2x2_even(pre)
    (g,) = torch.autograd.grad(out.sum(), pre)
    assert torch.all(out == 0) and torch.all(g == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_bwd_plain_bf16_matches_f32_formula(dtype):
    pre = torch.from_numpy(_quarters(9, (1, 8, 8, 16), -0.5, 0.5)).to(dtype)
    out = torch.clamp_min(pool.pool_fwd(pre), 0)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal((1, 4, 4, 16))
                         .astype(np.float32)).to(dtype)
    got = relu_pool.relu_pool_bwd(pre, out, g)
    want = pool.pool_bwd_plain(pre.float(), out.float(), g.float(), relu=True).to(dtype)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_gram_backward_matches_pallas_vjp_in_interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    from tbist_tpu.ops import pallas_gram

    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    gbar = rng.standard_normal((64, 64)).astype(np.float32)
    norm = 1.0 / (64 * 64)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x: pallas_gram.gram_2d(x, norm), jnp.asarray(x))
        (want,) = vjp(jnp.asarray(gbar))
    xt = torch.tensor(x[None], requires_grad=True)
    out = gram.GramFunction.apply(xt, norm)
    (got,) = torch.autograd.grad(out, xt, torch.from_numpy(gbar[None]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize(
    "b,n,c", [(1, 262144, 64), (1, 65536, 128), (1, 16384, 256), (1, 4096, 512),
              (1, 1024, 512), (1, 100, 64), (3, 37, 200), (2, 1, 8)]
)
def test_gram_split_rows_covers_every_row_once(b, n, c):
    for target_blocks in (4 * 132, 4 * 114, 4 * 16, 1):  # H100 SXM, H100 PCIe, small slices
        chunks, rows = gram.split_rows(b, n, c, target_blocks)
        assert rows % 32 == 0 and chunks >= 1
        assert (chunks - 1) * rows < n <= chunks * rows


def _sam_attn_inputs(seed, n, h, w, d, device="cpu"):
    rng = np.random.default_rng(seed)
    t = h * w
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device)
            for s in ((n, t, d), (n, t, d), (n, t, d), (n, t, h), (n, t, w))]


def test_sam_attn_plain_matches_pallas_in_interpret_mode():
    from tbist_tpu.ops import pallas_sam_attn

    n, h, w, d = 3, 8, 16, 16  # test_aux.py's shapes: a non-square grid
    args = _sam_attn_inputs(7, n, h, w, d)
    want = pallas_sam_attn.attention_with_rel_bias(
        *(jnp.asarray(a.numpy()) for a in args), h, w, interpret=True)
    kernels.reset_launch_counts()
    got = sam_attn.attention_with_rel_bias(*args, h, w)
    assert got.dtype == torch.float32 and kernels.launch_counts()["sam_attn"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_path_counts_no_launches():
    kernels.reset_launch_counts()
    x = torch.randn(1, 4, 4, 8, requires_grad=True)
    y = gram.gram_matrix(relu_pool.relu_max_pool_2x2_even(x)).sum()
    y = y + pool.max_pool_2x2_even(x).sum()
    y.backward()
    assert kernels.launch_counts() == {k: 0 for k in kernels.WRAPPERS}


def test_wrappers_reject_unsupported_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pool.pool_bwd(x, x[:, :2, :2], x[:, :2, :2])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gram.gram_fwd(x.reshape(1, 16, 8), 1.0)
    q = torch.empty((2, 16, 8), device="meta")
    b = torch.empty((2, 16, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sam_attn.attention_with_rel_bias(q, q, q, b, b, 4, 4)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(1, 4096, 64), (2, 1000, 128), (1, 256, 512), (1, 77, 24)])
def test_gram_kernels_match_plain_on_card(cuda, dtype, b, n, c):
    with full_f32():  # the plain versions in full f32
        _check_gram_kernels(cuda, dtype, b, n, c)


def _check_gram_kernels(cuda, dtype, b, n, c):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((b, n, c), generator=gen, device=cuda).to(dtype)
    before = gram.gram_fwd.launches
    got = gram.gram_fwd(x, 0.5)
    assert gram.gram_fwd.launches == before + 1
    want = gram.gram_fwd_plain(x, 0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * want.abs().max().item())
    m = torch.randn((b, c, c), generator=gen, device=cuda)
    got = gram.gram_bwd(x, m)
    want = gram.gram_bwd_plain(x, m)
    rtol = 1e-5 if dtype == torch.float32 else 8e-3  # one bf16 rounding of the f32 sum
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * want.float().abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 64, 64, 64), (2, 16, 12, 24), (1, 8, 8, 512)])
def test_pool_kernels_match_plain_on_card(cuda, dtype, shape):
    pre = torch.from_numpy(_quarters(12, shape, -0.5, 0.5)).to(cuda, dtype)
    b, h, w, c = shape
    g = torch.randn((b, h // 2, w // 2, c), device=cuda).to(dtype)
    out = pool.pool_fwd(pre)
    torch.testing.assert_close(pool.pool_bwd(pre, out, g), pool.pool_bwd_plain(pre, out, g),
                               rtol=0, atol=1e-6)
    out = torch.clamp_min(out, 0)
    torch.testing.assert_close(relu_pool.relu_pool_bwd(pre, out, g),
                               pool.pool_bwd_plain(pre, out, g, relu=True), rtol=0, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,d", [(2, 24, 40, 64), (3, 5, 7, 16), (1, 64, 64, 64),
                                     (2, 9, 9, 8), (1, 8, 8, 128)])
def test_sam_attn_kernel_matches_plain_on_card(cuda, n, h, w, d):
    # ragged tails: 960, 35 and 81 tokens are not multiples of the 64-key tile
    args = _sam_attn_inputs(13, n, h, w, d, cuda)
    before = sam_attn.attention_with_rel_bias.launches
    got = sam_attn.attention_with_rel_bias(*args, h, w)
    assert sam_attn.attention_with_rel_bias.launches == before + 1
    with full_f32():
        want = sam_attn.attention_with_rel_bias_plain(*args, h, w)
    torch.cuda.synchronize()
    # the online softmax sums the T keys in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
def test_sam_attn_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v, bh, bw = _sam_attn_inputs(14, 2, 4, 4, 16, cuda)
    with pytest.raises(ValueError, match="not h"):  # T = 16, h·w = 4·2
        sam_attn.attention_with_rel_bias(q, k, v, bh, bw[..., :2].contiguous(), 4, 2)
    with pytest.raises(TypeError, match="float32"):
        sam_attn.attention_with_rel_bias(q.double(), k, v, bh, bw, 4, 4)
    with pytest.raises(ValueError, match="contiguous"):
        sam_attn.attention_with_rel_bias(q.transpose(0, 1).contiguous().transpose(0, 1),
                                         k, v, bh, bw, 4, 4)
    q6 = torch.zeros((2, 16, 6), device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        sam_attn.attention_with_rel_bias(q6, q6, q6, bh, bw, 4, 4)
