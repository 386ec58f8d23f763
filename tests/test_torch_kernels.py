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
        assert rows % gram.SLAB_ROWS == 0 and chunks >= 1
        assert (chunks - 1) * rows < n <= chunks * rows


@pytest.mark.parametrize(
    "b,n,c,fwd,bwd",
    [
        # the five style layers at 512px on 132 SMs:
        # (tile, tiles, upper, chunks, rows) of the forward, tile of the backward
        (1, 262144, 64, (1, 1, 1, 521, 504), 1),
        (1, 65536, 128, (0, 1, 1, 256, 256), 0),
        (1, 16384, 256, (0, 2, 3, 86, 192), 0),
        (1, 4096, 512, (0, 4, 10, 27, 152), 1),
        (1, 1024, 512, (0, 4, 10, 26, 40), 1),
        (3, 37, 200, (0, 2, 3, 5, 8), 1),
        (2, 1, 8, (1, 1, 1, 1, 8), 1),
    ],
)
def test_gram_plan_picks_tiles_and_split(b, n, c, fwd, bwd):
    plan = gram.fwd_plan(b, n, c, 132)
    assert tuple(plan) == fwd
    # about BLOCKS_PER_SM blocks on each SM, never a row of chunks more
    assert plan.upper * plan.chunks * b < (gram.BLOCKS_PER_SM[plan.tile] + 1) * 132
    assert gram.bwd_tile(b, n, c, 132) == bwd


@pytest.mark.parametrize("c", [8, 24, 64, 128, 200, 256, 512])
def test_gram_upper_tiles_mirrored_cover_every_tile_once(c):
    plan = gram.fwd_plan(1, 4096, c, 132)
    assert plan.tiles == -(-c // gram.TILE_EDGE[plan.tile])
    covered = []
    for t in range(plan.upper):
        ti, tj = gram.upper_tile(t, plan.tiles)
        assert 0 <= ti <= tj < plan.tiles
        covered += [(ti, tj)] if ti == tj else [(ti, tj), (tj, ti)]
    assert sorted(covered) == [(i, j) for i in range(plan.tiles) for j in range(plan.tiles)]


def _gram_fwd_emulated(x, norm, sms):
    """gram.cu's forward in torch: each chunk's rows give each upper tile a
    partial (zero-padded past N and C), the partials are summed in chunk
    order, scaled, and mirrored below the diagonal; a diagonal tile's
    lower-left quadrant is not computed but mirrored from its upper right."""
    b, n, c = x.shape
    plan = gram.fwd_plan(b, n, c, sms)
    edge = gram.TILE_EDGE[plan.tile]
    xp = torch.zeros((b, plan.chunks * plan.rows, plan.tiles * edge))
    xp[:, :n, :c] = x.float()
    xp = xp.reshape(b, plan.chunks, plan.rows, plan.tiles, edge)
    total = torch.zeros((b, plan.upper, edge, edge))
    for k in range(plan.chunks):
        part = torch.stack([xp[:, k, :, ti].transpose(1, 2) @ xp[:, k, :, tj]
                            for ti, tj in (gram.upper_tile(t, plan.tiles)
                                           for t in range(plan.upper))], 1)
        total = total + part
    g = torch.zeros((b, plan.tiles * edge, plan.tiles * edge))
    for t in range(plan.upper):
        ti, tj = gram.upper_tile(t, plan.tiles)
        blk = total[:, t] * norm
        if ti == tj:
            h = edge // 2
            blk[:, h:, :h] = blk[:, :h, h:].transpose(1, 2)
        g[:, ti * edge:(ti + 1) * edge, tj * edge:(tj + 1) * edge] = blk
        if ti != tj:
            g[:, tj * edge:(tj + 1) * edge, ti * edge:(ti + 1) * edge] = blk.transpose(1, 2)
    return plan, g[:, :c, :c]


@pytest.mark.parametrize("n,c,sms", [(1003, 200, 132), (517, 64, 8), (999, 200, 2)])
def test_gram_upper_tile_emulation_matches_plain_and_pallas(n, c, sms):
    from jax.experimental.pallas import tpu as pltpu

    from tbist_tpu.ops import pallas_gram

    x = np.random.default_rng(15).standard_normal((n, c)).astype(np.float32)
    norm = 1.0 / (n * c)
    plan, got = _gram_fwd_emulated(torch.from_numpy(x)[None], norm, sms)
    assert plan.chunks > 1 and plan.chunks * plan.rows > n  # a split with a ragged last chunk
    with full_f32():
        want = gram.gram_fwd_plain(torch.from_numpy(x)[None], norm)
    atol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_gram.gram_2d(jnp.asarray(x), norm))
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-5, atol=atol)


def test_gram_vector_staging_needs_width_and_alignment():
    flat = torch.zeros(1 + 16 * 64)
    assert gram.vector_staging(64, 4, flat[:-1].view(1, 16, 64))
    assert not gram.vector_staging(64, 4, flat[1:].view(1, 16, 64))  # 4 bytes off
    assert not gram.vector_staging(30, 4, flat[:-1 - 16 * 4].view(1, 16, 60))
    assert gram.vector_staging(24, 8, torch.zeros((1, 4, 24), dtype=torch.bfloat16))
    assert not gram.vector_staging(20, 8, torch.zeros((1, 4, 20), dtype=torch.bfloat16))


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


@pytest.mark.parametrize(
    "n,t,sms,splits",
    [
        (12, 4096, 132, 1),  # (a) the 1024² encoder: 768 blocks fill 132 SMs
        (48, 4096, 132, 1),  # (b) the batch lane
        (3, 960, 132, 5),  # (c) the ragged 24x40 grid: 45 blocks, 15 key tiles
        (12, 256, 132, 4),  # (d) SAM at 256: 48 blocks, 4 key tiles
        (1, 4096, 132, 5),
        (1, 35, 132, 1),  # one key tile
        (2, 960, 8, 1),
        (2, 960, 114, 8),  # H100 PCIe
    ],
)
def test_sam_attn_kv_splits(n, t, sms, splits):
    assert sam_attn.kv_splits(n, t, sms) == splits
    bounds = sam_attn.split_bounds(t, splits)
    tiles = -(-t // sam_attn.KEY_TILE)
    assert len(bounds) == splits <= tiles
    # the splits cover the keys in order, each a whole number of tiles and none empty
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    assert all(lo < hi and lo % sam_attn.KEY_TILE == 0 for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    blocks = n * -(-t // sam_attn.QUERY_TILE)
    if splits > 1:  # split only a grid that leaves SMs short, and give each SM a block
        assert blocks < sam_attn.BLOCKS_PER_SM * sms <= blocks * splits * 2


def _check_split_merge(seed, n, h, w, d, splits):
    """Plain partials over ``split_bounds``' key ranges, merged by
    ``combine_splits_plain``, against the plain version and the Pallas kernel."""
    from tbist_tpu.ops import pallas_sam_attn

    args = _sam_attn_inputs(seed, n, h, w, d)
    args[0] = args[0] * 3  # sharper rows: the splits' maxima differ
    parts = [sam_attn.attention_partial_plain(*args, h, w, lo, hi)
             for lo, hi in sam_attn.split_bounds(h * w, splits)]
    assert len(parts) == splits
    got = sam_attn.combine_splits_plain(*(torch.stack(x) for x in zip(*parts)))
    with full_f32():
        want = sam_attn.attention_with_rel_bias_plain(*args, h, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    ref = pallas_sam_attn.attention_with_rel_bias(
        *(jnp.asarray(a.numpy()) for a in args), h, w, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("splits", [1, 2, 3, 5])
def test_sam_attn_split_merge_matches_plain_and_pallas(splits):
    # T = 308: a non-square grid, 5 key tiles, the last ragged
    _check_split_merge(17, 2, 14, 22, 16, splits)


@pytest.mark.parametrize("n,h,w,d,splits", [
    (3, 5, 13, 4, 1), (3, 5, 13, 4, 2),  # T = 65: the second split holds one key
    (1, 9, 15, 12, 1), (1, 9, 15, 12, 2), (1, 9, 15, 12, 3),  # T = 135, 3 key tiles
])
def test_sam_attn_split_merge_small_heads_match_plain_and_pallas(n, h, w, d, splits):
    _check_split_merge(19, n, h, w, d, splits)


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
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # one card: on a host with several, the mesh would shard these runs
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,c", [(1, 4096, 64), (2, 1000, 128), (1, 256, 512), (1, 77, 24),
                                   # two 128 tiles, one off the diagonal, ragged N and C
                                   (1, 20000, 200), (3, 37, 200), (1, 262144, 64)])
def test_gram_kernels_match_plain_on_card(cuda, dtype, b, n, c):
    with full_f32():  # the plain versions in full f32
        gen = torch.Generator(device=cuda).manual_seed(0)
        _check_gram_kernels(torch.randn((b, n, c), generator=gen, device=cuda).to(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["c30", "offset"])
def test_gram_kernels_scalar_staging_on_card(cuda, dtype, view):
    # C % 4 != 0, or a base pointer 2 or 4 bytes off 16: the scalar branch
    b, n, c = 2, 300, 30 if view == "c30" else 64
    flat = torch.randn(1 + b * n * c, generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda).to(dtype)
    x = flat[1:].view(b, n, c) if view == "offset" else flat[:-1].view(b, n, c)
    assert not gram.vector_staging(c, 4, x) and not gram.vector_staging(c, 8, x)
    with full_f32():
        _check_gram_kernels(x)


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,c", [(1, 262144, 64), (1, 4096, 512), (3, 37, 200)])
def test_gram_kernels_repeat_bitwise_on_card(cuda, b, n, c):
    x = torch.randn((b, n, c), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    m = torch.randn((b, c, c), generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    assert torch.equal(gram.gram_fwd(x, 0.5), gram.gram_fwd(x, 0.5))
    assert torch.equal(gram.gram_bwd(x, m), gram.gram_bwd(x, m))


def _check_gram_kernels(x):
    b, n, c = x.shape
    dtype, cuda = x.dtype, x.device
    gen = torch.Generator(device=cuda).manual_seed(0)
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


def _assert_sam_attn_close(got, args, h, w):
    with full_f32():
        want = sam_attn.attention_with_rel_bias_plain(*args, h, w)
    torch.cuda.synchronize()
    # the online softmax sums the T keys in another order; 3xTF32 products
    # are within a few f32 roundings of the f32 ones
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,d", [(2, 24, 40, 64), (3, 5, 7, 16), (1, 64, 64, 64),
                                     (2, 9, 9, 8), (1, 8, 8, 128), (1, 16, 16, 64),
                                     # head dims padded to the MMA's k of 8
                                     (2, 5, 7, 4), (2, 6, 10, 12)])
def test_sam_attn_kernel_matches_plain_on_card(cuda, n, h, w, d):
    # ragged tails: 960, 35 and 81 tokens are not multiples of the 64-key tile
    args = _sam_attn_inputs(13, n, h, w, d, cuda)
    before = sam_attn.attention_with_rel_bias.launches
    got = sam_attn.attention_with_rel_bias(*args, h, w)
    assert sam_attn.attention_with_rel_bias.launches == before + 1
    _assert_sam_attn_close(got, args, h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 15])
def test_sam_attn_kernel_key_splits_on_card(cuda, splits):
    n, h, w, d = 3, 24, 40, 64  # 15 key tiles, the last ragged
    args = _sam_attn_inputs(15, n, h, w, d, cuda)
    before = sam_attn.attention_with_rel_bias.launches
    got = sam_attn._launch(*args, h, w, splits)
    assert sam_attn.attention_with_rel_bias.launches == before + 1  # one, merge included
    _assert_sam_attn_close(got, args, h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 15])
def test_sam_attn_kernel_sharp_logits_on_card(cuda, splits):
    # logits of standard deviation 30, 30 times SAM's (q pre-scaled by d^-1/2): the
    # running max jumps between key tiles and between splits. Quarter-step q
    # and bias and integer k make every logit exact in f32 and in TF32 (no
    # small part), so both sides see the same logits and near-ties do not
    # magnify their roundings.
    n, h, w, d = 3, 24, 40, 64
    rng = np.random.default_rng(16)
    t = h * w
    args = [torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.integers(-12, 13, (n, t, d)) / 4, rng.integers(-3, 4, (n, t, d)),
        rng.standard_normal((n, t, d)), rng.integers(-8, 9, (n, t, h)) / 4,
        rng.integers(-8, 9, (n, t, w)) / 4)]
    _assert_sam_attn_close(sam_attn._launch(*args, h, w, splits), args, h, w)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [None, 1, 15])
def test_sam_attn_kernel_sharp_random_logits_on_card(cuda, splits):
    # logits of standard deviation 30 from random f32 inputs, whose TF32
    # small parts are not zero: against an f64 plain version, the 3xTF32
    # kernel's error stays within a small multiple of the f32 plain version's
    n, h, w, d = 3, 24, 40, 64
    q, k, v, bh, bw = _sam_attn_inputs(20, n, h, w, d, cuda)
    args = [q * (30 * d ** -0.5), k, v, bh, bw]
    got = sam_attn._launch(*args, h, w, splits)
    with full_f32():
        plain = sam_attn.attention_with_rel_bias_plain(*args, h, w)
    exact = sam_attn.attention_with_rel_bias_plain(*(a.double() for a in args), h, w)
    err_kernel = float((got.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    diff = (got - plain).abs()
    atol = 1e-5 * float(plain.abs().max())
    print(f"sharp random logits, splits {splits}: max abs err against f64: kernel "
          f"{err_kernel:.3e}, f32 plain {err_plain:.3e} (ratio {err_kernel / err_plain:.2f}); "
          f"kernel against f32 plain {float(diff.max()):.3e}, within rtol 1e-4, atol "
          f"{atol:.3e}: {bool(torch.all(diff <= atol + 1e-4 * plain.abs()))}")
    assert err_kernel <= 4 * err_plain


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,w,d", [(12, 64, 64, 64), (3, 24, 40, 64)])
def test_sam_attn_kernel_repeat_bitwise_on_card(cuda, n, h, w, d):
    args = _sam_attn_inputs(18, n, h, w, d, cuda)
    t = h * w
    assert (sam_attn.kv_splits(n, t, torch.cuda.get_device_properties(cuda).multi_processor_count)
            > 1) == (t < 4096)  # the second shape goes through the merge
    first = sam_attn.attention_with_rel_bias(*args, h, w)
    assert torch.equal(sam_attn.attention_with_rel_bias(*args, h, w), first)


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


@pytest.mark.gpu
def test_sam_attn_kernel_refuses_grids_over_shared_memory(cuda):
    # a 1x700 grid: the q tile's 64 rows of 701 bias_w columns overflow a block
    args = _sam_attn_inputs(21, 1, 1, 700, 64, cuda)
    before = sam_attn.attention_with_rel_bias.launches
    with pytest.raises(RuntimeError, match="shared memory"):
        sam_attn.attention_with_rel_bias(*args, 1, 700)
    assert sam_attn.attention_with_rel_bias.launches == before
    # the refusal leaves no CUDA error behind for the launches after it
    args = _sam_attn_inputs(22, 2, 9, 9, 8, cuda)
    _assert_sam_attn_close(sam_attn.attention_with_rel_bias(*args, 9, 9), args, 9, 9)
