"""The port's SAM (``models/sam.py``, ``weights/sam.py``) on the CPU, against
the JAX package's ``tbist_tpu.models.sam`` on shared weights and the same
numpy inputs, at a tiny config (``_use_pallas_attn`` is False on the CPU,
so the JAX side takes its einsum attention and the port its plain K4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.models import sam as jsam
from tbist_tpu_torch import kernels
from tbist_tpu_torch.models import sam as tsam
from tbist_tpu_torch.weights import sam as wsam

TINY = dict(img_size=64, patch=8, width=32, layers=2, heads=4, window=4, global_layers=(1,),
            embed_dim=32, decoder_heads=4, decoder_layers=2, mlp_dim=64)
# the port's decoder in the JAX package's form, which these tests hold it to
# (tests/test_torch_sam_published.py holds the published form)
JCFG, TCFG = jsam.SamConfig(**TINY), tsam.JaxDecoderConfig(**TINY)
# thresholded masks: at most this share of pixels may differ (a logit within
# float rounding of 0 can land on either side)
MASK_TOL = 1e-3


def _random_tree(cfg, seed):
    """The JAX init's structure with random values of unit-ish scale, so the
    mask logits are O(1): matrices normal / sqrt(fan-in), LayerNorm scales
    near 1, other vectors normal × 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a, np.float32)
        if a.ndim >= 2:
            scale = np.float32(1.0 / np.sqrt(np.prod(a.shape[:-1])))
            return rng.standard_normal(a.shape).astype(np.float32) * scale
        noise = 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return (1.0 + noise) if np.all(a == 1) else noise

    return jax.tree.map(leaf, jsam.init_params(jax.random.key(0), cfg))


NP_TREE = _random_tree(JCFG, 0)
JP = jax.tree.map(jnp.asarray, NP_TREE)
TP = wsam.from_jax_params(NP_TREE)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _img(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("size,rows", [(8, 15), (8, 27), (14, 7)])
def test_get_rel_pos_with_and_without_resize(size, rows):
    # 15 rows at size 8: no resize; 27 -> 15: a shrink; 7 -> 27: a stretch
    r = np.random.default_rng(1).standard_normal((rows, 6)).astype(np.float32)
    got = tsam._get_rel_pos(size, size, _t(r)).numpy()
    want = np.asarray(jsam._get_rel_pos(size, size, jnp.asarray(r)))
    assert got.shape == (size, size, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("global_attn", [False, True])
def test_attn_rel_matches_jax(global_attn):
    blk = NP_TREE["blocks"][1]["attn"]
    shape = (1, 8, 8, 32) if global_attn else (4, 4, 4, 32)
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = np.asarray(jsam._attn_rel(jnp.asarray(x), jax.tree.map(jnp.asarray, blk), 4,
                                     shape[1:3]))
    kernels.reset_launch_counts()
    got = tsam._attn_rel(_t(x), TP["blocks"][1]["attn"], 4, global_attn).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert kernels.launch_counts()["sam_attn"] == 0  # the CPU takes the plain version


@pytest.mark.parametrize("hw,win", [((6, 5), 4), ((8, 8), 4), ((64, 64), 14)])
def test_window_partition_round_trip_with_padding(hw, win):
    x = np.random.default_rng(3).standard_normal((2, *hw, 3)).astype(np.float32)
    wins, pad_hw = tsam._window_partition(_t(x), win)
    jwins, jpad = jsam._window_partition(jnp.asarray(x), win)
    assert pad_hw == jpad
    np.testing.assert_array_equal(wins.numpy(), np.asarray(jwins))
    back = tsam._window_unpartition(wins, win, pad_hw, hw)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("window", [4, 3])  # 3: the 8x8 grid pads to 9x9
def test_encode_image_matches_jax(window):
    jcfg, tcfg = JCFG._replace(window=window), TCFG._replace(window=window)
    tree = _random_tree(jcfg, 4)
    x = np.random.default_rng(5).standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jsam._encode_jit(jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(x)))
    got = tsam.encode_image(wsam.from_jax_params(tree), tcfg, _t(x)).numpy()
    assert got.shape == (2, 8, 8, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


BOXES01 = np.array([[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.9, 0.5], [0.0, 0.0, 1.0, 1.0]],
                   np.float32)


def test_decode_masks_reproduces_the_convT_flip():
    emb = np.random.default_rng(6).standard_normal((1, 8, 8, 32)).astype(np.float32)
    for name in ("upscale_conv1_w", "upscale_conv2_w"):
        k = NP_TREE[name]
        assert not np.allclose(k, k[::-1, ::-1]), "the test needs non-symmetric kernels"
    want = np.asarray(jsam._decode_jit(JP, JCFG, jnp.asarray(emb), jnp.asarray(BOXES01)))
    got = tsam.decode_masks(TP, TCFG, _t(emb), _t(BOXES01)).numpy()
    assert got.shape == (3, 32, 32) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4)
    # without the flip the port would compute official SAM, not the reference
    unflipped = dict(TP, **{n: TP[n].flip(2, 3) for n in ("upscale_conv1_w", "upscale_conv2_w")})
    other = tsam.decode_masks(unflipped, TCFG, _t(emb), _t(BOXES01)).numpy()
    assert np.abs(other - want).max() > 100 * 1e-4


def test_params_for_size_matches_jax():
    jp2, jcfg2 = jsam.params_for_size(JP, JCFG, 32)
    tp2, tcfg2 = tsam.params_for_size(TP, TCFG, 32)
    assert tuple(tcfg2) == tuple(jcfg2) and tsam.params_for_size(TP, TCFG, 64)[0] is TP
    np.testing.assert_allclose(tp2["pos_embed"].numpy(), np.asarray(jp2["pos_embed"]),
                               rtol=1e-5, atol=1e-6)
    for tb, jb in zip(tp2["blocks"], jp2["blocks"]):
        for name in ("rel_pos_h", "rel_pos_w"):
            np.testing.assert_allclose(tb["attn"][name].numpy(), np.asarray(jb["attn"][name]),
                                       rtol=1e-5, atol=1e-6)
    x = np.random.default_rng(7).standard_normal((1, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(tsam.encode_image(tp2, tcfg2, _t(x)).numpy(),
                               np.asarray(jsam._encode_jit(jp2, jcfg2, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of patch"):
        tsam.params_for_size(TP, TCFG, 36)


def test_predict_boxes_and_split_path_match_jax():
    img = _img(8, (48, 40, 3))  # non-square: scale 64/48, nw = 53, then a shrink back
    boxes = np.array([[5, 6, 30, 40], [0, 0, 39, 47], [12, 20, 25, 28]], np.float32)
    emb, scale, nh, nw = tsam.encode_uint8(TP, TCFG, img)
    jemb, jscale, jnh, jnw = jsam.encode_uint8(JP, JCFG, img)
    assert (scale, nh, nw) == (jscale, jnh, jnw) == (64 / 48, 64, 53)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-4, atol=1e-5)
    boxes01 = (boxes * np.float32(scale) + 0.5) / 64
    logits = tsam.decode_masks(TP, TCFG, emb, _t(boxes01)).numpy()
    jlogits = np.asarray(jsam._decode_jit(JP, JCFG, jemb, jnp.asarray(boxes01)))
    np.testing.assert_allclose(logits, jlogits, atol=1e-4)

    got = tsam.predict_boxes(TP, TCFG, img, boxes)
    want = jsam.predict_boxes(JP, JCFG, img, boxes)
    assert got.shape == (3, 48, 40) and got.dtype == bool and isinstance(got, np.ndarray)
    assert 0.05 < got.mean() < 0.95
    assert np.mean(got != want) <= MASK_TOL
    split = tsam.masks_from_embedding(TP, TCFG, emb, scale, nh, nw, 48, 40, boxes)
    np.testing.assert_array_equal(split, got)
    on_tensor = tsam.encode_uint8(TP, TCFG, torch.from_numpy(img))[0]
    torch.testing.assert_close(on_tensor, emb, rtol=0, atol=0)


def test_batch_lane_matches_single_and_jax():
    frames = np.stack([_img(9 + i, (40, 56, 3)) for i in range(3)])
    boxes = np.array([[[4, 4, 30, 30], [10, 2, 50, 38], [0, 0, 1, 1]],
                      [[20, 10, 55, 39], [0, 0, 1, 1], [0, 0, 1, 1]],
                      [[3, 3, 9, 9], [0, 0, 55, 39], [7, 7, 8, 8]]], np.float32)
    valid = np.array([[True, True, False], [True, False, False], [False, False, False]])
    embs, scale, nh, nw = tsam.encode_uint8_batch(TP, TCFG, frames)
    jembs = jsam.encode_uint8_batch(JP, JCFG, frames)[0]
    np.testing.assert_allclose(embs.numpy(), np.asarray(jembs), rtol=1e-4, atol=1e-5)
    got = tsam.masks_from_embedding_batch(TP, TCFG, embs, scale, nh, nw, 40, 56, boxes, valid)
    want = np.asarray(jsam.masks_from_embedding_batch(JP, JCFG, jembs, scale, nh, nw, 40, 56,
                                                      boxes, valid))
    assert isinstance(got, torch.Tensor) and got.shape == (3, 40, 56) and got.dtype == torch.bool
    assert np.mean(got.numpy() != want) <= MASK_TOL
    assert not got[2].any()  # no valid box: all False
    for i in range(2):  # each frame: the union of its valid boxes, padded ones ignored
        emb, *_ = tsam.encode_uint8(TP, TCFG, frames[i])
        torch.testing.assert_close(embs[i:i + 1], emb, rtol=1e-5, atol=1e-6)
        single = tsam.masks_from_embedding(TP, TCFG, embs[i:i + 1], scale, nh, nw, 40, 56,
                                           boxes[i][valid[i]])
        assert np.mean(single.any(0) != got[i].numpy()) <= MASK_TOL


def _official_sd(cfg, seed):
    """A random state dict in the official sam_vit_b layout at ``cfg``."""
    rng = np.random.default_rng(seed)
    d, e, p = cfg.width, cfg.embed_dim, cfg.patch
    g, hd, m = cfg.img_size // p, cfg.width // cfg.heads, cfg.mlp_dim
    shapes = {"image_encoder.patch_embed.proj.weight": (d, 3, p, p),
              "image_encoder.patch_embed.proj.bias": (d,),
              "image_encoder.pos_embed": (1, g, g, d)}
    for i in range(cfg.layers):
        b = f"image_encoder.blocks.{i}"
        rel = 2 * (g if i in cfg.global_layers else cfg.window) - 1
        shapes.update({f"{b}.norm1.weight": (d,), f"{b}.norm1.bias": (d,),
                       f"{b}.norm2.weight": (d,), f"{b}.norm2.bias": (d,),
                       f"{b}.attn.qkv.weight": (3 * d, d), f"{b}.attn.qkv.bias": (3 * d,),
                       f"{b}.attn.proj.weight": (d, d), f"{b}.attn.proj.bias": (d,),
                       f"{b}.attn.rel_pos_h": (rel, hd), f"{b}.attn.rel_pos_w": (rel, hd),
                       f"{b}.mlp.lin1.weight": (4 * d, d), f"{b}.mlp.lin1.bias": (4 * d,),
                       f"{b}.mlp.lin2.weight": (d, 4 * d), f"{b}.mlp.lin2.bias": (d,)})
    shapes.update({"image_encoder.neck.0.weight": (e, d, 1, 1),
                   "image_encoder.neck.1.weight": (e,), "image_encoder.neck.1.bias": (e,),
                   "image_encoder.neck.2.weight": (e, e, 3, 3),
                   "image_encoder.neck.3.weight": (e,), "image_encoder.neck.3.bias": (e,),
                   "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": (2, e // 2),
                   "prompt_encoder.no_mask_embed.weight": (1, e),
                   "mask_decoder.iou_token.weight": (1, e),
                   "mask_decoder.mask_tokens.weight": (cfg.num_mask_tokens, e)})
    shapes.update({f"prompt_encoder.point_embeddings.{i}.weight": (1, e) for i in range(4)})

    def attn(prefix, inner):
        for n in ("q", "k", "v"):
            shapes.update({f"{prefix}.{n}_proj.weight": (inner, e), f"{prefix}.{n}_proj.bias":
                           (inner,)})
        shapes.update({f"{prefix}.out_proj.weight": (e, inner), f"{prefix}.out_proj.bias": (e,)})

    t = "mask_decoder.transformer"
    for i in range(cfg.decoder_layers):
        b = f"{t}.layers.{i}"
        attn(f"{b}.self_attn", e)
        attn(f"{b}.cross_attn_token_to_image", e // 2)
        attn(f"{b}.cross_attn_image_to_token", e // 2)
        shapes.update({f"{b}.norm{j}.{s}": (e,) for j in range(1, 5) for s in ("weight", "bias")})
        shapes.update({f"{b}.mlp.lin1.weight": (m, e), f"{b}.mlp.lin1.bias": (m,),
                       f"{b}.mlp.lin2.weight": (e, m), f"{b}.mlp.lin2.bias": (e,)})
    attn(f"{t}.final_attn_token_to_image", e // 2)
    shapes.update({f"{t}.norm_final_attn.weight": (e,), f"{t}.norm_final_attn.bias": (e,)})
    u = "mask_decoder.output_upscaling"
    shapes.update({f"{u}.0.weight": (e, e // 4, 2, 2), f"{u}.0.bias": (e // 4,),
                   f"{u}.1.weight": (e // 4,), f"{u}.1.bias": (e // 4,),
                   f"{u}.3.weight": (e // 4, e // 8, 2, 2), f"{u}.3.bias": (e // 8,)})
    for i in range(cfg.num_mask_tokens):
        h = f"mask_decoder.output_hypernetworks_mlps.{i}.layers"
        shapes.update({f"{h}.0.weight": (e, e), f"{h}.0.bias": (e,), f"{h}.1.weight": (e, e),
                       f"{h}.1.bias": (e,), f"{h}.2.weight": (e // 8, e),
                       f"{h}.2.bias": (e // 8,)})
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_convert_sam_state_dict_matches_jax_converter():
    sd = _official_sd(TCFG, 10)
    got = wsam.convert_sam_state_dict(sd, TCFG)
    want = wsam.from_jax_params(jax.tree.map(np.asarray, jsam.convert_sam_state_dict(sd, JCFG)))
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))
    # torch tensors as values convert the same
    again = wsam.convert_sam_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, TCFG)
    torch.testing.assert_close(again["upscale_conv1_w"], got["upscale_conv1_w"])


def test_init_params_structure_matches_jax():
    got = wsam.init_params(torch.Generator().manual_seed(0), TCFG)
    want = wsam.from_jax_params(jax.tree.map(np.asarray, jsam.init_params(jax.random.key(0),
                                                                          JCFG)))
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert [(p, a.shape) for p, a in got_leaves] == [(p, a.shape) for p, a in want_leaves]
    assert all(a.dtype == torch.float32 for _, a in got_leaves)
    assert torch.all(got["blocks"][0]["ln1"]["scale"] == 1)
    assert got["blocks"][1]["attn"]["rel_pos_h"].shape == (2 * TCFG.window - 1, 8)
    assert abs(float(got["pe_gaussian"].std()) - 1.0) < 0.5
    assert float(got["blocks"][0]["attn"]["qkv_w"].std()) == pytest.approx(0.02, rel=0.2)


def test_get_loaded_params_raises_without_checkpoint(monkeypatch, tmp_path):
    monkeypatch.setenv("TBIST_SAM_PTH", str(tmp_path / "missing.pth"))
    with pytest.raises(FileNotFoundError, match="no SAM checkpoint"):
        tsam.get_loaded_params("cpu")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsam.get_predictor()
