"""The port's GroundingDINO (``models/swin.py``, ``models/bert.py``,
``models/dino.py``, ``weights/dino_convert.py``) on the CPU, against the JAX
package on shared numpy weights and the same numpy inputs, at the tiny
configs of ``tests/test_dino.py``. Both sides run in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.models import bert as jbert
from tbist_tpu.models import dino as jdino
from tbist_tpu.models import swin as jswin
from tbist_tpu.weights import dino_convert as jconvert
from tbist_tpu_torch.models import bert as tbert
from tbist_tpu_torch.models import dino as tdino
from tbist_tpu_torch.models import swin as tswin
from tbist_tpu_torch.utils.precision import full_f32
from tbist_tpu_torch.weights import dino_convert as tconvert

SWIN_KW = dict(embed_dim=8, depths=(1, 1, 1, 1), heads=(1, 2, 4, 8), window=4, mlp_ratio=2,
               out_indices=(1, 2, 3))
BERT_KW = dict(vocab=1100, hidden=32, layers=2, heads=2, ffn=64, max_pos=64, type_vocab=2)
DINO_KW = dict(d_model=16, heads=2, levels=4, points=2, enc_layers=2, dec_layers=2, ffn=32,
               num_queries=20, fusion_heads=2, fusion_dim=32)
JSWIN, TSWIN = jswin.SwinConfig(**SWIN_KW), tswin.SwinConfig(**SWIN_KW)
JBERT, TBERT = jbert.BertConfig(**BERT_KW), tbert.BertConfig(**BERT_KW)
JDINO, TDINO = jdino.DinoConfig(**DINO_KW), tdino.DinoConfig(**DINO_KW)
IDS = np.array([[101, 40, 41, 1012, 7, 1012, 102]], np.int64)  # [CLS] w w . w . [SEP]


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def dino_tree():
    return _randomize(lambda: jdino.init_params(jax.random.key(0), JDINO, JSWIN, JBERT), 0)


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("depths,window,hw", [
    ((1, 1, 1, 1), 4, (64, 96)),   # no shift; the last two stages pad to the window
    ((2, 2, 2, 2), 4, (64, 64)),   # shifted windows at every stage
    ((2, 2, 2, 2), 7, (72, 104)),  # window 7: 18x26 pads to 21x28; odd sides merge padded
])
def test_swin_matches_jax(depths, window, hw):
    kw = dict(SWIN_KW, depths=depths, window=window)
    jcfg, tcfg = jswin.SwinConfig(**kw), tswin.SwinConfig(**kw)
    tree = _randomize(lambda: jswin.init_params(jax.random.key(1), jcfg), 1)
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jax.jit(jswin.forward, static_argnums=1)(_j(tree), jcfg, jnp.asarray(x))
    params = jax.tree.map(_t, tree)
    params["patch_embed_w"] = _t(np.transpose(tree["patch_embed_w"], (3, 2, 0, 1)))  # HWIO->OIHW
    got = tswin.forward(params, tcfg, _t(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_swin_shift_mask_and_rel_index_match_jax():
    np.testing.assert_array_equal(tswin._shift_mask(14, 21, 7, 3),
                                  np.asarray(jswin._shift_mask(14, 21, 7, 3)))
    np.testing.assert_array_equal(tswin._rel_bias_index(7), jswin._rel_bias_index(7))


# ---------------------------------------------------------------------------
# BERT and the text masks
# ---------------------------------------------------------------------------

TEXT_CASES = [
    [101, 5, 6, 1012, 102],                 # [CLS] w w . [SEP]
    [101, 5, 1012, 7, 8, 1012, 102],        # two sub-sentences
    [101, 5, 6, 7, 102],                    # no interior special
    [101, 1012, 1012, 102],                 # adjacent specials
    [5, 6, 1012, 7],                        # no [CLS]/[SEP]
    [101, 5, 6, 102, 8, 9, 1029, 102],      # '?' separator
]


@pytest.mark.parametrize("ids", TEXT_CASES)
def test_build_text_token_masks_exact(ids):
    want_attn, want_pos = jdino.build_text_token_masks(jnp.asarray([ids], jnp.int32))
    got_attn, got_pos = tdino.build_text_token_masks(torch.tensor([ids]))
    np.testing.assert_array_equal(got_attn.numpy(), np.asarray(want_attn))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))


def test_bert_with_sub_sentence_bias_matches_jax():
    tree = _randomize(lambda: jbert.init_params(jax.random.key(3), JBERT), 3)
    ids = np.array([[101, 5, 6, 1012, 7, 8, 1012, 102, 0, 0]], np.int64)
    mask = (ids != 0).astype(np.float32)
    attend, pos = jdino.build_text_token_masks(jnp.asarray(ids, jnp.int32))
    bias = np.asarray((1.0 - np.asarray(attend, np.float32)[:, None]) * -1e9, np.float32)
    jforward = jax.jit(jbert.forward, static_argnums=1)
    want = jforward(_j(tree), JBERT, jnp.asarray(ids, jnp.int32), jnp.asarray(mask),
                    position_ids=pos, attention_bias=jnp.asarray(bias))
    got = tbert.forward(jax.tree.map(_t, tree), TBERT, _t(ids), _t(mask),
                        position_ids=_t(np.asarray(pos, np.int64)), attention_bias=_t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # the padding mask when no bias is given
    want = jforward(_j(tree), JBERT, jnp.asarray(ids, jnp.int32), jnp.asarray(mask))
    got = tbert.forward(jax.tree.map(_t, tree), TBERT, _t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# deformable attention and fusion
# ---------------------------------------------------------------------------

SHAPES = ((8, 8), (4, 4))


def _deform_inputs(seed, b, lq, ref_dim, d=16, heads=2, points=2):
    rng = np.random.default_rng(seed)
    hlp = heads * len(SHAPES) * points

    def nrm(*s, scale=0.1):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    p = {"value_proj_w": nrm(d, d), "value_proj_b": nrm(d),
         "sampling_offsets_w": nrm(d, hlp * 2), "sampling_offsets_b": nrm(hlp * 2, scale=0.5),
         "attention_weights_w": nrm(d, hlp), "attention_weights_b": nrm(hlp),
         "output_proj_w": nrm(d, d), "output_proj_b": nrm(d)}
    lv = sum(h * w for h, w in SHAPES)
    value = rng.random((b, lv, d)).astype(np.float32)
    query = nrm(b, lq, d, scale=1.0)
    if ref_dim == 2:  # points, some near and past the border
        refs = rng.uniform(-0.1, 1.1, (b, lq, 2)).astype(np.float32)
    else:  # cxcywh boxes
        refs = np.concatenate([rng.uniform(0, 1, (b, lq, 2)), rng.uniform(0.05, 0.6, (b, lq, 2))],
                              -1).astype(np.float32)
    return query, refs, value, p


@pytest.mark.parametrize("ref_dim", [2, 4])
@pytest.mark.parametrize("form", ["gather", "interp_matmul", "lax_map"])
def test_deformable_attention_matches_each_jax_form(monkeypatch, form, ref_dim):
    # the JAX package's three TPU forms; the interp-matmul needs lq·points >= 4096
    # and lax.map a batch above one
    b, lq = {"gather": (1, 7), "interp_matmul": (1, 2048), "lax_map": (2, 9)}[form]
    query, refs, value, p = _deform_inputs(4, b, lq, ref_dim)
    monkeypatch.setattr(jdino, "_INTERP_MM_MAX_HW", 1 << 20 if form == "interp_matmul" else 0)
    monkeypatch.setattr(jdino, "_GATHER_MAP_TABLE_BYTES", 0 if form == "lax_map" else 1 << 60)
    want = jax.jit(jdino.deformable_attention, static_argnums=(3, 5, 6))(
        jnp.asarray(query), jnp.asarray(refs), jnp.asarray(value), SHAPES, _j(p), 2, 2)
    got = tdino.deformable_attention(_t(query), _t(refs), _t(value), SHAPES,
                                     jax.tree.map(_t, p), 2, 2)
    assert got.shape == (b, lq, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_grid_sample_convention_pixel_centres_and_zero_outside():
    v = np.arange(16.0, dtype=np.float32).reshape(1, 16, 1)
    p = {"value_proj_w": np.eye(1, dtype=np.float32), "value_proj_b": np.zeros(1, np.float32),
         "sampling_offsets_w": np.zeros((1, 2), np.float32),
         "sampling_offsets_b": np.zeros(2, np.float32),
         "attention_weights_w": np.zeros((1, 1), np.float32),
         "attention_weights_b": np.zeros(1, np.float32),
         "output_proj_w": np.eye(1, dtype=np.float32), "output_proj_b": np.zeros(1, np.float32)}
    refs = np.array([[[(2 + 0.5) / 4, (1 + 0.5) / 4], [-0.5, -0.5]]], np.float32)
    out = tdino.deformable_attention(torch.zeros(1, 2, 1), _t(refs), _t(v), ((4, 4),),
                                     jax.tree.map(_t, p), 1, 1)
    np.testing.assert_allclose(out.numpy()[0, :, 0], [6.0, 0.0], atol=1e-6)


def test_bi_attention_with_padded_text_matches_jax(dino_tree):
    fus = dino_tree["fusion_layers"][0]
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 30, 16)).astype(np.float32)
    text = rng.standard_normal((2, 6, 16)).astype(np.float32)
    tmask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.float32)
    want = jax.jit(jdino.bi_attention, static_argnums=4)(
        jnp.asarray(img), jnp.asarray(text), jnp.asarray(tmask), _j(fus), JDINO)
    got = tdino.bi_attention(_t(img), _t(text), _t(tmask), jax.tree.map(_t, fus), TDINO)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("h,w,d", [(8, 12, 16), (100, 132, 256)])
def test_sine_embeddings_match_jax(h, w, d):
    np.testing.assert_allclose(tdino._sine_pos_2d(h, w, d, "cpu").numpy(),
                               np.asarray(jdino._sine_pos_2d(h, w, d)), rtol=1e-5, atol=1e-5)
    boxes = np.random.default_rng(6).random((3, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(tdino._box_pe(_t(boxes), d).numpy(),
                               np.asarray(jdino._box_pe(jnp.asarray(boxes), d)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------

def _jax_forward_and_scores(params, x, ids):
    """JAX's forward and its query-selection scores: the array its argsort
    sorts (dino.py:586-588), caught while the forward is traced."""
    caught = {}
    real_argsort = jnp.argsort

    def spy(a, *args, **kw):
        caught.setdefault("scores", a)
        return real_argsort(a, *args, **kw)

    jnp.argsort = spy
    try:
        out = jdino.forward(params, JDINO, x, ids, jnp.ones_like(ids), JSWIN, JBERT)
    finally:
        jnp.argsort = real_argsort
    return out, caught["scores"]


@pytest.fixture(scope="module")
def forward_pair(dino_tree):
    """Both forwards on one 64x64 and one 416x416 image (the larger has
    invalid level-0 border anchors), with the JAX side computed once."""
    tparams = tconvert.from_jax_params(dino_tree)
    jitted = jax.jit(_jax_forward_and_scores)
    out = {}
    for hw in ((64, 64), (416, 416)):
        x = np.random.default_rng(7).standard_normal((1, *hw, 3)).astype(np.float32)
        want, scores = jitted(_j(dino_tree), jnp.asarray(x), jnp.asarray(IDS, jnp.int32))
        with full_f32():
            got = tdino.forward(tparams, TDINO, _t(x), _t(IDS), torch.ones_like(_t(IDS)), TSWIN,
                                TBERT)
        out[hw] = (jax.tree.map(np.asarray, want), np.asarray(scores), got, x)
    return tparams, out


@pytest.mark.parametrize("hw", [(64, 64), (416, 416)])
def test_forward_logits_and_boxes_match_jax(forward_pair, hw):
    want, _, got, _ = forward_pair[1][hw]
    assert got["pred_logits"].shape == (1, 20, IDS.shape[1])
    np.testing.assert_allclose(got["pred_logits"].numpy(), want["pred_logits"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["pred_boxes"].numpy(), want["pred_boxes"], rtol=1e-4,
                               atol=1e-5)
    boxes = got["pred_boxes"].numpy()
    assert (boxes >= 0).all() and (boxes <= 1).all()


@pytest.mark.parametrize("hw", [(64, 64), (416, 416)])
def test_forward_selects_the_same_queries_as_jax(forward_pair, hw):
    _, scores, got, _ = forward_pair[1][hw]
    want = np.asarray(jnp.argsort(jnp.asarray(scores), axis=-1)[:, ::-1][:, :20])
    np.testing.assert_array_equal(got["topk_index"].numpy(), want)
    np.testing.assert_allclose(got["topk_scores"].numpy(), np.take_along_axis(scores, want, 1),
                               rtol=1e-4, atol=1e-5)
    if hw == (416, 416):  # level 0 is 52x52: its border anchors are invalid
        _, _, valid, _ = tdino._shape_constants(((52, 52), (26, 26), (13, 13), (7, 7)), 16,
                                                torch.device("cpu"))
        assert not bool(valid.all())


def test_forward_with_text_feats_equals_inline(forward_pair):
    tparams, out = forward_pair
    _, _, got, x = out[(64, 64)]
    with full_f32():
        feats = tdino.encode_text(tparams, TDINO, _t(IDS), torch.ones_like(_t(IDS)), TBERT)
        cached = tdino.forward(tparams, TDINO, _t(x), _t(IDS), torch.ones_like(_t(IDS)), TSWIN,
                               TBERT, text_feats=feats)
    for k in ("pred_logits", "pred_boxes"):
        torch.testing.assert_close(cached[k], got[k], rtol=0, atol=1e-6)


def test_encode_text_matches_jax(dino_tree, forward_pair):
    ids = jnp.asarray(IDS, jnp.int32)
    want = jax.jit(jdino.encode_text, static_argnums=(1, 4))(_j(dino_tree), JDINO, ids,
                                                            jnp.ones_like(ids), JBERT)
    got = tdino.encode_text(forward_pair[0], TDINO, _t(IDS), torch.ones_like(_t(IDS)), TBERT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_topk_breaks_ties_as_jax(seed):
    # heavy ties (invalid anchors all score the same): the higher index first
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, (2, 50)).astype(np.float32)
    scores[:, 10:30] = 0.0
    want = np.asarray(jnp.argsort(jnp.asarray(scores), axis=-1)[:, ::-1][:, :25])
    np.testing.assert_array_equal(tdino.select_topk(_t(scores), 25).numpy(), want)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_init_params_structure_matches_jax():
    got = tconvert.init_params(torch.Generator().manual_seed(0), TDINO, TSWIN, TBERT)
    shapes = jax.eval_shape(lambda: jdino.init_params(jax.random.key(0), JDINO, JSWIN, JBERT))
    want = tconvert.from_jax_params(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes))
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert [(p, a.shape) for p, a in got_leaves] == [(p, a.shape) for p, a in want_leaves]
    assert all(a.dtype == torch.float32 for _, a in got_leaves)
    assert torch.all(got["fusion_layers"][0]["gamma_v"] == 0.125)
    offsets = got["enc_layers"][0]["deform"]["sampling_offsets_w"]
    assert float(offsets.std()) == pytest.approx(0.001, rel=0.3)
    assert float(got["bert"]["word_emb"].std()) == pytest.approx(0.02, rel=0.1)


def _official_sd(seed):
    """A random state dict in the official groundingdino layout at the tiny
    configs."""
    rng = np.random.default_rng(seed)
    shapes = {}
    d, fd, e = TDINO.d_model, TDINO.fusion_dim, TSWIN.embed_dim
    hlp = TDINO.heads * TDINO.levels * TDINO.points

    def lin(name, cout, cin):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (cout, cin), (cout,)

    def ln(name, n):
        shapes[f"{name}.weight"], shapes[f"{name}.bias"] = (n,), (n,)

    s = "backbone.0."
    shapes[s + "patch_embed.proj.weight"], shapes[s + "patch_embed.proj.bias"] = (e, 3, 4, 4), (e,)
    ln(s + "patch_embed.norm", e)
    for si, depth in enumerate(TSWIN.depths):
        dim = e * 2**si
        for bi in range(depth):
            p = f"{s}layers.{si}.blocks.{bi}"
            ln(f"{p}.norm1", dim), ln(f"{p}.norm2", dim)
            lin(f"{p}.attn.qkv", 3 * dim, dim), lin(f"{p}.attn.proj", dim, dim)
            shapes[f"{p}.attn.relative_position_bias_table"] = ((2 * TSWIN.window - 1) ** 2,
                                                                TSWIN.heads[si])
            lin(f"{p}.mlp.fc1", 2 * dim, dim), lin(f"{p}.mlp.fc2", dim, 2 * dim)
        if si < 3:
            ln(f"{s}layers.{si}.downsample.norm", 4 * dim)
            shapes[f"{s}layers.{si}.downsample.reduction.weight"] = (2 * dim, 4 * dim)
    for i in TSWIN.out_indices:
        ln(f"{s}norm{i}", e * 2**i)

    hb = TBERT.hidden
    shapes["bert.embeddings.word_embeddings.weight"] = (TBERT.vocab, hb)
    shapes["bert.embeddings.position_embeddings.weight"] = (TBERT.max_pos, hb)
    shapes["bert.embeddings.token_type_embeddings.weight"] = (TBERT.type_vocab, hb)
    ln("bert.embeddings.LayerNorm", hb)
    for i in range(TBERT.layers):
        p = f"bert.encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", hb, hb)
        lin(f"{p}.attention.output.dense", hb, hb), ln(f"{p}.attention.output.LayerNorm", hb)
        lin(f"{p}.intermediate.dense", TBERT.ffn, hb), lin(f"{p}.output.dense", hb, TBERT.ffn)
        ln(f"{p}.output.LayerNorm", hb)

    lin("feat_map", d, hb)
    for i in range(4):
        cin, k = (e * 2 ** (i + 1), 1) if i < 3 else (e * 8, 3)
        shapes[f"input_proj.{i}.0.weight"], shapes[f"input_proj.{i}.0.bias"] = (d, cin, k, k), (d,)
        ln(f"input_proj.{i}.1", d)
    shapes["transformer.level_embed"] = (TDINO.levels, d)

    def mha(p):
        shapes[f"{p}.in_proj_weight"], shapes[f"{p}.in_proj_bias"] = (3 * d, d), (3 * d,)
        lin(f"{p}.out_proj", d, d)

    def deform(p):
        lin(f"{p}.value_proj", d, d), lin(f"{p}.sampling_offsets", hlp * 2, d)
        lin(f"{p}.attention_weights", hlp, d), lin(f"{p}.output_proj", d, d)

    for i in range(TDINO.enc_layers):
        f = f"transformer.encoder.fusion_layers.{i}"
        ln(f"{f}.layer_norm_v", d), ln(f"{f}.layer_norm_l", d)
        for n in ("v_proj", "l_proj", "values_v_proj", "values_l_proj"):
            lin(f"{f}.attn.{n}", fd, d)
        lin(f"{f}.attn.out_v_proj", d, fd), lin(f"{f}.attn.out_l_proj", d, fd)
        shapes[f"{f}.gamma_v"], shapes[f"{f}.gamma_l"] = (d,), (d,)
        t = f"transformer.encoder.text_layers.{i}"
        mha(f"{t}.self_attn"), ln(f"{t}.norm1", d), ln(f"{t}.norm2", d)
        lin(f"{t}.linear1", TDINO.ffn // 2, d), lin(f"{t}.linear2", d, TDINO.ffn // 2)
        el = f"transformer.encoder.layers.{i}"
        deform(f"{el}.self_attn"), ln(f"{el}.norm1", d), ln(f"{el}.norm2", d)
        lin(f"{el}.linear1", TDINO.ffn, d), lin(f"{el}.linear2", d, TDINO.ffn)
    for i in range(TDINO.dec_layers):
        dl = f"transformer.decoder.layers.{i}"
        mha(f"{dl}.self_attn"), mha(f"{dl}.ca_text"), deform(f"{dl}.cross_attn")
        for n in ("norm1", "norm2", "norm3", "catext_norm"):
            ln(f"{dl}.{n}", d)
        lin(f"{dl}.linear1", TDINO.ffn, d), lin(f"{dl}.linear2", d, TDINO.ffn)
    lin("transformer.enc_output", d, d), ln("transformer.enc_output_norm", d)
    for prefix in ("transformer.enc_out_bbox_embed", "bbox_embed.0"):
        lin(f"{prefix}.layers.0", d, d), lin(f"{prefix}.layers.1", d, d)
        lin(f"{prefix}.layers.2", 4, d)
    lin("transformer.decoder.ref_point_head.layers.0", d, 2 * d)
    lin("transformer.decoder.ref_point_head.layers.1", d, d)
    ln("transformer.decoder.norm", d)
    shapes["transformer.tgt_embed.weight"] = (TDINO.num_queries, d)
    return {"module." + k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}


def test_convert_matches_jax_converter():
    sd = _official_sd(8)
    got = tconvert.convert(sd, TDINO, TSWIN, TBERT)
    want = tconvert.from_jax_params(jax.tree.map(np.asarray,
                                                 jconvert.convert(sd, JDINO, JSWIN, JBERT)))
    got_leaves, want_leaves = _leaves(got), _leaves(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=str(path))
    # torch tensors as values convert the same
    again = tconvert.convert({k: torch.from_numpy(v) for k, v in sd.items()}, TDINO, TSWIN, TBERT)
    torch.testing.assert_close(again["input_proj"][3]["w"], got["input_proj"][3]["w"])
