"""The port's T5 (``models/t5.py``) and emoji texture path
(``models/t5_emoji.py``, ``effects/masking``'s stencil fallback) on the CPU
against the JAX package, on a small T5 config with JAX's seeded params
carried across."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.effects import masking as jmasking
from tbist_tpu.models import t5 as jt5
from tbist_tpu.models import t5_emoji as jt5_emoji
from tbist_tpu_torch.effects import masking
from tbist_tpu_torch.models import t5, t5_emoji
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.imageio import tree_to

CFG = t5.T5Config(vocab=64, d_model=32, d_ff=64, heads=4, d_kv=8, layers=2, rel_buckets=8,
                  rel_distance=16)
JCFG = jt5.T5Config(*CFG)


@pytest.fixture(scope="module")
def jparams():
    """JAX's seeded params. The decoder's output projections are scaled by
    3 so that the rows do not repeat one token, and EOS's embedding is
    token 34's grown by 1%, so that the first row of ``_inputs`` emits EOS
    at step 6 (where it would emit 34) while the others run to the end."""
    p = jt5.init_params(jax.random.key(1), JCFG)
    for layer in p["decoder"]:
        for k in ("self", "cross"):
            layer[k]["o"] = layer[k]["o"] * 3
        layer["mlp"]["wo"] = layer["mlp"]["wo"] * 3
    p["shared"] = p["shared"].at[1].set(p["shared"][34] * 1.01)
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def params(jparams):
    return t5.from_jax_params(jparams)


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 64, size=(3, 9)).astype(np.int32)
    mask = np.ones((3, 9), np.float32)
    mask[1, 5:] = 0
    ids[1, 5:] = 0
    return ids, mask


def test_config_copies_jax():
    assert t5.BASE == jt5.BASE and tuple(t5.BASE) == tuple(jt5.T5Config())
    assert t5.TINY._asdict() == jt5.T5Config(vocab=64, d_model=16, d_ff=32, heads=2, d_kv=8,
                                             layers=2, rel_buckets=8, rel_distance=16)._asdict()


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,distance", [(32, 128), (8, 16)])
def test_rel_bucket_matches_jax(bidirectional, buckets, distance):
    rel = np.arange(-200, 201)
    want = np.asarray(jt5._rel_bucket(jnp.asarray(rel), bidirectional, buckets, distance))
    got = t5._rel_bucket(torch.from_numpy(rel), bidirectional, buckets, distance)
    np.testing.assert_array_equal(got.numpy(), want)


def test_encode_matches_jax(jparams, params):
    ids, mask = _inputs()
    want = np.asarray(jt5.encode(jparams, JCFG, jnp.asarray(ids), jnp.asarray(mask)))
    got = t5.encode(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.shape == (3, 9, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_greedy_generate_matches_jax(jparams, params):
    ids, mask = _inputs()
    want = np.asarray(jt5.generate(jparams, JCFG, jnp.asarray(ids), jnp.asarray(mask),
                                   jax.random.key(0), max_len=10))
    got = t5.generate(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask), max_len=10)
    np.testing.assert_array_equal(got.numpy(), want)
    ended = (want == CFG.eos_id).any(-1)
    assert ended.tolist() == [True, False, False]  # one row ends early, then pads
    assert (want[0, list(want[0]).index(CFG.eos_id) + 1:] == CFG.pad_id).all()
    assert len(set(want[1])) > 1 and CFG.pad_id not in want[1:]
    assert (got[:, 0] != CFG.eos_id).all()


def test_sampled_generate_draws_from_the_generator(params):
    ids, mask = _inputs()
    kw = dict(max_len=6, do_sample=True, top_k=50, top_p=0.99)
    runs = [t5.generate(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask),
                        generator=torch.Generator().manual_seed(s), **kw) for s in (1, 1, 2)]
    torch.testing.assert_close(runs[0], runs[1], rtol=0, atol=0)
    assert all(int(r.max()) < CFG.vocab and (r[:, 0] != CFG.eos_id).all() for r in runs)


@pytest.mark.parametrize("top_k,top_p", [(10, 0.95), (3, 0.5), (64, 0.999)])
def test_sample_filter_matches_jax(top_k, top_p):
    logits = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32) * 3
    logits[0, :5] = logits[0, 5]  # ties at the k-th value
    want = np.asarray(jt5.sample_filter(jnp.asarray(logits), top_k, top_p))
    got = t5.sample_filter(torch.from_numpy(logits), top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), want)


def _hf_state_dict(cfg, rng):
    inner = cfg.heads * cfg.d_kv
    sd = {"shared.weight": (cfg.vocab, cfg.d_model),
          "encoder.final_layer_norm.weight": (cfg.d_model,),
          "decoder.final_layer_norm.weight": (cfg.d_model,)}
    for side in ("encoder", "decoder"):
        sd[f"{side}.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
            cfg.rel_buckets, cfg.heads)
        for i in range(cfg.layers):
            pre = f"{side}.block.{i}.layer"
            names = [("0", "SelfAttention")] + ([("1", "EncDecAttention")] if side == "decoder"
                                                else [])
            for j, name in names:
                sd[f"{pre}.{j}.layer_norm.weight"] = (cfg.d_model,)
                for w in ("q", "k", "v"):
                    sd[f"{pre}.{j}.{name}.{w}.weight"] = (inner, cfg.d_model)
                sd[f"{pre}.{j}.{name}.o.weight"] = (cfg.d_model, inner)
            m = 2 if side == "decoder" else 1
            sd[f"{pre}.{m}.layer_norm.weight"] = (cfg.d_model,)
            sd[f"{pre}.{m}.DenseReluDense.wi.weight"] = (cfg.d_ff, cfg.d_model)
            sd[f"{pre}.{m}.DenseReluDense.wo.weight"] = (cfg.d_model, cfg.d_ff)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}


def test_convert_hf_state_dict_matches_jax():
    sd = _hf_state_dict(CFG, np.random.default_rng(2))
    want = jax.tree.map(np.asarray, jt5.convert_hf_state_dict(sd, JCFG))
    got = t5.convert_hf_state_dict(sd, CFG)
    leaves_w, leaves_g = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(leaves_w) == len(leaves_g) == 3 + 2 + CFG.layers * (5 + 3) + CFG.layers * (5 + 5 + 3)
    assert jax.tree.structure(want) == jax.tree.structure(jax.tree.map(np.asarray, got))
    for a, b in zip(leaves_w, leaves_g):
        np.testing.assert_array_equal(b.numpy(), a)


def test_init_params_has_jax_tree_and_scales():
    got = t5.init_params(torch.Generator().manual_seed(0), CFG)
    want = jax.eval_shape(lambda: jt5.init_params(jax.random.key(0), JCFG))
    assert jax.tree.structure(want) == jax.tree.structure(jax.tree.map(np.asarray, got))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert tuple(a.shape) == tuple(b.shape)
    assert abs(float(got["shared"].std()) - 1.0) < 0.1


def _ttf():
    try:
        import matplotlib

        path = os.path.join(matplotlib.get_data_path(), "fonts/ttf/DejaVuSans.ttf")
    except ImportError:
        path = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
    if not os.path.exists(path):
        pytest.skip("no TrueType font here")
    return path


@pytest.mark.parametrize("char", ["A", "%", "g"])
def test_rasterize_char_matches_jax(char):
    font = _ttf()
    got = t5_emoji.rasterize_char(char, font)
    assert got.shape == (172, 172) and got.dtype == torch.bool and bool(got.any())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt5_emoji.rasterize_char(char, font)))


@pytest.mark.parametrize("prompt", ["fire", "  water", "", "42 cats", "ñ"])
def test_fallback_stencil_matches_jax(prompt):
    got = masking._fallback_emoji_stencil(prompt)
    assert got.shape == (172, 172) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmasking._fallback_emoji_stencil(prompt)))


def test_emoji_extractor_raises_without_files_and_masking_falls_back(monkeypatch, tmp_path):
    monkeypatch.setenv("TBIST_T5_EMOJI_DIR", str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="T5-emojilm"):
        t5_emoji.get_emoji_extractor.__wrapped__("cpu")
    (tmp_path / "model").mkdir()
    monkeypatch.setenv("TBIST_T5_EMOJI_DIR", str(tmp_path / "model"))
    monkeypatch.setenv("TBIST_EMOJI_FONT", str(tmp_path / "none.ttf"))
    with pytest.raises(FileNotFoundError, match="emoji font"):
        t5_emoji.get_emoji_extractor.__wrapped__("cpu")
    monkeypatch.setattr(degraded, "_FLAGS", {})
    masking.default_emoji_extractor.cache_clear()
    assert masking.default_emoji_extractor("cpu") is masking._fallback_emoji_stencil
    assert degraded.flags_for(["emoji_extractor"]) == ["emoji_fallback"]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # one card: on a host with several, the mesh would shard these runs
    monkeypatch.setenv("TBIST_DISABLE_MESH", "1")
    return torch.device("cuda")


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda, params):
    ids, mask = _inputs()
    want = t5.generate(params, CFG, torch.from_numpy(ids), torch.from_numpy(mask), max_len=10)
    got = t5.generate(tree_to(params, cuda), CFG, torch.from_numpy(ids).to(cuda),
                      torch.from_numpy(mask).to(cuda), max_len=10)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
