"""The port's SAM mask decoder in its default form is the published one
(``TwoWayTransformer`` with ``skip_first_layer_pe``, ``nn.LayerNorm`` at eps
1e-5), and the text→mask chain's spans. On the CPU at tiny widths, in f32
with TF32 off, against the plain references of the benchmark
(``portbench/reference/sam.py``, ``groundingdino.py``), which import
nothing of the port, and against transformers' ``SamTwoWayTransformer``.
The JAX package's form (``sam.JaxDecoderConfig``) is held to the JAX
package in ``tests/test_torch_sam.py``; here it has to fail against the
reference, so that these tests can tell the two forms apart."""

import pytest
import torch

from portbench import run, weights
from portbench.reference import sam as ref_sam
from portbench.requests import text_location as loc
from tbist_tpu_torch.models import dino_sam, sam
from tbist_tpu_torch.utils.precision import full_f32

# the location cell's configuration at a few channels: GroundingDINO, BERT
# and SAM cut in width and depth, the detector's input to 64 px, SAM's
# encoder to 64 px (a 4 x 4 embedding grid)
TINY = {
    "groundingdino": {
        "swin": {"embed_dim": 8, "depths": [2, 2, 2, 2], "heads": [1, 2, 2, 4], "window": 7,
                 "mlp_ratio": 2, "out_indices": [1, 2, 3]},
        "bert": {"vocab": 30522, "hidden": 16, "layers": 2, "heads": 2, "ffn": 32,
                 "max_pos": 64, "type_vocab": 2},
        "d_model": 16, "heads": 2, "ffn": 32, "enc_layers": 2, "dec_layers": 2, "levels": 4,
        "points": 2, "num_queries": 30, "two_stage": True, "max_text_len": 256,
        "fusion_heads": 2, "fusion_dim": 32, "box_threshold": 0.3, "text_threshold": 0.5,
        "input_short_side": 64, "input_max_side": 96, "boxes_kept": 3},
    "sam": {"img_size": 64, "patch": 16, "width": 16, "layers": 4, "heads": 2, "window": 2,
            "global_layers": [1, 3], "rel_pos": True, "embed_dim": 16, "decoder_heads": 2,
            "decoder_layers": 2, "mlp_dim": 32, "num_mask_tokens": 4,
            "multimask_output": False}}
CONFIG = {**run.load("configs", "gdino_swint_sam_vitb_mask"), **TINY}
DINO_CFG, SWIN_CFG, BERT_CFG, SAM_CFG = loc.port_configs(CONFIG)
BOXES01 = torch.tensor([[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.9, 0.5], [0.0, 0.0, 1.0, 1.0]])

# The port decodes in f32, the references in f64, so the port's mask logits
# lie from them by f32 rounding through two blocks, the final attention and
# the upscaling: 3.0e-7 to 1.4e-6 over seeds 0-9. The JAX package's form
# lies 0.31 to 1.30 away on the same seeds (0.586-1.06 at full width on the
# card, PERF.md section 2), so 1e-5 parts the two by five orders.
LOGITS_REL = 1e-5


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f64(v) for v in tree]
    return tree.double()


def _sam_case(seed):
    """Seeded SAM weights at the tiny widths, an embedding (1, g, g, C)."""
    p = weights.sam(CONFIG["sam"], seed, "cpu")
    g = torch.Generator().manual_seed(seed + 100)
    return p, torch.randn((1, 4, 4, 16), generator=g)


def _reference_logits(p, emb):
    """The reference's mask logits in f64."""
    return ref_sam.decode(_f64(p), emb.double().permute(0, 3, 1, 2), BOXES01.double(),
                          CONFIG["sam"])


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_masks_is_the_published_decoder(seed):
    p, emb = _sam_case(seed)
    with torch.no_grad():
        got = sam.decode_masks(p, SAM_CFG, emb, BOXES01)
        want = _reference_logits(p, emb)
    assert got.dtype == torch.float32 and got.shape == (3, 16, 16)
    assert float(want.abs().max()) > 0.1
    for box in range(3):
        assert _rel(got[box], want[box]) < LOGITS_REL, box
    assert type(sam.BASE) is sam.SamConfig and not sam.BASE.jax_decoder


def test_the_jax_form_departs_from_the_reference():
    p, emb = _sam_case(0)
    jax_cfg = sam.JaxDecoderConfig(*SAM_CFG)
    assert jax_cfg == SAM_CFG and jax_cfg.jax_decoder
    assert sam.params_for_size(p, jax_cfg, 32)[1].jax_decoder  # kept through a resize
    with torch.no_grad():
        got = sam.decode_masks(p, jax_cfg, emb, BOXES01)
        want = _reference_logits(p, emb)
    assert min(_rel(got[b], want[b]) for b in range(3)) > 1e3 * LOGITS_REL


def _hf_two_way(p, monkeypatch):
    """transformers' ``SamTwoWayTransformer`` at the tiny widths in f64,
    carrying the decoder weights of ``p`` (f64), as a function with the
    reference's ``two_way`` signature."""
    for key in ("USE_TF", "USE_FLAX", "USE_JAX"):
        monkeypatch.setenv(key, "0")
    modeling = pytest.importorskip("transformers.models.sam.modeling_sam")
    from transformers.models.sam.configuration_sam import SamMaskDecoderConfig

    hf = modeling.SamTwoWayTransformer(SamMaskDecoderConfig(
        hidden_size=16, hidden_act="relu", mlp_dim=32, num_hidden_layers=2,
        num_attention_heads=2, attention_downsample_rate=2, layer_norm_eps=1e-5,
        attn_implementation="eager")).double().eval()

    def lin(m, w, b):
        m.weight.data.copy_(w.T)
        m.bias.data.copy_(b)

    def attn(m, q):
        for n in ("q", "k", "v"):
            lin(getattr(m, n + "_proj"), q[n + "_w"], q[n + "_b"])
        lin(m.out_proj, q["out_w"], q["out_b"])

    def ln(m, q):
        m.weight.data.copy_(q["scale"])
        m.bias.data.copy_(q["bias"])

    for layer, blk in zip(hf.layers, p["decoder_blocks"]):
        attn(layer.self_attn, blk["self_attn"])
        attn(layer.cross_attn_token_to_image, blk["cross_t2i"])
        attn(layer.cross_attn_image_to_token, blk["cross_i2t"])
        for i in range(1, 5):
            ln(getattr(layer, f"layer_norm{i}"), blk[f"ln{i}"])
        lin(layer.mlp.lin1, blk["mlp_fc1_w"], blk["mlp_fc1_b"])
        lin(layer.mlp.lin2, blk["mlp_fc2_w"], blk["mlp_fc2_b"])
    attn(hf.final_attn_token_to_image, p["final_t2i"])
    ln(hf.layer_norm_final_attn, p["final_ln"])

    def two_way(_p, tokens, keys, key_pe, _heads):
        n, t, c = keys.shape
        g = int(t ** 0.5)
        grid = keys.transpose(1, 2).reshape(n, c, g, g)
        pe = key_pe.expand(n, -1, -1).transpose(1, 2).reshape(n, c, g, g)
        q, k = hf(tokens[:, None], grid, pe, None)[:2]
        return q[:, 0], k[:, 0]

    return two_way


def test_decode_masks_matches_transformers_two_way_transformer(monkeypatch):
    """The mask logits with transformers' two-way transformer (an
    implementation of the published model independent of the port and the
    reference) in place of the reference's, in f64; the prompt encoding,
    upscaling and hypernetwork are the reference's."""
    p, emb = _sam_case(2)
    hf_two_way = _hf_two_way(_f64(p), monkeypatch)
    with torch.no_grad():
        want = _reference_logits(p, emb)
        monkeypatch.setattr(ref_sam, "two_way", hf_two_way)
        hf = _reference_logits(p, emb)
        got = sam.decode_masks(p, SAM_CFG, emb, BOXES01)
    # transformers takes its attention's softmax in f32 (its eager
    # attention casts the weights to f32 and back): 1.2e-7 against the f64
    # reference here
    assert _rel(hf, want) < 1e-6
    for box in range(3):
        assert _rel(got[box], hf[box]) < LOGITS_REL, box


def _photo(h=40, w=56, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((h, w, 3), generator=g) * 255).to(torch.uint8)


def _models(seed=11):
    vocab = loc.vocabulary(["dog", "boat"])
    return (weights.groundingdino(CONFIG["groundingdino"], seed, "cpu"),
            weights.sam(CONFIG["sam"], seed + 1, "cpu"), vocab)


def _extract(dino_p, sam_p, vocab, image, batch=False):
    kw = dict(sam_cfg=SAM_CFG, vocab=vocab, det_size=64, det_max=96, cfg=DINO_CFG,
              swin_cfg=SWIN_CFG, bert_cfg=BERT_CFG)
    if batch:
        return dino_sam.extract_masks_batch(dino_p, sam_p, image[None], "dog", **kw)[0]
    return dino_sam.extract_mask(dino_p, sam_p, image, "dog", **kw)


def test_extract_mask_matches_the_references():
    """One whole location request, the port's ``extract_mask`` (GroundingDINO,
    SAM's encoder and published decoder, the resize back) against the
    reference detector and SAM, both in f32 with TF32 off: the same kept
    boxes, and the same mask wherever the reference's logit lies further
    from 0 than the mask logits' rounding (1e-3 of their RMS, the
    benchmark's ``mask_band_rel``). Seed 14 covers 922 of the 2,240 pixels,
    and the JAX package's form misses 345 of them."""
    dino_p, sam_p, vocab = _models(14)
    img = _photo()
    with torch.no_grad(), full_f32():
        mask = _extract(dino_p, sam_p, vocab, img)
        ref = loc.reference_request(dino_p, sam_p, img, "dog", vocab, CONFIG)
    assert int(ref["keep"].sum()) == CONFIG["groundingdino"]["boxes_kept"]
    full = ref["full"].double()
    near = full.abs() <= 1e-3 * full.pow(2).mean().sqrt()
    want = full > 0
    assert mask.shape == (40, 56) and 0 < int(want.sum()) < want.numel()
    assert int(near.sum()) < 10  # 2 here
    assert int(((mask != want) & ~near).sum()) == 0


PHASES = ["tbist.location.dino", "tbist.location.sam_encode", "tbist.location.collect",
          "tbist.location.sam_decode"]


@pytest.mark.parametrize("batch", [False, True])
def test_location_spans_in_order(batch):
    """``extract_mask`` and ``extract_masks_batch`` open the four location
    spans once each, in the chain's order, under a profiler."""
    dino_p, sam_p, vocab = _models()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _extract(dino_p, sam_p, vocab, _photo(), batch)
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.name.startswith("tbist.location."))
    assert [n for *_, n in spans] == PHASES
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))  # one after the other


def test_no_span_opens_without_a_profiler(monkeypatch):
    """With no profiler recording, the chain enters no ``record_function``."""
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    dino_p, sam_p, vocab = _models()
    with torch.no_grad():
        for batch in (False, True):
            _extract(dino_p, sam_p, vocab, _photo(), batch)
    assert opened == []
