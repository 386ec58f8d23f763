"""The location request kind at a tiny width on the CPU (``run.execute``
with ``device="cpu"``): GroundingDINO, BERT and SAM cut to a few channels,
the photos' detector input to 64 px, SAM's encoder to 64 px.

As the port stands its SAM mask decoder departs from the published one
(its first two-way block adds the self-attention to the tokens where the
published block replaces them, and its LayerNorms take eps 1e-6 where the
published ``nn.LayerNorm`` takes 1e-5; PERF.md, Open questions): the run
comes out not correct on the mask logits and the mask, and sound on the
detector and the encoder. With the published block put in the port's place
(``published_decoder``) it comes out correct, and each planted fault makes
it not correct again: a shifted box, mask logits off beyond their limit, a
dropped detector decoder layer. A request that took the border-prior
fallback ends the run without a result.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import run
from portbench.requests import text_location as loc

TINY = {"config": {
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
            "multimask_output": False}},
    "params": {"sample_from": 18, "sample_per_photo": 1, "trace_requests": [2, 4]}}
SECONDS = 36  # on ``request_clock``: 18 requests


@pytest.fixture(autouse=True)
def request_clock(monkeypatch):
    """The generator's clock, one second on at each reading. It reads it
    twice a request, so a window of ``SECONDS`` holds the 18 requests the
    tiny sample is drawn from, however long each takes here."""
    import itertools
    import time
    import types

    tick = itertools.count(int(time.perf_counter()) + 1)
    clock = types.SimpleNamespace(perf_counter=lambda: float(next(tick)))
    real = run.module

    def module(kind, name):
        mod = real(kind, name)
        if kind == "generators":
            mod.time = clock
        return mod

    monkeypatch.setattr(run, "module", module)


def execute(seed=3000000001, seconds=SECONDS, trace=0, **kw):
    torch.manual_seed(0)
    return run.execute(["--workload", "text_location", "--seed", str(seed), "--seconds",
                        str(seconds), "--trace", str(trace)], device="cpu", overrides=TINY, **kw)


def _numbers(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.fixture
def published_decoder(monkeypatch):
    """The port's two-way block as the published ``TwoWayAttentionBlock``
    computes it: the first block's self-attention replaces the tokens, and
    the decoder's LayerNorms take eps 1e-5."""
    from tbist_tpu_torch.models import sam

    def ln(x, p):
        return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-5)

    def twoway(queries, keys, q_pe, k_pe, p, heads, skip_first_pe):
        if skip_first_pe:
            queries = ln(sam._mha_split(queries, queries, queries, p["self_attn"], heads),
                         p["ln1"])
        else:
            q = queries + q_pe
            queries = ln(queries + sam._mha_split(q, q, queries, p["self_attn"], heads),
                         p["ln1"])
        k = keys + k_pe
        queries = ln(queries + sam._mha_split(queries + q_pe, k, keys, p["cross_t2i"], heads),
                     p["ln2"])
        h = torch.relu(queries @ p["mlp_fc1_w"] + p["mlp_fc1_b"])
        queries = ln(queries + (h @ p["mlp_fc2_w"] + p["mlp_fc2_b"]), p["ln3"])
        keys = keys + sam._mha_split(k, queries + q_pe, queries, p["cross_i2t"], heads)
        return queries, ln(keys, p["ln4"])

    real_decode = sam._decode

    def decode(params, cfg, emb, boxes01):
        real_ln = sam._layer_norm

        def final_ln(x, p):
            return ln(x, p) if p is params["final_ln"] else real_ln(x, p)

        sam._layer_norm = final_ln
        try:
            return real_decode(params, cfg, emb, boxes01)
        finally:
            sam._layer_norm = real_ln

    monkeypatch.setattr(sam, "_twoway_block", twoway)
    monkeypatch.setattr(sam, "_decode", decode)


def test_the_port_as_it_stands_fails_on_the_mask_decoder():
    rc, out, _ = execute()
    assert rc == 0 and out["correct"] is False
    n, lim = _numbers(out), {k: v["limit"] for k, v in out["checks"].items()}
    for k in ("topk_gap", "dino_logits_rel", "dino_boxes_rel", "kept_off", "boxes_off",
              "sam_embedding_rel"):
        assert n[k] <= lim[k], (k, n[k])
    assert n["sam_logits_rel"] > 100 * lim["sam_logits_rel"]
    assert n["mask_pixels_off"] > 0


def test_the_published_decoder_in_its_place_is_correct(published_decoder):
    keep = {}
    rc, out, lines = execute(keep=keep)
    assert rc == 0 and out["correct"] is True, out["checks"]
    assert out["attempted"] == len(keep["records"]) == 18
    checked = [r for i, r in enumerate(keep["records"]) if r["captures"]["sampled"]]
    assert len(checked) == 9 and {r["item"] for r in checked} == set(
        run.load("workloads", "text_location")["params"]["photos"])
    assert all(r["captures"]["boxes"] == 3 for r in keep["records"])
    assert list(out)[-1] == "checks" and lines[-1].startswith("check mask_pixels_off")


def test_a_shifted_box_is_not_correct(published_decoder, monkeypatch):
    from tbist_tpu_torch.models import dino_sam

    real = dino_sam._detect_collect

    def shifted(ids, out, vocab):
        boxes, phrases = real(ids, out, vocab)
        boxes = boxes.copy()
        boxes[0, 0] += 0.01
        return boxes, phrases

    monkeypatch.setattr(dino_sam, "_detect_collect", shifted)
    rc, out, _ = execute()
    assert rc == 0 and out["correct"] is False
    assert _numbers(out)["kept_off"] > 0


def test_mask_logits_off_beyond_their_limit(published_decoder, monkeypatch):
    from tbist_tpu_torch.models import sam

    real = sam.decode_masks
    limit = run.load("workloads", "text_location")["limits"]["sam_logits_rel"]

    def off(params, cfg, emb, boxes01):
        return real(params, cfg, emb, boxes01) * (1 + 3 * limit)

    monkeypatch.setattr(sam, "decode_masks", off)
    rc, out, _ = execute()
    assert rc == 0 and out["correct"] is False
    assert _numbers(out)["sam_logits_rel"] > limit


def test_a_dropped_detector_decoder_layer(published_decoder, monkeypatch):
    from tbist_tpu_torch.models import dino

    real = dino.forward

    def dropped(params, cfg, *a, **k):
        return real(dict(params, dec_layers=params["dec_layers"][1:]),
                    cfg._replace(dec_layers=cfg.dec_layers - 1), *a, **k)

    monkeypatch.setattr(dino, "forward", dropped)
    rc, out, _ = execute()
    assert rc == 0 and out["correct"] is False
    assert _numbers(out)["dino_logits_rel"] > out["checks"]["dino_logits_rel"]["limit"]


def test_the_border_prior_fallback_ends_the_run(monkeypatch, capsys):
    """Without an extractor in the registry the port falls back (no
    checkpoints here) and flags ``mask_fallback``: no result."""
    monkeypatch.setattr(loc.Session, "make_registry",
                        lambda self: self.api.ModelRegistry(device=self.dev))
    rc, out, _ = execute()
    assert rc == 4 and out is None
    assert "mask_fallback" in capsys.readouterr().err


def test_order_and_sample_are_seeded_and_cover_every_photo():
    params = run.load("workloads", "text_location")["params"]
    a, sa = loc.draw_order(params, 7)
    assert (a, sa) == loc.draw_order(params, 7)
    b, sb = loc.draw_order(params, 8)
    assert a != b and sa != sb
    n = len(params["photos"])
    assert sorted(a[:n]) == sorted(b[:n]) == sorted(params["photos"])
    assert len(sa) == n * params["sample_per_photo"] and max(sa) < params["sample_from"]
    assert {a[i] for i in sa} == set(params["photos"])


def test_vocabulary_keeps_the_special_ids():
    v = loc.vocabulary(["dog", "apple"])
    assert len(v) == 30522 and len(set(v.values())) == 30522
    assert (v["[CLS]"], v["[SEP]"], v["."], v["?"], v["[UNK]"]) == (101, 102, 1012, 1029, 100)
    assert (v["apple"], v["dog"]) == (2000, 2001)
    from tbist_tpu_torch.models import dino_sam

    assert dino_sam._simple_bert_tokenize("dog.", v) == [101, 2001, 1012, 102]


def test_mask_numbers_leave_out_the_band_around_zero():
    work = run.load("workloads", "text_location")
    assert work["params"]["mask_band_rel"] == work["limits"]["sam_logits_rel"]
    full = torch.tensor([[1.0, -1.0], [1e-6, -2.0]])
    r = {"scores": torch.arange(40.0), "logits": torch.zeros(30, 4), "boxes": torch.zeros(30, 4),
         "keep": torch.zeros(30, dtype=torch.bool), "emb": torch.ones(1, 2, 1, 1), "low": None,
         "full": full}
    prog = {"topk": torch.arange(39, 9, -1), "pred_logits": torch.zeros(30, 4),
            "pred_boxes": torch.zeros(30, 4), "kept": np.zeros((0, 4), np.float32),
            "emb": torch.ones(1, 1, 1, 2), "low": []}
    img = np.zeros((2, 2, 3), np.uint8)
    img[0, 0] = 255
    n = loc.request_numbers(prog, r, img, 1e-3, 0)
    assert n["mask_pixels_off"] == 0 and n["mask_pixels_near"] == 1 and n["topk_gap"] == 0
    img[1, 1] = 255
    assert loc.request_numbers(prog, r, img, 1e-3, 0)["mask_pixels_off"] == 1
    prog["topk"] = torch.arange(30)
    assert loc.request_numbers(prog, r, img, 1e-3, 0)["topk_gap"] > 0


WITNESS = r'''
import json, os, sys
os.environ.update(USE_TF="0", USE_FLAX="0", USE_JAX="0", USE_TORCH="1")
import torch
from transformers.models.sam.configuration_sam import SamMaskDecoderConfig
from transformers.models.sam.modeling_sam import SamTwoWayTransformer
from portbench import weights
from portbench.reference import sam as ref
from tbist_tpu_torch.models import sam as port

cfg = dict(img_size=64, patch=16, width=16, layers=2, heads=2, window=2, global_layers=[1],
           embed_dim=16, decoder_heads=2, decoder_layers=2, mlp_dim=32, num_mask_tokens=4)
p = weights.sam(cfg, 5, "cpu")
dt = torch.float64
def to(t):
    if isinstance(t, dict):
        return {k: to(v) for k, v in t.items()}
    if isinstance(t, list):
        return [to(v) for v in t]
    return t.to(dt)
p = to(p)
hf = SamTwoWayTransformer(SamMaskDecoderConfig(
    hidden_size=16, hidden_act="relu", mlp_dim=32, num_hidden_layers=2, num_attention_heads=2,
    attention_downsample_rate=2, layer_norm_eps=1e-5, attn_implementation="eager")).to(dt).eval()
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
g = torch.Generator().manual_seed(1)
tokens = torch.randn(1, 7, 16, generator=g, dtype=dt)
keys = torch.randn(1, 16, 16, generator=g, dtype=dt)
pos = torch.randn(1, 16, 16, generator=g, dtype=dt)
with torch.no_grad():
    hq, hk = hf(tokens[:, None], keys.transpose(1, 2).reshape(1, 16, 4, 4),
                pos.transpose(1, 2).reshape(1, 16, 4, 4), None)
    rq, rk = ref.two_way(p, tokens, keys, pos, 2)
    q, k = tokens, keys
    for i, blk in enumerate(p["decoder_blocks"]):
        q, k = port._twoway_block(q, k, tokens, pos, blk, 2, skip_first_pe=(i == 0))
    q = port._layer_norm(q + port._mha_split(q + tokens, k + pos, k, p["final_t2i"], 2),
                         p["final_ln"])
def rel(a, b):
    return float((a - b).norm() / b.norm())
print(json.dumps({"hf_vs_reference": rel(hq[:, 0], rq), "hf_keys_vs_reference": rel(hk[:, 0], rk),
                  "port_vs_reference": rel(q, rq), "port_vs_hf": rel(q, hq[:, 0])}))
'''


def test_a_published_implementation_sides_with_the_reference():
    """The second witness of the decoder's departure: transformers'
    ``SamTwoWayTransformer`` (an implementation of the published model
    independent of both) on the same weights in f64 agrees with the
    reference's ``two_way`` to its f32 softmax, and the port's blocks read
    0.5 against both. It runs in its
    own process, where transformers is installed (not on the card's
    machine)."""
    import importlib.util
    import json
    import os
    import subprocess
    import sys

    if importlib.util.find_spec("transformers") is None:
        pytest.skip("transformers is not installed")
    out = subprocess.run([sys.executable, "-c", WITNESS], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, PYTHONPATH=run.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    # transformers takes its softmax in f32 (``eager_attention_forward``): 7e-8 here
    assert r["hf_vs_reference"] < 1e-6 and r["hf_keys_vs_reference"] < 1e-6, r
    assert r["port_vs_reference"] > 1e-2 and r["port_vs_hf"] > 1e-2, r
