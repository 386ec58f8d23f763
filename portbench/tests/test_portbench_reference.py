"""The plain reference against the port at tiny sizes on the CPU: VGG-19's
features, the Gatys loss and its gradient, Depth Anything, L-BFGS over
enough steps that its buffer wraps, GroundingDINO, and SAM's encoder and
mask decoder."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.reference import depth_anything as ref_da
from portbench.reference import gatys as ref
from portbench.reference import vgg19 as ref_vgg
from portbench.tests.test_portbench_harness import TINY_DA
from portbench import run
from portbench.tests.test_portbench_location import published_decoder  # noqa: F401

CFG = run.load("configs", "vgg19_gatys_512")["gatys"]


def _images(side=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    c = torch.rand((1, side, side, 3), generator=g)
    s = torch.rand((1, side, side, 3), generator=g)
    c[:, :6, :6] = 0.5  # a flat patch: TV's differences are exact zeros there
    return c, s


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_vgg_features_match_the_port():
    from tbist_tpu_torch.models import vgg19

    params = weights.vgg19(5, "cpu")
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    layers = ["conv1_1", "conv2_1", "conv3_1", "conv4_1", "conv4_2", "conv5_1"]
    port = vgg19.extract_features(params, x, layers)
    mine = ref_vgg.features(ref_vgg.plain_weights(params), x.permute(0, 3, 1, 2), layers)
    for l in layers:
        assert _rel(mine[l].permute(0, 2, 3, 1), port[l]) < 1e-5, l


@pytest.mark.parametrize("with_depth", [False, True])
def test_loss_and_gradient_match_the_port(with_depth):
    from tbist_tpu_torch.models import depth_anything as da
    from tbist_tpu_torch.ops.mip import normalize_depth
    from tbist_tpu_torch.optimize import gatys
    from tbist_tpu_torch.utils.config import GatysConfig

    vgg = weights.vgg19(7, "cpu")
    c, s = _images()
    cfg = dict(CFG, w_depth=5e4 if with_depth else 0.0)
    da_params = weights.depth_anything(TINY_DA, 9, "cpu") if with_depth else None
    obj = ref.objective(cfg, vgg, c, s, da_params, TINY_DA)
    x = (c + 0.05 * torch.randn(c.shape, generator=torch.Generator().manual_seed(3))).clamp(0, 1)
    lr, gr = ref.loss_grad(obj, x)

    gcfg = GatysConfig(w_depth=cfg["w_depth"])
    dcfg = da.DAConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_DA.items()})

    def depth_fn(img):
        return da.predict_depth(da_params, dcfg, img)

    mean, std = gatys._vgg_stats(torch.device("cpu"))
    layers = tuple(dict.fromkeys(gcfg.content_layers + gcfg.style_layers))
    with torch.no_grad():
        from tbist_tpu_torch.models import vgg19
        from tbist_tpu_torch.ops import losses

        nc = losses.normalize(c, mean, std)
        feats = vgg19.extract_features(vgg, nc, layers)
        grams = losses.style_targets([vgg19.extract_features(vgg, losses.normalize(s, mean, std),
                                                             gcfg.style_layers)],
                                     gcfg.style_layers)
        tg = losses.gradient_images(losses.to_grayscale(nc))
        td = normalize_depth(depth_fn(c))[None] if with_depth else None
    xp = x.clone().requires_grad_(True)
    lp = gatys.lane_losses(gcfg, vgg, xp, feats, tg, grams, gcfg.w_style,
                           depth_fn if with_depth else None, td)[0]
    (gp,) = torch.autograd.grad(lp, xp)
    assert float(lr) == pytest.approx(float(lp.detach()), rel=1e-5)
    assert _rel(gr, gp) < 1e-4


def test_depth_anything_matches_the_port():
    from tbist_tpu_torch.models import depth_anything as da

    params = weights.depth_anything(TINY_DA, 4, "cpu")
    cfg = da.DAConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY_DA.items()})
    x = torch.rand((1, 40, 36, 3), generator=torch.Generator().manual_seed(2))
    port = da.predict_depth(params, cfg, x)
    mine = ref_da.depth(params, TINY_DA, x.permute(0, 3, 1, 2))
    assert mine.shape == port.shape == (40, 36)
    assert float(port.std()) > 0
    assert _rel(mine, port) < 1e-5


def test_lbfgs_matches_the_port_over_a_wrapped_buffer():
    """The two-loop recursion over the circular buffer against the port's
    compact form, on a convex quadratic, 25 steps with m = 4; a skipped
    pair (y·s <= 1e-10) leaves its slot as it was in both."""
    from tbist_tpu_torch.optimize import lbfgs

    n = 64
    g = torch.Generator().manual_seed(0)
    a = torch.randn((n, n), generator=g, dtype=torch.float64)
    hess = (a @ a.T / n + torch.eye(n, dtype=torch.float64)).float()
    x_p = x_r = torch.randn(n, generator=g)
    st_p = lbfgs.init_state((n,), 4)
    st_r = ref.init_state((n,), 4, "cpu")
    for k in range(25):
        grad_p, grad_r = hess @ x_p, hess @ x_r
        if k == 7:  # a pair the update must skip
            grad_p = st_p.prev_grad.clone()
            grad_r = st_r["prev_grad"].clone()
        step_p, st_p = lbfgs.update(grad_p, st_p)
        step_r = ref.lbfgs_step(grad_r, st_r)
        assert _rel(step_r, step_p) < 1e-4, k
        x_p, x_r = x_p + step_p, x_r + step_r
    assert torch.equal(st_p.rho != 0, st_r["rho"] != 0)


def test_free_run_captures_have_the_port_shapes():
    vgg = weights.vgg19(7, "cpu")
    c, s = _images(side=16)
    obj = ref.objective(dict(CFG, w_depth=0.0), vgg, c, s)
    cap = ref.stylize(obj, c, 14, 10, check_steps=12)
    assert len(cap["hist"]) == 14 and np.isfinite(cap["hist"]).all()
    assert cap["output_u8"].dtype == torch.uint8
    assert cap["x_last"].shape == cap["grad_last"].shape == cap["step_last"].shape == c.shape
    assert len(cap["steps_u"]) == 13 and cap["gradk"].shape == c.shape
    assert cap["state_last"]["step"] == 13 and cap["state_last"]["s_hist"].shape == (10, *c.shape)


def test_the_check_follows_a_free_run_of_the_reference():
    """The reference's own free run, put in the program's place, reads
    round-off on every number, and the image exactly."""
    from portbench import check

    vgg = weights.vgg19(7, "cpu")
    c, s = _images(side=16)
    obj = ref.objective(dict(CFG, w_depth=0.0), vgg, c, s)
    cap = ref.stylize(obj, c, 14, 10, check_steps=12)
    out = check.request_numbers(obj, c, cap, cap["output_u8"][0].numpy(), 1.0, 10)
    assert set(out) == set(check.NUMBERS)
    assert out["output_levels_off"] == 0
    assert max(out.values()) < 1e-5, out


def test_pool_splits_ties_as_the_port():
    """The reference's pool and its gradient against the port's K3 (its
    plain version on the CPU) on quarter steps: exact ties and exact zeros."""
    from tbist_tpu_torch.kernels.relu_pool import relu_max_pool_2x2_even

    g = torch.Generator().manual_seed(0)
    pre = ((torch.rand((1, 8, 12, 4), generator=g) * 4).round() / 4 - 0.5)
    up = torch.randn((1, 4, 6, 4), generator=g)
    a = pre.clone().requires_grad_(True)
    (relu_max_pool_2x2_even(a) * up).sum().backward()
    b = pre.permute(0, 3, 1, 2).clone().requires_grad_(True)
    h = torch.relu(b).reshape(1, 4, 4, 2, 6, 2).amax(dim=(3, 5))
    (h * up.permute(0, 3, 1, 2)).sum().backward()
    assert torch.allclose(a.grad, b.grad.permute(0, 2, 3, 1), atol=1e-6)
    assert int((a.grad.abs() > 0).sum()) > int((up.abs() > 0).sum())  # ties were split


# ---------------------------------------------------------------------------
# the location cell: GroundingDINO, SAM
# ---------------------------------------------------------------------------


def _location_models(seed=11):
    from portbench.requests import text_location as loc
    from portbench.tests.test_portbench_location import TINY

    cfg = {**run.load("configs", "gdino_swint_sam_vitb_mask"), **TINY["config"]}
    dino_p = weights.groundingdino(cfg["groundingdino"], seed, "cpu")
    sam_p = weights.sam(cfg["sam"], seed + 1, "cpu")
    return cfg, dino_p, sam_p, loc


def _photo(h=40, w=56, seed=3):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((h, w, 3), generator=g) * 255).to(torch.uint8)


def test_groundingdino_matches_the_port():
    """The reference detector (Swin-T, BERT, fusion, deformable attention,
    two-stage selection, decoder) against the port's ``dino_sam`` dispatch
    on the same seeded weights: the same top queries, and logits and boxes
    to f32 rounding; the seeded draw keeps ``boxes_kept`` boxes."""
    from portbench.reference import groundingdino as ref_dino
    from tbist_tpu_torch.models import dino_sam

    cfg, dino_p, _, loc = _location_models()
    dino_cfg, swin_cfg, bert_cfg, _ = loc.port_configs(cfg)
    g = cfg["groundingdino"]
    vocab = loc.vocabulary(["dog", "boat"])
    img = _photo()
    det_hw = ref_dino.detection_size(40, 56, g["input_short_side"], g["input_max_side"])
    with torch.no_grad():
        ids, out = dino_sam._detect_dispatch(dino_p, img, "dog", vocab, cfg=dino_cfg,
                                             swin_cfg=swin_cfg, bert_cfg=bert_cfg, det_hw=det_hw)
        mine = ref_dino.detect(dino_p, img, det_hw, "dog", vocab, cfg=g, swin_cfg=g["swin"])
    assert ids == mine["ids"] == [101, 2001, 1012, 102]
    assert torch.equal(out["topk_index"][0], mine["topk"])
    assert _rel(out["pred_logits"][0], mine["logits"]) < 1e-5
    assert _rel(out["pred_boxes"][0], mine["boxes"]) < 1e-5
    assert int(ref_dino.kept(mine["logits"]).sum()) == g["boxes_kept"]
    assert torch.equal(ref_dino.kept(mine["logits"]), ref_dino.kept(out["pred_logits"][0]))


def test_sam_encoder_matches_the_port():
    """SAM's image encoder (windows, global attention with the decomposed
    relative positions, neck) and its preprocessing against the port's."""
    from portbench.reference import sam as ref_sam
    from tbist_tpu_torch.models import sam

    cfg, _, sam_p, loc = _location_models()
    *_, sam_cfg = loc.port_configs(cfg)
    img = _photo(50, 36)
    with torch.no_grad():
        emb, scale, nh, nw = sam.encode_uint8(sam_p, sam_cfg, img)
        x, rscale, rnh, rnw = ref_sam.preprocess(img, cfg["sam"])
        mine = ref_sam.encode(sam_p, x, cfg["sam"])
    assert (scale, nh, nw) == (rscale, rnh, rnw)
    assert _rel(emb.permute(0, 3, 1, 2), mine) < 1e-5


@pytest.mark.parametrize("published", [False, True])
def test_sam_decoder_against_the_port(request, published):
    """The mask decoder on the same embedding and boxes: the port's departs
    from the published one (its first two-way block keeps a residual, its
    LayerNorms take eps 1e-6; PERF.md, Open questions) by far more than
    rounding; with the published block in its place it agrees."""
    from portbench.reference import sam as ref_sam
    from tbist_tpu_torch.models import sam

    if published:
        request.getfixturevalue("published_decoder")
    cfg, _, sam_p, loc = _location_models()
    *_, sam_cfg = loc.port_configs(cfg)
    emb = torch.randn((1, 4, 4, 16), generator=torch.Generator().manual_seed(2))
    corners = torch.tensor([[0.1, 0.2, 0.6, 0.7], [0.3, 0.1, 0.9, 0.5]])
    with torch.no_grad():
        port = sam.decode_masks(sam_p, sam_cfg, emb, corners)
        mine = ref_sam.decode(sam_p, emb.permute(0, 3, 1, 2), corners, cfg["sam"])
    if published:
        assert _rel(port, mine) < 1e-5
    else:
        assert _rel(port, mine) > 1e-2
