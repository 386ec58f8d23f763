"""Weight-arrival runbook of the port (counterpart of
``tbist_tpu.weights.verify_all``): convert + checksum + certify every model
family through the port's own loaders.

No real checkpoint is in the repository, so the port's converters are
proven only by their parity tests against the JAX package. The day the
reference checkpoint zip (the reference README.md:28-46) and HF snapshots
are at hand, ONE command certifies the port's whole neural stack on the
card:

    python -m tbist_tpu_torch.weights.verify_all --checkpoints /path/to/checkpoints \
        [--clip-pth ...] [--clip-bpe ...] [--t5-dir ...] [--depth-pth ...] \
        [--vgg-pth ...] [--bert-vocab ...] [--device cuda]

For each family it resolves the file(s), exports the matching TBIST_* env
var, loads through the port's loaders (``weights/vgg.py``,
``weights/ghiasi_convert.py``, ``models/clip_text.py``,
``models/dino_sam.get_loaded_params``, ``models/t5_emoji.py``,
``weights/depth_convert.py``), records a SHA256 manifest into
weights_cache/MANIFEST_torch.json (the JAX runbook's MANIFEST.json is left
alone), and runs the same behavioral battery on the bundled demo assets:

  vgg            conv1_1 ImageNet filter stats + finite features on boat.jpg
  ghiasi+mlp     64px stylization in range, prompt-sensitive
  clip           normalized 512-d prompt embedding, prompt-sensitive
  dino+sam       "boat" mask on boat.jpg: non-trivial coverage
  t5-emoji       "fire" -> non-empty emoji stencil
  depth          boat.jpg depth: finite, non-constant

Families whose files are absent report MISSING (exit code stays 0 unless
--strict); behavioral failures exit 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from typing import Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA = os.path.join(REPO, "data")
CACHE = os.path.join(REPO, "weights_cache")

# reference checkpoint-zip layout (README.md:28-46)
ZIP_FILES = {
    "ghiasi": "image_transformer.pth",
    "clip_mlp": "clip_text_embedding_transformer.pth",
    "dino": "groundingdino_swint_ogc.pth",
    "sam": "sam_vit_b_01ec64.pth",
}


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _boat() -> np.ndarray:
    from PIL import Image

    path = os.path.join(DATA, "content_imgs", "boat.jpg")
    return np.asarray(Image.open(path).convert("RGB"))


class Report:
    def __init__(self):
        self.results: Dict[str, str] = {}
        self.manifest: Dict[str, Dict] = {}

    def record(self, family: str, status: str, detail: str = ""):
        self.results[family] = f"{status}" + (f" — {detail}" if detail else "")
        print(f"[{status:7s}] {family:12s} {detail}", flush=True)

    def add_file(self, family: str, path: str):
        self.manifest.setdefault(family, {})[os.path.basename(path)] = {
            "path": os.path.abspath(path),
            "sha256": _sha256(path),
            "bytes": os.path.getsize(path),
        }


def _on(device, arr) -> "torch.Tensor":
    import torch

    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def verify_vgg(rep: Report, pth: Optional[str], device="cuda") -> bool:
    import torch

    if not (pth and os.path.exists(pth)):
        rep.record("vgg", "MISSING", "no torchvision vgg19 .pth")
        return True
    os.environ["TBIST_VGG19_PTH"] = pth
    rep.add_file("vgg", pth)
    from tbist_tpu_torch.models import vgg19
    from tbist_tpu_torch.ops import losses
    from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD
    from tbist_tpu_torch.utils.precision import full_f32
    from tbist_tpu_torch.weights import vgg as vgg_weights

    vgg_weights.get_params.cache_clear()
    params = vgg_weights.get_params(device=device)
    k = params["conv1_1"]["weight"].cpu().numpy()
    # ImageNet vgg19 conv1_1: weights are small, non-degenerate, mixed-sign
    ok = k.shape == (64, 3, 3, 3) and 0.05 < np.abs(k).max() < 5.0 and k.std() > 0.01
    x = _on(device, _boat()[None, :224, :224].astype("float32") / 255.0)
    with torch.no_grad(), full_f32():
        feats = vgg19.extract_features(
            params, losses.normalize(x, VGG_MEAN, VGG_STD), ("conv4_2",)
        )
    ok = ok and bool(torch.isfinite(feats["conv4_2"]).all())
    rep.record("vgg", "PASS" if ok else "FAIL", f"conv1_1 |w|max={np.abs(k).max():.3f}")
    return ok


def verify_ghiasi(rep: Report, g_pth: Optional[str], m_pth: Optional[str],
                  device="cuda") -> bool:

    if not (g_pth and m_pth and os.path.exists(g_pth) and os.path.exists(m_pth)):
        rep.record("ghiasi+mlp", "MISSING", "image_transformer / clip_mlp .pth")
        return True
    os.environ["TBIST_GHIASI_PTH"] = g_pth
    os.environ["TBIST_CLIP_MLP_PTH"] = m_pth
    rep.add_file("ghiasi", g_pth)
    rep.add_file("clip_mlp", m_pth)
    from tbist_tpu_torch.effects import text_transfer
    from tbist_tpu_torch.weights import ghiasi_convert

    ghiasi_convert.get_params.cache_clear()
    x_np = _boat()[None, :64, :64].astype("float32") / 255.0
    x = _on(device, x_np)
    out1 = text_transfer.perform_transfer(x, "mosaic tiles").cpu().numpy()
    out2 = text_transfer.perform_transfer(x, "pencil sketch").cpu().numpy()
    ok = (
        out1.shape == x_np.shape
        and 0.0 <= out1.min() and out1.max() <= 1.0
        and np.abs(out1 - x_np).mean() > 1e-3  # actually stylized
        and np.abs(out1 - out2).mean() > 1e-4  # prompt-sensitive
    )
    rep.record("ghiasi+mlp", "PASS" if ok else "FAIL",
               f"prompt delta={np.abs(out1 - out2).mean():.4f}")
    return ok


def verify_clip(rep: Report, pth: Optional[str], bpe: Optional[str], device="cuda") -> bool:

    if not (pth and bpe and os.path.exists(pth) and os.path.exists(bpe)):
        rep.record("clip", "MISSING", "ViT-B/32 .pth / BPE vocab")
        return True
    os.environ["TBIST_CLIP_PTH"] = pth
    os.environ["TBIST_CLIP_BPE"] = bpe
    rep.add_file("clip", pth)
    rep.add_file("clip", bpe)
    from tbist_tpu_torch.models import clip_text

    clip_text.get_default_encoder.cache_clear()
    enc = clip_text.get_default_encoder(device)
    e1 = enc("a photograph of a boat").cpu().numpy()
    e2 = enc("abstract watercolor painting").cpu().numpy()
    # cosine between normalized prompt embeddings: CLIP text space keeps
    # distinct prompts well separated but positively correlated
    n1 = e1 / np.linalg.norm(e1)
    n2 = e2 / np.linalg.norm(e2)
    cos = float((n1 * n2).sum())
    ok = e1.shape[-1] == 512 and np.isfinite(e1).all() and 0.3 < cos < 0.999
    rep.record("clip", "PASS" if ok else "FAIL", f"prompt cos={cos:.3f}")
    return ok


def verify_dino_sam(
    rep: Report, dino_pth: Optional[str], sam_pth: Optional[str],
    bert_vocab: Optional[str], device="cuda",
) -> bool:

    missing = [
        name for name, p in
        [("dino", dino_pth), ("sam", sam_pth), ("bert_vocab", bert_vocab)]
        if not (p and os.path.exists(p))
    ]
    if missing:
        rep.record("dino+sam", "MISSING", ", ".join(missing))
        return True
    os.environ["TBIST_DINO_PTH"] = dino_pth
    os.environ["TBIST_SAM_PTH"] = sam_pth
    os.environ["TBIST_BERT_VOCAB"] = bert_vocab
    rep.add_file("dino", dino_pth)
    rep.add_file("sam", sam_pth)
    rep.add_file("bert", bert_vocab)
    from tbist_tpu_torch.models import dino_sam

    dino_sam.get_mask_extractor.cache_clear()
    dino_sam.get_loaded_params.cache_clear()
    dino_sam.sam_lib.get_loaded_params.cache_clear()
    dino_sam._load_vocab.cache_clear()
    extractor = dino_sam.get_mask_extractor(device)
    img = _boat()
    mask = extractor(img, "boat").cpu().numpy()
    cover = mask.mean()
    # the boat occupies a meaningful central fraction of boat.jpg
    ok = mask.shape == img.shape[:2] and 0.02 < cover < 0.6
    rep.record("dino+sam", "PASS" if ok else "FAIL", f"mask coverage={cover:.3f}")
    return ok


def verify_t5(rep: Report, t5_dir: Optional[str], font: Optional[str], device="cuda") -> bool:

    if not (t5_dir and os.path.isdir(t5_dir)):
        rep.record("t5-emoji", "MISSING", "HF t5-base-emojilm dir")
        return True
    os.environ["TBIST_T5_EMOJI_DIR"] = t5_dir
    if font and os.path.exists(font):
        os.environ["TBIST_EMOJI_FONT"] = font
    from tbist_tpu_torch.models import t5_emoji

    t5_emoji.get_emoji_extractor.cache_clear()
    extractor = t5_emoji.get_emoji_extractor(device)
    mask = extractor("fire").float().numpy()
    frac = mask.mean()
    ok = mask.shape == (172, 172) and 0.005 < frac < 0.9
    rep.record("t5-emoji", "PASS" if ok else "FAIL", f"stencil fill={frac:.3f}")
    return ok


def verify_depth(rep: Report, pth: Optional[str], device="cuda") -> bool:

    if not (pth and os.path.exists(pth)):
        rep.record("depth", "MISSING", "Depth-Anything-V2-Small checkpoint")
        return True
    os.environ["TBIST_DEPTH_PTH"] = pth
    rep.add_file("depth", pth)
    from tbist_tpu_torch.weights import depth_convert

    depth_convert.get_depth_estimator.cache_clear()
    est = depth_convert.get_depth_estimator(device)
    x = _on(device, _boat()[None].astype("float32") / 255.0)
    d = est(x).cpu().numpy()
    ok = (
        d.shape == x.shape[1:3]
        and np.isfinite(d).all()
        and d.std() > 0.02  # a real depth map is far from constant
    )
    rep.record("depth", "PASS" if ok else "FAIL", f"depth std={d.std():.3f}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoints", default=None,
                    help="dir with the reference checkpoint-zip files")
    ap.add_argument("--vgg-pth", default=None)
    ap.add_argument("--clip-pth", default=None)
    ap.add_argument("--clip-bpe", default=None)
    ap.add_argument("--t5-dir", default=None)
    ap.add_argument("--emoji-font", default=None)
    ap.add_argument("--depth-pth", default=None)
    ap.add_argument("--bert-vocab", default=None)
    ap.add_argument("--strict", action="store_true",
                    help="missing families also fail")
    ap.add_argument("--device", default="cuda",
                    help="torch device to load and check on (default cuda)")
    args = ap.parse_args(argv)
    from tbist_tpu_torch.utils.imageio import resolve_device

    device = resolve_device(args.device)

    def from_zip(name: str) -> Optional[str]:
        if not args.checkpoints:
            return None
        p = os.path.join(args.checkpoints, ZIP_FILES[name])
        return p if os.path.exists(p) else None

    rep = Report()
    ok = True
    ok &= verify_vgg(rep, args.vgg_pth, device)
    ok &= verify_ghiasi(rep, from_zip("ghiasi"), from_zip("clip_mlp"), device)
    ok &= verify_clip(rep, args.clip_pth, args.clip_bpe, device)
    ok &= verify_dino_sam(rep, from_zip("dino"), from_zip("sam"), args.bert_vocab, device)
    ok &= verify_t5(rep, args.t5_dir, args.emoji_font, device)
    ok &= verify_depth(rep, args.depth_pth, device)

    os.makedirs(CACHE, exist_ok=True)
    manifest_path = os.path.join(CACHE, "MANIFEST_torch.json")
    with open(manifest_path, "w") as f:
        json.dump({"results": rep.results, "files": rep.manifest}, f, indent=2)
    print(f"\nmanifest: {manifest_path}")

    if args.strict and any("MISSING" in v for v in rep.results.values()):
        ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
