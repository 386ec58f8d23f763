"""Location requests: a text -> mask edit of a whole photo through
``api.apply_image``, GroundingDINO SwinT-OGC finding the prompt's boxes and
SAM ViT-B segmenting them (a workload whose ``"request"`` is
``"text_location"``).

Each request is ``EffectRequest(grayscale=True,
text=TextEffectConfig(location_prompt=<noun>))`` on one of the workload's
photos at its own size (``photos``: file, SHA-256, the photo's one-noun
subject). In the port's location mode the text stage returns the mask
itself as the image (``compose.pipeline``: a location prompt alone shows
its mask; the grayscale stage before it is the cheapest effect there is),
so the returned image is the mask. The seed draws the photos' order (every
seed sends the same set) and the sample the check compares (``sample``).

Set-up draws the seeded weights (``weights.groundingdino``,
``weights.sam``), makes the vocabulary (``vocabulary``), hands both models
and the vocabulary to the port through ``dino_sam.extract_mask`` (what
``make_mask_extractor`` calls, with the configuration's widths passed
explicitly) in the registry, and sends one request per photo, so that
every detector shape, every prompt's text features (the port encodes a
prompt once and keeps it) and every kernel are ready before the window.

Reading points, a contract. For the length of a run the benchmark wraps
four of the port's functions and calls through to them unchanged; a change
to the program that stops calling them through their modules has to keep
them, or bring a benchmark change that reads the same outputs another way.
A request that does not reach each of them as the location path does ends
the run without a result (``problems``), and so does a request that took
the border-prior fallback (``mask_fallback``) instead of DINO and SAM.

- ``models.dino_sam._dino_forward``, once a request: GroundingDINO's
  forward is queued under the range ``portbench.dino``.
- ``models.dino_sam._detect_collect(ids, out, vocab)``, once a request:
  keeps DINO's outputs before any threshold (``pred_logits`` (1, 900, T),
  ``pred_boxes``, ``topk_index``) and the boxes it returns.
- ``models.sam.encode_uint8``, once a request: SAM's image encoder under
  the range ``portbench.sam_encoder``; keeps the image embedding.
- ``models.sam.decode_masks``, once a chunk of boxes: SAM's mask decoder
  under the range ``portbench.sam_decoder``; counts the boxes
  (``captures["boxes"]``) and keeps their low-resolution mask logits.

Only the sampled requests keep anything: references to the program's own
output tensors on the card, which the program does not write again, so a
kept request costs no copy and no host time, and the card holds their few
MiB beside the program's memory. Every request is counted.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import check, weights
from portbench.reference import gatys as precision_ref
from portbench.reference import groundingdino as ref_dino
from portbench.reference import sam as ref_sam
from portbench.requests.gatys import read_checked

SPECIAL_IDS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103, ".": 1012,
               "?": 1029}
FIRST_WORD_ID = 2000


def vocabulary(words, size: int = 30522) -> Dict[str, int]:
    """A vocabulary of bert-base-uncased's size: its special tokens at
    their ids, ``words`` (sorted) at 2000 up, ``[unusedN]`` elsewhere."""
    vocab = dict(SPECIAL_IDS)
    for i, w in enumerate(sorted(set(words))):
        vocab[w] = FIRST_WORD_ID + i
    taken = set(vocab.values())
    vocab.update({f"[unused{i}]": i for i in range(size) if i not in taken})
    return vocab


def draw_order(params: Dict, seed: int) -> Tuple[List[str], List[int]]:
    """The photos of ``params["requests"]`` requests, each round of all of
    them in an order drawn from ``seed``; and the sample the check
    compares: ``sample_per_photo`` of each photo's requests among the first
    ``sample_from``, also drawn from ``seed``."""
    names = sorted(params["photos"])
    rng = np.random.default_rng(seed)
    order: List[str] = []
    while len(order) < params["requests"]:
        order.extend(names[i] for i in rng.permutation(len(names)))
    order = order[:params["requests"]]
    sample = []
    for n in names:
        at = [i for i in range(params["sample_from"]) if order[i] == n]
        sample.extend(int(i) for i in rng.choice(at, size=params["sample_per_photo"],
                                                  replace=False))
    return order, sorted(sample)


# ---------------------------------------------------------------------------
# reading points
# ---------------------------------------------------------------------------


class Reader:
    """Counts and keeps what the wrapped functions see, request by request,
    and starts and stops the profiler around the traced requests."""

    def __init__(self, sample=(), trace_requests: Optional[Tuple[int, int]] = None,
                 on_trace: Optional[Callable[[bool], None]] = None):
        self.sample = set(sample)
        self.trace_requests = trace_requests
        self.on_trace = on_trace
        self.index = -1
        self.capturing = False
        self.tracing = False
        self.captured: Dict = {}
        self.counts = {"dino": 0, "collect": 0, "encode": 0, "boxes": 0}

    def start_request(self, index: int, trace: bool = False) -> bool:
        self.index = index
        self.capturing = index in self.sample
        self.captured = {"low": []}
        self.counts = {k: 0 for k in self.counts}
        traced = bool(trace and self.trace_requests
                      and self.trace_requests[0] <= index < self.trace_requests[1])
        if traced and index == self.trace_requests[0]:
            self.on_trace(True)
            self.tracing = True
        return traced

    def finish_request(self) -> Dict:
        if self.tracing and self.index == self.trace_requests[1] - 1:
            self.on_trace(False)
            self.tracing = False
        out = dict(self.captured, **self.counts, sampled=self.capturing)
        out["problems"] = self.problems(out)
        self.captured, self.capturing = {}, False
        return out

    def problems(self, cap: Dict) -> List[str]:
        out = []
        for key, fn in (("dino", "models.dino_sam._dino_forward"),
                        ("collect", "models.dino_sam._detect_collect"),
                        ("encode", "models.sam.encode_uint8")):
            if cap[key] != 1:
                out.append(f"{fn} reached {cap[key]} times in a location request")
        if "kept" in cap and cap["boxes"] != len(cap["kept"]):
            out.append(f"models.sam.decode_masks decoded {cap['boxes']} boxes of the "
                       f"{len(cap['kept'])} the detector kept")
        return out

    def dino_forward(self, real, *a, **k):
        self.counts["dino"] += 1
        with torch.profiler.record_function("portbench.dino"):
            return real(*a, **k)

    def detect_collect(self, real, ids, out, vocab):
        self.counts["collect"] += 1
        boxes, phrases = real(ids, out, vocab)
        if self.capturing:
            self.captured.update(pred_logits=out["pred_logits"][0].detach(),
                                 pred_boxes=out["pred_boxes"][0].detach(),
                                 topk=out["topk_index"][0].detach(), kept=np.array(boxes))
        else:
            self.captured["kept"] = np.zeros((len(boxes), 4), np.float32)
        return boxes, phrases

    def encode(self, real, *a, **k):
        self.counts["encode"] += 1
        with torch.profiler.record_function("portbench.sam_encoder"):
            emb, scale, nh, nw = real(*a, **k)
        if self.capturing:
            self.captured.update(emb=emb.detach(), scale=scale, nh=nh, nw=nw)
        return emb, scale, nh, nw

    def decode(self, real, params, cfg, emb, boxes01):
        self.counts["boxes"] += int(boxes01.shape[0])
        with torch.profiler.record_function("portbench.sam_decoder"):
            low = real(params, cfg, emb, boxes01)
        if self.capturing:
            self.captured["low"].append(low.detach())
        return low


@contextlib.contextmanager
def installed(reader: Reader):
    """Wrap the port's reading points for the block."""
    from tbist_tpu_torch.models import dino_sam, sam

    saved = [(dino_sam, "_dino_forward", dino_sam._dino_forward),
             (dino_sam, "_detect_collect", dino_sam._detect_collect),
             (sam, "encode_uint8", sam.encode_uint8), (sam, "decode_masks", sam.decode_masks)]
    fwd, collect, enc, dec = (s[2] for s in saved)
    dino_sam._dino_forward = lambda *a, **k: reader.dino_forward(fwd, *a, **k)
    dino_sam._detect_collect = lambda ids, out, vocab: reader.detect_collect(collect, ids, out,
                                                                              vocab)
    sam.encode_uint8 = lambda *a, **k: reader.encode(enc, *a, **k)
    sam.decode_masks = lambda p, c, e, b: reader.decode(dec, p, c, e, b)
    try:
        yield reader
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a.double() - b.double()))
                 / torch.clamp(torch.linalg.vector_norm(b.double()), min=1e-30))


def path_input(photo: np.ndarray, dev) -> torch.Tensor:
    """The (H, W, 3) uint8 frame the location path hands both models: the
    photo as the API's float image, mapped back as the extractor maps a
    float frame, (clip(x, 0, 1) * 255) truncated."""
    x = torch.from_numpy(np.array(photo)).to(dev).float() / 255.0
    return (x.clamp(0, 1) * 255).to(torch.uint8)


def xyxy(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """cxcywh in [0, 1] -> pixel xyxy, in f32 on the host."""
    b = boxes.float().cpu() * torch.tensor([w, h, w, h], dtype=torch.float32)
    return torch.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                        b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], 1)


def reference_request(dino_p, sam_p, frame: torch.Tensor, prompt: str, vocab, cfg: Dict,
                      topk=None) -> Dict:
    """The plain reference's location request on ``frame``: the detector
    (following ``topk`` where given), the kept boxes, the embedding, each
    kept box's low-resolution logits and the image's mask logits (the
    largest over the boxes)."""
    g, s = cfg["groundingdino"], cfg["sam"]
    h, w = frame.shape[:2]
    det_hw = ref_dino.detection_size(h, w, g["input_short_side"], g["input_max_side"])
    d = ref_dino.detect(dino_p, frame, det_hw, prompt, vocab, topk=topk, cfg=g, swin_cfg=g["swin"])
    keep = ref_dino.kept(d["logits"])
    x, scale, nh, nw = ref_sam.preprocess(frame, s)
    emb = ref_sam.encode(sam_p, x, s)
    corners = ref_sam.boxes01(xyxy(d["boxes"][keep], h, w), scale, s).to(frame.device)
    low = ref_sam.decode(sam_p, emb, corners, s) if len(corners) else None
    full = ref_sam.full_logits(low, nh, nw, h, w, s).max(0).values if low is not None else None
    return dict(d, keep=keep, emb=emb, corners=corners, low=low, full=full)


def request_numbers(prog: Dict, r: Dict, out_img: np.ndarray, band_rel: float,
                    boxes_kept: int) -> Dict[str, float]:
    """The numbers of one request, the program's (``prog``: its DINO
    outputs, kept boxes, embedding and each box's low-resolution logits) against the reference's (``r``, which followed the program's
    query selection):

    - ``topk_gap``: how far the program's 900 chosen image tokens fall short
      of a top 900 of the reference's scores, in their order (0 where every
      chosen score is at least the reference's 900th and each at least the
      next), over the largest score;
    - ``dino_logits_rel``, ``dino_boxes_rel``: the 900 queries' logits and
      boxes, before any threshold, relative L2;
    - ``kept_off``: queries the program kept that the reference's
      thresholds do not keep or the other way round, and kept boxes the
      program returned other than its own outputs at the kept queries
      (exact, 0);
    - ``boxes_off``: the kept boxes' count against the configuration's;
    - ``sam_embedding_rel``: SAM's image embedding (the encoder, K4);
    - ``sam_logits_rel``: each box's low-resolution mask logits, the worst
      box, relative L2 (NaN where the kept sets differ);
    - ``mask_pixels_off``: pixels of the returned mask other than the
      reference's (its largest logit over the boxes above 0), leaving out
      those whose reference logit lies within ``band_rel`` of the logits'
      RMS from 0 (the workload's ``mask_band_rel``, set to the mask
      logits' own limit; counted in ``mask_pixels_near``)."""
    out: Dict[str, float] = {}
    s = r["scores"].double()
    chosen = s[prog["topk"].to(s.device)]
    kth = torch.sort(s, descending=True).values[chosen.shape[0] - 1]
    gap = torch.clamp(kth - chosen.min(), min=0)
    order = torch.clamp(chosen[1:] - chosen[:-1], min=0).max() if chosen.shape[0] > 1 else 0.0
    out["topk_gap"] = float(max(gap, order) / s.abs().max())
    out["dino_logits_rel"] = _rel_l2(prog["pred_logits"], r["logits"])
    out["dino_boxes_rel"] = _rel_l2(prog["pred_boxes"], r["boxes"])
    pkeep = ref_dino.kept(prog["pred_logits"]).cpu()
    rkeep = r["keep"].cpu()
    own = prog["pred_boxes"][pkeep.to(prog["pred_boxes"].device)].float().cpu().numpy()
    returned = np.asarray(prog["kept"], np.float32)
    same_rows = returned.shape == own.shape and bool((returned == own).all())
    out["kept_off"] = float(int((pkeep != rkeep).sum()) + (0 if same_rows else returned.shape[0]
                                                             + own.shape[0]))
    out["boxes_off"] = float(abs(int(rkeep.sum()) - boxes_kept))
    out["sam_embedding_rel"] = _rel_l2(prog["emb"].permute(0, 3, 1, 2), r["emb"])
    low = torch.cat(prog["low"]) if prog["low"] else None
    if low is None and r["low"] is None:
        out["sam_logits_rel"] = 0.0
    elif low is None or r["low"] is None or low.shape != r["low"].shape:
        out["sam_logits_rel"] = float("nan")
    else:
        out["sam_logits_rel"] = max(_rel_l2(a, b) for a, b in zip(low, r["low"]))
    img = np.asarray(out_img)
    got = torch.from_numpy(img[..., 0] > 127)
    bad = torch.from_numpy(~np.isin(img, (0, 255)).all(-1))
    if r["full"] is None:
        want, near = torch.zeros_like(got), torch.zeros_like(got)
    else:
        full = r["full"].double().cpu()
        want = full > 0
        near = full.abs() <= band_rel * full.pow(2).mean().sqrt()
    out["mask_pixels_off"] = float(int(((got != want) & ~near).sum()) + int(bad.sum()))
    out["mask_pixels_near"] = float(int(near.sum()))
    return out


# ---------------------------------------------------------------------------
# the request kind
# ---------------------------------------------------------------------------


def port_configs(cfg: Dict):
    """The configuration's widths as the port's config tuples."""
    from tbist_tpu_torch.models import bert, dino, sam, swin

    g, s = cfg["groundingdino"], cfg["sam"]
    sw = g["swin"]
    swin_cfg = swin.SwinConfig(embed_dim=sw["embed_dim"], depths=tuple(sw["depths"]),
                               heads=tuple(sw["heads"]), window=sw["window"],
                               mlp_ratio=sw["mlp_ratio"], out_indices=tuple(sw["out_indices"]))
    bert_cfg = bert.BertConfig(**g["bert"])
    dino_cfg = dino.DinoConfig(**{k: g[k] for k in dino.DinoConfig._fields})
    sam_cfg = sam.SamConfig(**{k: tuple(s[k]) if isinstance(s[k], list) else s[k]
                               for k in sam.SamConfig._fields})
    return dino_cfg, swin_cfg, bert_cfg, sam_cfg


class Session:
    """One run's location requests: the seeded models behind the port's
    extractor in a registry, the photos and their order, the reading points
    and the check."""

    def __init__(self, config: Dict, params: Dict, seeds: List[int], dev: torch.device,
                 on_trace: Optional[Callable[[bool], None]], trace: bool):
        from tbist_tpu_torch import api

        self.config, self.params, self.dev, self.api = config, params, dev, api
        self.dino_p = weights.groundingdino(config["groundingdino"], seeds[0], dev)
        self.sam_p = weights.sam(config["sam"], seeds[1], dev)
        self.vocab = vocabulary(p["prompt"] for p in params["photos"].values())
        self.registry = self.make_registry()
        self.trace_requests = tuple(params["trace_requests"])
        self.reader = Reader((), self.trace_requests if trace else None, on_trace)
        self.photos: Dict[str, np.ndarray] = {}
        self.sample: List[int] = []

    def make_registry(self):
        """The port's registry with the extractor the location path takes:
        ``dino_sam.extract_mask`` over the seeded models and the vocabulary."""
        from tbist_tpu_torch.models import dino_sam

        dino_cfg, swin_cfg, bert_cfg, sam_cfg = port_configs(self.config)
        dp, sp, vocab = self.dino_p, self.sam_p, self.vocab

        def extractor(image, prompt, det_size=800, det_max=1333, seg_size=0):
            return dino_sam.extract_mask(dp, sp, dino_sam._as_uint8_frame(image), prompt,
                                         sam_cfg=sam_cfg, vocab=vocab, det_size=det_size,
                                         det_max=det_max, seg_size=seg_size, cfg=dino_cfg,
                                         swin_cfg=swin_cfg, bert_cfg=bert_cfg)

        return self.api.ModelRegistry(device=self.dev, mask_extractor=extractor)

    def installed(self):
        return installed(self.reader)

    def trace_units(self) -> int:
        """Requests in the traced slice."""
        return self.trace_requests[1] - self.trace_requests[0]

    def load(self, root: str) -> None:
        self.photos = {name: np.asarray(read_checked(root, self.params["photo_dir"], name,
                                                     p["sha256"]))
                       for name, p in self.params["photos"].items()}

    def draw(self, seed: int) -> List[str]:
        order, self.sample = draw_order(self.params, seed)
        self.reader.sample = set(self.sample)
        return order

    def request(self, name: str):
        g = self.config["groundingdino"]
        req = self.config["request"]
        text = self.api.TextEffectConfig(
            location_prompt=self.params["photos"][name]["prompt"],
            edge_smoothing=req["edge_smoothing"], detection_size=g["input_short_side"],
            detection_max_size=g["input_max_side"])
        return self.api.EffectRequest(grayscale=req["grayscale"], text=text)

    def send(self, name: str):
        m = self.api.RunMetrics()
        out = self.api.apply_image(self.photos[name], self.request(name),
                                   registry=self.registry, metrics=m, device=self.dev)
        return np.asarray(out), {"degraded": list(m.degraded)}

    def warm_up(self, items: List[str]) -> None:
        """One request a photo: every shape, prompt and kernel the window
        uses."""
        for name in sorted(self.photos):
            self.send(name)

    def due(self, records: List[Dict]) -> int:
        """Requests the check has to compare: the sampled ones in the window."""
        return sum(i in set(self.sample) for i in range(len(records)))

    def problems(self, records: List[Dict]) -> List[str]:
        out = {p for r in records if r["error"] is None and r["out"] is not None
               for p in r["captures"]["problems"]}
        out |= {"a request took the border-prior fallback (mask_fallback), not DINO and SAM"
                for r in records if "mask_fallback" in r["timings"].get("degraded", ())}
        return sorted(out)

    def release(self) -> None:
        self.registry = None

    def check(self, records: List[Dict]) -> Tuple[Dict[str, float], int]:
        """Each sampled request against the reference, in f32 with TF32 off:
        the numbers at their worst request, and how many were compared."""
        rows = []
        cfg = self.config
        with precision_ref.precision(tf32=False), torch.no_grad():
            for i, r in enumerate(records):
                if i not in set(self.sample) or r["out"] is None or r["error"] is not None:
                    continue
                cap = r["captures"]
                frame = path_input(self.photos[r["item"]], self.dev)
                ref = reference_request(self.dino_p, self.sam_p, frame,
                                        self.params["photos"][r["item"]]["prompt"], self.vocab,
                                        cfg, topk=cap["topk"])
                rows.append(request_numbers(cap, ref, r["out"], self.params["mask_band_rel"],
                                            cfg["groundingdino"]["boxes_kept"]))
                del ref
        return check.worst(rows), len(rows)
