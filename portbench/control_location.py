"""The readings that the limits of the location check are set from, on the
card at the cell's own size; the benchmark's runs do not run this.

    python3 portbench/control_location.py --control-seeds 7,8,9 [--photos 9]

For each control seed: the seeded models of a run with that seed, and for
each photo the plain reference put in the program's place one precision
below the configuration's (TF32 on in cuBLAS and cuDNN, where the
configuration states f32 with TF32 off, and SAM's global attention in plain
TF32 where K4 runs 3xTF32), with its own query selection, kept boxes,
embedding, mask logits and mask; then the check's numbers of it against the
f32 reference with TF32 off, as ``requests/text_location.py`` works them out
for the program. They are the upper readings; the lower readings are the
numbers of the cell's own runs (``run.py``, ``keep``). It prints one JSON
line a photo and seed, one with each seed's worst photo (as a run's check
reads its requests) and a last line with the smallest of those.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402


def control_readings(seed: int, device: str = "cuda", photos: int = 0, overrides=None):
    """One row of numbers a photo for ``seed``: the TF32 control against the
    f32 reference."""
    import numpy as np
    import torch

    from portbench import weights
    from portbench.reference import gatys as precision_ref
    from portbench.requests import text_location as loc

    work = run.load("workloads", "text_location")
    config = {**run.load("configs", work["config"]), **(overrides or {}).get("config", {})}
    params = {**work["params"], **(overrides or {}).get("params", {})}
    dev = torch.device(device)
    seeds = run.sub_seeds(seed)
    dino_p = weights.groundingdino(config["groundingdino"], seeds[0], dev)
    sam_p = weights.sam(config["sam"], seeds[1], dev)
    vocab = loc.vocabulary(p["prompt"] for p in params["photos"].values())
    names = sorted(params["photos"])[:photos or None]
    rows = []
    for name in names:
        photo = np.asarray(loc.read_checked(ROOT, params["photo_dir"], name,
                                            params["photos"][name]["sha256"]))
        frame = loc.path_input(photo, dev)
        prompt = params["photos"][name]["prompt"]
        with torch.no_grad():
            with precision_ref.precision(tf32=True):
                c = loc.reference_request(dino_p, sam_p, frame, prompt, vocab, config)
            full = c["full"]
            mask = (full > 0).cpu().numpy() if full is not None else np.zeros(photo.shape[:2],
                                                                              bool)
            img = np.repeat((mask * 255).astype(np.uint8)[..., None], 3, -1)
            keep = c["keep"]
            prog = {"pred_logits": c["logits"], "pred_boxes": c["boxes"], "topk": c["topk"],
                    "kept": c["boxes"][keep].float().cpu().numpy(),
                    "emb": c["emb"].permute(0, 2, 3, 1), "low": [c["low"]] if c["low"] is not None
                    else []}
            with precision_ref.precision(tf32=False):
                r = loc.reference_request(dino_p, sam_p, frame, prompt, vocab, config,
                                          topk=c["topk"])
            rows.append({"seed": seed, "photo": name,
                         "numbers": loc.request_numbers(prog, r, img, params["mask_band_rel"],
                                                        config["groundingdino"]["boxes_kept"])})
        del c, r
    return rows


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--control-seeds", default="")
    p.add_argument("--photos", type=int, default=0)
    a = p.parse_args()
    from portbench import check

    upper = {}
    for seed in [int(x) for x in a.control_seeds.split(",") if x]:
        rows = control_readings(seed, photos=a.photos)
        for row in rows:
            print(json.dumps(row), flush=True)
        worst = check.worst([r["numbers"] for r in rows])  # as a run's check reads them
        print(json.dumps({"seed": seed, "worst": worst}), flush=True)
        for k, v in worst.items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": "text_location", "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
