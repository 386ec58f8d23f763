"""Interactive terminal app of the port (counterpart of
``tbist_tpu.ui.basic_cli``).

Reference: basic.py exposes 9 text-centric processing modes behind a
desktop widget (options list at basic.py:15-25, dispatch factory at
:210-280). The same mode list drives a prompt loop over the full pipeline
on one torch device. Run: ``python -m tbist_tpu_torch.ui.basic_cli``
(``--device cpu`` runs on the CPU).
"""

from __future__ import annotations

import argparse
import os

from tbist_tpu_torch import api
from tbist_tpu_torch.utils.config import DepthConfig, EffectRequest, TextEffectConfig

MODES = [
    "Text-Based Style Transfer",
    "Location Masking",
    "Style (Emoji) Masking",
    "Transfer + Location Mask",
    "Transfer + Style Mask",
    "Transfer + Location + Style Mask",
    "Location + Style Mask (merged mask)",
    "Style Transfer (Gatys)",
    "Depth-Based Style Transfer",
]


def _request_for(mode: int, prompts: dict) -> EffectRequest:
    t = prompts.get("transfer")
    l = prompts.get("location")
    x = prompts.get("texture")
    table = {
        0: TextEffectConfig(style_prompt=t),
        1: TextEffectConfig(location_prompt=l),
        2: TextEffectConfig(texture_prompt=x),
        3: TextEffectConfig(style_prompt=t, location_prompt=l),
        4: TextEffectConfig(style_prompt=t, texture_prompt=x),
        5: TextEffectConfig(style_prompt=t, location_prompt=l, texture_prompt=x),
        6: TextEffectConfig(location_prompt=l, texture_prompt=x),
    }
    if mode in table:
        return EffectRequest(text=table[mode])
    if mode == 7:
        return EffectRequest(style_transfer=True)
    return EffectRequest(depth=DepthConfig(mode="mip"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="tbist_tpu_torch basic app")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; 'cpu' runs "
                    "the plain PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    print("tbist_tpu_torch basic app — modes:")
    for i, m in enumerate(MODES):
        print(f"  {i}: {m}")
    mode = int(input("mode> ").strip())
    image = input("input image path> ").strip()
    prompts = {}
    style_path = None
    if mode in (0, 3, 4, 5):
        prompts["transfer"] = input("style prompt> ").strip()
    if mode in (1, 3, 5, 6):
        prompts["location"] = input("location prompt> ").strip()
    if mode in (2, 4, 5, 6):
        prompts["texture"] = input("texture prompt> ").strip()
    if mode in (7, 8):
        style_path = input("style image path> ").strip()
    out_path = input("output path [out.png]> ").strip() or "out.png"

    req = _request_for(mode, prompts)
    result = api.apply_image(image, req, style_image=style_path, device=args.device)
    if result is None:
        print("processing returned nothing (missing inputs?)")
        return 1
    result.save(out_path)
    print(f"saved {os.path.abspath(out_path)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
