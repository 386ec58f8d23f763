"""Command-line entry point of the port (counterpart of ``tbist_tpu.cli``).

Example:
  python -m tbist_tpu_torch.cli --image data/content_imgs/boat.jpg \
      --style data/style_imgs/starry_night.jpg --style-transfer \
      --steps 200 --out out.png

It takes the JAX CLI's flags. Flags of effects the port does not run yet
stop the CLI with a message naming the ROADMAP item and exit code 2.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from tbist_tpu_torch import api
from tbist_tpu_torch.utils.config import EffectRequest, GatysConfig
from tbist_tpu_torch.utils.logging import RunMetrics, logger

# (argparse dest, flag, the ROADMAP Queue 1 item that ports it)
_UNPORTED_FLAGS = (
    ("video", "--video", "slice 7, items 28-30"),
    ("grayscale", "--grayscale", "item 11"),
    ("text_style", "--text-style", "items 17-19"),
    ("text_location", "--text-location", "items 20-23"),
    ("text_texture", "--text-texture", "item 24"),
    ("pixel_art", "--pixel-art", "item 13"),
    ("pixel_from_image", "--pixel-from-image", "item 13"),
    ("color_palette", "--color-palette", "item 11"),
    ("depth", "--depth", "items 25-27"),
    ("channel_attention", "--channel-attention", "item 8"),
    ("resume_dir", "--resume-dir", "item 9"),
    ("aot_cache", "--aot-cache", "item 32"),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="tbist_tpu_torch — GPU style transfer")
    p.add_argument("--image", help="input image path")
    p.add_argument("--video", help="input video path")
    p.add_argument("--out", required=True, help="output path (.png / .mp4)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                   "the plain PyTorch versions of the kernels)")

    p.add_argument("--grayscale", action="store_true")
    p.add_argument("--text-style", help="text prompt for feed-forward stylization")
    p.add_argument("--text-location", help="prompt for DINO+SAM location mask")
    p.add_argument("--text-texture", help="prompt for emoji texture mask")
    p.add_argument("--mask-crop", type=int, nargs=4, default=(0, 0, 0, 0),
                   metavar=("L", "R", "T", "B"),
                   help="crop pixels off the mask-detection input")
    p.add_argument("--mask-square", action="store_true",
                   help="center-crop the mask-detection input square")
    p.add_argument("--mask-resize", type=int, nargs=2, metavar=("H", "W"),
                   help="resize the mask-detection input")
    p.add_argument("--detection-size", type=int, default=800,
                   help="GroundingDINO input shortest side")
    p.add_argument("--segmentation-size", type=int, default=0,
                   help="SAM encoder input size")

    p.add_argument("--pixel-art", action="store_true")
    p.add_argument("--pixel-size", type=float, default=0.4)
    p.add_argument("--pixel-palette", type=int, default=-1, help="palette index 0-69")
    p.add_argument("--pixel-edges", action="store_true")
    p.add_argument("--edge-threshold", type=int, default=50)
    p.add_argument("--pixel-interpolate", action="store_true",
                   help="gradient-interpolate the palette strip")
    p.add_argument("--pixel-from-image", help="extract the palette from this image")
    p.add_argument("--pixel-colors", type=int, default=10,
                   help="# colors for palette-from-image k-means")

    p.add_argument("--style-transfer", action="store_true")
    p.add_argument("--style", help="style image path")
    p.add_argument("--style2", help="second style image (mixing)")
    p.add_argument("--style-weight", type=float, default=0.5)
    p.add_argument("--mixing", action="store_true")
    p.add_argument("--channel-attention", action="store_true")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--optimizer", choices=["lbfgs", "adam"], default="lbfgs")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 VGG trunk (Gram matrices accumulate in f32)")
    p.add_argument("--aot-cache", action="store_true",
                   help="serialized-executable cache of the JAX package")
    p.add_argument("--resume-dir",
                   help="checkpoint dir: resumable optimization in segments")
    p.add_argument("--segment-steps", type=int, default=100,
                   help="steps per checkpoint segment with --resume-dir")

    p.add_argument("--color-palette", help="palette source image path")
    p.add_argument("--depth", choices=["mip", "depth_loss"])
    p.add_argument("--mip-layers", type=int, default=2)

    p.add_argument("--interp-frames", type=int, default=0)
    p.add_argument("--slowmo", type=float, default=0.0)
    p.add_argument("--max-frames", type=int)
    return p


def request_from_args(args) -> EffectRequest:
    return EffectRequest(
        style_transfer=args.style_transfer,
        style_mixing=args.mixing,
        gatys=GatysConfig(
            num_steps=args.steps,
            optimizer=args.optimizer,
            style_img_weight=args.style_weight,
            channel_attention=args.channel_attention,
            dtype="bfloat16" if args.bf16 else "float32",
        ),
    )


def main(argv=None, metrics: Optional[RunMetrics] = None) -> int:
    """Run the CLI on ``argv``; ``metrics``, when given, receives the run's
    timings and loss history."""
    parser = build_parser()
    args = parser.parse_args(argv)
    for dest, flag, item in _UNPORTED_FLAGS:
        if getattr(args, dest):
            parser.error(f"{flag} is not ported to the GPU yet (ROADMAP Queue 1, {item})")
    req = request_from_args(args)
    metrics = metrics if metrics is not None else RunMetrics()
    out = api.apply_image(
        args.image, req,
        style_image=args.style, style_image1=args.style, style_image2=args.style2,
        metrics=metrics, device=args.device,
    )
    if out is None:
        logger.error("image processing returned None (missing inputs?)")
        return 1
    out.save(args.out)
    if metrics.degraded:
        logger.warning("degraded components: %s", ", ".join(metrics.degraded))
    logger.info("wrote %s (timings: %s)", args.out, metrics.timings_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
