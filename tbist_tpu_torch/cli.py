"""Command-line entry point of the port (counterpart of ``tbist_tpu.cli``).

Example:
  python -m tbist_tpu_torch.cli --image data/content_imgs/boat.jpg \
      --style data/style_imgs/starry_night.jpg --style-transfer \
      --steps 200 --out out.png

It takes the JAX CLI's flags; ``--video`` (with ``--max-frames``,
``--interp-frames`` and ``--slowmo``) writes an mp4 through
``api.apply_video``. ``--aot-cache`` is accepted and does nothing (the
eager port compiles nothing to cache; ROADMAP item 32). ``--resume-dir`` runs the optimisation
in checkpointed segments where the JAX CLI does: with ``--style-transfer``,
``--image`` and ``--style``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from tbist_tpu_torch import api
from tbist_tpu_torch.utils.config import (
    DepthConfig,
    EffectRequest,
    GatysConfig,
    PixelArtConfig,
    TextEffectConfig,
    VideoConfig,
)
from tbist_tpu_torch.utils.logging import RunMetrics, logger

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
                   help="accepted for the JAX CLI's sake; the port has no "
                   "executable cache yet and ignores it")
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
    text = None
    if args.text_style or args.text_location or args.text_texture:
        text = TextEffectConfig(
            style_prompt=args.text_style,
            location_prompt=args.text_location,
            texture_prompt=args.text_texture,
            mask_crop=tuple(args.mask_crop),
            mask_square=args.mask_square,
            mask_resize=tuple(args.mask_resize or ()),
            detection_size=args.detection_size,
            segmentation_size=args.segmentation_size,
        )
    pixel = None
    if args.pixel_art:
        pixel = PixelArtConfig(
            pixel_size=args.pixel_size,
            use_palette=args.pixel_palette >= 0 or bool(args.pixel_from_image),
            palette_number=max(args.pixel_palette, 0),
            palette_from_image=bool(args.pixel_from_image),
            palette_num_colors=args.pixel_colors,
            interpolate=args.pixel_interpolate,
            edge_detect=args.pixel_edges,
            edge_threshold=args.edge_threshold,
        )
    depth = DepthConfig(mode=args.depth, mip_layers=args.mip_layers) if args.depth else None
    return EffectRequest(
        grayscale=args.grayscale,
        text=text,
        pixel_art=pixel,
        style_transfer=args.style_transfer,
        style_mixing=args.mixing,
        color_palette=bool(args.color_palette),
        depth=depth,
        gatys=GatysConfig(
            num_steps=args.steps,
            optimizer=args.optimizer,
            style_img_weight=args.style_weight,
            channel_attention=args.channel_attention,
            dtype="bfloat16" if args.bf16 else "float32",
        ),
        video=VideoConfig(interpolation_frames=args.interp_frames, slowmo=args.slowmo),
    )


def _resume(args, cfg: GatysConfig, metrics: RunMetrics) -> int:
    """Resumable pixel optimization (``optimize.checkpoint``): segments of
    ``--segment-steps`` with the state saved between them."""
    import time

    from tbist_tpu_torch.optimize import checkpoint as ckpt
    from tbist_tpu_torch.utils import degraded
    from tbist_tpu_torch.utils.imageio import from_device, load_image, to_device
    from tbist_tpu_torch.weights import vgg as vgg_weights

    content, style = (to_device(load_image(p), cfg.shape_bucket, cfg.max_side, device=args.device)
                      for p in (args.image, args.style))
    t0 = time.perf_counter()
    out, hist = ckpt.stylize_resumable(
        content, [style], cfg, vgg_weights.get_params(device=args.device),
        args.resume_dir, args.segment_steps, device=args.device, metrics=metrics,
    )
    metrics.timings_s["gatys"] = time.perf_counter() - t0  # ends in the last read-back
    metrics.loss_history = hist
    from_device(out).save(args.out)
    flags = degraded.flags_for(["vgg_params"])
    if flags:
        metrics.degraded = sorted(set(metrics.degraded) | set(flags))
        logger.warning("degraded components: %s", ", ".join(flags))
    logger.info("wrote %s (resumable, %d new steps)", args.out, len(hist))
    return 0


def main(argv=None, metrics: Optional[RunMetrics] = None) -> int:
    """Run the CLI on ``argv``; ``metrics``, when given, receives the run's
    timings and loss history."""
    args = build_parser().parse_args(argv)
    if args.aot_cache:
        logger.info("--aot-cache: the port has no executable cache yet (ROADMAP Queue 1, "
                    "item 32); ignored")
    req = request_from_args(args)
    metrics = metrics if metrics is not None else RunMetrics()
    if args.resume_dir and args.style_transfer and args.image and args.style:
        return _resume(args, req.gatys, metrics)
    if args.video:
        path = api.apply_video(
            args.video, req,
            style_image=args.style, style_image1=args.style, style_image2=args.style2,
            color_palette_image=args.color_palette, pixel_palette_image=args.pixel_from_image,
            out_path=args.out, max_frames=args.max_frames, metrics=metrics, device=args.device,
        )
        if path is None:
            logger.error("video processing returned None (missing inputs?)")
            return 1
        if metrics.degraded:
            logger.warning("degraded components: %s", ", ".join(metrics.degraded))
        logger.info("wrote %s", path)
        return 0
    out = api.apply_image(
        args.image, req,
        style_image=args.style, style_image1=args.style, style_image2=args.style2,
        color_palette_image=args.color_palette, pixel_palette_image=args.pixel_from_image,
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
