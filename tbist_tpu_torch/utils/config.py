"""Typed configuration dataclasses.

A copy of ``tbist_tpu.utils.config`` that imports nothing of the JAX
package (importing that module runs ``tbist_tpu/utils/__init__.py``, which
imports jax). Fields and defaults are the same; a test checks them field
by field. Every effect has a frozen dataclass and the whole request is one
aggregate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# VGG / Gatys optimization
# ---------------------------------------------------------------------------

# ImageNet statistics used for VGG normalization (reference app.py:376-377).
VGG_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
VGG_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)

CONTENT_LAYERS_DEFAULT: Tuple[str, ...] = ("conv4_2",)
STYLE_LAYERS_DEFAULT: Tuple[str, ...] = (
    "conv1_1",
    "conv2_1",
    "conv3_1",
    "conv4_1",
    "conv5_1",
)


@dataclasses.dataclass(frozen=True)
class GatysConfig:
    """Pixel-optimization style transfer configuration.

    Defaults mirror the reference call sites (app.py:380-385,
    Style_a3.py:18): 400 steps, w_style=5e5, w_content=1, w_tv=20, w_edge=20.
    """

    num_steps: int = 400
    w_style: float = 5e5
    w_content: float = 1.0
    w_tv: float = 2e1
    w_edge: float = 2e1
    w_depth: float = 0.0
    random_init: bool = False
    content_layers: Tuple[str, ...] = CONTENT_LAYERS_DEFAULT
    style_layers: Tuple[str, ...] = STYLE_LAYERS_DEFAULT
    # Optimizer: "lbfgs" matches the reference (torch.optim.LBFGS,
    # run_style_transfer.py:90); "adam" is the fast TPU-friendly default for
    # CLIPstyler-style runs.
    optimizer: str = "lbfgs"
    learning_rate: float = 1.0  # LBFGS step scale; Adam uses adam_lr
    lbfgs_memory: int = 10  # (s, y) history pairs (torch default is 100;
    # 10 measured indistinguishable on this objective and 10x lighter)
    adam_lr: float = 2e-2
    # Two-style mixing weight (weight of style 2; reference StyleMixer.py:23).
    style_img_weight: float = 0.5
    # SE channel attention on content features (reference intends this but
    # its ChannelAttention crashes on a __init__ typo, ChannelAttention.py:11;
    # we implement the working behavior).
    channel_attention: bool = False
    # Reproduce the reference StyleMixer midpoint-shape precedence bug
    # (StyleMixer.py:31-32: `a + b // 2` instead of `(a + b) // 2`).
    exact_reference_mixer: bool = False
    # Images are bilinearly resized so H and W are multiples of this before
    # entering jit; keeps XLA compile cache small. 32 = VGG pool stride
    # product, also satisfies TPU lane tiling after 4 pools.
    shape_bucket: int = 32
    # Max dimension; larger inputs are downscaled preserving aspect.
    max_side: int = 1024
    seed: int = 101  # reference seeds all RNGs to 101 (run_style_transfer.py:52)
    dtype: str = "float32"  # "bfloat16" enables bf16 conv compute


@dataclasses.dataclass(frozen=True)
class TextEffectConfig:
    """Text-based effects (reference app.py:161-282, text/)."""

    style_prompt: Optional[str] = None  # CLIP→Ghiasi feed-forward transfer
    location_prompt: Optional[str] = None  # GroundingDINO+SAM mask
    texture_prompt: Optional[str] = None  # T5-emoji texture mask
    edge_smoothing: float = 5.0  # Gaussian feather of the binary mask
    emoji_blur_strength: int = 95
    emoji_step_size: float = 0.5
    emoji_style_strength: float = 1.5
    # Deterministic emoji sampling; the reference uses do_sample=True with no
    # seed (EmojiMaskExtractor.py:49) — we default to greedy and expose the
    # sampled path behind an explicit PRNG seed.
    emoji_sample: bool = False
    emoji_seed: int = 0
    box_threshold: float = 0.3
    text_threshold: float = 0.5
    # TextMaskExtractor._preprocess_image options (TextMaskExtractor.py:70-131):
    # crop (left, right, top, bottom) pixels off the detection input, center-
    # crop it square, and/or resize it to (height, width) before mask
    # extraction. The extracted mask is placed back into content coordinates
    # (the reference never passes non-defaults from any call site).
    mask_crop: Tuple[int, int, int, int] = (0, 0, 0, 0)
    mask_square: bool = False
    mask_resize: Tuple[int, ...] = ()
    # GroundingDINO detection resolution: shortest side / longest-side cap
    # of the detector input. Defaults match the reference preprocess
    # exactly (RandomResize([800], max_size=1333),
    # groundingdino_text_object_detector.py:43-49). TPU-native extension:
    # lowering detection_size trades mask fidelity for detector compute —
    # the dominant cost of the masked-text VIDEO lane, where small frames
    # are otherwise UPSCALED to 800px per the reference recipe (a 256px
    # frame runs 9.8x fewer detector pixels at detection_size=256).
    detection_size: int = 800
    detection_max_size: int = 1333
    # SAM image-encoder input size (longest side). 0/1024 = the
    # checkpoint-native grid (segment_anything SamPredictor.set_image).
    # Lower multiples of 16 (e.g. 512) interpolate the position grids
    # (models/sam.py params_for_size) for ~(1024/s)^2 less encoder
    # compute at reduced mask fidelity — pairs with detection_size for
    # fast masked VIDEO.
    segmentation_size: int = 0


@dataclasses.dataclass(frozen=True)
class PixelArtConfig:
    """Pixel art effect (reference components/pixel_art/pixel_art.py)."""

    pixel_size: float = 0.4
    use_palette: bool = False
    palette_number: int = 0
    palette_from_image: bool = False
    palette_num_colors: int = 10
    interpolate: bool = False
    edge_detect: bool = False
    edge_threshold: int = 50


@dataclasses.dataclass(frozen=True)
class ColorPaletteConfig:
    """Reinhard lαβ color transfer (reference color_palette/)."""

    clip_min: float = 1e-6
    std_floor: float = 1e-5


@dataclasses.dataclass(frozen=True)
class DepthConfig:
    """Depth-based style transfer (reference components/style_transfer_depth/)."""

    # default matches the reference UI default "Modified loss Style
    # Transfer" (app.py:110 via the radio value at app.py:968)
    mode: str = "depth_loss"  # "depth_loss" | "mip"
    mip_layers: int = 2
    w_depth: float = 5e4  # Style_a3.py:181


@dataclasses.dataclass(frozen=True)
class MaskCompositeConfig:
    """Mask compositing knobs (reference text/segmentation_style_transfer.py)."""

    edge_smoothing: float = 5.0
    blur_strength: int = 95
    step_size_multiplier: float = 0.5
    style_strength: float = 1.5


@dataclasses.dataclass(frozen=True)
class VideoConfig:
    """Video pipeline (reference app.py:742-864)."""

    interpolation_frames: int = 0  # cross-dissolve frames between real frames
    slowmo: float = 0.0  # 0 disables; else fps multiplier
    # Frames processed per device batch (vmap width). Bounds HBM usage.
    frame_batch: int = 8


@dataclasses.dataclass(frozen=True)
class EffectRequest:
    """Aggregate request replacing the reference's 25-positional-arg API.

    Effects compose in the reference order (app.py:157-735):
    grayscale → text → pixel art → style transfer → style mixing →
    color palette → depth.
    """

    grayscale: bool = False
    text: Optional[TextEffectConfig] = None
    pixel_art: Optional[PixelArtConfig] = None
    style_transfer: bool = False
    style_mixing: bool = False
    color_palette: bool = False
    depth: Optional[DepthConfig] = None
    gatys: GatysConfig = dataclasses.field(default_factory=GatysConfig)
    composite: MaskCompositeConfig = dataclasses.field(
        default_factory=MaskCompositeConfig
    )
    video: VideoConfig = dataclasses.field(default_factory=VideoConfig)
