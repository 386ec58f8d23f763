from tbist_tpu_torch.utils.config import (
    ColorPaletteConfig,
    DepthConfig,
    EffectRequest,
    GatysConfig,
    MaskCompositeConfig,
    PixelArtConfig,
    TextEffectConfig,
    VideoConfig,
)
from tbist_tpu_torch.utils.imageio import (
    from_device,
    load_image,
    save_image,
    to_device,
    to_float,
    to_uint8,
)

__all__ = [
    "ColorPaletteConfig",
    "DepthConfig",
    "EffectRequest",
    "GatysConfig",
    "MaskCompositeConfig",
    "PixelArtConfig",
    "TextEffectConfig",
    "VideoConfig",
    "from_device",
    "load_image",
    "save_image",
    "to_device",
    "to_float",
    "to_uint8",
]
