"""Emoji texture-mask extractor: T5-emojilm ``generate``, then the glyph
rasterized (counterpart of ``tbist_tpu.models.t5_emoji``).

Reference text/EmojiMaskExtractor.py: the prompt prefixed "translate to a
single emoji:", T5-base emojilm ``generate``, the first emoji character
drawn at size 109 on a 172×172 white canvas with the Noto Color Emoji
font, mask = pixels < 255.

Resolution, as in the JAX package: ``TBIST_T5_EMOJI_DIR`` or
``weights_cache/t5_emojilm/`` holds a HF model directory (weights and
tokenizer files); the font is ``TBIST_EMOJI_FONT`` or
``weights_cache/NotoColorEmoji.ttf``. ``get_emoji_extractor`` raises when
either is missing, or when ``transformers`` (for the tokenizer) is not
installed; ``effects.masking.default_emoji_extractor`` then falls back.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import numpy as np
import torch

from tbist_tpu_torch.models import t5
from tbist_tpu_torch.utils.imageio import resolve_device, tree_to, upload
from tbist_tpu_torch.utils.logging import logger

EMOJI_SIZE = 172
FONT_SIZE = 109
PREFIX = "translate to a single emoji:"

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)


def rasterize_char(char: str, font_path: str) -> torch.Tensor:
    """One character drawn at (20, 10) on a white 172×172 canvas -> a bool
    (172, 172) CPU mask of the pixels below 255 (EmojiMaskExtractor.py:62-70)."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.fromarray(np.full((EMOJI_SIZE, EMOJI_SIZE, 3), 255, np.uint8))
    draw = ImageDraw.Draw(img)
    draw.text((20, 10), char, (0, 0, 0), font=ImageFont.truetype(font_path, size=FONT_SIZE))
    return torch.from_numpy(np.asarray(img)[:, :, 0] < 255)


@functools.lru_cache(maxsize=None)
def get_emoji_extractor(device="cuda") -> Callable[[str], torch.Tensor]:
    """The prompt -> (172, 172) bool stencil callable, T5 on ``device``,
    decoding greedily. Raises when a file is missing."""
    device = resolve_device(device)
    model_dir = os.environ.get("TBIST_T5_EMOJI_DIR", os.path.join(_CACHE_DIR, "t5_emojilm"))
    font_path = os.environ.get("TBIST_EMOJI_FONT", os.path.join(_CACHE_DIR, "NotoColorEmoji.ttf"))
    if not os.path.isdir(model_dir):
        raise FileNotFoundError(f"no T5-emojilm model dir at {model_dir}")
    if not os.path.exists(font_path):
        raise FileNotFoundError(f"no emoji font at {font_path}")

    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(model_dir)
    sd_path = next((os.path.join(model_dir, n) for n in ("pytorch_model.bin", "model.safetensors")
                    if os.path.exists(os.path.join(model_dir, n))), None)
    if sd_path is None:
        raise FileNotFoundError(f"no weights file in {model_dir}")
    if sd_path.endswith(".safetensors"):
        from safetensors.torch import load_file

        sd = load_file(sd_path)
    else:
        sd = torch.load(sd_path, map_location="cpu", weights_only=True)
    params = tree_to(t5.convert_hf_state_dict({k: v.float().numpy() for k, v in sd.items()}),
                     device)
    logger.info("T5-emojilm: converted HF checkpoint from %s", model_dir)

    def extractor(prompt: str) -> torch.Tensor:
        enc = tokenizer([PREFIX + prompt], max_length=64, truncation=True, return_tensors="np")
        out = t5.generate(params, t5.BASE, upload(enc["input_ids"], device),
                          upload(enc["attention_mask"], device), max_len=16)
        text = tokenizer.batch_decode(out.cpu().numpy(), skip_special_tokens=True)[0]
        if not text:
            return torch.zeros((EMOJI_SIZE, EMOJI_SIZE), dtype=torch.bool)
        return rasterize_char(text[0], font_path)

    return extractor
