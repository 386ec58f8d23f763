"""Palette quantization and k-means color reduction, ported from
``tbist_tpu.ops.palette``.

Reference: components/pixel_art/pixel_art.py:76-89 quantizes via a sklearn
KDTree nearest-neighbor lookup over a 256-wide rendered palette strip, and
components/pixel_art/util.py:16-32 extracts palettes with cv2.kmeans.

Nearest-palette is a brute-force argmin over the palette axis, and k-means
a fixed-iteration Lloyd loop that stays on the device. The squared
distances ||x||² - 2x·p + ||p||² are sums of per-channel products added in
a fixed order, and the cluster sums are one-hot matrix products in f64, so
the card and the CPU find the same nearest colors and the same centres.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tbist_tpu_torch.utils.imageio import upload


def _sq_dist(x: torch.Tensor, c: torch.Tensor, with_x: bool) -> torch.Tensor:
    """(N, 3) and (P, 3) -> (N, P) squared L2 distances, left to right as the
    JAX package writes them: (||x||² -) 2x·c + ||c||²."""
    cross = x[:, None, 0] * c[None, :, 0] + x[:, None, 1] * c[None, :, 1]
    cross = cross + x[:, None, 2] * c[None, :, 2]
    cc = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2]
    if not with_x:
        return cc[None, :] - 2.0 * cross
    xx = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]
    return (xx[:, None] - 2.0 * cross) + cc[None, :]


def quantize_to_palette(img: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """Map each pixel of (..., 3) ``img`` to its nearest ``palette`` entry.

    L2 metric, ties to the lowest index (matching KDTree). ``palette`` is
    (P, 3).
    """
    flat = img.reshape(-1, 3).float()
    pal = palette.to(flat.device, torch.float32)
    idx = torch.argmin(_sq_dist(flat, pal, with_x=False), dim=1)
    return pal[idx].reshape(img.shape)


def draw_init_idx(n: int, k: int, seed: int = 0) -> torch.Tensor:
    """k distinct indices of [0, n), uniformly, from a ``torch.Generator``
    seeded with ``seed``: the distribution of the JAX package's
    ``jax.random.choice(key, n, (k,), replace=False)``, not its numbers.

    Floyd's algorithm draws a uniform k-subset in k draws, which a shuffle
    then orders: a permutation of all n pixels (``randperm``) costs the
    host about 30 ms at a megapixel."""
    gen = torch.Generator().manual_seed(seed)
    chosen = []
    for j in range(n - k, n):
        t = int(torch.randint(j + 1, (1,), generator=gen))
        chosen.append(j if t in chosen else t)
    return torch.tensor(chosen)[torch.randperm(k, generator=gen)]


def kmeans(
    pixels: torch.Tensor,
    k: int,
    init_idx: Optional[torch.Tensor] = None,
    iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means over (N, 3) pixels -> (centers (k, 3), labels (N,)).

    Fixed iteration count (the reference uses 10 cv2 iterations,
    util.py:29-30); empty clusters keep their previous center. The centres
    start at ``pixels[init_idx]``, drawn by ``draw_init_idx(N, k)``
    when not given. No value is read back inside the loop.
    """
    x = pixels.float()
    if init_idx is None:
        init_idx = draw_init_idx(x.shape[0], k)
    centers = x[upload(init_idx, x.device).long()]
    x64 = x.double()

    def assign(c):
        return torch.argmin(_sq_dist(x, c, with_x=True), dim=1)

    for _ in range(iters):
        one_hot = torch.nn.functional.one_hot(assign(centers), k).double()  # (N, k)
        counts = one_hot.sum(0)
        sums = one_hot.T @ x64  # (k, 3), a fixed-order reduction (no atomics)
        new = (sums / torch.clamp(counts, min=1.0)[:, None]).float()
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers, assign(centers)


def palette_from_image(
    img: torch.Tensor,
    num_colors: int,
    init_idx: Optional[torch.Tensor] = None,
) -> np.ndarray:
    """k-means color extraction -> sorted unique uint8 centers (host array).

    Matches ColourPalette.set_palette_from_image (colour_palette.py:53-64):
    the palette is the sorted unique set of quantized pixel values.
    ``num_colors`` clamps to >=1. ``img`` is (H, W, 3), float in [0, 1] or
    uint8. One read-back: the centres and how many pixels each labels (the
    unique quantized pixels are the rounded centres that label any).
    """
    num_colors = max(1, int(num_colors))
    flat = img.reshape(-1, 3)
    flat = flat * 255.0 if flat.is_floating_point() else flat.float()
    centers, labels = kmeans(flat, num_colors, init_idx=init_idx)
    # by comparison, not bincount: a card's bincount reads the labels' max back
    counts = (labels[:, None] == torch.arange(num_colors, device=labels.device)).sum(0)
    host = torch.cat([centers, counts[:, None].float()], dim=1).cpu().numpy()
    quantized = host[host[:, 3] > 0, :3]
    quantized = np.clip(np.round(quantized), 0, 255).astype(np.uint8)
    # each channel sorted on its own, as the JAX package does (palette.py:90)
    return np.sort(np.unique(quantized, axis=0), axis=0)


def render_palette_strip(
    palette: np.ndarray, size: Tuple[int, int], interpolate: bool = False
) -> np.ndarray:
    """Render a palette as an (H, W, 3) uint8 strip (host, for UI + quantizer).

    Matches ColourPalette._create_image (colour_palette.py:67-97): equal
    color blocks, or per-pair ``np.linspace`` gradients when interpolating;
    trailing columns beyond ``blocks * n`` stay black.
    """
    h, w = size
    n = len(palette)
    blocks = w // (n - 1 if interpolate and n > 1 else n)
    out = np.zeros((h, w, 3), dtype=np.uint8)
    if interpolate and n > 1:
        for i in range(n - 1):
            r = np.linspace(palette[i][0], palette[i + 1][0], blocks, dtype=np.uint8)
            g = np.linspace(palette[i][1], palette[i + 1][1], blocks, dtype=np.uint8)
            b = np.linspace(palette[i][2], palette[i + 1][2], blocks, dtype=np.uint8)
            out[:, i * blocks : (i + 1) * blocks] = np.stack([r, g, b], axis=-1)
    else:
        for i in range(n):
            out[:, i * blocks : (i + 1) * blocks] = palette[i]
    return out
