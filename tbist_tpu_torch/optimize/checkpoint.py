"""Checkpoint/resume for the pixel-optimization loop, ported from
``tbist_tpu.optimize.checkpoint``.

``stylize_resumable`` runs the loop in segments and saves ``(pixels,
step)`` between segments, so a preempted job resumes from the saved
pixels. A checkpoint is the file ``<dir>/step_<N>`` written by
``torch.save`` under a temporary name and then renamed into place, so a
reader never sees half a file (the JAX package commits orbax directories of
the same names atomically). The L-BFGS curvature history restarts each
segment (bounded memory; it rebuilds within a few iterations);
``save_state`` accepts an ``opt_state`` slot for callers that want to keep
it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch

from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.utils.imageio import resolve_device
from tbist_tpu_torch.utils.logging import RunMetrics, logger


def _ckpt_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return os.path.abspath(path)


def save_state(path: str, pixels: torch.Tensor, opt_state, step: int) -> None:
    """Write ``step_<step>`` under ``path``, replacing one of that name."""
    final = os.path.join(_ckpt_dir(path), f"step_{step}")
    tmp = os.path.join(os.path.dirname(final), f".step_{step}.{os.getpid()}.tmp")
    torch.save({"pixels": pixels.detach().cpu(), "opt_state": opt_state, "step": int(step)},
               tmp)
    os.replace(tmp, final)


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(path)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None


def load_state(path: str, step: int):
    return torch.load(os.path.join(_ckpt_dir(path), f"step_{step}"), map_location="cpu",
                      weights_only=True)


def stylize_resumable(
    content: torch.Tensor,
    styles: Sequence[torch.Tensor],
    cfg: GatysConfig,
    vgg_params,
    ckpt_path: str,
    segment_steps: int = 100,
    device="cuda",
    metrics: Optional[RunMetrics] = None,
) -> Tuple[torch.Tensor, list]:
    """Gatys stylization in resumable segments.

    Each segment is one ``gatys.stylize`` run of ``segment_steps`` (the last
    one clamped so the total never passes ``cfg.num_steps``) that starts
    from the saved pixels; the content and style targets stay those of the
    original ``content`` and ``styles``. ``cfg.random_init`` counts on a
    fresh start only, drawn as an unsegmented ``stylize`` draws it. Returns
    (image, loss history of the segments run in this call). ``metrics``,
    when given, receives the step it resumed at and the segments run.
    """
    device = resolve_device(device)
    start = latest_step(ckpt_path)
    if start is not None:
        img = load_state(ckpt_path, start)["pixels"]
        logger.info("resuming optimization at step %d", start)
    else:
        start = 0
        if cfg.random_init:
            img = gatys.random_start(content.shape, cfg.seed, device)
        else:
            img = content.to(torch.float32)

    history = []
    step, segments = start, 0
    while step < cfg.num_steps:
        remaining = min(segment_steps, cfg.num_steps - step)
        seg_cfg = dataclasses.replace(cfg, num_steps=remaining, random_init=False)
        img, hist = gatys.stylize(content, styles, seg_cfg, vgg_params, init=img, device=device)
        step += remaining
        segments += 1
        history.extend(hist.cpu().tolist())
        save_state(ckpt_path, img, None, step)
        logger.info("checkpointed optimization at step %d", step)
    if metrics is not None:
        metrics.extra["resumed_at_step"] = start
        metrics.extra["segments"] = segments
    return img.to(device), history
