"""Depth-aware Gatys optimization, ported from ``tbist_tpu.optimize.gatys_depth``.

The reference's depth loss has no gradient: it renders the image to PIL and
re-runs the HF depth pipeline inside each closure (Style_a3.py:142-146).
Here, as in the JAX package, the depth estimator is a differentiable
function kept in the graph: the loss is Gatys's plus
``w_depth · MSE(normalize(depth(x)), normalize(depth(content)))``, the
target computed once without a graph. The loop is ``gatys.stylize``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.utils.logging import RunMetrics


def stylize_with_depth(
    content: torch.Tensor,
    style: torch.Tensor,
    cfg: GatysConfig,
    depth_fn: Callable[[torch.Tensor], torch.Tensor],
    vgg_params,
    metrics: Optional[RunMetrics] = None,
    device="cuda",
) -> torch.Tensor:
    """Gatys toward ``style`` with the depth term weighted by ``cfg.w_depth``.
    Returns the (1, H, W, 3) image on ``device``; ``metrics`` receives the
    loss history.

    As in the JAX package's ``_stylize_depth_jit`` the loop is L-BFGS from
    the content image with one style and no channel attention, whatever
    ``cfg`` says of those."""
    cfg = dataclasses.replace(cfg, optimizer="lbfgs", random_init=False,
                              channel_attention=False)
    out, hist = gatys.stylize(content, [style], cfg, vgg_params, device=device,
                              depth_fn=depth_fn)
    if metrics is not None:
        metrics.loss_history = hist.tolist()
    return out
