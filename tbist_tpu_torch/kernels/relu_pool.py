"""K3: maxpool2x2(relu(pre)) with the relu and tie-splitting pool backward
fused, on the hand-written CUDA kernel of ``csrc/pool_bwd.cu``
(``FUSE_RELU`` on).

Replaces ``tbist_tpu/ops/pallas_relu_pool.py`` (``_bwd_pallas`` :75, kernel
``_bwd_kernel`` :46, custom VJP ``relu_max_pool_2x2_even`` :105-121), which
the JAX package runs at every pool under ``TBIST_PALLAS_RELU_POOL=2``. The
port's VGG trunk always takes it. A CUDA tensor goes to the kernel (or
raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import torch

from tbist_tpu_torch.kernels import _build
from tbist_tpu_torch.kernels.pool import launch_pool_bwd, pool_bwd_plain, pool_fwd


def relu_pool_bwd(pre: torch.Tensor, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient w.r.t. ``pre`` of maxpool2x2(relu(pre)): tie-split, then
    masked by pre > 0 (relu'(0) = 0, as ``jax.nn.relu``)."""
    if pre.device.type == "cpu":
        return pool_bwd_plain(pre, out, g, relu=True)
    gx = launch_pool_bwd("relu_pool_bwd", pre, out, g, fuse_relu=True)
    _build.count_launch(relu_pool_bwd)
    return gx


relu_pool_bwd.launches = 0


class ReluMaxPool2x2Even(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pre: torch.Tensor) -> torch.Tensor:
        # relu is monotone, so relu(max(window)) == max(relu(window)) exactly;
        # pooling first never materialises relu(pre).
        out = torch.clamp_min(pool_fwd(pre), 0)
        ctx.save_for_backward(pre, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        pre, out = ctx.saved_tensors
        return relu_pool_bwd(pre, out, g.contiguous())


def relu_max_pool_2x2_even(pre: torch.Tensor) -> torch.Tensor:
    """maxpool2x2(relu(pre)) for an even-H/W NHWC tensor, fused backward."""
    return ReluMaxPool2x2Even.apply(pre)
