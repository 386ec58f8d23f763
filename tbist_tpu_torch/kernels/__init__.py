"""Hand-written CUDA kernels of the port, one module per Pallas file of the
JAX package: ``gram`` (K1), ``pool`` (K2), ``relu_pool`` (K3), ``sam_attn``
(K4).

Each wrapper counts the kernel launches it makes in ``<wrapper>.launches``;
``launch_counts`` and ``reset_launch_counts`` read and zero them all, so a
run can show that its path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from tbist_tpu_torch.kernels.gram import gram_bwd, gram_fwd
from tbist_tpu_torch.kernels.pool import pool_bwd
from tbist_tpu_torch.kernels.relu_pool import relu_pool_bwd
from tbist_tpu_torch.kernels.sam_attn import attention_with_rel_bias

WRAPPERS = {
    "gram_fwd": gram_fwd,
    "gram_bwd": gram_bwd,
    "pool_bwd": pool_bwd,
    "relu_pool_bwd": relu_pool_bwd,
    "sam_attn": attention_with_rel_bias,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
