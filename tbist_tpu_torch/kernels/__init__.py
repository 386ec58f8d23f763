"""Hand-written CUDA kernels of the port, one module per Pallas file of the
JAX package: ``gram`` (K1), ``pool`` (K2), ``relu_pool`` (K3), ``sam_attn``
(K4).

Each wrapper counts the kernel launches it makes in ``<wrapper>.launches``;
``launch_counts`` and ``reset_launch_counts`` read and zero them all, so a
run can show that its path went through the kernels. Those are the host's
launches: a replayed CUDA graph runs its kernels without a call of their
wrappers, so what the card ran is read from a device trace's kernel names
(``traced_counts``).
"""

from __future__ import annotations

from typing import Dict, Iterable

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


def traced_counts(kernel_names: Iterable[str]) -> Dict[str, int]:
    """K1's, K2's and K3's kernels among a device trace's ``kernel_names``,
    by the wrapper names of ``launch_counts``: one ``gram_fwd_kernel`` (its
    split-K reduction is another kernel) and one ``gram_bwd_kernel`` per
    call, and one ``pool_bwd_kernel`` per call of K2 or K3, which runs it
    with ``FUSE_RELU``, its last template argument, true."""
    counts = {"gram_fwd": 0, "gram_bwd": 0, "pool_bwd": 0, "relu_pool_bwd": 0}
    for name in kernel_names:
        if "gram_fwd_kernel" in name:
            counts["gram_fwd"] += 1
        elif "gram_bwd_kernel" in name:
            counts["gram_bwd"] += 1
        elif "pool_bwd_kernel" in name:  # demangled "..., true>", mangled "...Lb1E"
            fused = "true>" in name or "Lb1E" in name
            counts["relu_pool_bwd" if fused else "pool_bwd"] += 1
    return counts
