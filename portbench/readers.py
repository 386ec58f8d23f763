"""Arithmetic that several metric readers share. Each reader in
``metrics/`` is one small file, found by its metric's name, that calls
these with its own kernel-name patterns and its own count of work, and
returns None where it finds nothing to read (the harness then leaves the
metric out of the line).

``ctx`` is the run's context (``run.py``): ``setup_s``, ``window_s``,
``records`` (one a window request: wall seconds, the program's own timing,
whether it was traced), ``completed``, ``cards``, ``config``, ``params``,
``peaks`` and, in a traced run, ``trace`` (``tracing.Trace``).
"""

from __future__ import annotations

from typing import Optional, Sequence

from portbench import tracing
from portbench.work import flops


def image_s(ctx) -> Optional[float]:
    """Window seconds over the images completed in it."""
    return ctx.window_s / ctx.completed if ctx.completed else None


def steady(ctx):
    """Window requests that completed and were not profiled."""
    return [r for r in ctx.records if r["error"] is None and r["out"] is not None
            and not r["traced"] and r["timings"].get("program_s")]


def launches_per_step(ctx) -> Optional[float]:
    """Kernels in the traced slice, a step and a card."""
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.steps / t.cards


def idle_share(ctx) -> Optional[float]:
    """Percent of the traced window with no operation on a card, the mean
    over the cell's cards."""
    t = ctx.trace
    if t is None:
        return None
    b = tracing.busy(t)
    if not b["window_us"]:
        return None
    return 100.0 * (1.0 - b["mean_busy_us"] / b["window_us"])


def step_mfu(ctx) -> Optional[float]:
    """Percent of the f32 peak of every card in the cell that one step's
    model FLOPs take at the step time of the unprofiled requests (the
    program's own span of its optimisation, over its steps)."""
    rows = steady(ctx)
    if not rows:
        return None
    side = ctx.params["side"]
    step_s = sum(r["timings"]["program_s"] for r in rows) / (len(rows) * ctx.params["steps"])
    return 100.0 * flops.step_flops(ctx.config, side, side) / step_s / (
        ctx.peaks["float32"] * ctx.cards)


def roofline(ctx, names: Sequence[str], bound_s_per_step: float,
             exclude: Sequence[str] = ()) -> Optional[float]:
    """Percent: the least time of the traced steps' work over the traced
    time of the kernels whose name holds one of ``names``."""
    t = ctx.trace
    if t is None:
        return None
    us = t.device_us(tuple(names), tuple(exclude))
    if us <= 0:
        return None
    return 100.0 * bound_s_per_step * t.steps / (us / 1e6)


def kernel_roofline(ctx, kind: str, names: Sequence[str]) -> Optional[float]:
    """``roofline`` of K1 forward, K1 backward or K3 (``flops.kernel_bound_s``)."""
    side, p = ctx.params["side"], ctx.peaks
    return roofline(ctx, names, flops.kernel_bound_s(kind, side, side, p["float32"], p["bytes"]))
