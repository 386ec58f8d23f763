"""The traced window's idle time put down to the program's own step phases.

The port opens ranges named ``tbist.*`` while a profiler records
(``tbist_tpu_torch/utils/logging.span``); they reach ``Trace.host_ops``
on the kineto clock of the kernels. Each card's idle intervals are those
of ``tracing.idle_gaps`` (before the window's first operation, between
the union of the card's operations, after the last), and each goes to the
innermost ``tbist.*`` range open on the host when it began: the latest
start among the ranges open then, searched over the program's ranges
alone (a host-op look-back would miss a step begun thousands of host ops
earlier). The phases partition the idle time: their sum over the steps
equals ``device_idle_share`` of the window.

A program without such ranges reads nothing: every reader returns None.
"""

from __future__ import annotations

import bisect
from typing import Dict, Optional

from portbench import tracing

PREFIX = "tbist."
PHASES = {"tbist.step.forward": "fwd", "tbist.step.backward": "bwd",
          "tbist.step.update": "update", "tbist.depth.forward": "depth_fwd",
          "tbist.depth.backward": "depth_bwd"}
OTHER = "other"  # any other range, or none


def idle_ms_per_step(trace: tracing.Trace) -> Optional[Dict[str, float]]:
    """Idle milliseconds a step in each phase (``PHASES``' values and
    ``OTHER``), the mean over the trace's cards; None without device
    operations or without the program's ranges."""
    ops = trace.ops()
    ranges = sorted((s, -e, n) for s, e, n in trace.host_ops if n.startswith(PREFIX))
    if not ops or not ranges:
        return None
    starts = [s for s, _, _ in ranges]
    lo, hi = min(s for *_, s, _ in ops), max(e for *_, e in ops)
    idle = dict.fromkeys(list(PHASES.values()) + [OTHER], 0.0)
    for d in range(trace.cards):
        mine = [(s, e) for _, c, s, e in ops if c == d]
        spans = tracing._union(mine) if mine else [(hi, hi)]
        edges = [(lo, spans[0][0])] + [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
        edges.append((spans[-1][1], hi))
        for gs, ge in edges:
            if ge > gs:
                idle[PHASES.get(_innermost(ranges, starts, gs), OTHER)] += ge - gs
    return {k: v / 1e3 / trace.cards / trace.steps for k, v in idle.items()}


def _innermost(ranges, starts, t: float) -> Optional[str]:
    """The name of the range open at ``t`` with the latest start (of two
    with one start, the shorter; ``ranges`` hold (start, -end, name))."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if -ranges[i][1] >= t:
            return ranges[i][2]
    return None


def read(ctx, phase: str) -> Optional[float]:
    """A reader's value: ``phase``'s idle ms a step in the run's trace."""
    if ctx.trace is None:
        return None
    phases = idle_ms_per_step(ctx.trace)
    return None if phases is None else phases[phase]
