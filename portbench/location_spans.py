"""The traced window's idle time put down to the location chain's phases.

The port opens the ranges ``tbist.location.dino``, ``.sam_encode``,
``.collect`` and ``.sam_decode`` around the four phases of a text -> mask
request (``tbist_tpu_torch/models/dino_sam.extract_mask``) while a
profiler records. Each card's idle intervals (before the window's first
operation, between the union of its operations, after the last) go to the
innermost of these ranges open on the host when the interval began
(``program_spans._innermost``), and to ``other`` where none was: the
request's front, the pipeline's stages around the mask, the read-back of
the image. The phases partition the idle time: their sum over the
requests is ``device_idle_share`` of the window.

A program without these ranges reads nothing: every reader returns None.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench import program_spans, tracing

PREFIX = "tbist.location."
PHASES = {"tbist.location.dino": "dino", "tbist.location.sam_encode": "sam",
          "tbist.location.collect": "collect", "tbist.location.sam_decode": "sam"}
OTHER = "other"


def idle_ms_per_request(trace: tracing.Trace) -> Optional[Dict[str, float]]:
    """Idle milliseconds a request in each phase (``dino``, ``sam``: the
    encoder and the decoder, ``collect``, ``other``), the mean over the
    trace's cards; None without device operations or without the
    location ranges."""
    ops = trace.ops()
    ranges = sorted((s, -e, n) for s, e, n in trace.host_ops if n.startswith(PREFIX))
    if not ops or not ranges:
        return None
    starts = [s for s, _, _ in ranges]
    lo, hi = min(s for *_, s, _ in ops), max(e for *_, e in ops)
    idle = dict.fromkeys(("dino", "sam", "collect", OTHER), 0.0)
    for d in range(trace.cards):
        mine = [(s, e) for _, c, s, e in ops if c == d]
        spans = tracing._union(mine) if mine else [(hi, hi)]
        edges = [(lo, spans[0][0])] + [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
        edges.append((spans[-1][1], hi))
        for gs, ge in edges:
            if ge > gs:
                phase = program_spans._innermost(ranges, starts, gs)
                idle[PHASES.get(phase, OTHER)] += ge - gs
    return {k: v / 1e3 / trace.cards / trace.steps for k, v in idle.items()}


def read(ctx, phase: str) -> Optional[float]:
    """A reader's value: ``phase``'s idle ms a request in the run's trace."""
    if ctx.trace is None:
        return None
    phases = idle_ms_per_request(ctx.trace)
    return None if phases is None else phases[phase]
