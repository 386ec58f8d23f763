"""The traced slice of a run: ``torch.profiler`` (CPU and CUDA activity,
CUPTI's kernel records) over a fixed run of whole steps, and its reduction
to device operations, busy time and idle gaps.

The busy arithmetic (the union of each card's operation spans, over a
window from the slice's first operation to its last on any card) is that
of the port's ``utils/prof.py`` (``_busy``, ``busy_by_device``), copied so
that the yardstick does not move with the program. Nothing is written to
disk.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

Span = Tuple[str, int, float, float]  # name, card, start us, end us


@dataclasses.dataclass
class Trace:
    """One traced slice: ``kernels`` and ``copies`` (memcpy and memset) as
    spans on the cards, the host's CPU operations as (start, end, name),
    the device microseconds of the kernels launched under each of the
    benchmark's own ranges (``portbench.*``), and the steps and cards."""

    kernels: List[Span]
    copies: List[Span]
    host_ops: List[Tuple[float, float, str]]
    ranges_us: Dict[str, float]
    steps: int
    cards: int

    def ops(self) -> List[Span]:
        return self.kernels + self.copies

    def device_us(self, names: Tuple[str, ...], exclude: Tuple[str, ...] = ()) -> float:
        """Summed time of the kernels whose name holds one of ``names`` and
        none of ``exclude``."""
        return sum(e - s for n, _, s, e in self.kernels
                   if any(k in n for k in names) and not any(x in n for x in exclude))


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    spans = sorted(spans)
    out = [list(spans[0])]
    for s, e in spans[1:]:
        if s > out[-1][1]:
            out.append([s, e])
        else:
            out[-1][1] = max(out[-1][1], e)
    return [(s, e) for s, e in out]


def busy(trace: Trace) -> Dict:
    """Each card's busy microseconds (the union of its operations), the
    common window from the first operation to the last on any card, and
    the mean busy time over the cards (a card with no operation is busy 0)."""
    ops = trace.ops()
    if not ops:
        return {"window_us": 0.0, "per_card_us": {}, "mean_busy_us": 0.0}
    window = max(e for *_, e in ops) - min(s for *_, s, _ in ops)
    per = {}
    for d in range(trace.cards):
        mine = [(s, e) for _, c, s, e in ops if c == d]
        per[d] = sum(e - s for s, e in _union(mine)) if mine else 0.0
    return {"window_us": window, "per_card_us": per,
            "mean_busy_us": sum(per.values()) / trace.cards}


def idle_gaps(trace: Trace) -> List[Tuple[str, float]]:
    """Idle microseconds of each card inside the window, by what the host
    was doing when the gap began (its innermost CPU operation then)."""
    ops = trace.ops()
    if not ops:
        return []
    lo, hi = min(s for *_, s, _ in ops), max(e for *_, e in ops)
    host = sorted(trace.host_ops)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for d in range(trace.cards):
        spans = _union([(s, e) for _, c, s, e in ops if c == d]) or [(hi, hi)]
        edges = [(lo, spans[0][0])] + [(a[1], b[0]) for a, b in zip(spans, spans[1:])]
        edges.append((spans[-1][1], hi))
        for gs, ge in edges:
            if ge <= gs:
                continue
            label = "nothing traced"
            i = bisect.bisect_right(starts, gs) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if host[j][1] >= gs:
                    label = host[j][2]
                    break
            key = f"card {d}: {label}"
            out[key] = out.get(key, 0.0) + (ge - gs)
    return sorted(out.items(), key=lambda kv: -kv[1])


def top_ops(trace: Trace, n: int = 10) -> List[Tuple[str, float]]:
    by: Dict[str, float] = {}
    for name, _, s, e in trace.ops():
        by[name[:120]] = by.get(name[:120], 0.0) + (e - s)
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


class Slice:
    """The profiler over the traced steps, started and stopped by the
    reading point in the loop; every card is synchronised first, so the
    slice holds the work those steps launched and nothing before them."""

    def __init__(self, cards: int):
        self.cards = cards
        self.prof: Optional[torch.profiler.profile] = None
        self.done = False

    @staticmethod
    def warm() -> None:
        """Initialise the profiler and CUPTI once, in set-up."""
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def _sync(self) -> None:
        if torch.cuda.is_available():
            for d in range(self.cards):
                torch.cuda.synchronize(d)

    def toggle(self, start: bool) -> None:
        self._sync()
        if start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        else:
            self.prof.stop()
            self.done = True

    def reduce(self, steps: int) -> Optional[Trace]:
        if not self.done:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        kernels, copies, host, ranges = [], [], [], {}
        for e in self.prof.events():
            if e.device_type == cuda:
                if e.name.startswith("portbench.") or getattr(e, "is_user_annotation", False):
                    continue  # a range's mirror on the device timeline, not an operation
                span = (e.name, int(e.device_index), float(e.time_range.start),
                        float(e.time_range.end))
                (copies if e.name.startswith(("Memcpy", "Memset")) else kernels).append(span)
                continue
            if e.name.startswith("portbench."):
                total = getattr(e, "device_time_total", None)
                if total is None:
                    total = e.cuda_time_total
                ranges[e.name] = ranges.get(e.name, 0.0) + float(total)
            if not e.name.startswith("cuda"):
                host.append((float(e.time_range.start), float(e.time_range.end), e.name))
        return Trace(kernels, copies, host, ranges, steps, self.cards)
