"""Structured logging & observability (after ``tbist_tpu.utils.logging``).

Every effect returns timing/loss metadata and logs through the stdlib logger.
``span`` marks the program's phases in the trace of a running
``torch.profiler``, on the profiler's clock beside the kernels; with no
profiler recording a span costs one flag check.
"""

from __future__ import annotations

import contextlib
import logging
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.autograd import profiler as _profiler

logger = logging.getLogger("tbist_tpu_torch")
logger.propagate = False  # avoid double lines when the root logger has handlers
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(
        logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


@dataclass
class RunMetrics:
    """Per-run metrics returned alongside effect outputs."""

    timings_s: Dict[str, float] = field(default_factory=dict)
    loss_history: List[float] = field(default_factory=list)
    extra: Dict[str, float] = field(default_factory=dict)
    # Degradation tags (e.g. "vgg_seeded", "mask_fallback") for components
    # this run used that resolved to fallbacks — see utils.degraded.
    degraded: List[str] = field(default_factory=list)


SPAN_PREFIX = "tbist."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A range ``tbist.<name>`` in the running profiler's trace, or one
    shared no-op context manager when no profiler records. The profiler is
    the recorder (``export_chrome_trace`` the exporter); the flag is checked
    first because ``record_function`` costs microseconds even with no
    profiler."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def backward_span(name: str, output: torch.Tensor, inp: torch.Tensor) -> None:
    """``span(name)`` over a backward pass through a function: opened by a
    hook on ``output``'s gradient, closed by a hook on ``inp``'s, both on
    the autograd thread. Registered only while a profiler records and
    ``output`` has a graph."""
    if not _profiler._is_profiler_enabled or not output.requires_grad:
        return
    opened = []

    def start(_grad):
        opened.append(torch.profiler.record_function(SPAN_PREFIX + name).__enter__())

    def end(_grad):
        if opened:
            opened.pop().__exit__(None, None, None)

    output.register_hook(start)
    inp.register_hook(end)
