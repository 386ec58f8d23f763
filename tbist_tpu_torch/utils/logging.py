"""Structured logging & observability (a copy of ``tbist_tpu.utils.logging``).

Every effect returns timing/loss metadata and logs through the stdlib logger.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List

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


@contextmanager
def timed(metrics: RunMetrics, name: str):
    """Wall-clock bracket; callers must synchronize first for device work."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        metrics.timings_s[name] = metrics.timings_s.get(name, 0.0) + (
            time.perf_counter() - t0
        )
