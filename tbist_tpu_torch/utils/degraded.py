"""Degraded-mode registry: which components resolved to fallbacks.

A copy of ``tbist_tpu.utils.degraded``. Every loader that falls back to
seeded weights calls :func:`mark`; the pipeline then attaches the flags of
the components a request actually used to ``RunMetrics.degraded``, which
the API returns and the CLI logs — so callers always know when an output
did not come from real pretrained weights.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set

# component key (ModelRegistry field name) -> degradation tags
_FLAGS: Dict[str, Set[str]] = {}


def mark(component: str, tag: str) -> None:
    """Record that ``component`` resolved to a degraded implementation."""
    _FLAGS.setdefault(component, set()).add(tag)


def flags_for(components: Iterable[str]) -> List[str]:
    """Sorted degradation tags for the components a run actually used."""
    out: Set[str] = set()
    for c in components:
        out |= _FLAGS.get(c, set())
    return sorted(out)


def all_flags() -> List[str]:
    return sorted(set().union(*_FLAGS.values())) if _FLAGS else []


def reset() -> None:
    """Testing hook; loaders are lru-cached so marks normally persist."""
    _FLAGS.clear()
