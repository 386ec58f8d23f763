"""Published peaks of the card, and its name and power limit as
``nvidia-smi`` reads them.

NVIDIA's H100 data sheet (dense rates, no sparsity) states the peaks at the
full power limit: 700 W for the SXM part, 350 W for the PCIe card. A card
set below its limit runs slower under load, so every share of a peak is
printed beside the limit read here.
"""

from __future__ import annotations

import subprocess
from typing import Dict

# name substring -> peaks; the first match wins
_PEAKS = (
    ("H100 PCIe", {"float32": 51e12, "tf32": 378e12, "bfloat16": 756e12, "bytes": 2.0e12,
                   "rated_w": 350.0}),
    ("H100", {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "bytes": 3.35e12,
              "rated_w": 700.0}),
)


def peaks_for(card_name: str) -> Dict[str, float]:
    """The published peaks of the card named ``card_name`` (an H100 SXM's
    where the name says nothing more)."""
    for key, peaks in _PEAKS:
        if key in card_name:
            return dict(peaks)
    return dict(_PEAKS[-1][1])


def smi() -> str:
    """``name, power.limit`` of each visible card, one line a card; empty
    where ``nvidia-smi`` is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip()
