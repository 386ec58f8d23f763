"""Float32 precision on the card.

A float32 convolution goes through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits. The JAX reference computes in full f32, so every model of
the port that convolves or multiplies in f32 runs inside ``full_f32``.

The two flags are process-global, and a server runs ``full_f32`` regions on
several threads at once (the micro-batcher's worker beside the request
threads). So the regions share one entry count under one lock: the first
entry from any thread saves the flags and turns TF32 off, and the last exit
restores them. A thread outside every region may meanwhile see TF32 off:
that is more precision, never less.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.Lock()
_entries = 0
_saved = (True, False)


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls until the last
    open region in the process exits; restored then."""
    global _entries, _saved
    with _LOCK:
        if _entries == 0:
            _saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        _entries += 1
    try:
        yield
    finally:
        with _LOCK:
            _entries -= 1
            if _entries == 0:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = _saved
