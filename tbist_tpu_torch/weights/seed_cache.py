"""Disk cache for seeded weight draws (counterpart of
``tbist_tpu.weights.seed_cache``).

Without checkpoints a model falls back to weights drawn from a seeded
``torch.Generator``. The draw is deterministic, so its tensors can be kept:
the first process writes them to ``weights_cache/torch/<name>.pt`` and later
processes load them from disk, as the reference loads its ``.pth`` files at
start-up (README.md:28-46).

The caller states the draw's structure, each tensor's name, shape and
dtype, in ``spec`` (the counterpart of the JAX package's ``jax.eval_shape``:
tracing ``init_fn`` under ``FakeTensorMode`` would take seconds on its first
use, about as long as a draw). A file whose tensors do not match the spec
(the model definition changed) is ignored and rebuilt. Tensors come back
with the strides they were drawn with (``torch.save`` keeps them). Writes
are atomic, so concurrent first starts never read a torn file.
``TBIST_SEED_CACHE=0`` disables the cache: every process draws anew.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache", "torch",
)


Spec = Tuple[Sequence[int], torch.dtype]  # a leaf of ``spec``: (shape, dtype)


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, tuple))


def _flatten(tree, prefix: str = "") -> dict:
    if _is_leaf(tree):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unflatten(flat: Dict[str, torch.Tensor], like, prefix: str = ""):
    if _is_leaf(like):
        return flat[prefix]
    return {k: _unflatten(flat, v, f"{prefix}.{k}" if prefix else str(k))
            for k, v in like.items()}


def _matches(flat: Dict[str, torch.Tensor], expected: Dict[str, Spec]) -> bool:
    return set(flat) == set(expected) and all(
        isinstance(t, torch.Tensor) and tuple(t.shape) == tuple(expected[n][0])
        and t.dtype == expected[n][1] for n, t in flat.items())


def _load(path: str, expected: Dict[str, Spec]) -> Optional[Dict[str, torch.Tensor]]:
    """The file's tensors, or None where the file is unreadable or does not
    match ``expected`` by name, shape and dtype."""
    try:
        data = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return None
    return data if isinstance(data, dict) and _matches(data, expected) else None


def _save(path: str, flat: Dict[str, torch.Tensor]) -> None:
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".pt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save({k: t.detach().cpu() for k, t in flat.items()}, f)
            os.replace(tmp, path)
        except BaseException:
            os.unlink(tmp)
            raise
    except OSError:
        pass  # a read-only checkout: the cache is best-effort


def cached_seeded_init(name: str, init_fn: Callable[[], dict], spec: dict) -> dict:
    """Return ``init_fn()``'s CPU dict of tensors (nested dicts allowed),
    from ``weights_cache/torch/<name>.pt`` when it holds a draw that matches
    ``spec``, else drawn and written there. ``spec`` mirrors the dict with
    ``(shape, dtype)`` leaves. ``name`` must identify the model family AND
    the seed (e.g. ``"vgg19_seeded_s0"``)."""
    if os.environ.get("TBIST_SEED_CACHE", "1") == "0":
        return init_fn()
    expected = _flatten(spec)
    path = os.path.join(_CACHE_DIR, f"{name}.pt")
    flat = _load(path, expected) if os.path.exists(path) else None
    if flat is not None:
        return _unflatten(flat, spec)
    params = init_fn()
    drawn = _flatten(params)
    if not _matches(drawn, expected):
        raise ValueError(f"seed cache {name!r}: the draw does not match its spec")
    _save(path, drawn)
    return params
