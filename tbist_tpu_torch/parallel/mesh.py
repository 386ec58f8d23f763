"""Device mesh and sharding, ported from ``tbist_tpu.parallel.mesh``.

A 2-D ``(dp, sp)`` layout of the visible cards, driven by one process:

* ``dp`` (data parallel) splits the lanes of a batch (video frames, MIP's
  depth layers, a burst of text-style requests) over the cards; each card
  runs its own lanes with its own replica of the weights;
* ``sp`` (spatial parallel) cuts one image's width into shards, one a card;
  a 3×3 (or k×k) convolution first takes the neighbours' edge columns
  (``halo``), so each card convolves its own columns, and the reductions
  that span the image (Gram matrices, content and instance-norm
  statistics) are summed on the first card in shard order.

The JAX package gets both from XLA's GSPMD; here they are written out. The
mesh is a list of ``torch.device``s: shards move between cards with peer
copies, one autograd graph spans the cards, and the backward engine runs a
thread per card. A mesh may repeat a device (tests lay 8 ``cpu`` entries
out, the one-card smoke 4 × ``cuda:0``); the decomposition is the same.
Production builds a mesh only over two or more cards (``production_mesh``).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from tbist_tpu_torch.utils.imageio import tree_to

DP_AXIS = "dp"
SP_AXIS = "sp"

# the columns an sp shard is cut in, by model: VGG-19 pools four times
# before conv5_1, so a shard edge on a multiple of 16 stays on a column edge
# at every level; Ghiasi's two stride-2 convolutions need a multiple of 4
VGG_ALIGN = 16
GHIASI_ALIGN = 4
# a Ghiasi shard holds at least two blocks: its 9×9 convolutions reflect
# four columns at the image's edges, and its 3×3 ones one column at a
# quarter of the width
GHIASI_MIN_WIDTH = 8

Plan = Tuple[Tuple[int, int], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices[r][c]``: the card of dp row ``r`` and sp column ``c``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {DP_AXIS: len(self.devices), SP_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (dp, sp) with sp as large a power-of-two factor ≤ 4."""
    for sp in (4, 2, 1):
        if n % sp == 0:
            return n // sp, sp
    return n, 1


def make_mesh(devices: Sequence, dp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """A (dp, sp) mesh over ``devices`` (row-major), ``_factor``'s layout
    unless both axes are given."""
    devices = [torch.device(d) for d in devices]
    if dp is None or sp is None:
        dp, sp = _factor(len(devices))
    if dp * sp != len(devices):
        raise ValueError(f"a {dp}x{sp} mesh does not fit {len(devices)} devices")
    return Mesh(tuple(tuple(devices[r * sp:(r + 1) * sp]) for r in range(dp)))


def production_mesh(device="cuda", dp_only: bool = False,
                    sp_only: bool = False) -> Optional[Mesh]:
    """The mesh the product runs on: every visible card (``CUDA_VISIBLE_DEVICES``
    limits them), ``device``'s first, or None where there is nothing to
    shard over: a CPU caller, fewer than two cards, or
    ``TBIST_DISABLE_MESH=1``.

    ``dp_only`` lays every card on dp (the video lanes, the fast-text batch
    and MIP's layers: lanes are independent, so dp adds no traffic between
    cards); ``sp_only`` every card on sp (one image's width)."""
    if os.environ.get("TBIST_DISABLE_MESH") == "1":
        return None
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    first = device.index if device.index is not None else torch.cuda.current_device()
    cards = [torch.device("cuda", (first + i) % n) for i in range(n)]
    if dp_only:
        return make_mesh(cards, dp=n, sp=1)
    if sp_only:
        return make_mesh(cards, dp=1, sp=n)
    return make_mesh(cards)


def pad_to_multiple(x: torch.Tensor, m: int) -> Tuple[torch.Tensor, int]:
    """Pad a (B, ...) tensor's batch to a multiple of m by repeating the last
    row. Returns (padded, pad_count); callers slice the pad back off."""
    pad = (-x.shape[0]) % m
    if pad:
        x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
    return x, pad


def split_lanes(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of each non-empty part of n lanes cut into ``parts``
    as evenly as whole lanes allow (the first parts take one more)."""
    q, r = divmod(n, parts)
    edges = [0]
    for i in range(parts):
        edges.append(edges[-1] + q + (i < r))
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def width_plan(w: int, parts: int, align: int, min_width: int = 0) -> Plan:
    """[start, stop) columns of each sp shard of a width-``w`` image.

    Inner edges fall on multiples of ``align``, and the shards are as even as
    whole blocks of ``align`` columns allow (the first ones take one block
    more); the columns past the last whole block go to the last shard. Where
    there are fewer blocks (of at least ``min_width`` columns a shard) than
    ``parts``, the plan has fewer shards."""
    blocks = w // align
    per = max(1, -(-min_width // align))
    n = max(1, min(parts, blocks // per))
    q, r = divmod(blocks, n)
    edges = [0]
    for i in range(n):
        edges.append(edges[-1] + (q + (i < r)) * align)
    edges[-1] = w
    return tuple(zip(edges[:-1], edges[1:]))


@dataclasses.dataclass(frozen=True)
class WidthSharding:
    """One image's width cut by ``plan``, shard ``i`` on ``devices[i]``."""

    plan: Plan
    devices: Tuple[torch.device, ...]

    def scatter(self, x: torch.Tensor, dim: int) -> List[torch.Tensor]:
        return scatter_width(x, self.plan, self.devices, dim)


def width_sharding(w: int, devices: Sequence[torch.device], align: int,
                   min_width: int = 0) -> Optional[WidthSharding]:
    """``width_plan`` over ``devices`` (the first ``len(plan)`` of them), or
    None where the plan has one shard."""
    plan = width_plan(w, len(devices), align, min_width)
    if len(plan) < 2:
        return None
    return WidthSharding(plan, tuple(devices[:len(plan)]))


def scatter_width(x: torch.Tensor, plan: Plan, devices: Sequence[torch.device],
                  dim: int) -> List[torch.Tensor]:
    """Shard ``i`` of ``x``'s ``dim`` axis onto ``devices[i]`` (a view where
    it already lies there). Differentiable."""
    return [x.narrow(dim, a, b - a).to(d, non_blocking=True)
            for (a, b), d in zip(plan, devices)]


def gather_width(shards: Sequence[torch.Tensor], device, dim: int) -> torch.Tensor:
    """The shards joined along ``dim`` on ``device``, in shard order."""
    return torch.cat([s.to(device, non_blocking=True) for s in shards], dim)


def sum_on(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The tensors summed on ``device`` in their order (shard order, so the
    result does not depend on which card finished first)."""
    total = tensors[0].to(device, non_blocking=True)
    for t in tensors[1:]:
        total = total + t.to(device, non_blocking=True)
    return total


def halo(shards: Sequence[torch.Tensor], k: int, dim: int,
         edge: str = "zeros") -> List[torch.Tensor]:
    """Each shard with ``k`` columns of ``dim`` added on either side: its
    neighbours' edge columns, copied to its device, and at the image's own
    edges zeros (``edge="zeros"``, a zero-padded convolution) or the
    reflection of its own columns (``"reflect"``, as ``F.pad`` reflects).
    Differentiable: a neighbour's columns send their gradient back to it.
    Builds new tensors and writes into none, so a mesh that repeats a
    device is safe."""
    if k == 0:
        return list(shards)
    out = []
    last = len(shards) - 1
    for i, s in enumerate(shards):
        w = s.shape[dim]
        if i > 0:
            prev = shards[i - 1]
            left = prev.narrow(dim, prev.shape[dim] - k, k).to(s.device, non_blocking=True)
        elif edge == "reflect":
            left = s.narrow(dim, 1, k).flip(dim)
        else:
            left = s.new_zeros(s.shape[:dim] + (k,) + s.shape[dim + 1:])
        if i < last:
            right = shards[i + 1].narrow(dim, 0, k).to(s.device, non_blocking=True)
        elif edge == "reflect":
            right = s.narrow(dim, w - 1 - k, k).flip(dim)
        else:
            right = s.new_zeros(s.shape[:dim] + (k,) + s.shape[dim + 1:])
        out.append(torch.cat([left, s, right], dim))
    return out


def tree_device(tree) -> Optional[torch.device]:
    """The device of a parameter tree's first tensor (None without one)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    values = tree.values() if isinstance(tree, dict) else tree
    for v in values if isinstance(tree, (dict, list, tuple)) else ():
        d = tree_device(v)
        if d is not None:
            return d
    return None


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Replicas:
    """A parameter tree and its copies on other devices: ``on(device)``
    copies the tree there the first time and keeps the copy (one replica of
    the model a card)."""

    def __init__(self, params):
        home = tree_device(params)
        self.home = None if home is None else _indexed(home)
        self._replicas = {self.home: params}
        self._lock = threading.Lock()

    def on(self, device):
        device = _indexed(device)
        with self._lock:
            if device not in self._replicas:
                self._replicas[device] = tree_to(self._replicas[self.home], device)
            return self._replicas[device]


# the trees ``replicas_of`` has seen, latest last: (tree, its Replicas)
_REPLICAS: "collections.OrderedDict[int, Tuple[object, Replicas]]" = collections.OrderedDict()
_REPLICAS_LOCK = threading.Lock()
_REPLICAS_KEPT = 8  # more trees than a process serves (VGG-19, Ghiasi, CLIP-MLP)


def replicas_of(params) -> Replicas:
    """The ``Replicas`` of a parameter tree, the same object each time the
    same tree is given, so that every caller shares one copy of a model a
    card; a ``Replicas`` is returned as it is. The last ``_REPLICAS_KEPT``
    trees are kept."""
    if isinstance(params, Replicas):
        return params
    with _REPLICAS_LOCK:
        held = _REPLICAS.get(id(params))
        if held is None or held[0] is not params:
            held = (params, Replicas(params))
            _REPLICAS[id(params)] = held
            while len(_REPLICAS) > _REPLICAS_KEPT:
                _REPLICAS.popitem(last=False)
        _REPLICAS.move_to_end(id(params))
        return held[1]


class Replicated(Replicas):
    """``fn(params, x, ...)`` called on an input ``x`` on any device, with
    the replica of the parameters on ``x``'s device. A host input runs
    where the parameters were given."""

    def __init__(self, fn: Callable, params):
        super().__init__(params)
        self.fn = fn

    def __call__(self, x, *args, **kwargs):
        device = x.device if isinstance(x, torch.Tensor) else self.home
        return self.fn(self.on(device), x, *args, **kwargs)


def on_devices(fn: Callable[[int, torch.device], object],
               devices: Sequence[torch.device]) -> list:
    """``fn(i, devices[i])`` for every i, each on a thread of its own with
    its device current, so that a card's host work (its launches, its waits
    on its own results) does not wait for another's. Results in order; the
    first exception raises."""
    def call(i, d):
        if d.type != "cuda":
            return fn(i, d)
        with torch.cuda.device(d):
            return fn(i, d)

    if len(devices) == 1:
        return [call(0, devices[0])]
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(call, i, d) for i, d in enumerate(devices)]
        return [f.result() for f in futures]
