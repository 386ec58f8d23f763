"""Reading points in the port's optimisation loop.

The benchmark wraps two of the port's functions for the length of a run,
and calls through to them unchanged. These reading points are part of the
yardstick: a change to the program that stops calling them through their
modules (a local binding, a fused or captured step) has to keep them, or
bring a benchmark change that reads the same state another way. A request
in which they were not reached as often as the request has steps ends the
run without a result (``problems``).

- ``optimize.lbfgs.update(grad, state, lr)``, called once a step with the
  step's gradient and the optimizer's state (on one card in
  ``optimize.gatys.stylize``; one lane per call in
  ``parallel.batched.lbfgs_lanes`` on a mesh). It counts the request's
  steps; keeps the update of each of the first ``check_steps`` + 1 steps
  and the gradient of the last of them; keeps the last step's gradient,
  update and the state the last update started from; and starts and
  stops the profiler around the traced steps.
- ``optimize.gatys.lane_losses`` and ``lane_losses_sharded``, called once
  a step with the clamped image the step differentiates. It counts the
  calls and keeps the last image.

What it keeps is the program's own output, for the check after the window
(``check.py``). Each tensor is copied to pinned host memory on the
program's stream as it is kept (``_keep``): the copy runs on the card in
the stream's order, before any later write to the tensor (``update``
writes its history in place), while the program goes on; so the window
holds no copy of its own between requests, and the card holds no more
than the program does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch

STATE_FIELDS = ("s_hist", "y_hist", "rho", "gamma", "prev_grad", "prev_step_vec")


class Reader:
    """What the wrapped functions keep, for the request under way."""

    def __init__(self, steps: int, trace_steps: Optional[tuple] = None,
                 on_trace: Optional[Callable[[bool], None]] = None, check_steps: int = 0):
        self.steps = steps  # steps of a window request
        self.check_steps = check_steps  # updates 0..check_steps are kept
        self.trace_steps = trace_steps  # (first, end) update calls to profile
        self.on_trace = on_trace  # called with True to start, False to stop
        self.capturing = False
        self.trace_pending = False
        self.captured: Dict = {}
        self.updates = self.loss_calls = 0

    def start_request(self, capture: bool, trace: bool = False) -> None:
        self.capturing, self.trace_pending = capture, trace
        self.captured, self.updates, self.loss_calls = {"steps_u": []}, 0, 0

    def finish_request(self) -> Dict:
        """The request's captures, moved to the host, with ``steps`` and
        ``problems``: what the reading points missed."""
        self.capturing = False
        out = {k: _to_host(v) for k, v in self.captured.items()}
        out["steps"] = self.updates
        out["problems"] = self.problems(out)
        self.captured = {}
        return out

    def problems(self, cap: Dict) -> List[str]:
        """Why ``cap`` cannot be checked: the reading points were bypassed."""
        out = []
        if self.updates != self.steps:
            out.append(f"optimize.lbfgs.update reached {self.updates} times "
                       f"in a request of {self.steps} steps")
        if self.loss_calls != self.steps:
            out.append(f"optimize.gatys.lane_losses(_sharded) reached {self.loss_calls} "
                       f"times in a request of {self.steps} steps")
        want = {"grad0", "gradk", "x_last", "grad_last", "step_last", "state_last"}
        missing = sorted(want - set(cap))
        if missing:
            out.append(f"no capture of {missing}")
        if len(cap.get("steps_u", [])) != self.check_steps + 1:
            out.append(f"{len(cap.get('steps_u', []))} of the first "
                       f"{self.check_steps + 1} updates captured")
        return out

    def _update(self, real, grad, state, lr=1.0):
        k = state.step
        self.updates += 1
        if self.trace_pending and self.trace_steps is not None:
            if k == self.trace_steps[0]:
                self.on_trace(True)
            elif k == self.trace_steps[1]:
                self.on_trace(False)
                self.trace_pending = False
        if not self.capturing:
            return real(grad, state, lr=lr)
        last = k == self.steps - 1
        if k == 0:
            self.captured["grad0"] = _keep(grad)
        if k == self.check_steps:
            self.captured["gradk"] = _keep(grad)
        if last:
            self.captured["grad_last"] = _keep(grad)
            self.captured["state_last"] = dict(
                {f: _keep(getattr(state, f)) for f in STATE_FIELDS}, step=k)
        step, new_state = real(grad, state, lr=lr)
        if k <= self.check_steps:
            self.captured["steps_u"].append(_keep(step))
        if last:
            self.captured["step_last"] = _keep(step)
        return step, new_state

    def _losses(self, real, cfg, params, imgs, *args, **kwargs):
        self.loss_calls += 1
        if self.capturing and self.loss_calls == self.steps:
            self.captured["x_last"] = _keep(imgs)
        return real(cfg, params, imgs, *args, **kwargs)


def _keep(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it stands now in the stream's order: a copy in pinned host
    memory for a card's tensor, valid once the stream has passed it (the
    request's image read-back syncs it); a CPU tensor's own copy."""
    t = t.detach()
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.device(t.device):
        host.copy_(t, non_blocking=True)
    return host


def _to_host(v):
    if isinstance(v, torch.Tensor):
        return v.to("cpu")
    if isinstance(v, dict):
        return {k: _to_host(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_to_host(x) for x in v]
    return v


@contextlib.contextmanager
def installed(reader: Reader):
    """Wrap the port's reading points for the block."""
    from tbist_tpu_torch.optimize import gatys, lbfgs

    saved = [(lbfgs, "update", lbfgs.update), (gatys, "lane_losses", gatys.lane_losses),
             (gatys, "lane_losses_sharded", gatys.lane_losses_sharded)]
    upd, one, sharded = (s[2] for s in saved)
    lbfgs.update = lambda grad, state, lr=1.0: reader._update(upd, grad, state, lr)
    gatys.lane_losses = lambda *a, **k: reader._losses(one, *a, **k)
    gatys.lane_losses_sharded = lambda *a, **k: reader._losses(sharded, *a, **k)
    try:
        yield reader
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
