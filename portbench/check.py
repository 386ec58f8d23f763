"""The comparison that decides ``correct``: each request of the window
against the plain reference (``reference/``), once the window has closed.

L-BFGS spreads a one-ulp difference between two f32 runs over a few steps
(the port's own cuDNN dgrads are not bitwise repeatable), so a free run of
the reference does not follow a 400-step run of the port. The reference
therefore follows the program's trajectory, from the updates the program
made, taken at the reading points of ``requests/gatys.py``:

- ``loss0_rel``: the program's first loss against the reference's at the
  content image (VGG-19, the targets the reference works out itself, the
  content, Gram style, TV, edge and depth terms);
- ``grad0_rel``: the program's first gradient against the reference's, as
  a relative L2 gap (the backward: K1's backward, K3, the depth model's);
- ``step0_rel``: the program's first update against the reference's,
  -min(1, 1/||g||₁)·g from the reference's gradient (relative L2);
- ``loss1_rel``: the program's second loss against the reference's after
  the reference's own first step and clamp;
- ``stepk_rel``: over steps 1 to k (the workload's ``check_steps``), the
  widest relative L2 gap between the program's update and the reference's
  two-loop update. The reference keeps its own history of m pairs (the
  configuration's ``lbfgs_memory``): its gradients at the program's
  iterates, which it makes itself as clamp(previous iterate + the
  program's update), and the program's updates as the steps. From step
  m + 1 on the buffer is full and wraps;
- ``stepk_median_rel``: the median of those k gaps, steady where single
  steps swing (the depth term's gradient in f32, PERF.md §2);
- ``gradk_rel``: the program's gradient at step k against the reference's
  at the same iterate (relative L2);
- ``last_step_rel``: the program's last update against the reference's
  from the state the program's last update started from (its m pairs,
  gamma, previous gradient and step) and the reference's gradient at the
  program's last iterate: this stage follows the program's own state;
- ``last_loss_rel``: the program's last loss against the reference's at
  the program's last iterate;
- ``output_levels_off``: values of the returned image that differ from the
  reference's rounding of clamp(last iterate + the program's last update),
  an exact comparison.

A cell's workload file says which numbers it holds and their limits; a
number is held at the worst request. Every number is worked out for every
request; a number a cell does not limit is printed but not judged
(PERF.md says why).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference import gatys as ref

NUMBERS = ("loss0_rel", "grad0_rel", "step0_rel", "loss1_rel", "stepk_rel",
           "stepk_median_rel", "gradk_rel", "last_step_rel", "last_loss_rel",
           "output_levels_off")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.clamp(torch.linalg.vector_norm(b.double()), min=1e-30))


def _program_state(st: Dict, shape, m: int, dev) -> Dict:
    """The program's L-BFGS state in the reference's form, or None where it
    does not hold m pairs of ``shape``."""
    if st["s_hist"].shape[0] != m or st["s_hist"][0].numel() != int(np.prod(shape)):
        return None
    out = {k: st[k].to(dev) for k in ("s_hist", "y_hist", "rho", "gamma")}
    out["s_hist"] = out["s_hist"].reshape(m, *shape)
    out["y_hist"] = out["y_hist"].reshape(m, *shape)
    out["prev_grad"] = st["prev_grad"].to(dev).reshape(shape)
    out["prev_step_vec"] = st["prev_step_vec"].to(dev).reshape(shape)
    out["step"] = st["step"]
    return out


def request_numbers(obj: ref.Objective, content: torch.Tensor, cap: Dict,
                    output_u8: np.ndarray, lr: float, m: int) -> Dict[str, float]:
    """The numbers of one request: ``cap`` holds the program's loss
    history (``hist``), first gradient, first updates (``steps_u``),
    gradient at the last of them (``gradk``), last iterate, gradient,
    update and the state the last update started from; ``output_u8`` the
    returned image (H, W, 3); ``m`` the configuration's L-BFGS memory."""
    dev = content.device
    hist = cap["hist"]
    x0 = content.clamp(0.0, 1.0)
    shape = tuple(x0.shape)
    us = [u.to(dev).reshape(shape) for u in cap["steps_u"]]
    k = len(us) - 1
    st = ref.init_state(shape, m, dev)
    x, out, gaps = x0, {}, []
    for j in range(k + 1):
        lj, gj = ref.loss_grad(obj, x)
        uj = ref.lbfgs_step(gj, st, lr)
        if j == 0:
            out["loss0_rel"] = _rel(hist[0], float(lj))
            out["grad0_rel"] = _rel_l2(cap["grad0"].to(dev).reshape(shape), gj)
            out["step0_rel"] = _rel_l2(us[0], uj)
            with torch.no_grad():
                out["loss1_rel"] = _rel(hist[1], float(ref.loss(obj, (x0 + uj).clamp(0.0, 1.0))))
        else:
            gaps.append(_rel_l2(us[j], uj))
        if j == k:
            out["gradk_rel"] = _rel_l2(cap["gradk"].to(dev).reshape(shape), gj)
        st["prev_step_vec"] = us[j]  # the reference follows the program's trajectory
        x = (x + us[j]).clamp(0.0, 1.0)
    out["stepk_rel"] = max(gaps)
    out["stepk_median_rel"] = float(np.median(gaps))
    x_last = cap["x_last"].to(dev).reshape(shape)
    step = cap["step_last"].to(dev).reshape(shape)  # one lane's shape, no batch axis, on a mesh
    l_last, g_last = ref.loss_grad(obj, x_last)
    out["last_loss_rel"] = _rel(hist[-1], float(l_last))
    last_state = _program_state(cap["state_last"], shape, m, dev)
    out["last_step_rel"] = (float("nan") if last_state is None
                            else _rel_l2(step, ref.lbfgs_step(g_last, last_state, lr)))
    want = torch.clamp(torch.round((x_last + step).clamp(0.0, 1.0) * 255.0), 0, 255)
    got = torch.as_tensor(np.array(output_u8), device=dev).reshape(want.shape)
    out["output_levels_off"] = float(torch.count_nonzero(got.to(want.dtype) != want))
    return out


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number at its worst request; a NaN anywhere is the worst."""
    if not rows:
        return {}
    return {k: (float("nan") if any(np.isnan(r[k]) for r in rows) else max(r[k] for r in rows))
            for k in rows[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every limited number is within its limit (NaN fails)."""
    if not numbers:
        return False
    return all(numbers[k] <= limits[k] for k in limits)
