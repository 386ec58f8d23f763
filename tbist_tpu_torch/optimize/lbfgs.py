"""L-BFGS with ``torch.optim.LBFGS``-default semantics, ported from
``tbist_tpu.optimize.lbfgs`` (``update``, :108-195).

No line search, lr scales the step, the first step is
``min(1, 1/||g||_1)``, and a (s, y) pair is skipped when ``y·s <= 1e-10``
(reference run_style_transfer.py:90). The inverse-Hessian product uses the
Byrd-Nocedal-Schnabel compact form over a fixed circular buffer of m
pairs, exactly as the JAX package does; history rows keep the gradient's
own shape.

Two differences from the JAX version, neither of which changes the
arithmetic:

* ``step`` is a host int (the step-0 branch is deterministic), while
  ``valid``, ``rho``, ``gamma`` and the slot write stay on the device
  through ``torch.where``: a step never reads a value back to the host.
* ``update`` writes the history slot in place and returns the same state
  object, where JAX donates the buffers and returns new ones.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch


@dataclasses.dataclass
class LBFGSState:
    step: int  # iteration counter (host)
    s_hist: torch.Tensor  # (m, *shape) parameter differences
    y_hist: torch.Tensor  # (m, *shape) gradient differences
    rho: torch.Tensor  # (m,) 1/(y·s); 0 marks an invalid slot
    prev_grad: torch.Tensor  # (*shape,)
    prev_step_vec: torch.Tensor  # (*shape,) t*d actually applied last iteration
    gamma: torch.Tensor  # () H0 scaling (y·s)/(y·y)


def init_state(
    shape: Union[int, Tuple[int, ...]],
    memory_size: int,
    dtype: torch.dtype = torch.float32,
    device="cpu",
) -> LBFGSState:
    """``shape`` is the parameter shape (an int gives a flat vector)."""
    if isinstance(shape, int):
        shape = (shape,)
    m = memory_size
    z = dict(dtype=dtype, device=device)
    return LBFGSState(
        step=0,
        s_hist=torch.zeros((m, *shape), **z),
        y_hist=torch.zeros((m, *shape), **z),
        rho=torch.zeros((m,), **z),
        prev_grad=torch.zeros(shape, **z),
        prev_step_vec=torch.zeros(shape, **z),
        gamma=torch.ones((), **z),
    )


def _combine(coeff: torch.Tensor, hist: torch.Tensor) -> torch.Tensor:
    """(m,) x (m, *shape) -> (*shape,); weighted sum of history rows."""
    return (coeff @ hist.reshape(hist.shape[0], -1)).reshape(hist.shape[1:])


def _solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # solve_ex: no error check, so no device->host sync
    return torch.linalg.solve_ex(a, b.unsqueeze(-1))[0].squeeze(-1)


def update(
    grad: torch.Tensor, state: LBFGSState, lr: float = 1.0
) -> Tuple[torch.Tensor, LBFGSState]:
    """One L-BFGS step. Returns (update_vector, state); ``update_vector`` is
    the additive parameter update (t * direction), shaped like ``grad``."""
    g = grad
    m = state.s_hist.shape[0]
    if state.step == 0:
        # torch: t = min(1, 1/||g||_1) * lr ; d = -g
        t = torch.clamp(1.0 / torch.sum(torch.abs(g)), max=1.0) * lr
        step_vec = -t * g
    else:
        s = state.prev_step_vec
        y = g - state.prev_grad
        ys = torch.sum(y * s)
        valid = ys > 1e-10

        slot = (state.step - 1) % m
        state.s_hist[slot] = torch.where(valid, s, state.s_hist[slot])
        state.y_hist[slot] = torch.where(valid, y, state.y_hist[slot])
        state.rho[slot] = torch.where(valid, 1.0 / ys, state.rho[slot])
        state.gamma = torch.where(valid, ys / torch.sum(y * y), state.gamma)

        # Compact representation (Byrd-Nocedal-Schnabel 1994):
        #   H g = g*gamma + S^T[R^-T((D + gamma*YY^T)R^-1 Sg - gamma*Yg)]
        #         - gamma*Y^T(R^-1 Sg)
        # with rows of S/Y in circular-buffer order; chronological order
        # enters only through the triangular mask of R. Invalid slots
        # (rho == 0) have all-zero S/Y rows and identity diagonal in R/D.
        # R is triangular only after a permutation, hence a general solve.
        s_flat = state.s_hist.reshape(m, -1)
        y_flat = state.y_hist.reshape(m, -1)
        gamma = state.gamma
        valid_slots = state.rho != 0.0
        SY = s_flat @ y_flat.T  # (m, m)
        YY = y_flat @ y_flat.T
        # chronological position of each buffer row (newest == m-1)
        chrono = (torch.arange(m, device=g.device) - slot - 1) % m
        keep = chrono[:, None] <= chrono[None, :]
        eye = torch.eye(m, dtype=g.dtype, device=g.device)
        diag_fix = torch.where(valid_slots, 0.0, 1.0).to(g.dtype)
        R = torch.where(keep, SY, torch.zeros_like(SY)) + diag_fix * eye
        d_tilde = torch.where(valid_slots, torch.diagonal(SY), torch.ones_like(gamma))

        g_flat = g.reshape(-1)
        Sg = s_flat @ g_flat  # (m,)
        Yg = y_flat @ g_flat
        p = _solve(R, Sg)  # R^-1 Sg  (10x10 -- negligible)
        w = d_tilde * p + gamma * (YY @ p) - gamma * Yg
        u = _solve(R.T, w)  # R^-T w
        r_vec = gamma * g + _combine(u, state.s_hist) - gamma * _combine(p, state.y_hist)
        step_vec = -lr * r_vec

    state.step += 1
    state.prev_grad = g
    state.prev_step_vec = step_vec
    return step_vec, state
