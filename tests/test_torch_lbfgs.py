"""The port's L-BFGS ``update`` against the JAX package's, step by step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tbist_tpu.optimize import lbfgs as jlbfgs
from tbist_tpu_torch.optimize import lbfgs as tlbfgs

SHAPE = (4, 5, 3)
REPEAT_AT = (9, 20)  # steps fed the previous gradient again: y = 0, pair skipped


def _problem(dtype):
    rng = np.random.default_rng(3)
    n = int(np.prod(SHAPE))
    M = rng.standard_normal((n, n))
    A = (M @ M.T / n + np.eye(n)).astype(dtype)
    b = rng.standard_normal(n).astype(dtype)
    x0 = rng.standard_normal(SHAPE).astype(dtype)
    return A, b, x0


def _grad(A, b, x):
    return (A @ x.reshape(-1) - b).reshape(SHAPE)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-9), (np.float32, 1e-4)])
def test_update_trajectory_matches_jax(dtype, rtol):
    A, b, x0 = _problem(dtype)
    jstate = jlbfgs.init_state(SHAPE, 5, dtype=jnp.dtype(dtype))
    tstate = tlbfgs.init_state(SHAPE, 5, dtype=getattr(torch, np.dtype(dtype).name))
    xj = xt = x0
    g_prev = None
    for step in range(30):
        g = _grad(A, b, xj)
        if step in REPEAT_AT:
            g = g_prev
        vj, jstate = jlbfgs.update(jnp.asarray(g), jstate, lr=0.9)
        vt, tstate = tlbfgs.update(torch.from_numpy(np.array(g)), tstate, lr=0.9)
        vj = np.asarray(vj)
        np.testing.assert_allclose(vt.numpy(), vj, rtol=rtol,
                                   atol=rtol * np.abs(vj).max(), err_msg=f"step {step}")
        np.testing.assert_allclose(tstate.rho.numpy(), np.asarray(jstate.rho), rtol=rtol,
                                   err_msg=f"step {step}")
        xj = (xj + vj).astype(dtype)
        g_prev = g
    assert tstate.step == 30
    assert int(np.sum(tstate.rho.numpy() == 0)) == 0  # later pairs refilled the slots


def test_skipped_pair_keeps_the_old_slot():
    state = tlbfgs.init_state((6,), 4, dtype=torch.float64)
    g0 = torch.ones(6, dtype=torch.float64)
    _, state = tlbfgs.update(g0, state)
    _, state = tlbfgs.update(g0.clone(), state)  # y = 0: invalid curvature
    assert torch.all(state.rho == 0) and torch.all(state.s_hist == 0)
    _, state = tlbfgs.update(0.5 * g0, state)  # y.s > 0: stored
    assert state.rho[1] > 0 and torch.all(state.rho[[0, 2, 3]] == 0)


def test_matches_torch_optim_lbfgs_on_quadratic():
    """Same case as tests/test_lbfgs.py, through the port's update."""
    rng = np.random.default_rng(3)
    n = 8
    M = rng.standard_normal((n, n))
    A = torch.tensor(M @ M.T + n * np.eye(n))
    b = torch.tensor(rng.standard_normal(n))
    x0 = torch.tensor(rng.standard_normal(n))

    xt = x0.clone().requires_grad_(True)
    opt = torch.optim.LBFGS([xt], lr=1.0, max_iter=1, history_size=10,
                            tolerance_grad=0, tolerance_change=0)
    x = x0.clone()
    state = tlbfgs.init_state(n, 10, dtype=torch.float64)
    for i in range(12):
        def closure():
            opt.zero_grad()
            loss = 0.5 * xt @ A @ xt - b @ xt
            loss.backward()
            return loss

        opt.step(closure)
        step_vec, state = tlbfgs.update(A @ x - b, state)
        x = x + step_vec
        torch.testing.assert_close(x, xt.detach(), rtol=1e-6, atol=1e-8, msg=f"step {i}")
