"""Time-varying LQR gains around linearized contact dynamics.

JAX re-implementation of
``/root/reference/src/controller/gains.jl``. The backward Riccati
recursion runs as a reverse ``lax.scan``; the contact-dynamics Jacobians
come from the linearized sensitivity ``∂z/∂θ = −rz⁻¹ rθ`` exactly as
``reference_gains`` (gains.jl:17-51), with the two-configuration state
x = (q1, q2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..models.base import Model, dims_of
from .linearized import LinearizedData, linearize_trajectory
from .objective import TrackingVelocityObjective
from .trajectory import ContactTraj


def tvlqr(a, b, q, r):
    """Discrete-time backward Riccati sweep (gains.jl:1-16).

    a: (T-1, n, n), b: (T-1, n, m), q: (T, n, n), r: (T-1, m, m).
    Returns gains K (T-1, m, n) and cost-to-go P (T, n, n).
    """
    p_final = q[-1]

    def step(p_next, blocks):
        a_t, b_t, q_t, r_t = blocks
        btp = b_t.T @ p_next
        k_t = jnp.linalg.solve(r_t + btp @ b_t, btp @ a_t)
        acl = a_t - b_t @ k_t
        p_t = q_t + k_t.T @ r_t @ k_t + acl.T @ p_next @ acl
        return p_t, (k_t, p_t)

    _, (k, p) = jax.lax.scan(step, p_final, (a, b, q[:-1], r),
                             reverse=True)
    p_full = jnp.concatenate([p, p_final[None]], axis=0)
    return k, p_full


def reference_gains(model: Model, env, traj: ContactTraj, obj, *,
                    periods: int = 10, kappa: float = 2e-4,
                    u_scaling: float = 100.0, v_scaling: float = 100.0):
    """TVLQR gains about a reference contact trajectory
    (reference_gains, gains.jl:17-51): tile the gait ``periods`` times,
    build A, B from the per-knot solution sensitivities, and run the
    Riccati sweep; return the first gait period's gains (H, nu, 2nq)."""
    dims = dims_of(model, env)
    nq, nu = dims.nq, dims.nu
    horizon = traj.horizon
    total = periods * horizon
    dtype = traj.q.dtype

    lin = linearize_trajectory(model, env, traj, kappa)
    dzdth = jax.vmap(lambda rz, rt: -jnp.linalg.solve(rz, rt))(
        lin.rz0, lin.rtheta0)
    tile = lambda x: jnp.tile(x, (periods,) + (1,) * (x.ndim - 1))
    dzdth = tile(dzdth)

    dq3dq1 = dzdth[:, dims.iq2, dims.iq0]
    dq3dq2 = dzdth[:, dims.iq2, dims.iq1]
    dq3du = dzdth[:, dims.iq2, dims.iu1]

    znn = jnp.zeros((total, nq, nq), dtype)
    eye = jnp.broadcast_to(jnp.eye(nq, dtype=dtype), (total, nq, nq))
    a = jnp.concatenate([
        jnp.concatenate([znn, eye], axis=2),
        jnp.concatenate([dq3dq1, dq3dq2], axis=2)], axis=1)
    b = jnp.concatenate([jnp.zeros((total, nq, nu), dtype), dq3du], axis=1)

    qw = jnp.diag(jnp.asarray(obj.q[0], dtype))
    vw = v_scaling * jnp.diag(jnp.asarray(
        obj.v[0] if isinstance(obj, TrackingVelocityObjective)
        else jnp.zeros((nq,)), dtype))
    q_blk = jnp.concatenate([
        jnp.concatenate([qw + vw, -vw], axis=1),
        jnp.concatenate([-vw, qw + vw], axis=1)], axis=0)
    q = jnp.broadcast_to(q_blk, (total + 1, 2 * nq, 2 * nq))
    r = jnp.broadcast_to(u_scaling * jnp.diag(jnp.asarray(obj.u[0], dtype)),
                         (total, nu, nu))

    k, _ = tvlqr(a, b, q, r)
    return k[:horizon]
