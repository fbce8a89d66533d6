"""Implicit (smoothed) contact dynamics for the MPC: batched linearized
interior-point solves with sensitivities.

JAX redesign of ``ImplicitTrajectory`` / ``implicit_dynamics!``
(``/root/reference/src/controller/implicit_dynamics.jl``). The reference
loops (optionally ``Threads.@threads``) over H per-knot solvers; here the H
knots are one ``jax.vmap`` over the interior-point kernel — identical
structure across knots makes the batch perfectly regular.

Outputs per knot t (implicit_dynamics.jl:156-192):

* ``d``  — dynamics violation ``z*[:nd] − [q2ref; γref; bref]``
  (mode ``configurationforce``) or ``z*[:nq] − q2ref`` (``configuration``)
* ``dq0, dq1, du1`` — sensitivity blocks ``∂z*[:nd]/∂(q0, q1, u1)``
  (views of ``ip.δz``, implicit_dynamics.jl:83-86)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..sim.interior_point import IPOptions, ip_solve
from .linearized import (LinearizedData, linearized_residual_fns,
                         make_schur_solver)
from .trajectory import ContactTraj

CONFIGURATION = "configuration"
CONFIGURATION_FORCE = "configurationforce"


def nd_of(dims: Dims, mode: str) -> int:
    """implicit_dynamics.jl:46-52."""
    if mode == CONFIGURATION_FORCE:
        return dims.nq + dims.nc + dims.nb
    if mode == CONFIGURATION:
        return dims.nq
    raise ValueError(f"invalid mode {mode!r}")


def default_mpc_ip_options(kappa: float, max_iter: int = 100) -> IPOptions:
    """ImplicitTrajectory defaults (implicit_dynamics.jl:25-32)."""
    return IPOptions(r_tol=1.0e-8, kappa_tol=float(kappa), max_iter=max_iter,
                     undercut=5.0, gamma_reg=0.1, diff_sol=True)


class ImplicitDynamicsResult(NamedTuple):
    d: jnp.ndarray          # (H, nd) dynamics violation
    dq0: jnp.ndarray        # (H, nd, nq)
    dq1: jnp.ndarray        # (H, nd, nq)
    du1: jnp.ndarray        # (H, nd, nu)
    z: jnp.ndarray          # (H, nz) solved knots
    converged: jnp.ndarray  # (H,)


def implicit_dynamics(dims: Dims, mode: str, lin: LinearizedData,
                      traj: ContactTraj, alt: jnp.ndarray,
                      opts: IPOptions,
                      fixed_iters: int = 0) -> ImplicitDynamicsResult:
    """Solve all H knots of the smooth implicit model around ``lin``.

    ``lin`` must already be gathered to the horizon window
    (implicit_dynamics.jl:160-178: lin index = window, traj index = i).

    ``fixed_iters > 0`` switches to the deterministic fixed-iteration
    solver (``ops.linearized_ip_fixed``) — the real-time path.
    """
    nd = nd_of(dims, mode)
    horizon = traj.horizon
    opts = dataclasses.replace(opts, diff_sol=True)

    if fixed_iters > 0:
        from ..ops.fixed_ip import linearized_ip_fixed

        def solve_knot(lin_z0, lin_th0, lin_r0, lin_rz0, lin_rt0,
                       q2_init, theta):
            return linearized_ip_fixed(dims, lin_z0, lin_th0, lin_r0,
                                       lin_rz0, lin_rt0, alt, theta,
                                       q2_init, opts, iters=fixed_iters)
    else:
        def solve_knot(lin_z0, lin_th0, lin_r0, lin_rz0, lin_rt0,
                       q2_init, theta):
            r_fn, rz_fn, rt_fn = linearized_residual_fns(
                dims, lin_z0, lin_th0, lin_r0, lin_rz0, lin_rt0, alt)
            z0 = jnp.ones((dims.nz,), theta.dtype).at[dims.iq2].set(q2_init)
            return ip_solve(dims, r_fn, z0, theta, opts,
                            jacobian_fn=rz_fn, rtheta_fn=rt_fn,
                            linear_solver=make_schur_solver(dims, lin_rz0,
                                                            opts))

    res = jax.vmap(solve_knot)(lin.z0, lin.theta0, lin.r0, lin.rz0,
                               lin.rtheta0, traj.q[2:horizon + 2], traj.theta)

    # dynamics violation (implicit_dynamics.jl:180-190)
    if mode == CONFIGURATION_FORCE:
        ref = jnp.concatenate([traj.q[2:horizon + 2], traj.gamma, traj.b],
                              axis=1)
    else:
        ref = traj.q[2:horizon + 2]
    d = res.z[:, :nd] - ref

    # sensitivity views (implicit_dynamics.jl:83-86): δz rows 1:nd, θ-cols
    dz = res.dz
    dq0 = dz[:, :nd, dims.iq0]
    dq1 = dz[:, :nd, dims.iq1]
    du1 = dz[:, :nd, dims.iu1]
    return ImplicitDynamicsResult(d=d, dq0=dq0, dq1=dq1, du1=du1,
                                  z=res.z, converged=res.converged)
