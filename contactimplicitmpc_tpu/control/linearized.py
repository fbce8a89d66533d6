"""Pre-linearized residual data for the MPC's smooth implicit-dynamics
model.

JAX redesign of ``LinearizedStep``
(``/root/reference/src/controller/linearized_step.jl``) and the
structure-exploiting ``RLin/RZLin/RθLin`` residual
(``src/controller/linearized_solver.jl:15-587``).

The reference stores per-knot static-array blocks and a Schur
factorization refreshed every IP iteration. Here the linearization data is
a stack of dense ``(H, nz, nz)`` / ``(H, nz, nθ)`` arrays — at these sizes
(nz ≤ ~64) a batched dense LU beats block bookkeeping, and the
bilinear rows are refreshed inside the generic interior-point kernel by
overwriting their diagonal blocks (see ``ip_solve``).

Residual semantics (rlin!, linearized_solver.jl:364-373)::

    r_dyn,rst(z, θ) = r0 + rz0 (z − z0) + rθ0 (θ − θ0)   (affine rows)
    r_bil(z, κ)     = y1 ∘ y2 − κ                        (exact rows)
    r_rst[imp]     += alt                                 (altitude shift)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..models.base import Model, dims_of
from ..sim.residual import residual
from .trajectory import ContactTraj


class LinearizedData(NamedTuple):
    """Stacked LinearizedStep (linearized_step.jl:1-29): linearization
    points and Jacobians for every knot of a reference trajectory."""

    z0: jnp.ndarray        # (H, nz)
    theta0: jnp.ndarray    # (H, nθ)
    r0: jnp.ndarray        # (H, nz)  residual at (z0, θ0, κ)
    rz0: jnp.ndarray       # (H, nz, nz)
    rtheta0: jnp.ndarray   # (H, nz, nθ)


def linearize_trajectory(model: Model, env, traj: ContactTraj,
                         kappa) -> LinearizedData:
    """Evaluate r, rz, rθ at every knot of ``traj``
    (ImplicitTrajectory construction, implicit_dynamics.jl:56-68)."""
    kappa = jnp.asarray(kappa, traj.z.dtype)
    nz = traj.z.shape[1]

    def one(z0, th0):
        # r, rz and rθ from one forward-mode pass over [z; θ] (κ shifts
        # the bilinear rows by a constant, so the Jacobian is rz!/rθ!'s)
        def r(zt):
            out = residual(model, env, zt[:nz], zt[nz:], kappa)
            return out, out
        jac, r0 = jax.jacfwd(r, has_aux=True)(jnp.concatenate([z0, th0]))
        return r0, jac[:, :nz], jac[:, nz:]

    # one compiled program: op-by-op dispatch of the per-knot Jacobians
    # costs tens of seconds of host time at set-up
    r0, rz0, rt0 = jax.jit(jax.vmap(one))(traj.z, traj.theta)
    return LinearizedData(z0=traj.z, theta0=traj.theta, r0=r0, rz0=rz0,
                          rtheta0=rt0)


def gather(lin: LinearizedData, idx: jnp.ndarray) -> LinearizedData:
    """Select the knots covered by the receding-horizon window."""
    take = lambda a: jnp.take(a, idx, axis=0)
    return LinearizedData(*(take(a) for a in lin))


def linearized_residual_fns(dims: Dims, z0, theta0, r0, rz0, rtheta0, alt):
    """Residual/Jacobian callbacks for one knot's linearized model, in the
    form expected by ``ip_solve``."""
    ibil, iy1, iy2, iimp = dims.ibil, dims.iy1, dims.iy2, dims.iimp

    def r_fn(z, th, kap):
        r = r0 + rz0 @ (z - z0) + rtheta0 @ (th - theta0)
        r = r.at[ibil].set(z[iy1] * z[iy2] - kap)
        return r.at[iimp].add(alt)

    def rz_fn(z, th):
        # constant affine rows; ip_solve refreshes the bilinear diagonals
        return rz0

    def rtheta_fn(z, th):
        return rtheta0

    return r_fn, rz_fn, rtheta_fn


def make_schur_solver(dims: Dims, rz0, opts):
    """Structured linear-system backend for the linearized IP solve
    (linear_solve!, linearized_solver.jl:424-444).

    The Jacobian is ``[[Dx Dy1 0]; [Rx Ry1 diag(Ry2)]; [0 diag(y2)
    diag(y1)]]`` with only the bilinear diagonals changing per IP
    iteration. Eliminating y2 diagonally leaves a 2×2 block system whose
    Schur complement about the constant ``Dx`` needs only an ny×ny
    factorization per iteration — Dx⁻¹, Rx Dx⁻¹ and Rx Dx⁻¹ Dy1 are
    precomputed once per linearization point (RZLin, linearized_solver.jl:
    224-304). This cuts the sequential factorization depth from nz to ny
    per iteration.
    """
    from ..ops.linsolve import gj_inverse, pdot

    idyn, irst, ibil = dims.idyn, dims.irst, dims.ibil
    ix, iy1, iy2 = dims.ix, dims.iy1, dims.iy2

    dx = rz0[idyn, ix]
    dy1 = rz0[idyn, iy1]
    rx = rz0[irst, ix]
    ry1 = rz0[irst, iy1]
    ry2 = jnp.diagonal(rz0[irst, iy2])

    dxi = gj_inverse(dx)
    cai = pdot(rx, dxi)
    caib = pdot(cai, dy1)

    gamma_reg = opts.gamma_reg

    def factor(z, theta, kvio):
        dtype = z.dtype
        reg = jnp.asarray(gamma_reg, dtype) * kvio
        y1r = jnp.maximum(z[iy1], reg)
        y2r = jnp.maximum(z[iy2], reg)
        d = ry1 - jnp.diag(ry2 * y2r / y1r)
        si = gj_inverse(d - caib)
        return (si, y1r, y2r)

    def solve(factors, rhs):
        si, y1r, y2r = factors
        vec = rhs.ndim == 1
        r = rhs[:, None] if vec else rhs
        rdyn, rrst, rbil = r[idyn], r[irst], r[ibil]
        v = rrst - (ry2 / y1r)[:, None] * rbil
        temp = pdot(si, pdot(cai, rdyn) - v)
        x = pdot(dxi, rdyn + pdot(dy1, temp))
        y = -temp
        dy2 = (rbil - y2r[:, None] * y) / y1r[:, None]
        out = jnp.concatenate([x, y, dy2], axis=0)
        return out[:, 0] if vec else out

    return factor, solve
