"""Fixed-iteration linearized interior-point solve — the deterministic
real-time variant of the MPC's per-knot subproblem.

Semantics match ``ip_solve`` over the linearized residual (Mehrotra
predictor–corrector with centering fallback and merit line search), but
the solver runs a *fixed* number of masked iterations inside
``lax.fori_loop``:

* deterministic on-device timing — the replacement for the reference's
  wall-clock ``max_time`` budget (SURVEY.md §7)
* no batched-while lane synchronization

All linear algebra is the structured Schur path (constant blocks
precomputed once per linearization point).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..sim.interior_point import IPOptions, _step_length
from ..utils.vma import unify_varying
from .linsolve import gj_inverse, pdot


class FixedIPResult(NamedTuple):
    z: jnp.ndarray
    converged: jnp.ndarray
    rvio: jnp.ndarray
    kvio: jnp.ndarray
    dz: jnp.ndarray   # (nz, nθ) sensitivities


def linearized_ip_fixed(dims: Dims, z0_lin, theta0, r0, rz0, rtheta0,
                        alt, theta, q2_init, opts: IPOptions,
                        iters: int = 10):
    """Solve one pre-linearized knot with ``iters`` masked IP iterations.

    Inputs are one knot's ``LinearizedData`` fields plus the current data
    vector θ; vmap over the leading axis for batches.
    """
    dtype = theta.dtype
    nx, ny, nq = dims.nx, dims.ny, dims.nq
    ix, iy1, iy2 = dims.ix, dims.iy1, dims.iy2
    idyn, irst, ibil, iimp = dims.idyn, dims.irst, dims.ibil, dims.iimp

    # constant blocks (RZLin, linearized_solver.jl:224-304)
    dx = rz0[idyn, ix]
    dy1 = rz0[idyn, iy1]
    rx = rz0[irst, ix]
    ry1 = rz0[irst, iy1]
    ry2 = jnp.diagonal(rz0[irst, iy2])
    dxi = gj_inverse(dx)
    cai = pdot(rx, dxi)
    caib = pdot(cai, dy1)

    # affine residual pieces: r_affine(z) = base + rz0_affrows (z − z0)
    alt_full = jnp.zeros((dims.nz,), dtype).at[iimp].set(alt)
    r_base = (r0 + pdot(rtheta0, theta - theta0) + alt_full)[: nx + ny]
    rz_aff = rz0[: nx + ny]

    def residual(z, kappa):
        affine = r_base + pdot(rz_aff, z - z0_lin)
        bil = z[iy1] * z[iy2] - kappa
        return jnp.concatenate([affine, bil])

    def schur_factor(z, kvio):
        reg = jnp.asarray(opts.gamma_reg, dtype) * kvio
        y1r = jnp.maximum(z[iy1], reg)
        y2r = jnp.maximum(z[iy2], reg)
        s = ry1 - jnp.diag(ry2 * y2r / y1r) - caib
        si = gj_inverse(s)
        return si, y1r, y2r

    def schur_solve(factors, rhs):
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

    def violations(r):
        return (jnp.max(jnp.abs(r[: nx + ny])),
                jnp.max(jnp.abs(r[nx + ny:])))

    def apply_jac(factors, d):
        """The factorization's own (regularized) operator applied to step
        columns d — refinement against this contracts unconditionally;
        the true (unclamped) Jacobian diverges when the γ_reg clamp is
        active (see interior_point.apply_reg_jacobian)."""
        _, y1r, y2r = factors
        vec = d.ndim == 1
        dd = d[:, None] if vec else d
        eq = pdot(rz_aff, dd)
        bil = y1r[:, None] * dd[iy2] + y2r[:, None] * dd[iy1]
        out = jnp.concatenate([eq, bil], axis=0)
        return out[:, 0] if vec else out

    def solve_refined(z, factors, rhs):
        """Schur solve + ``opts.refine`` float32 iterative-refinement
        passes against the regularized operator."""
        d = schur_solve(factors, rhs)
        for _ in range(opts.refine):
            d = d + schur_solve(factors, rhs - apply_jac(factors, d))
        return d

    z_init = jnp.ones((dims.nz,), dtype).at[dims.iq2].set(q2_init)
    n_ls = opts.max_ls + 1
    halvings = 0.5 ** jnp.arange(n_ls, dtype=dtype)

    def body(_, carry):
        z, done = carry
        r0_ = residual(z, jnp.zeros((), dtype))
        rvio, kvio = violations(r0_)
        done_now = (rvio <= opts.r_tol) & (kvio <= opts.kappa_tol)

        factors = schur_factor(z, kvio)
        d_aff = solve_refined(z, factors, r0_)
        y1, y2 = z[iy1], z[iy2]
        one = jnp.asarray(1.0, dtype)
        a_aff = jnp.minimum(_step_length(y1, d_aff[iy1], one),
                            _step_length(y2, d_aff[iy2], one))
        mu = jnp.dot(y1, y2) / ny
        mu_aff = jnp.dot(y1 - a_aff * d_aff[iy1],
                         y2 - a_aff * d_aff[iy2]) / ny
        sigma = jnp.clip(mu_aff / jnp.maximum(mu, jnp.finfo(dtype).tiny),
                         0.0, 1.0) ** 3
        kappa_t = jnp.maximum(sigma * mu,
                              jnp.asarray(opts.kappa_tol / opts.undercut,
                                          dtype))

        r_center = residual(z, kappa_t)
        r_cor = r_center.at[ibil].add(d_aff[iy1] * d_aff[iy2])
        both = solve_refined(z, factors,
                             jnp.stack([r_cor, r_center], axis=1))
        d_cor, d_cen = both[:, 0], both[:, 1]

        tau = jnp.clip(1.0 - jnp.maximum(rvio, kvio) ** 2,
                       jnp.asarray(opts.tau_min, dtype),
                       jnp.asarray(opts.tau_max, dtype))
        a_cor = jnp.minimum(_step_length(y1, d_cor[iy1], tau),
                            _step_length(y2, d_cor[iy2], tau))
        a_cen = jnp.minimum(_step_length(y1, d_cen[iy1], tau),
                            _step_length(y2, d_cen[iy2], tau))
        alphas = jnp.concatenate([a_cor * halvings, a_cen * halvings])
        dirs = jnp.concatenate(
            [jnp.broadcast_to(d_cor, (n_ls,) + d_cor.shape),
             jnp.broadcast_to(d_cen, (n_ls,) + d_cen.shape)])
        merit0 = jnp.sum(jnp.square(r_center))
        merits = jax.vmap(
            lambda a, d: jnp.sum(jnp.square(residual(z - a * d, kappa_t))))(
            alphas, dirs)
        ok = merits < (1.0 - 1.0e-3 * alphas) * merit0
        pick = jnp.where(jnp.any(ok), jnp.argmax(ok), jnp.argmin(merits))

        z_new = z - alphas[pick] * dirs[pick]
        # keep the last finite iterate: a float32 blow-up in the Schur
        # solve must not freeze the lane on NaN for the remaining masked
        # iterations (mirrors ip_solve's divergence guard)
        z_ok = jnp.all(jnp.isfinite(z_new))
        z = jnp.where(done | done_now | jnp.logical_not(z_ok), z, z_new)
        return (z, done | done_now)

    z, done = jax.lax.fori_loop(
        0, iters, body, unify_varying((z_init, jnp.zeros((), bool))),
        unroll=max(1, opts.unroll))

    r_final = residual(z, jnp.zeros((), dtype))
    rvio, kvio = violations(r_final)
    converged = (rvio <= opts.r_tol) & (kvio <= opts.kappa_tol)

    factors = schur_factor(z, kvio)
    dz = solve_refined(z, factors, -rtheta0)
    # sensitivity guard (ip_solve parity): a singular float32
    # factorization at a finite z must not poison the horizon-Newton
    # Jacobian blocks — zero the sensitivities and flag the knot instead
    dz_bad = jnp.logical_not(jnp.all(jnp.isfinite(dz)))
    dz = jnp.where(dz_bad, jnp.zeros_like(dz), dz)
    converged = jnp.logical_and(converged, jnp.logical_not(dz_bad))
    return FixedIPResult(z=z, converged=converged, rvio=rvio, kvio=kvio,
                         dz=dz)
