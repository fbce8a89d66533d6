"""Contact-NCP residual: one physics step as a nonlinear complementarity
problem.

JAX redesign of the reference's ``src/simulation/simulation.jl``.
The reference traces this residual with Symbolics and codegens ``r, rz, rθ``
(code_gen_simulation.jl:2-168); here the residual is a traced JAX function
and ``jax.jacfwd`` provides the Jacobians — the XLA compile cache plays the
role of the JLD2 expression cache.

Residual rows for the linearized cone (simulation.jl:133-158)::

    r = [ d(h, q0, q1, u1, w1, Jᵀλ1, q2)          dynamics        (nq)
          s1 - ϕ(q2) + alt                         impact          (nc)
          η1 - vT(q1,q2) - Eᵀψ1                    max dissipation (nb)
          s2 - (μ γ1 - E b1)                       friction cone   (nc)
          γ1 ∘ s1 - κ                              bilinear        (nc)
          b1 ∘ η1 - κ                              bilinear        (nb)
          ψ1 ∘ s2 - κ ]                            bilinear        (nc)

``alt`` is the per-contact altitude offset used by the MPC's linearized
model (linearized_solver.jl:370, set via set_altitude! at
implicit_dynamics.jl:141-154); the physics simulation path leaves it zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..models.base import (Model, contact_forces, dims_of, dynamics,
                           e_mapping, velocity_stack)


def unpack_z(dims: Dims, z):
    """index.jl:417-435."""
    return (z[dims.iq2], z[dims.igamma1], z[dims.ib1], z[dims.ipsi1],
            z[dims.is1], z[dims.ieta1], z[dims.is2])


def unpack_theta(dims: Dims, theta):
    """index.jl:396-411."""
    return (theta[dims.iq0], theta[dims.iq1], theta[dims.iu1],
            theta[dims.iw1], theta[dims.imu], theta[dims.ih])


def pack_z(q2, gamma1, b1, psi1, s1, eta1, s2):
    """index.jl:449-451."""
    return jnp.concatenate([q2, gamma1, b1, psi1, s1, eta1, s2])


def pack_z_consistent(model: Model, env, q2, gamma1, b1, psi1, eta1):
    """index.jl:437-447 — derive the slacks from primal variables."""
    dims = dims_of(model, env)
    s1 = model.phi(env, q2)
    if env.cone == "linearized":
        e = e_mapping(dims, q2.dtype)
        s2 = model.mu_world * gamma1 - e @ b1
    else:
        s2 = model.mu_world * gamma1
    return pack_z(q2, gamma1, b1, psi1, s1, eta1, s2)


def pack_theta(q0, q1, u1, w1, mu, h):
    """index.jl:413-415 / simulation.jl:109-125."""
    dtype = jnp.result_type(q0)
    return jnp.concatenate([
        q0, q1, u1, w1,
        jnp.reshape(jnp.asarray(mu, dtype), (1,)),
        jnp.reshape(jnp.asarray(h, dtype), (1,)),
    ])


def soc_product(u, v):
    """Second-order-cone product u ∘ v = [uᵀv; u0 v̄ + v0 ū]."""
    return jnp.concatenate([
        jnp.dot(u, v)[None], u[0] * v[1:] + v[0] * u[1:]])


def residual(model: Model, env, z, theta, kappa, alt=None):
    """NCP residual r(z, θ, κ) (simulation.jl:133-186)."""
    dims = dims_of(model, env)
    q2, gamma1, b1, psi1, s1, eta1, s2 = unpack_z(dims, z)
    q0, q1, u1, w1, mu, h = unpack_theta(dims, theta)
    kappa = jnp.reshape(jnp.asarray(kappa, z.dtype), ())
    if alt is None:
        alt = jnp.zeros((dims.nc,), z.dtype)

    phi = model.phi(env, q2)
    k = model.kinematics(q2)
    lam1 = contact_forces(model, env, gamma1, b1, q2, k)
    cap_lam1 = model.contact_jacobian(q2).T @ lam1
    vt = velocity_stack(model, env, q1, q2, k, h)

    d = dynamics(model, h, q0, q1, u1, w1, cap_lam1, q2)

    if env.cone == "linearized":
        e = e_mapping(dims, z.dtype)
        psi_stack = e.T @ psi1
        return jnp.concatenate([
            d,
            s1 - phi + alt,
            eta1 - vt - psi_stack,
            s2 - (mu * gamma1 - e @ b1),
            gamma1 * s1 - kappa,
            b1 * eta1 - kappa,
            psi1 * s2 - kappa,
        ])

    # Nonlinear (second-order) cone, simulation.jl:160-186.
    nf = dims.nf
    soc_rows = []
    for i in range(dims.nc):
        u = jnp.concatenate([psi1[i][None], eta1[i * nf:(i + 1) * nf]])
        v = jnp.concatenate([s2[i][None], b1[i * nf:(i + 1) * nf]])
        prod = soc_product(u, v)
        soc_rows.append(prod - jnp.concatenate([
            kappa[None], jnp.zeros((nf,), z.dtype)]))
    return jnp.concatenate([
        d,
        s1 - phi + alt,
        eta1 - vt,
        s2 - mu * gamma1,
        gamma1 * s1 - kappa,
        jnp.concatenate(soc_rows),
    ])


def residual_z_jacobian(model: Model, env, z, theta):
    """rz = ∂r/∂z via forward-mode autodiff (replaces codegen'd ``rz!``)."""
    return jax.jacfwd(lambda zz: residual(model, env, zz, theta, 0.0))(z)


def residual_theta_jacobian(model: Model, env, z, theta):
    """rθ = ∂r/∂θ via forward-mode autodiff (replaces codegen'd ``rθ!``)."""
    return jax.jacfwd(
        lambda tt: residual(model, env, z, tt, 0.0), )(theta)
