"""Model protocol and the variational (midpoint Lagrangian) integrator.

JAX redesign of the reference's ``src/dynamics/model.jl``. The
reference codegens ``L, M, C, B, A, k`` through Symbolics
(code_gen_dynamics.jl:5-77); here each robot is a plain Python object with
pure JAX methods, and the autodiff defaults below replace the symbolic
derivations exactly:

* ``mass_matrix``  default = ∂²L/∂v² (code_gen_dynamics.jl:35)
* ``bias``         default = ∂²L/∂v∂q · v − ∂L/∂q (code_gen_dynamics.jl:43-50)

Models are *static* w.r.t. jit: instances are captured by closure, so every
shape/parameter is a compile-time constant — the analog of the reference's
statically-sized codegen'd functions.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import jax
import jax.numpy as jnp

from ..dims import Dims

if TYPE_CHECKING:  # pragma: no cover
    from ..env import Environment


class Model:
    """Base robot model (``Model{T}`` subtype protocol, model.jl:1-41).

    Subclasses set ``nq, nu, nw, nc``, ``mu_world``, ``joint_friction`` and
    implement ``lagrangian`` (or override ``mass_matrix``/``bias``
    analytically), ``kinematics``, ``control_jacobian``,
    ``disturbance_jacobian`` and ``contact_jacobian``.
    """

    nq: int
    nu: int
    nw: int
    nc: int
    mu_world: float
    mu_joint: float = 0.0
    joint_friction: tuple = ()

    # ---- Lagrangian mechanics -----------------------------------------
    def lagrangian(self, q, v):
        raise NotImplementedError

    def mass_matrix(self, q):
        """M(q). Default: Hessian of L in velocity (code_gen_dynamics.jl:35)."""
        v0 = jnp.zeros_like(q)
        return jax.hessian(lambda vv: self.lagrangian(q, vv))(v0)

    def bias(self, q, v):
        """C(q, v) = ∂²L/∂v∂q · v − ∂L/∂q (code_gen_dynamics.jl:43-50)."""
        dLq = jax.grad(self.lagrangian, argnums=0)(q, v)
        d2Lvq = jax.jacfwd(jax.grad(self.lagrangian, argnums=1), argnums=0)(q, v)
        return d2Lvq @ v - dLq

    # ---- input maps ----------------------------------------------------
    def control_jacobian(self, q):
        """B(q): (nu, nq); applied as Bᵀu (model.jl:30)."""
        raise NotImplementedError

    def disturbance_jacobian(self, q):
        """A(q): (nw, nq); applied as Aᵀw (model.jl:31)."""
        raise NotImplementedError

    def contact_jacobian(self, q):
        """J(q): (nc * ne, nq); applied as Jᵀλ (model.jl:38-41)."""
        raise NotImplementedError

    # ---- contact kinematics -------------------------------------------
    def kinematics(self, q):
        """Per-contact world positions, shape (nc, ne)."""
        raise NotImplementedError

    def phi(self, env: "Environment", q):
        """Signed distances, shape (nc,). Default: height minus terrain
        (e.g. particle/model.jl:58-60, hopper_2D/model.jl:54-57)."""
        k = self.kinematics(q)

        def one(ki):
            return ki[-1] - env.surf(ki[:-1])

        return jax.vmap(one)(k)

    def joint_friction_vector(self, dtype):
        jf = jnp.asarray(self.joint_friction, dtype=dtype)
        if jf.shape != (self.nq,):
            jf = jnp.zeros((self.nq,), dtype=dtype)
        return jf

    def damping_force(self, h, vm2):
        """Velocity damping added to the integrator residual.

        Default: −h · joint_friction ∘ v (model.jl:34). Models with
        relative/structured damping override this (e.g.
        point_foot_quadruped/model.jl:230-241)."""
        jf = self.joint_friction_vector(jnp.result_type(vm2))
        return -h * jf * vm2

    # ---- contact maps (overridable, like the reference's per-model
    # contact_forces/velocity_stack methods, e.g.
    # centroidal_quadruped_wall/model.jl:147-174) -------------------------
    def contact_forces(self, env: "Environment", gamma1, b1, q2, k):
        return _default_contact_forces(self, env, gamma1, b1, q2, k)

    def velocity_stack(self, env: "Environment", q1, q2, k, h):
        return _default_velocity_stack(self, env, q1, q2, k, h)


def dims_of(model: Model, env: "Environment") -> Dims:
    return Dims(nq=model.nq, nu=model.nu, nw=model.nw, nc=model.nc,
                nf=env.friction_dim, ne=env.dim)


def lagrangian_derivatives(model: Model, q, v):
    """model.jl:12-16: D1L = -C(q, v), D2L = M(q) v."""
    d1 = -model.bias(q, v)
    d2 = model.mass_matrix(q) @ v
    return d1, d2


def dynamics(model: Model, h, q0, q1, u1, w1, lam1, q2):
    """Discrete Euler–Lagrange residual (model.jl:18-36).

    ``lam1`` is the generalized contact impulse Λ1 = Jᵀλ1 (already mapped
    into configuration space).
    """
    h = jnp.reshape(jnp.asarray(h, jnp.result_type(q1)), ())
    qm1 = 0.5 * (q0 + q1)
    vm1 = (q1 - q0) / h
    qm2 = 0.5 * (q1 + q2)
    vm2 = (q2 - q1) / h

    d1l1, d2l1 = lagrangian_derivatives(model, qm1, vm1)
    d1l2, d2l2 = lagrangian_derivatives(model, qm2, vm2)

    return (0.5 * h * d1l1 + d2l1 + 0.5 * h * d1l2 - d2l2
            + model.control_jacobian(qm2).T @ u1
            + model.disturbance_jacobian(qm2).T @ w1
            + lam1
            + model.damping_force(h, vm2))


# ---------------------------------------------------------------------------
# Contact-space helpers (src/simulation/contact_methods.jl)
# ---------------------------------------------------------------------------

def e_mapping(dims: Dims, dtype) -> jnp.ndarray:
    """E: (nc, nb) block-ones duplication matrix (simulation.jl:127-131)."""
    return jnp.kron(jnp.eye(dims.nc, dtype=dtype),
                    jnp.ones((1, dims.nf), dtype=dtype))


def contact_forces(model: Model, env: "Environment", gamma1, b1, q2, k):
    """World-frame contact forces, shape (nc * ne,); dispatches to the
    model's override when present (contact_methods.jl:27-40)."""
    return model.contact_forces(env, gamma1, b1, q2, k)


def velocity_stack(model: Model, env: "Environment", q1, q2, k, h):
    """Tangential contact-velocity stack, shape (nb,); dispatches to the
    model's override when present (contact_methods.jl:42-56)."""
    return model.velocity_stack(env, q1, q2, k, h)


def _default_contact_forces(model: Model, env: "Environment",
                            gamma1, b1, q2, k):
    """Rotate per-contact surface-frame forces into the world frame."""
    fm = env.friction_mapping(jnp.result_type(q2))

    def one(ki, bi, gi):
        rot = env.rotation(ki[: env.dim - 1])
        if env.cone == "linearized":
            f_surf = jnp.concatenate([fm @ bi, gi[None]])
        else:
            f_surf = jnp.concatenate([bi, gi[None]])
        return rot.T @ f_surf

    nb_per = b1.reshape(model.nc, -1)
    return jax.vmap(one)(k, nb_per, gamma1).reshape(-1)


def _default_velocity_stack(model: Model, env: "Environment", q1, q2, k, h):
    """Surface-frame tangential velocities via the contact Jacobian."""
    h = jnp.reshape(jnp.asarray(h, jnp.result_type(q2)), ())
    v = model.contact_jacobian(q2) @ (q2 - q1) / h
    v = v.reshape(model.nc, env.dim)

    def one(ki, vi):
        v_surf = env.rotation(ki[: env.dim - 1]) @ vi
        vt = v_surf[: env.dim - 1]
        if env.cone == "linearized":
            return jnp.concatenate([vt, -vt])
        return vt

    return jax.vmap(one)(k, v).reshape(-1)
