"""Planar quadruped (~Unitree A1), 11-DoF, 4 contact feet.

JAX re-implementation of
``/root/reference/src/dynamics/quadruped/model.jl``. The reference builds
kinematics/Jacobians by hand and codegens everything through Symbolics;
here the link kinematics are small traced JAX functions and the com
Jacobians come from ``jax.jacfwd`` — numerically identical, no codegen.

Configuration (model.jl:500-503)::

    q = [x, z, θ_torso, θ_thigh1, θ_calf1, θ_thigh2, θ_calf2,
         θ_thigh3, θ_calf3, θ_thigh4, θ_calf4]

Legs 1/2 hang from the hip point (x, z); legs 3/4 hang from the torso tip.
All angles are absolute (world frame).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import Model


class Quadruped(Model):
    """model.jl:1-66 (fields), :555-569 (nominal instance)."""

    nq, nu, nw, nc = 11, 8, 2, 4

    def __init__(self, g=9.81, mu_world=1.0, mu_joint=0.1,
                 m_payload=0.0, j_payload=0.0):
        self.g = g
        self.mu_world = mu_world
        self.mu_joint = mu_joint

        # ~Unitree A1 parameters (model.jl:512-535)
        self.m_torso = 4.713 + 4 * 0.696 + m_payload
        self.m_thigh = 1.013
        self.m_calf = 0.166
        self.j_torso = 0.01683 + 4 * 0.696 * 0.183 ** 2 + j_payload
        self.j_thigh = 0.00552
        self.j_calf = 0.00299
        self.l_torso = 0.183 * 2
        self.l_thigh = 0.2
        self.l_calf = 0.2
        self.d_torso = 0.5 * self.l_torso + 0.0127
        self.d_thigh = 0.5 * self.l_thigh - 0.00323
        self.d_calf = 0.5 * self.l_calf - 0.006435

        self.joint_friction = tuple([0.0] * 3 + [mu_joint] * 8)

    # ---- link kinematics (model.jl:75-270) ----------------------------
    @staticmethod
    def _link(p, r, theta):
        return p + r * jnp.stack([jnp.sin(theta), -jnp.cos(theta)])

    def _com_positions(self, q):
        """Center-of-mass position of each of the 9 bodies."""
        hip = q[:2]
        torso = self._link(hip, self.d_torso, q[2])
        torso_ee = self._link(hip, self.l_torso, q[2])
        coms = [torso]
        # legs 1, 2 from the hip; legs 3, 4 from the torso tip
        for root, (i_th, i_ca) in ((hip, (3, 4)), (hip, (5, 6)),
                                   (torso_ee, (7, 8)), (torso_ee, (9, 10))):
            coms.append(self._link(root, self.d_thigh, q[i_th]))
            knee = self._link(root, self.l_thigh, q[i_th])
            coms.append(self._link(knee, self.d_calf, q[i_ca]))
        return jnp.stack(coms)  # (9, 2)

    def kinematics(self, q):
        """Foot (calf end-effector) positions, (4, 2)
        (model.jl:410-417)."""
        hip = q[:2]
        torso_ee = self._link(hip, self.l_torso, q[2])
        feet = []
        for root, (i_th, i_ca) in ((hip, (3, 4)), (hip, (5, 6)),
                                   (torso_ee, (7, 8)), (torso_ee, (9, 10))):
            knee = self._link(root, self.l_thigh, q[i_th])
            feet.append(self._link(knee, self.l_calf, q[i_ca]))
        return jnp.stack(feet)

    # ---- mechanics -----------------------------------------------------
    def lagrangian(self, q, v):
        """model.jl:277-372."""
        masses = jnp.asarray(
            [self.m_torso] + [self.m_thigh, self.m_calf] * 4, q.dtype)
        inertias = jnp.asarray(
            [self.j_torso] + [self.j_thigh, self.j_calf] * 4, q.dtype)
        coms_fn = self._com_positions
        jac = jax.jacfwd(coms_fn)(q)          # (9, 2, nq)
        vel = jac @ v                          # (9, 2)
        ke = 0.5 * jnp.sum(masses * jnp.sum(vel * vel, axis=1))
        ke = ke + 0.5 * jnp.sum(inertias * v[2:] ** 2)
        pe = self.g * jnp.sum(masses * coms_fn(q)[:, 1])
        return ke - pe

    def mass_matrix(self, q):
        """model.jl:421-463: Σ mᵢ JᵢᵀJᵢ + rotational inertias."""
        masses = jnp.asarray(
            [self.m_torso] + [self.m_thigh, self.m_calf] * 4, q.dtype)
        inertias = jnp.asarray(
            [0.0, 0.0, self.j_torso] + [self.j_thigh, self.j_calf] * 4,
            q.dtype)
        jac = jax.jacfwd(self._com_positions)(q)  # (9, 2, nq)
        m = jnp.einsum("b,bin,bim->nm", masses, jac, jac)
        return m + jnp.diag(inertias)

    def control_jacobian(self, q):
        """model.jl:489-498 — relative joint torques."""
        b = np.zeros((8, 11))
        pairs = [(2, 3), (3, 4), (2, 5), (5, 6), (2, 7), (7, 8), (2, 9),
                 (9, 10)]
        for row, (parent, child) in enumerate(pairs):
            b[row, parent] = -1.0
            b[row, child] = 1.0
        return jnp.asarray(b, q.dtype)

    def disturbance_jacobian(self, q):
        """model.jl:500-503."""
        return jnp.eye(2, 11, dtype=q.dtype)

    def contact_jacobian(self, q):
        """model.jl:505-463 — stacked foot Jacobians (8, 11)."""
        return jax.jacfwd(lambda qq: self.kinematics(qq).reshape(-1))(q)


def initial_configuration(model: Quadruped, theta0, theta1, theta2, theta3,
                          x, dz):
    """Kinematically-consistent standing pose from leg angles — the
    reference's Monte-Carlo initial-state distribution
    (``examples/quadruped/monte_carlo.jl:94-116``): legs 1/3 posed at
    (−θ1, θ2), body height from their kinematics, legs 2/4 solved by
    ``acos`` to touch the same ground, then the body is pitched by θ0 and
    lifted by Δz. Sampling ranges upstream (monte_carlo.jl:80-84):
    θ0∈[0,0.05], θ1..θ3∈[0.6,0.8], x∈[−0.2,0.2], Δz∈[0,0.1]."""
    z = model.l_thigh * jnp.cos(-theta1) + model.l_calf * jnp.cos(theta2)
    calf_bd = jnp.arccos(jnp.clip(
        (z - model.l_thigh * jnp.cos(-theta3)) / model.l_calf, -1.0, 1.0))
    pi_2 = jnp.pi / 2.0
    return jnp.stack([
        x, z + dz, pi_2 + theta0,
        -theta1, theta2,          # leg 1
        -theta3, calf_bd,         # leg 2
        -theta1, theta2,          # leg 3
        -theta3, calf_bd,         # leg 4
    ])


quadruped = Quadruped()
quadruped_payload = Quadruped(m_payload=3.0, j_payload=0.03)
