"""Flamingo: planar 9-DoF biped with feet (toe + heel contacts).

JAX re-implementation of
``/root/reference/src/dynamics/flamingo/model.jl``.

Configuration (model.jl:455-460)::

    q = [x, z, θ_torso, θ_thigh1, θ_calf1, θ_thigh2, θ_calf2,
         θ_foot1, θ_foot2]

The torso points up (kinematics_1 torso branch negates the sine terms,
model.jl:61-93); contacts are [toe1, heel1, toe2, heel2].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import Model


class Flamingo(Model):
    """model.jl:1-58 (fields), :459-500 (nominal instance)."""

    nq, nu, nw, nc = 9, 6, 2, 4

    def __init__(self, g=9.81, mu_world=0.9, mu_joint=0.0):
        self.g = g
        self.mu_world = mu_world
        self.mu_joint = mu_joint

        self.m_torso, self.m_thigh = 12.0, 0.4598
        self.m_calf, self.m_foot = 0.306, 0.3466
        self.l_torso, self.l_thigh = 0.385, 0.42
        self.l_calf, self.l_foot = 0.45, 0.1725
        self.d_torso, self.d_thigh = 0.20, 0.21
        self.d_calf, self.d_foot = 0.225, 0.0525
        self.j_torso, self.j_thigh = 0.10, 0.01256
        self.j_calf, self.j_foot = 0.00952, 0.0015

        self.joint_friction = tuple([0.0] * 9)

    @staticmethod
    def _down(p, r, theta):
        return p + r * jnp.stack([jnp.sin(theta), -jnp.cos(theta)])

    def _ankles(self, q):
        hip = q[:2]
        a1 = self._down(self._down(hip, self.l_thigh, q[3]),
                        self.l_calf, q[4])
        a2 = self._down(self._down(hip, self.l_thigh, q[5]),
                        self.l_calf, q[6])
        return a1, a2

    def _com_positions(self, q):
        """Bodies: torso, thigh1, calf1, foot1, thigh2, calf2, foot2."""
        hip = q[:2]
        torso = hip + self.d_torso * jnp.stack(
            [-jnp.sin(q[2]), jnp.cos(q[2])])
        cb = 0.5 * (self.l_foot - self.d_foot)
        coms = [torso]
        for i_th, i_ca, i_ft in ((3, 4, 7), (5, 6, 8)):
            thigh = self._down(hip, self.d_thigh, q[i_th])
            knee = self._down(hip, self.l_thigh, q[i_th])
            calf = self._down(knee, self.d_calf, q[i_ca])
            ankle = self._down(knee, self.l_calf, q[i_ca])
            foot = self._down(ankle, cb, q[i_ft])
            coms.extend([thigh, calf, foot])
        return jnp.stack(coms)  # (7, 2)

    def kinematics(self, q):
        """[toe1, heel1, toe2, heel2] positions (model.jl:342-349)."""
        a1, a2 = self._ankles(q)
        pts = [self._down(a1, self.l_foot, q[7]),
               self._down(a1, -self.d_foot, q[7]),
               self._down(a2, self.l_foot, q[8]),
               self._down(a2, -self.d_foot, q[8])]
        return jnp.stack(pts)

    def lagrangian(self, q, v):
        """model.jl:259-328."""
        masses = jnp.asarray(
            [self.m_torso, self.m_thigh, self.m_calf, self.m_foot,
             self.m_thigh, self.m_calf, self.m_foot], q.dtype)
        # rotational DoF of each body in q order: torso=2, thigh1=3,
        # calf1=4, foot1=7, thigh2=5, calf2=6, foot2=8
        rot_idx = jnp.asarray([2, 3, 4, 7, 5, 6, 8])
        inertias = jnp.asarray(
            [self.j_torso, self.j_thigh, self.j_calf, self.j_foot,
             self.j_thigh, self.j_calf, self.j_foot], q.dtype)
        jac = jax.jacfwd(self._com_positions)(q)
        vel = jac @ v
        ke = 0.5 * jnp.sum(masses * jnp.sum(vel * vel, axis=1))
        ke = ke + 0.5 * jnp.sum(inertias * v[rot_idx] ** 2)
        pe = self.g * jnp.sum(masses * self._com_positions(q)[:, 1])
        return ke - pe

    def mass_matrix(self, q):
        """model.jl:352-389."""
        masses = jnp.asarray(
            [self.m_torso, self.m_thigh, self.m_calf, self.m_foot,
             self.m_thigh, self.m_calf, self.m_foot], q.dtype)
        diag = np.zeros(9)
        for j, idx in zip([self.j_torso, self.j_thigh, self.j_calf,
                           self.j_foot, self.j_thigh, self.j_calf,
                           self.j_foot], [2, 3, 4, 7, 5, 6, 8]):
            diag[idx] += j
        jac = jax.jacfwd(self._com_positions)(q)
        m = jnp.einsum("b,bin,bim->nm", masses, jac, jac)
        return m + jnp.diag(jnp.asarray(diag, q.dtype))

    def control_jacobian(self, q):
        """model.jl:404-411 — relative torques: hips, knees, ankles."""
        b = np.zeros((6, 9))
        pairs = [(2, 3), (3, 4), (2, 5), (5, 6), (4, 7), (6, 8)]
        for row, (parent, child) in enumerate(pairs):
            b[row, parent] = -1.0
            b[row, child] = 1.0
        return jnp.asarray(b, q.dtype)

    def disturbance_jacobian(self, q):
        """model.jl:413-416."""
        return jnp.eye(2, 9, dtype=q.dtype)

    def contact_jacobian(self, q):
        """model.jl:418-429 — stacked toe/heel Jacobians (8, 9)."""
        return jax.jacfwd(lambda qq: self.kinematics(qq).reshape(-1))(q)


flamingo = Flamingo()
