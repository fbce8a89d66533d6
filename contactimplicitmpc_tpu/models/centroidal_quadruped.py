"""Centroidal quadruped: 3D single rigid body + four point feet.

JAX re-implementation of
``/root/reference/src/dynamics/centroidal_quadruped/model.jl``.

Configuration (model.jl:1-10)::

    q = (p_body (3), euler_body (3), f1 (3), f2 (3), f3 (3), f4 (3))

Controls are world-frame forces at the four feet, mapped to body
wrench + foot reactions through B (model.jl:96-119). The bias includes
the gyroscopic term ω × I ω with Euler rates standing in for body rates
(model.jl:75-84).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import Model
from .rotations import euler_rotation_matrix, skew


class CentroidalQuadruped(Model):
    """model.jl:11-32, :186-208 (nominal instance)."""

    nq, nu, nw, nc = 18, 12, 3, 4

    def __init__(self, mass_body=13.5, inertia_scaling=10.0, mass_foot=0.2,
                 mu_world=0.3, mu_joint=1.0, g=9.81, damped=True):
        self.mass_body = mass_body
        self.inertia_body = np.diag([0.0178533, 0.0377999, 0.0456542]) \
            * inertia_scaling
        self.mass_foot = mass_foot
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        if damped:
            self.joint_friction = tuple(
                mu_joint * np.concatenate(
                    [10 * np.ones(3), 30 * np.ones(3), 10 * np.ones(12)]))
        else:
            self.joint_friction = tuple(np.zeros(18))

    def kinematics(self, q):
        """Foot positions, (4, 3) (model.jl:60-62)."""
        return q[6:].reshape(4, 3)

    def lagrangian(self, q, v):
        m = self.mass_matrix(q)
        pe = self.g * (self.mass_body * q[2]
                       + self.mass_foot * jnp.sum(q[8::3]))
        return 0.5 * jnp.dot(v, m @ v) - pe

    def mass_matrix(self, q):
        """model.jl:66-74."""
        diag = jnp.concatenate([
            self.mass_body * jnp.ones(3),
            jnp.zeros(3),
            self.mass_foot * jnp.ones(12)]).astype(q.dtype)
        m = jnp.diag(diag)
        return m.at[3:6, 3:6].set(
            jnp.asarray(self.inertia_body, q.dtype))

    def bias(self, q, v):
        """model.jl:76-85 — gravity + gyroscopic term."""
        inertia = jnp.asarray(self.inertia_body, q.dtype)
        om = v[3:6]
        gyro = skew(om) @ (inertia @ om)
        g_body = jnp.asarray([0.0, 0.0, self.mass_body * self.g], q.dtype)
        g_foot = jnp.asarray([0.0, 0.0, self.mass_foot * self.g], q.dtype)
        return jnp.concatenate([g_body, gyro] + [g_foot] * 4)

    def phi(self, env, q):
        """Foot heights (model.jl:87-96) — flat-ground variant."""
        return q[8::3]

    def control_jacobian(self, q):
        """model.jl:98-119 — foot forces to generalized forces."""
        dtype = q.dtype
        rot = euler_rotation_matrix(q[3:6])
        p = q[:3]
        eye = jnp.eye(3, dtype=dtype)
        z3 = jnp.zeros((3, 3), dtype)
        rows = []
        for i in range(4):
            r_i = q[6 + 3 * i:9 + 3 * i] - p
            foot_blocks = [z3] * 4
            foot_blocks[i] = -eye
            rows.append(jnp.concatenate(
                [eye, rot.T @ skew(r_i)] + foot_blocks, axis=1))
        return jnp.concatenate(rows, axis=0)

    def disturbance_jacobian(self, q):
        return jnp.eye(3, 18, dtype=q.dtype)

    def contact_jacobian(self, q):
        """model.jl:126-135 — feet are their own coordinates."""
        eye12 = jnp.eye(12, dtype=q.dtype)
        return jnp.concatenate([jnp.zeros((12, 6), q.dtype), eye12], axis=1)


centroidal_quadruped = CentroidalQuadruped()
centroidal_quadruped_undamped = CentroidalQuadruped(damped=False)


def relative_state_cost(qbody, qorientation, qfoot, dtype=jnp.float64):
    """Coupled body/feet tracking weights (model.jl:167-183): penalizes
    foot positions relative to the body. Returns an (18, 18) matrix for
    use as a dense q-cost block."""
    q = jnp.zeros((18, 18), dtype)
    q = q.at[:3, :3].set(jnp.diag(jnp.asarray(qbody, dtype)))
    q = q.at[3:6, 3:6].set(jnp.diag(jnp.asarray(qorientation, dtype)))
    foot = jnp.diag(jnp.asarray(qfoot, dtype))
    for i in range(4):
        s = 6 + 3 * i
        q = q.at[:3, :3].add(foot)
        q = q.at[s:s + 3, s:s + 3].add(foot)
        q = q.at[:3, s:s + 3].add(-foot)
        q = q.at[s:s + 3, :3].add(-foot)
    return q
