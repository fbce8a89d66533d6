"""PushBot: inverted pendulum between two walls (push recovery).

JAX re-implementation of
``/root/reference/src/dynamics/pushbot/model.jl``. q = (θ, d) where d is
the end-effector slider along the pole; two contacts against walls at
x = ±0.5. Custom φ (wall gaps) and contact Jacobian (rotated slider
Jacobian) override the height-field defaults.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Model


class PushBot(Model):
    """pushbot/model.jl:4-22, :119-138."""

    nq, nu, nw, nc = 2, 2, 2, 2

    def __init__(self, mb=1.0, ma=0.01, length=1.0, mu_world=0.5,
                 mu_joint=10.0, g=9.81):
        self.mb = mb
        self.ma = ma
        self.l = length
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = (mu_joint, mu_joint)

    def _kin_d(self, q):
        """pushbot/model.jl:26-40 (:d mode)."""
        th, d = q[0], q[1]
        return jnp.stack([-self.l * jnp.sin(th) + d * jnp.cos(th),
                          self.l * jnp.cos(th) + d * jnp.sin(th)])

    def _jac_d(self, q):
        th, d = q[0], q[1]
        return jnp.stack([
            jnp.stack([-self.l * jnp.cos(th) - d * jnp.sin(th),
                       jnp.cos(th)]),
            jnp.stack([-self.l * jnp.sin(th) + d * jnp.cos(th),
                       jnp.sin(th)]),
        ])

    def kinematics(self, q):
        k = self._kin_d(q)
        return jnp.stack([k, k])

    def lagrangian(self, q, v):
        """pushbot/model.jl:66-78."""
        th = q[0]
        jc = jnp.stack([
            jnp.stack([-self.l * jnp.cos(th), jnp.zeros((), q.dtype)]),
            jnp.stack([-self.l * jnp.sin(th), jnp.zeros((), q.dtype)]),
        ])
        vth = jc @ v
        lag = 0.5 * self.mb * jnp.dot(vth, vth)
        lag -= self.mb * self.g * self.l * jnp.cos(th)
        vd = self._jac_d(q) @ v
        lag += 0.5 * self.ma * jnp.dot(vd, vd)
        lag -= self.ma * self.g * self._kin_d(q)[1]
        return lag

    def phi(self, env, q):
        """Wall gaps at x = ±0.5 (pushbot/model.jl:88-92)."""
        x = self._kin_d(q)[0]
        return jnp.stack([x + 0.5, 0.5 - x])

    def contact_jacobian(self, q):
        """pushbot/model.jl:100-106."""
        jd = self._jac_d(q)
        r1 = jnp.asarray([[0.0, -1.0], [1.0, 0.0]], q.dtype)
        r2 = jnp.asarray([[0.0, 1.0], [-1.0, 0.0]], q.dtype)
        return jnp.concatenate([r1 @ jd, r2 @ jd], axis=0)

    def control_jacobian(self, q):
        """pushbot/model.jl:108-111."""
        return jnp.asarray([[self.l, 1.0], [1.0, 1.0 / self.l]], q.dtype)

    def disturbance_jacobian(self, q):
        return jnp.eye(2, dtype=q.dtype)


pushbot = PushBot()
