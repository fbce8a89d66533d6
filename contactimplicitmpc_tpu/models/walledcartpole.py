"""Walled cartpole: pole tip confined between two compliant walls.

JAX re-implementation of
``/root/reference/src/dynamics/walledcartpole/model.jl``.
q = (θ, x, xw1, xw2): pole angle, cart position, and the two wall
deflections (spring-loaded with stiffness k).
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import Model


class WalledCartpole(Model):
    """walledcartpole/model.jl:16-38, :144-162."""

    nq, nu, nw, nc = 4, 1, 4, 2

    def __init__(self, mb=0.978, mt=0.411, mw=0.1, length=0.6, lc=0.4267,
                 w=0.35, k=50.0, mu_world=0.1, mu_joint=1.0, g=9.81):
        self.mb = mb
        self.mt = mt
        self.mw = mw
        self.l = length
        self.lc = lc
        self.w = w
        self.k = k
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = (0.0, mu_joint, 3.0 * mu_joint, 3.0 * mu_joint)

    def _tip(self, q):
        th, x = q[0], q[1]
        return jnp.stack([x - self.l * jnp.sin(th),
                          self.l * jnp.cos(th)])

    def kinematics(self, q):
        k = self._tip(q)
        return jnp.stack([k, k])

    def lagrangian(self, q, v):
        """walledcartpole/model.jl:75-99."""
        th = q[0]
        xw1, xw2 = q[2], q[3]
        om, xd, w1d, w2d = v[0], v[1], v[2], v[3]
        ke = (0.5 * (self.mt + self.mb) * xd ** 2
              - self.mt * xd * om * self.lc * jnp.cos(th)
              + 0.5 * self.mt * self.lc ** 2 * om ** 2)
        ke = ke + 0.5 * self.mw * (w1d ** 2 + w2d ** 2)
        pe = self.mt * self.g * self.lc * jnp.cos(th)
        pe = pe + self.k * (xw1 ** 2 + xw2 ** 2)
        return ke - pe

    def phi(self, env, q):
        """Gap to each (deflected) wall (walledcartpole/model.jl:101-110)."""
        x_tip = self._tip(q)[0]
        return jnp.stack([x_tip - q[2] + self.w,
                          self.w + q[3] - x_tip])

    def contact_jacobian(self, q):
        """walledcartpole/model.jl:112-118."""
        th = q[0]
        z = jnp.zeros((), q.dtype)
        o = jnp.ones((), q.dtype)
        jt = jnp.stack([
            jnp.stack([-self.l * jnp.cos(th), o, z, z]),
            jnp.stack([-self.l * jnp.sin(th), z, z, z]),
        ])
        w1 = jnp.asarray([[0.0, 0.0, -1.0, 0.0], [0.0, 0.0, 0.0, 0.0]],
                         q.dtype)
        w2 = jnp.asarray([[0.0, 0.0, 0.0, -1.0], [0.0, 0.0, 0.0, 0.0]],
                         q.dtype)
        r1 = jnp.asarray([[0.0, -1.0], [1.0, 0.0]], q.dtype)
        r2 = jnp.asarray([[0.0, 1.0], [-1.0, 0.0]], q.dtype)
        return jnp.concatenate([r1 @ (jt + w1), r2 @ (jt + w2)], axis=0)

    def control_jacobian(self, q):
        return jnp.asarray([[0.0, 1.0, 0.0, 0.0]], q.dtype)

    def disturbance_jacobian(self, q):
        return jnp.eye(4, dtype=q.dtype)


walledcartpole = WalledCartpole()
