"""3D hopper with MRP orientation.

JAX re-implementation of
``/root/reference/src/dynamics/hopper_3D/model.jl``.
q = (px, py, pz, mrp_x, mrp_y, mrp_z, r): body position, modified
Rodrigues parameters, leg length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .base import Model
from .rotations import mrp_rotation_matrix


class Hopper3D(Model):
    """hopper_3D/model.jl:7-28, :96-120."""

    nq, nu, nw, nc = 7, 3, 3, 1

    def __init__(self, mb=3.0, ml=0.3, Jb=0.75, Jl=0.075,
                 mu_world=1.5, mu_joint=0.0, g=9.81):
        self.mb = mb
        self.ml = ml
        self.Jb = Jb
        self.Jl = Jl
        self.mu_world = mu_world
        self.mu_joint = mu_joint
        self.g = g
        self.joint_friction = tuple([0.0] * 7)

    def kinematics(self, q):
        """Foot position (hopper_3D/model.jl:32-37)."""
        rot = mrp_rotation_matrix(q[3:6])
        foot = q[:3] + rot @ jnp.stack(
            [jnp.zeros((), q.dtype), jnp.zeros((), q.dtype), -q[6]])
        return foot[None, :]

    def lagrangian(self, q, v):
        m = jnp.asarray([self.mb + self.ml] * 3
                        + [self.Jb + self.Jl] * 3 + [self.ml], q.dtype)
        return 0.5 * jnp.dot(v, m * v) - (self.mb + self.ml) * self.g * q[2]

    def mass_matrix(self, q):
        """hopper_3D/model.jl:40-44."""
        return jnp.diag(jnp.asarray(
            [self.mb + self.ml] * 3 + [self.Jb + self.Jl] * 3 + [self.ml],
            q.dtype))

    def bias(self, q, v):
        """hopper_3D/model.jl:46-48."""
        c = jnp.zeros((7,), q.dtype)
        return c.at[2].set((self.mb + self.ml) * self.g)

    def control_jacobian(self, q):
        """hopper_3D/model.jl:55-61 — torques in body frame + leg force."""
        rot = mrp_rotation_matrix(q[3:6])
        z3 = jnp.zeros((3,), q.dtype)
        row1 = jnp.concatenate([z3, rot[:, 0], jnp.zeros((1,), q.dtype)])
        row2 = jnp.concatenate([z3, rot[:, 1], jnp.zeros((1,), q.dtype)])
        row3 = jnp.concatenate([rot[:, 2], z3, jnp.ones((1,), q.dtype)])
        return jnp.stack([row1, row2, row3])

    def disturbance_jacobian(self, q):
        return jnp.eye(3, 7, dtype=q.dtype)

    def contact_jacobian(self, q):
        """hopper_3D/model.jl:71-74 — autodiff of foot kinematics."""
        return jax.jacfwd(lambda qq: self.kinematics(qq).reshape(-1))(q)


hopper_3d = Hopper3D()
