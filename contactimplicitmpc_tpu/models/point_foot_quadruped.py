"""Point-foot quadruped (120 Hz variant): centroidal body + four feet
with orientation damping and springs.

JAX re-implementation of
``/root/reference/src/dynamics/point_foot_quadruped/model.jl`` (V1
parameter set: orientation friction 5, orientation spring 0.5, no joint
springs/friction). The model overrides the integrator damping with
relative body↔foot damping + orientation friction
(model.jl:230-241).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import Model
from .centroidal_quadruped import CentroidalQuadruped
from .rotations import skew


class PointFootQuadruped(CentroidalQuadruped):
    """point_foot_quadruped/model.jl:1-40, :244-294."""

    def __init__(self, body_height=0.3, foot_x=0.17, foot_y=0.15,
                 mass_body=13.5, mass_foot=0.2, mu_world=0.3, g=9.81,
                 joint_friction_gain=0.0, spring_stiffness_joint=0.0,
                 orientation_friction=5.0,
                 spring_stiffness_orientation=0.5):
        super().__init__(mass_body=mass_body, inertia_scaling=1.0,
                         mass_foot=mass_foot, mu_world=mu_world,
                         mu_joint=0.0, g=g, damped=False)
        self.body_height = body_height
        self.foot_x = foot_x
        self.foot_y = foot_y
        self.joint_friction_gain = joint_friction_gain
        self.spring_stiffness_joint = spring_stiffness_joint
        self.orientation_friction = orientation_friction
        self.spring_stiffness_orientation = spring_stiffness_orientation

    def _offsets(self, dtype):
        fx, fy, bh = self.foot_x, self.foot_y, self.body_height
        return jnp.asarray([[fx, fy, -bh], [fx, -fy, -bh],
                            [-fx, fy, -bh], [-fx, -fy, -bh]], dtype)

    def bias(self, q, v):
        """model.jl:82-100 — gravity, gyroscopic, joint/orientation
        springs."""
        dtype = q.dtype
        inertia = jnp.asarray(self.inertia_body, dtype)
        om = v[3:6]
        gyro = skew(om) @ (inertia @ om)
        ks = self.spring_stiffness_joint
        ko = self.spring_stiffness_orientation
        offsets = self._offsets(dtype)
        p, feet = q[:3], q[6:].reshape(4, 3)

        g_body = jnp.asarray([0.0, 0.0, self.mass_body * self.g], dtype)
        body = g_body + ks * (jnp.sum(offsets, axis=0) + 4 * p
                              - jnp.sum(feet, axis=0))
        orient = gyro + ko * q[3:6]
        g_foot = jnp.asarray([0.0, 0.0, self.mass_foot * self.g], dtype)
        foot_rows = g_foot[None, :] + ks * (-offsets + feet - p[None, :])
        return jnp.concatenate([body, orient, foot_rows.reshape(-1)])

    def damping_force(self, h, vm2):
        """model.jl:230-241 — orientation friction + relative body↔foot
        damping."""
        dtype = jnp.result_type(vm2)
        kj = self.joint_friction_gain
        ko = self.orientation_friction
        d = jnp.zeros((18,), dtype)
        v_body, v_or = vm2[:3], vm2[3:6]
        feet_v = vm2[6:].reshape(4, 3)
        d = d.at[3:6].add(-h * ko * v_or)
        rel = v_body[None, :] - feet_v                    # (4, 3)
        d = d.at[:3].add(-h * kj * jnp.sum(rel, axis=0))
        d = d.at[6:].add(-h * kj * (-rel).reshape(-1))
        return d


point_foot_quadruped = PointFootQuadruped()
