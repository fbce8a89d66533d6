"""Rotation utilities: quaternions, modified Rodrigues parameters, Euler.

JAX re-implementation of
``/root/reference/src/dynamics/{quaternions,mrp,euler}.jl``.
Quaternions are (w, x, y, z).
"""

from __future__ import annotations

import jax.numpy as jnp


def skew(v):
    z = jnp.zeros((), v.dtype)
    return jnp.stack([
        jnp.stack([z, -v[2], v[1]]),
        jnp.stack([v[2], z, -v[0]]),
        jnp.stack([-v[1], v[0], z]),
    ])


def conjugate(q):
    """quaternions.jl:10-15."""
    return jnp.concatenate([q[:1], -q[1:]])


def l_multiply(q):
    """Left-multiplication matrix (quaternions.jl:17-24)."""
    s, v = q[0], q[1:]
    top = jnp.concatenate([q[:1], -v])[None, :]
    bottom = jnp.concatenate([v[:, None], s * jnp.eye(3, dtype=q.dtype)
                              + skew(v)], axis=1)
    return jnp.concatenate([top, bottom], axis=0)


def r_multiply(q):
    """Right-multiplication matrix (quaternions.jl:26-33)."""
    s, v = q[0], q[1:]
    top = jnp.concatenate([q[:1], -v])[None, :]
    bottom = jnp.concatenate([v[:, None], s * jnp.eye(3, dtype=q.dtype)
                              - skew(v)], axis=1)
    return jnp.concatenate([top, bottom], axis=0)


def multiply(q1, q2):
    return l_multiply(q1) @ q2


def attitude_jacobian(q):
    """quaternions.jl:36-43 (planning-with-attitude eq. 14)."""
    s, v = q[0], q[1:]
    return jnp.concatenate([-v[None, :],
                            s * jnp.eye(3, dtype=q.dtype) + skew(v)],
                           axis=0)


def quaternion_rotation_matrix(q):
    """Rotation matrix of a unit quaternion."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)]),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)]),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)]),
    ])


def mrp_quaternion_map(mrp):
    """mrp.jl:1-6."""
    n2 = jnp.dot(mrp, mrp)
    m = 2.0 / (1.0 + n2)
    return jnp.concatenate([((1.0 - n2) / (1.0 + n2))[None], m * mrp])


def mrp_rotation_matrix(mrp):
    """mrp.jl:8 — matches Rotations.jl MRP convention."""
    return quaternion_rotation_matrix(mrp_quaternion_map(mrp))


def euler_rotation_matrix(euler):
    """ZYX Euler (roll-pitch-yaw) rotation matrix (euler.jl)."""
    r, p, y = euler[0], euler[1], euler[2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    rz = jnp.stack([jnp.stack([cy, -sy, 0 * cy]),
                    jnp.stack([sy, cy, 0 * cy]),
                    jnp.stack([0 * cy, 0 * cy, 1 + 0 * cy])])
    ry = jnp.stack([jnp.stack([cp, 0 * cp, sp]),
                    jnp.stack([0 * cp, 1 + 0 * cp, 0 * cp]),
                    jnp.stack([-sp, 0 * cp, cp])])
    rx = jnp.stack([jnp.stack([1 + 0 * cr, 0 * cr, 0 * cr]),
                    jnp.stack([0 * cr, cr, -sr]),
                    jnp.stack([0 * cr, sr, cr])])
    return rz @ ry @ rx
