"""Tracking objectives for the horizon Newton solve.

JAX redesign of the reference's ``src/controller/objective.jl``.
Weights are stored as per-knot diagonal vectors (the reference uses
``Diagonal`` matrices) stacked along the horizon.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

from ..dims import Dims


class TrackingObjective(NamedTuple):
    """objective.jl:3-16. Diagonal weights, shape (H, n_*)."""

    q: jnp.ndarray
    u: jnp.ndarray
    gamma: jnp.ndarray
    b: jnp.ndarray


class TrackingVelocityObjective(NamedTuple):
    """objective.jl:18-47: adds a finite-difference velocity penalty
    ``vᵀ diag(v_w) v`` with targets."""

    q: jnp.ndarray
    v: jnp.ndarray
    u: jnp.ndarray
    gamma: jnp.ndarray
    b: jnp.ndarray
    v_target: jnp.ndarray
    q_target: jnp.ndarray


def tracking_objective(dims: Dims, horizon: int, q=None, u=None, gamma=None,
                       b=None, dtype=jnp.float64) -> TrackingObjective:
    def mk(x, n):
        if x is None:
            return jnp.zeros((horizon, n), dtype)
        x = jnp.asarray(np.asarray(x), dtype)
        if x.ndim == 1:
            x = jnp.broadcast_to(x[None, :], (horizon, n))
        return x

    return TrackingObjective(q=mk(q, dims.nq), u=mk(u, dims.nu),
                             gamma=mk(gamma, dims.nc), b=mk(b, dims.nb))


def tracking_velocity_objective(dims: Dims, horizon: int, q=None, v=None,
                                u=None, gamma=None, b=None, v_target=None,
                                dtype=jnp.float64) -> TrackingVelocityObjective:
    def mk(x, n):
        if x is None:
            return jnp.zeros((horizon, n), dtype)
        x = jnp.asarray(np.asarray(x), dtype)
        if x.ndim == 1:
            x = jnp.broadcast_to(x[None, :], (horizon, n))
        return x

    vt = mk(v_target, dims.nq)
    # q_target = cumulative integral of v_target (objective.jl:36-45)
    if v_target is None:
        qt = jnp.zeros((horizon, dims.nq), dtype)
    else:
        qt = jnp.concatenate(
            [jnp.zeros((1, dims.nq), dtype), jnp.cumsum(vt[:-1], axis=0)],
            axis=0)
    return TrackingVelocityObjective(q=mk(q, dims.nq), v=mk(v, dims.nq),
                                     u=mk(u, dims.nu), gamma=mk(gamma, dims.nc),
                                     b=mk(b, dims.nb), v_target=vt, q_target=qt)
