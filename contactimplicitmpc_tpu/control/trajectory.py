"""Contact trajectories: the reference/working gait storage of the MPC.

JAX redesign of the reference's ``src/controller/trajectory.jl``.
The reference stores vectors-of-vectors mutated in place; here a
``ContactTraj`` is a NamedTuple of stacked arrays (a pytree), and every
update (rotation, striding, window selection) is a functional array op that
lives happily inside ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dims import Dims
from ..models.base import Model, dims_of, e_mapping
from ..sim.residual import pack_theta, pack_z


class ContactTraj(NamedTuple):
    """trajectory.jl:1-19. Leading axis is the knot index."""

    h: jnp.ndarray        # () time step
    kappa: jnp.ndarray    # () central-path parameter
    q: jnp.ndarray        # (H+2, nq)
    u: jnp.ndarray        # (H, nu)
    w: jnp.ndarray        # (H, nw)
    gamma: jnp.ndarray    # (H, nc)
    b: jnp.ndarray        # (H, nb)
    z: jnp.ndarray        # (H, nz)
    theta: jnp.ndarray    # (H, nθ)

    @property
    def horizon(self) -> int:
        return self.u.shape[0]


def contact_trajectory(dims: Dims, horizon: int, h, kappa=0.0,
                       dtype=jnp.float64) -> ContactTraj:
    """trajectory.jl:21-49 — zero-filled trajectory."""
    theta = jnp.zeros((horizon, dims.ntheta), dtype)
    theta = theta.at[:, dims.ih].set(jnp.asarray(h, dtype))
    return ContactTraj(
        h=jnp.asarray(h, dtype), kappa=jnp.asarray(kappa, dtype),
        q=jnp.zeros((horizon + 2, dims.nq), dtype),
        u=jnp.zeros((horizon, dims.nu), dtype),
        w=jnp.zeros((horizon, dims.nw), dtype),
        gamma=jnp.zeros((horizon, dims.nc), dtype),
        b=jnp.zeros((horizon, dims.nb), dtype),
        z=jnp.zeros((horizon, dims.nz), dtype),
        theta=theta)


def update_z(dims: Dims, traj: ContactTraj) -> ContactTraj:
    """trajectory.jl:51-65 — refresh the (q2, γ1, b1) slots of z."""
    z = traj.z
    z = z.at[:, dims.iq2].set(traj.q[2:])
    z = z.at[:, dims.igamma1].set(traj.gamma)
    z = z.at[:, dims.ib1].set(traj.b)
    return traj._replace(z=z)


def update_theta(dims: Dims, traj: ContactTraj) -> ContactTraj:
    """trajectory.jl:67-82 — refresh (q0, q1, u1, w1) slots of θ."""
    horizon = traj.horizon
    th = traj.theta
    th = th.at[:, dims.iq0].set(traj.q[:horizon])
    th = th.at[:, dims.iq1].set(traj.q[1:horizon + 1])
    th = th.at[:, dims.iu1].set(traj.u)
    th = th.at[:, dims.iw1].set(traj.w)
    return traj._replace(theta=th)


def from_gait(model: Model, env, gait: dict, kappa=0.0,
              update_friction: bool = False,
              dtype=jnp.float64) -> ContactTraj:
    """Build a ContactTraj from a converted gait asset
    (get_trajectory, trajectory.jl:143-185).

    ``update_friction`` replaces the gait's friction coefficient with the
    model's (update_friction_coefficient!, trajectory.jl:133-141).
    """
    dims = dims_of(model, env)
    q = jnp.asarray(np.asarray(gait["q"]), dtype)
    u = jnp.asarray(np.asarray(gait["u"]), dtype)
    gam = jnp.asarray(np.asarray(gait["gamma"]), dtype)
    b = jnp.asarray(np.asarray(gait["b"]), dtype)
    psi = jnp.asarray(np.asarray(gait["psi"]), dtype)
    eta = jnp.asarray(np.asarray(gait["eta"]), dtype)
    h = float(np.asarray(gait["h"]))
    mu_file = float(np.asarray(gait["mu"]))
    mu = model.mu_world if (update_friction or np.isnan(mu_file)) else mu_file

    horizon = u.shape[0]
    w = jnp.zeros((horizon, dims.nw), dtype)

    e = e_mapping(dims, dtype)

    def make_z(qt2, g, bb, ps, et):
        # pack_z (index.jl:437-441): slacks from primals at the *model's* μ
        s1 = model.phi(env, qt2)
        s2 = model.mu_world * g - e @ bb
        return pack_z(qt2, g, bb, ps, s1, et, s2)

    z = jax.vmap(make_z)(q[2:], gam, b, psi, eta)

    def make_theta(q0, q1, ut, wt):
        return pack_theta(q0, q1, ut, wt, mu, h)

    theta = jax.vmap(make_theta)(q[:horizon], q[1:horizon + 1], u, w)

    return ContactTraj(h=jnp.asarray(h, dtype), kappa=jnp.asarray(kappa, dtype),
                       q=q, u=u, w=w, gamma=gam, b=b, z=z, theta=theta)


def repeat_traj(traj: ContactTraj, n: int, idx_shift=()) -> ContactTraj:
    """Tile a gait n times, shifting ``idx_shift`` coordinates by the gait
    stride each period (repeat_ref_traj, trajectory.jl:84-115)."""
    idx = np.asarray(list(idx_shift), np.int32)
    shift = jnp.zeros((traj.q.shape[1],), traj.q.dtype)
    if idx.size:
        shift = shift.at[idx].set(traj.q[-1, idx] - traj.q[1, idx])

    horizon = traj.horizon
    qs = [traj.q]
    for i in range(1, n):
        qs.append(traj.q[2:] + i * shift[None, :])
    q = jnp.concatenate(qs, axis=0)
    tile = lambda x: jnp.concatenate([x] * n, axis=0)
    return ContactTraj(h=traj.h, kappa=traj.kappa, q=q,
                       u=tile(traj.u), w=tile(traj.w), gamma=tile(traj.gamma),
                       b=tile(traj.b), z=tile(traj.z), theta=tile(traj.theta))


def get_stride(model: Model, traj: ContactTraj) -> jnp.ndarray:
    """mpc_utils.jl:103-107 — per-period x-offset of the gait."""
    stride = jnp.zeros((model.nq,), traj.q.dtype)
    return stride.at[0].set(traj.q[-2, 0] - traj.q[0, 0])


def rot_n_stride(dims: Dims, traj: ContactTraj,
                 stride: jnp.ndarray) -> ContactTraj:
    """Receding-horizon shift: rotate one knot and re-tile the wrap-around
    with the stride offset (rotate! + mpc_stride!, mpc_utils.jl:1-101)."""
    q = jnp.roll(traj.q, -1, axis=0)
    roll1 = lambda x: jnp.roll(x, -1, axis=0)
    u, w, gam, b, z, th = map(roll1, (traj.u, traj.w, traj.gamma, traj.b,
                                      traj.z, traj.theta))
    # mpc_stride!: last two configurations = first two + stride
    q = q.at[-2].set(q[0] + stride)
    q = q.at[-1].set(q[1] + stride)
    out = traj._replace(q=q, u=u, w=w, gamma=gam, b=b, z=z, theta=th)
    # refresh q-dependent slots of z and θ (the reference touches only the
    # wrapped knots; all others already satisfy the invariant)
    return update_theta(dims, update_z(dims, out))


def initial_conditions(traj: ContactTraj):
    """trajectory.jl:219-224."""
    q1 = traj.q[1]
    v1 = (traj.q[1] - traj.q[0]) / traj.h
    return q1, v1


def tracking_errors(ref: ContactTraj, sim_q, sim_u, sim_gamma, sim_b,
                    n_sample: int, idx_shift=()):
    """Per-knot average L1 tracking errors vs the tiled reference
    (trajectory.jl:188-217), as traced scalars.

    Pure gather/reduce over static indices — jit- and vmap-safe, so a
    Monte-Carlo batch evaluates health over *all* rollouts in one fused
    reduction (``jax.vmap(lambda q, u, g, b: tracking_errors(...))``).
    """
    h_sim = sim_u.shape[0]
    h_ref = ref.horizon
    reps = int(np.ceil((h_sim / n_sample) / h_ref))
    dup = repeat_traj(ref, max(reps, 1), idx_shift=idx_shift)
    h_dup = dup.horizon

    nq, nu = ref.q.shape[1], ref.u.shape[1]
    nc, nb = ref.gamma.shape[1], ref.b.shape[1]
    # knots with a matching sim sample; the reference's loop counts one
    # extra iteration when it breaks mid-scan (trajectory.jl:196-205)
    t = np.arange(h_dup)
    tv = t[t * n_sample + 1 <= h_sim]
    cnt = min(tv.size + 1, h_dup)

    l1 = lambda a, b_: jnp.sum(jnp.abs(a - b_), axis=-1)
    q_err = jnp.sum(l1(dup.q[tv + 2], sim_q[tv * n_sample + 2])) / nq
    u_err = jnp.sum(l1(dup.u[tv], sim_u[tv * n_sample])) / nu
    g_err = jnp.sum(l1(dup.gamma[tv], sim_gamma[tv * n_sample])) / nc
    b_err = jnp.sum(l1(dup.b[tv], sim_b[tv * n_sample])) / nb
    return q_err / cnt, u_err / cnt, g_err / cnt, b_err / cnt


def tracking_error(ref: ContactTraj, sim_q, sim_u, sim_gamma, sim_b,
                   n_sample: int, idx_shift=()):
    """Host-side convenience wrapper around ``tracking_errors`` returning
    Python floats (one rollout)."""
    return tuple(float(e) for e in tracking_errors(
        ref, sim_q, sim_u, sim_gamma, sim_b, n_sample, idx_shift))
