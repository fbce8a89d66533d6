"""Sharded Monte-Carlo rollouts: the multi-device replacement for the
reference's serial robustness studies.

``examples/hopper/monte_carlo.jl:78-91`` runs 100 seeds × 1000 steps in a
serial Julia loop. Here a batch of closed-loop rollouts is one ``vmap`` per
device and a ``shard_map`` across the mesh; sweep statistics reduce with
one ``psum`` (SURVEY.md §2.10).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sim.simulator import SimTrajectory, simulate


class RolloutStats(NamedTuple):
    """Global sweep statistics (SimulatorStatistics equivalent)."""

    n_rollouts: jnp.ndarray
    success_rate: jnp.ndarray   # fraction of rollouts with all solves ok
    mean_iterations: jnp.ndarray
    mean_final_q: jnp.ndarray   # (nq,)


def monte_carlo_rollouts(model, env, horizon: int, h: float,
                         q1_batch, v1_batch, policy=None,
                         disturbances=None, opts=None) -> SimTrajectory:
    """Single-device batched rollouts (one vmap)."""
    roll = functools.partial(simulate, model, env, horizon, h,
                             policy=policy, disturbances=disturbances,
                             opts=opts)
    return jax.vmap(roll)(q1_batch, v1_batch)


def sharded_rollouts(mesh: Mesh, model, env, horizon: int, h: float,
                     q1_batch, v1_batch, policy=None, disturbances=None,
                     opts=None) -> SimTrajectory:
    """Rollouts sharded over every mesh axis (pure data parallel: the
    batch is laid out over the whole mesh; XLA keeps all compute local)."""
    roll = functools.partial(simulate, model, env, horizon, h,
                             policy=policy, disturbances=disturbances,
                             opts=opts)
    batch_sharding = NamedSharding(mesh, P(mesh.axis_names))
    fn = jax.jit(jax.vmap(roll),
                 in_shardings=(batch_sharding, batch_sharding),
                 out_shardings=batch_sharding)
    # flatten the mesh axes onto the leading batch axis
    return fn(q1_batch, v1_batch)


class MPCSweepStats(NamedTuple):
    """Multi-device closed-loop MPC sweep health (the batched analog of the
    reference's per-example report: examples/quadruped/flat.jl:71-79 +
    test thresholds mpc_quadruped.jl:61-68). All fields are global
    (psum-reduced over the mesh)."""

    n_rollouts: jnp.ndarray
    success_rate: jnp.ndarray      # all sim solves converged
    q_err: jnp.ndarray             # mean tracking errors over ALL rollouts
    u_err: jnp.ndarray
    gamma_err: jnp.ndarray
    b_err: jnp.ndarray
    mean_newton_iters: jnp.ndarray
    mean_sim_iters: jnp.ndarray
    mean_r_norm: jnp.ndarray       # final Newton residual, averaged


def make_sharded_mpc_rollouts(mesh: Mesh, rollout_fn, ref, n_sample: int,
                              idx_shift=(0,)):
    """Build the jitted, mesh-sharded CIMPC Monte-Carlo sweep.

    Returns ``fn(q1_batch, v1_batch) -> (MPCRollout, MPCSweepStats)``,
    jitted ONCE — call it repeatedly (warm timing loops) without paying a
    re-trace per call.

    ``rollout_fn(q1, v1) -> MPCRollout`` is one un-batched closed-loop
    rollout (control.rollout.mpc_rollout partially applied). Each shard
    vmaps its slice of the batch locally; sweep statistics (success rate,
    full-batch tracking errors, iteration counts) reduce with ``psum``
    — only scalars cross devices. The rollout output stays laid
    out over the mesh.
    """
    from ..control.trajectory import tracking_errors

    axes = mesh.axis_names

    def local_shard(q1s, v1s):
        traj = jax.vmap(rollout_fn)(q1s, v1s)
        ok = jnp.all(traj.sim_converged, axis=1)
        errs = jax.vmap(lambda q, u, g, b: tracking_errors(
            ref, q, u, g, b, n_sample, idx_shift))(
            traj.q, traj.u, traj.gamma, traj.b)
        n_local = jnp.asarray(q1s.shape[0], jnp.float32)
        n = jax.lax.psum(n_local, axes)
        n_ok = jnp.maximum(jax.lax.psum(
            jnp.sum(ok.astype(jnp.float32)), axes), 1.0)
        mean = lambda x: jax.lax.psum(
            jnp.sum(x.astype(jnp.float32)), axes) / n
        # tracking errors are averaged over SUCCESSFUL rollouts only: a
        # diverged lane's error is meaningless (it is already counted by
        # success_rate) and would otherwise poison the batch means
        mean_ok = lambda x: jax.lax.psum(
            jnp.sum(jnp.where(ok, x.astype(jnp.float32), 0.0)), axes) / n_ok
        stats = MPCSweepStats(
            n_rollouts=n,
            success_rate=mean(ok),
            q_err=mean_ok(errs[0]), u_err=mean_ok(errs[1]),
            gamma_err=mean_ok(errs[2]), b_err=mean_ok(errs[3]),
            mean_newton_iters=mean(
                jnp.mean(traj.newton_iterations.astype(jnp.float32),
                         axis=1)),
            mean_sim_iters=mean(
                jnp.mean(traj.sim_iterations.astype(jnp.float32), axis=1)),
            mean_r_norm=mean_ok(jnp.mean(traj.mpc_r_norm, axis=1)))
        return traj, stats

    spec = P(axes)
    stats_spec = jax.tree_util.tree_map(lambda _: P(),
                                        MPCSweepStats(*[0.0] * 9))
    return jax.jit(jax.shard_map(
        local_shard, mesh=mesh, in_specs=(spec, spec),
        out_specs=(spec, stats_spec)))


def sharded_mpc_rollouts(mesh: Mesh, rollout_fn, ref, n_sample: int,
                         q1_batch, v1_batch, idx_shift=(0,)):
    """One-shot convenience wrapper around ``make_sharded_mpc_rollouts``.
    For repeated calls (timing loops) build the function once instead."""
    fn = make_sharded_mpc_rollouts(mesh, rollout_fn, ref, n_sample,
                                   idx_shift)
    return fn(q1_batch, v1_batch)


def sharded_rollout_stats(mesh: Mesh, model, env, horizon: int, h: float,
                          q1_batch, v1_batch, policy=None,
                          disturbances=None, opts=None) -> RolloutStats:
    """shard_map version with explicit collectives: each shard rolls
    its slice of the batch locally, then sweep statistics ``psum`` across
    the whole mesh — nothing but scalars crosses chips."""
    axes = mesh.axis_names
    roll = functools.partial(simulate, model, env, horizon, h,
                             policy=policy, disturbances=disturbances,
                             opts=opts)

    def local_shard(q1s, v1s):
        traj = jax.vmap(roll)(q1s, v1s)
        ok = jnp.all(traj.converged, axis=1)
        n_local = jnp.asarray(q1s.shape[0], jnp.float32)
        n = jax.lax.psum(n_local, axes)
        succ = jax.lax.psum(jnp.sum(ok.astype(jnp.float32)), axes) / n
        iters = jax.lax.psum(
            jnp.sum(jnp.mean(traj.iterations.astype(jnp.float32), axis=1)),
            axes) / n
        qf = jax.lax.psum(jnp.sum(traj.q[:, -1, :], axis=0), axes) / n
        return RolloutStats(n_rollouts=n, success_rate=succ,
                            mean_iterations=iters, mean_final_q=qf)

    spec = P(axes)
    fn = jax.jit(jax.shard_map(
        local_shard, mesh=mesh, in_specs=(spec, spec),
        out_specs=RolloutStats(n_rollouts=P(), success_rate=P(),
                               mean_iterations=P(), mean_final_q=P())))
    return fn(q1_batch, v1_batch)
