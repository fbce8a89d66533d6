"""Pushbot push recovery: a pole between two walls, batted by impulses,
recovering upright under contact-implicit MPC (wall contacts brace it).

Mirror of ``/root/reference/examples/pushbot/push_recovery.jl``:
N_sample=2, H_mpc=40, κ=1e-4, zero reference (stay upright), the "fast
recovery" time-ramped velocity-tracking objective (push_recovery.jl:60-66),
and the five scripted impulses (push_recovery.jl:78-86).

Run: python examples/pushbot_push_recovery.py [--steps 1000] [--cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    import contactimplicitmpc_tpu as ci
    from contactimplicitmpc_tpu.control import (
        CONFIGURATION_FORCE, NewtonOptions, ci_mpc_policy,
        contact_trajectory, tracking_velocity_objective, update_theta,
        update_z)
    from contactimplicitmpc_tpu.control.implicit_dynamics import \
        default_mpc_ip_options
    from contactimplicitmpc_tpu.models import pushbot as model
    from contactimplicitmpc_tpu.models.base import dims_of
    from contactimplicitmpc_tpu.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu.sim.simulator import impulse_disturbances

    dtype = jnp.float64 if args.f64 else jnp.float32
    env = ci.flat_2d_lc
    dims = dims_of(model, env)

    # zero reference at the upright (push_recovery.jl:15-32)
    h = 0.04
    h_mpc, n_sample, kappa = 40, 2, 1.0e-4
    ref = contact_trajectory(dims, 100, h, dtype=dtype)
    ref = ref._replace(theta=ref.theta.at[:, dims.imu].set(model.mu_world))
    ref = update_theta(dims, update_z(dims, ref))

    # "fast recovery" weights, time-ramped toward the horizon end
    # (push_recovery.jl:60-66)
    t_ramp = (np.arange(1, h_mpc + 1) / h_mpc)
    obj = tracking_velocity_objective(
        dims, h_mpc,
        q=np.stack([12 * t_ramp ** 2, 12 * t_ramp ** 2], axis=1),
        v=np.tile(np.array([1.0, 0.01]) / h ** 2, (h_mpc, 1)),
        u=np.tile([100.0, 1.0], (h_mpc, 1)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype)

    # hard real time in the reference: max_time = h/2 (push_recovery.jl:76);
    # the deterministic device analog is the fixed iteration budget below
    policy = ci_mpc_policy(
        model, env, ref, obj, h_mpc=h_mpc, n_sample=n_sample,
        kappa_mpc=kappa, mode=CONFIGURATION_FORCE,
        n_opts=NewtonOptions(r_tol=3e-4, max_iter=10),
        ip_opts=default_mpc_ip_options(kappa, max_iter=30))

    # scripted pushes (push_recovery.jl:78-86)
    idx = np.array([20, 220, 300, 500, 530])
    impulses = np.array([[-5.5, 0.0], [5.5, 0.0], [5.5, 0.0],
                         [-1.5, 0.0], [-6.5, 0.0]])
    dist = impulse_disturbances(jnp.asarray(impulses, dtype),
                                jnp.asarray(idx))

    sim_opts = None
    if not args.f64:
        sim_opts = IPOptions(r_tol=1e-3, kappa_tol=1e-5, max_iter=40,
                             undercut=float("inf"), max_ls=6)

    q1 = jnp.zeros((2,), dtype)
    v1 = jnp.zeros((2,), dtype)
    h_sim = h / n_sample
    fn = jax.jit(lambda q, v: ci.simulate(
        model, env, args.steps, h_sim, q, v, policy=policy,
        disturbances=dist, opts=sim_opts))

    t0 = time.time()
    traj = jax.block_until_ready(fn(q1, v1))
    print(f"compile+run: {time.time() - t0:.1f}s")
    t0 = time.time()
    traj = jax.block_until_ready(fn(q1, v1))
    wall = time.time() - t0

    ok = bool(ci.status(traj))
    ang = np.asarray(traj.q[:, 0])
    print(f"sim converged: {ok}")
    print(f"max |angle|: {np.abs(ang).max():.3f} rad "
          f"(walls at ±0.35 reach); final |angle|: {abs(ang[-1]):.4f}")
    print(f"speed ratio: {args.steps * h_sim / wall:.2f}x real time")
    assert ok and abs(ang[-1]) < 0.05, "push recovery failed"


if __name__ == "__main__":
    main()
