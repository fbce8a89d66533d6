"""Monte-Carlo robustness sweep of the flat-ground quadruped CIMPC —
multi-device replacement for the reference's serial loop
(``/root/reference/examples/quadruped/monte_carlo.jl`` /
``examples/hopper/monte_carlo.jl:78-91``): the batch of rollouts with
uniformly-offset initial states runs as ONE mesh-sharded program; sweep
statistics psum-reduce across the devices.

Run: python examples/quadruped_monte_carlo.py [--n 128] [--steps 500]
     [--cpu8]   (--cpu8 = virtual 8-device CPU mesh)
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--png", type=str, default=None,
                    help="write a visualize_runs!-style overlay figure")
    ap.add_argument("--cpu8", action="store_true")
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import os

    import jax
    if args.cpu8:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
        jax.config.update("jax_platforms", "cpu")
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    import numpy as np

    import contactimplicitmpc_tpu as ci
    from contactimplicitmpc_tpu.control import (
        CONFIGURATION, NewtonOptions, from_gait, tracking_objective)
    from contactimplicitmpc_tpu.hotpath import conf_initial_states
    from contactimplicitmpc_tpu.control.rollout import mpc_rollout
    from contactimplicitmpc_tpu.models import quadruped as model
    from contactimplicitmpc_tpu.models.base import dims_of
    from contactimplicitmpc_tpu.parallel import (make_mesh,
                                                 make_sharded_mpc_rollouts)
    from contactimplicitmpc_tpu.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu.utils.gaits import load_gait

    dtype = jnp.float64 if args.f64 else jnp.float32
    env = ci.flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=dtype)
    n_sample, h_mpc, kappa = 5, 10, 2.0e-4

    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * 8)
    obj = tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype)
    sim_opts = IPOptions(r_tol=(1e-8 if args.f64 else 1e-3),
                         kappa_tol=(1e-8 if args.f64 else 1e-5),
                         max_iter=(100 if args.f64 else 40),
                         undercut=float("inf"),
                         max_ls=(25 if args.f64 else 6))

    def rollout(q, v):
        return mpc_rollout(model, env, ref, obj, args.steps, h_mpc,
                           n_sample, kappa, CONFIGURATION, q, v,
                           n_opts=NewtonOptions(r_tol=3e-4, max_iter=5),
                           sim_opts=sim_opts, warm_start_floor=1e-2,
                           newton_mode="structure",
                           structure_full_warm=False)

    devices = jax.devices()
    mesh = make_mesh(len(devices))
    n = (args.n // len(devices)) * len(devices)
    run = make_sharded_mpc_rollouts(mesh, rollout, ref, n_sample)

    # the reference study's distribution (monte_carlo.jl:80-89), lane 0
    # nominal
    q1s, v1s = conf_initial_states(model, ref, n, jax.random.PRNGKey(0),
                                   dtype)

    t0 = time.time()
    traj, stats = run(q1s, v1s)
    jax.block_until_ready(stats)
    print(f"compile+first run: {time.time() - t0:.1f}s "
          f"({len(devices)} device(s), mesh {mesh.devices.shape})")
    t0 = time.time()
    traj, stats = run(q1s, v1s)
    jax.block_until_ready(stats)
    wall = time.time() - t0

    solves = n * (args.steps // n_sample)
    print(f"runs: {int(float(stats.n_rollouts))}  "
          f"success rate: {float(stats.success_rate):.3f}")
    print(f"tracking over successful runs: q={float(stats.q_err):.4f} "
          f"u={float(stats.u_err):.4f}")
    print(f"throughput: {solves / wall:.1f} MPC solves/s "
          f"({solves / wall / len(devices):.1f} per device)")

    if args.png:
        from contactimplicitmpc_tpu.utils.visuals import plot_runs_2d
        plot_runs_2d(model, np.asarray(traj.q)[:16], env=env,
                     path=args.png, stride=max(1, args.steps // 8))
        print(f"wrote {args.png}")


if __name__ == "__main__":
    main()
