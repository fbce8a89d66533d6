"""Raibert heuristic hopping baseline on the 2D hopper — the classical
policy the CIMPC paper compares against.

Mirror of ``/root/reference/examples/raibert/flat_raibert.jl``: flat
ground, h_sim = 0.02, start at q_ref = [0, 0.5, 0, 0.5], commanded
forward velocity v0. A batched variant sweeps several v0 commands in one
vmap — the replacement for rerunning the script per setting.

Run: python examples/hopper_raibert.py [--steps 1000] [--v0 0.2] [--gif out.gif]
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--v0", type=float, default=0.2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--gif", type=str, default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    # reference numerics are Float64 (flat_raibert.jl r_tol/κ_tol 1e-8);
    # the pure-sim workload has no MPC solve, so f64 costs little
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import contactimplicitmpc_tpu as ci
    from contactimplicitmpc_tpu.control import raibert_policy
    from contactimplicitmpc_tpu.models import hopper_2d as model
    from contactimplicitmpc_tpu.sim.interior_point import IPOptions
    from contactimplicitmpc_tpu.sim.simulator import simulate, status

    h_sim = 0.02  # gait h 0.1 / N_sample 5 (flat_raibert.jl:24-25)
    opts = IPOptions(r_tol=1e-8, kappa_tol=1e-8, max_iter=100,
                     undercut=float("inf"), max_ls=25)
    q1 = jnp.array([0.0, 0.5, 0.0, 0.5])
    v1 = jnp.zeros(4)

    # sweep of velocity commands, one vmapped program (the single
    # requested v0 rides along as lane 0); v0 enters only through the
    # touchdown angle, so it vmaps as a traced scalar
    v0s = jnp.array([args.v0, 0.0, 0.1, 0.3, 0.4])

    def run(v0):
        policy = raibert_policy(model, h=h_sim, v0=v0)
        return simulate(model, ci.flat_2d_lc, args.steps, h_sim, q1, v1,
                        policy=policy, opts=opts)

    t0 = time.time()
    trajs = jax.jit(jax.vmap(run))(v0s)
    jax.block_until_ready(trajs.q)
    dt = time.time() - t0
    for i, v0 in enumerate(v0s):
        ok = bool(jnp.all(trajs.converged[i]))
        x = float(trajs.q[i, -1, 0])
        v_avg = x / (args.steps * h_sim)
        print(f"v0={float(v0):+.2f}: status={ok} x_final={x:+.2f} "
              f"v_avg={v_avg:+.3f} m/s")
    print(f"{len(v0s)} rollouts x {args.steps} steps in {dt:.1f}s "
          f"(incl. compile)")

    if args.gif:
        from contactimplicitmpc_tpu.utils.visuals import animate_2d
        animate_2d(model, trajs.q[0][::5], path=args.gif)
        print(f"wrote {args.gif}")


if __name__ == "__main__":
    main()
