"""Compile-lean closed-loop MPC rollout for benchmarks and multi-device
sweeps.

The general path (``ci_mpc_policy`` + ``simulate``) keeps the reference's
per-sim-step policy dispatch, which under jit duplicates the whole control
update inside a ``lax.cond`` and nests the Newton line search's vmap over
the per-knot vmap — fine on CPU, but the accelerator compile cost scales
with program size. This module restructures the same computation as::

    scan over control periods:
        one CIMPC Newton solve          (control update)
        scan over N_sample physics steps (interior-point sim)

which eliminates the cond, the sample-and-hold counters, and one level of
control-flow nesting, compiling to a much smaller device program with
identical semantics for the standard "control every N_sample steps"
schedule (policy.jl:98-152).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..models.base import Model, dims_of
from ..sim.interior_point import IPOptions, ip_solve, z_initialize
from ..sim.residual import pack_theta, residual
from ..utils.vma import unify_varying
from .implicit_dynamics import nd_of
from .linearized import gather, linearize_trajectory
from .newton import NewtonAssembler, NewtonOptions, newton_solve
from .trajectory import (ContactTraj, get_stride, update_theta, update_z)


class MPCRollout(NamedTuple):
    q: jnp.ndarray          # (T+2, nq)
    u: jnp.ndarray          # (T, nu) applied controls
    gamma: jnp.ndarray      # (T, nc)
    b: jnp.ndarray          # (T, nb)
    sim_converged: jnp.ndarray   # (T,)
    mpc_r_norm: jnp.ndarray      # (T/N_sample,) final Newton residuals
    # observability (print_status parity, newton.jl:290-301 +
    # SimulatorStatistics): per-control-step Newton iterations and
    # per-sim-step interior-point iterations — free extra scan outputs
    newton_iterations: jnp.ndarray  # (T/N_sample,)
    sim_iterations: jnp.ndarray     # (T,)
    sim_rvio: jnp.ndarray           # (T,) final equality-residual
    #                                 violation per sim step — calibrates
    #                                 the strict flag: a "failed" step at
    #                                 rvio ≈ r_tol is marginal, not
    #                                 divergent


def mpc_rollout(
    model: Model,
    env,
    ref_traj: ContactTraj,
    obj,
    horizon_sim: int,
    h_mpc: int,
    n_sample: int,
    kappa_mpc: float,
    mode: str,
    q1,
    v1,
    n_opts: Optional[NewtonOptions] = None,
    ip_opts: Optional[IPOptions] = None,
    sim_opts: Optional[IPOptions] = None,
    warm_start_floor: float = 0.0,
    newton_mode: str = "direct",
    mpc_opts=None,
    stride_idx=(0,),
    structure_full_warm: bool = True,
    w=None,
    sim_model: Optional[Model] = None,
    sim_env=None,
    newton_reset_scale: float = 0.0,
):
    """Closed-loop CIMPC rollout, one jittable program.

    ``horizon_sim`` must be a multiple of ``n_sample``.

    ``newton_mode="structure"`` replaces the dense horizon-KKT solve with
    the O(H) block-tridiagonal Riccati sweep (configuration mode;
    structure_solver.py) — the dense KKT LU is the throughput ceiling at
    large Monte-Carlo batches.
    """
    from .implicit_dynamics import default_mpc_ip_options
    from .policy import CIMPCOptions

    assert horizon_sim % n_sample == 0
    n_ctrl = horizon_sim // n_sample
    dims = dims_of(model, env)
    nd = nd_of(dims, mode)
    dtype = ref_traj.q.dtype
    h_ref = ref_traj.horizon
    h_sim = float(ref_traj.h) / n_sample

    n_opts = n_opts or NewtonOptions(r_tol=3.0e-4, max_iter=5)
    ip_opts = ip_opts or default_mpc_ip_options(kappa_mpc)
    sim_opts = sim_opts or IPOptions(r_tol=1e-8, kappa_tol=1e-8,
                                     max_iter=100, undercut=float("inf"),
                                     max_ls=6)
    mpc_opts = mpc_opts or CIMPCOptions()

    lin = linearize_trajectory(model, env, ref_traj, kappa_mpc)
    if tuple(stride_idx) == (0,):
        stride = get_stride(model, ref_traj)
    else:
        idxs = jnp.asarray(list(stride_idx), jnp.int32)
        stride = jnp.zeros((dims.nq,), dtype).at[idxs].set(
            ref_traj.q[-2, idxs] - ref_traj.q[0, idxs])
    assembler = NewtonAssembler(dims, h_mpc, mode)
    mu = jnp.asarray(model.mu_world, dtype)

    structure = newton_mode == "structure"
    if structure:
        from .structure_solver import (shift_state, state_from_reference,
                                       structure_newton_solve,
                                       structure_objective_from_tracking)
        sobj = structure_objective_from_tracking(dims, obj,
                                                 n_opts.beta_init,
                                                 h_mpc, dtype)
    elif newton_mode != "direct":
        raise ValueError(f"invalid newton_mode {newton_mode!r}")

    def slice_h(traj):
        return ContactTraj(h=traj.h, kappa=traj.kappa,
                           q=traj.q[:h_mpc + 2], u=traj.u[:h_mpc],
                           w=traj.w[:h_mpc], gamma=traj.gamma[:h_mpc],
                           b=traj.b[:h_mpc], z=traj.z[:h_mpc],
                           theta=traj.theta[:h_mpc])

    def ref_window_at(t):
        """Rows [t, t+h_mpc) of the receding-horizon reference — the
        closed form of t applications of rotate! + mpc_stride!
        (mpc_utils.jl:1-107). The rotated gait's extended rows satisfy
        V[j] = q[j] for j ≤ H+1 and V[j] = V[j−H] + stride past them, so
        the window is a gather + a wrap-count stride offset. Building it
        per period (instead of carrying the rotated gait through the
        scan) removes the H_ref-sized PER-LANE loop-carried arrays and
        the rotation that rewrote every gait row each period (chosen
        before the move to the H100; not measured there yet, ROADMAP
        D3)."""
        rows2 = t + jnp.arange(h_mpc + 2)
        jm2 = rows2 - 2
        q_wrap = (ref_traj.q[(jm2 % h_ref) + 2]
                  + (jm2 // h_ref).astype(dtype)[:, None] * stride[None, :])
        q = jnp.where((rows2 <= 1)[:, None],
                      ref_traj.q[jnp.clip(rows2, 0, 1)], q_wrap)
        rows = (t + jnp.arange(h_mpc)) % h_ref
        win = ContactTraj(h=ref_traj.h, kappa=ref_traj.kappa, q=q,
                          u=ref_traj.u[rows], w=ref_traj.w[rows],
                          gamma=ref_traj.gamma[rows], b=ref_traj.b[rows],
                          z=ref_traj.z[rows], theta=ref_traj.theta[rows])
        # refresh the q-dependent slots of z and θ for the wrapped rows
        # (rot_n_stride parity)
        return update_theta(dims, update_z(dims, win))

    # the physics may run a different model/terrain from the controller's —
    # robustness-to-model-mismatch studies (payload.jl:8-18 simulates the
    # loaded quadruped under the no-load controller; parkour.jl runs the
    # stairs terrain under the flat-ground MPC model + altitude updates)
    sim_model = sim_model or model
    sim_env = sim_env or env

    def r_fn(z, th, kap):
        return residual(sim_model, sim_env, z, th, kap)

    # external disturbance forces per sim step ((T, nw); zero if absent) —
    # the OpenLoopDisturbance analog for the fused rollout
    # (disturbances.jl:40-60, scaled by 1/N_sample like the held control)
    w_steps = (jnp.zeros((horizon_sim, dims.nw), dtype) if w is None
               else jnp.asarray(w, dtype).reshape(horizon_sim, dims.nw))
    w_periods = w_steps.reshape(n_ctrl, n_sample, dims.nw)

    def sim_substeps(q0, q1, u, z_prev, w_period):
        """N_sample physics steps under the held control u / N_sample.

        The cone variables warm-start from the previous step's solution,
        floored away from the boundary (z_warmstart!-style,
        simulation.jl:87-101) — roughly halves interior-point iterations
        along a steady gait.
        """
        u_step = u / n_sample
        floor = jnp.asarray(warm_start_floor, dtype)

        def step(carry, w_t):
            qa, qb, zp = carry
            theta = pack_theta(qa, qb, u_step, w_t, mu, h_sim)
            if warm_start_floor > 0:
                cone = jnp.maximum(zp[dims.nq:], floor)
                z0 = jnp.concatenate([qb, cone])
            else:
                z0 = z_initialize(dims, qb)
            res = ip_solve(dims, r_fn, z0, theta, sim_opts)
            q2 = res.z[dims.iq2]
            # warm-start policy for the next step: a DIVERGED solve must
            # not seed it (poisoned cone variables), but a merely
            # near-converged one (rvio within 100× tolerance — common
            # under fixed-iteration budgets at contact transitions) is a
            # far better seed than the cold initializer. Cold-resetting
            # on every strict-flag failure creates a failure cascade:
            # the cold-started next solve needs ~2× the iterations, also
            # overruns the budget, and the lane never recovers (measured
            # round 5: fixed=8 step convergence 0.79 with strict reset
            # vs 2.5% true >8-iteration steps).
            warm_ok = res.converged | (
                res.rvio < 100.0 * sim_opts.r_tol)
            z_carry = jnp.where(warm_ok, res.z,
                                z_initialize(dims, q2, dtype))
            return (qb, q2, z_carry), (q2, res.z[dims.igamma1],
                                       res.z[dims.ib1], res.converged,
                                       res.iterations, res.rvio)

        (qa, qb, zp), ys = jax.lax.scan(step, (q0, q1, z_prev), w_period)
        return qa, qb, zp, ys

    def update_altitude(alt, gamma_prev, q_prev, warm):
        """Terrain-height discovery from the last control period's contact
        impulses (update_altitude!, mpc_utils.jl:109-135)."""
        idx = jnp.argmax(gamma_prev, axis=0)             # (nc,)
        gamma_max = jnp.max(gamma_prev, axis=0)
        q_at = q_prev[idx]                               # (nc, nq)
        phi_i = jnp.diagonal(
            jax.vmap(lambda q: model.phi(env, q))(q_at))
        alt_new = jnp.where(
            gamma_max > mpc_opts.altitude_impact_threshold, phi_i, alt)
        return jnp.where(warm, alt_new, alt)

    # Newton failure threshold for the controller-level cold restart: a
    # control solve that ends with its residual far above tolerance has
    # garbage duals/primals; warm-starting the NEXT solve from them can
    # trap the controller in a non-converging feedback loop (observed in
    # f32 at batch ≥ 64: one borderline step at ~10× r_tol never
    # recovers for the rest of the rollout). ``newton_reset_scale > 0``
    # resets the next step's warm start to the reference whenever
    # r_norm > scale · r_tol · n — the batched analog of the reference's
    # failure -> stale/reset recovery (implicit_dynamics.jl:169-177) and
    # of IPOptions.retries in the sim. Default 0 (disabled) = reference
    # semantics: hard-terrain recipes (parkour) legitimately run 40% of
    # control steps above any such threshold and NEED the warm start kept.
    n_norm = (h_mpc - 1) * (dims.nu + 4 * dims.nq) if structure \
        else h_mpc * (assembler.ind.nr + nd)
    fail_tol = (newton_reset_scale * n_opts.r_tol * n_norm
                if newton_reset_scale > 0 else float("inf"))

    def control_period(carry, t):
        (warm_state, nu, q_ctrl_prev, qa_sim,
         qb_sim, z_prev, alt, gamma_prev, q_prev, prev_ok) = carry
        warm = (t > 0) & prev_ok
        if mpc_opts.altitude_update:
            alt = update_altitude(alt, gamma_prev, q_prev, warm)

        ref_window = ref_window_at(t)
        window = (t + jnp.arange(h_mpc, dtype=jnp.int32)) % h_ref
        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(warm, x, y), a, b)

        if structure:
            lin_w = gather(lin, window[:h_mpc - 1])
            q_ref = ref_window.q[:h_mpc + 1]
            u_ref = ref_window.u[:h_mpc - 1]
            # full warm start: the previous solve's primal stages and duals,
            # shifted one knot to stay aligned with the rotated window
            # (reset!/warm_start semantics, newton.jl:130-167); measured
            # q0/q1 are pinned inside structure_newton_solve
            st_ref = state_from_reference(q_ref, u_ref, dims, h_mpc, dtype)
            if structure_full_warm:
                st0 = sel(shift_state(warm_state, q_ref, u_ref, h_mpc), st_ref)
            else:
                # duals-only warm start (round-1 behavior): rebuild the
                # primal stages from the reference every control step —
                # breaks the f32 error-feedback loop at some tracking cost
                st0 = st_ref._replace(
                    nu1=jnp.where(warm, warm_state.nu1, st_ref.nu1),
                    nu2=jnp.where(warm, warm_state.nu2, st_ref.nu2))
            result = structure_newton_solve(
                dims, sobj, lin_w, q_ref, u_ref,
                ref_window.theta[:h_mpc - 1], q_ctrl_prev, qb_sim, st0,
                alt, ip_opts, n_opts, h_mpc)
            u = result.state.u[1]
            nu_next = nu  # unused carry slot in structure mode
            warm_next = result.state
        else:
            lin_w = gather(lin, window)
            traj0 = sel(warm_state, ref_window)
            nu0 = jnp.where(warm, nu, jnp.zeros_like(nu))

            # newton sees configurations one control period (= gait step h)
            # apart: (q at previous update, current q) — policy.jl:117-132
            result = newton_solve(dims, mode, assembler, obj, lin_w,
                                  ref_window, traj0, nu0, q_ctrl_prev,
                                  qb_sim, alt, ip_opts, n_opts)
            u = result.traj.u[0]
            nu_next = result.nu
            warm_next = result.traj

        qa, qb, zp, ys = sim_substeps(qa_sim, qb_sim, u, z_prev,
                                      w_periods[t])
        qs_period, gammas_period = ys[0], ys[1]

        # newton_reset_scale=0 must reproduce reference semantics exactly
        # (warm start always kept): gate on the flag, since a NaN r_norm
        # would otherwise compare False against the inf threshold and
        # still trigger a restart (the structure solver already sanitizes
        # non-finite warm-start leaves back to the reference)
        if newton_reset_scale > 0:
            solve_ok = result.r_norm < fail_tol
        else:
            solve_ok = jnp.ones((), bool)
        carry = (warm_next, nu_next, qb_sim, qa, qb, zp,
                 alt, gammas_period, qs_period, solve_ok)
        return carry, (ys, jnp.broadcast_to(u / n_sample, (n_sample, dims.nu)),
                       result.r_norm, result.iterations)

    q1 = jnp.asarray(q1, dtype)
    q0 = q1 - h_sim * jnp.asarray(v1, dtype)
    # the MPC's previous-control-period configuration starts at the gait's
    # q[0] (policy.jl:101-102: p.q0 = ref_traj.q[1])
    if structure:
        ref_w = slice_h(ref_traj)
        warm0 = state_from_reference(ref_w.q[:h_mpc + 1],
                                     ref_w.u[:h_mpc - 1], dims, h_mpc,
                                     dtype)
        nu0 = jnp.zeros((0,), dtype)  # unused in structure mode
    else:
        warm0 = slice_h(ref_traj)
        nu0 = jnp.zeros((h_mpc, nd), dtype)
    carry0 = (warm0, nu0,
              ref_traj.q[0], q0, q1, z_initialize(dims, q1, dtype),
              jnp.zeros((dims.nc,), dtype),
              jnp.zeros((n_sample, dims.nc), dtype),
              jnp.zeros((n_sample, dims.nq), dtype),
              jnp.ones((), bool))
    carry0 = unify_varying(carry0)
    _, ((qs, gammas, bs, conv, sim_iters, rvios), us, r_norms, n_iters) = \
        jax.lax.scan(control_period, carry0, jnp.arange(n_ctrl))

    qs = qs.reshape(horizon_sim, dims.nq)
    q_full = jnp.concatenate([q0[None], q1[None], qs], axis=0)
    return MPCRollout(q=q_full, u=us.reshape(horizon_sim, dims.nu),
                      gamma=gammas.reshape(horizon_sim, dims.nc),
                      b=bs.reshape(horizon_sim, dims.nb),
                      sim_converged=conv.reshape(horizon_sim),
                      mpc_r_norm=r_norms,
                      newton_iterations=n_iters,
                      sim_iterations=sim_iters.reshape(horizon_sim),
                      sim_rvio=rvios.reshape(horizon_sim))
