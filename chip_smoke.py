#!/usr/bin/env python
"""Bring-up check: the closed-loop CIMPC program on an NVIDIA GPU.

Run from the repository root:

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs: sharded sweep only

One process holds the card(s). Phases, each of which must pass:

1. device gate: refuses anything but a GPU (no CPU fallback) and prints
   the device, the JAX version, the matmul precision, and the card's name
   and power limit from nvidia-smi;
2. main path, the sweep: ``hotpath.make_quadruped_rollout`` at the bench's
   full size (256 lanes × 250 sim steps, float32) through
   ``parallel.make_sharded_mpc_rollouts`` on a one-device mesh, held to
   the health bar of tests/test_hotpath.py;
3. main path, the per-call policy: ``__graft_entry__``'s ``ci_mpc_policy``
   inside ``ci.simulate`` for 100 sim steps (20 control calls);
4. plain reference: the card's float32 against float64 on the CPU,
   computed in a child process that never opens the card, for the
   batched knot interior point, one control update of ``entry()`` and
   one sim-path ``ip_solve`` step; plus the warm time of the knot
   interior point at the bench's shape.

``--four`` runs only the sweep sharded over four GPUs at batch 1024 and
compares its first 256 lanes with a plain ``jax.vmap`` of the same
rollout on one GPU.

The last line of stdout is ``{"ok": true, "device": {...}}``; it is
printed only when every phase passed. Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

SEED = 0
SWEEP_BATCH = 256          # bench.py defaults (CIMPC_BENCH_BATCH/STEPS)
SWEEP_STEPS = 250
FOUR_BATCH = 1024          # 256 lanes per card on four cards
POLICY_STEPS = 100         # 20 control calls at N_sample = 5

# health bar of tests/test_hotpath.py: the upstream CI thresholds
# (test/controller/mpc_quadruped.jl:61-68, fail at 1.5× the nominal
# q error 0.0201) for the nominal lane, and ≥90% of lanes with ≥95% of
# their sim steps converged
Q_ERR_LIMIT = 1.5 * 0.0201
LANE_STEP_SHARE = 0.95
LANE_SHARE = 0.90

# Reference tolerances, float32 on the card vs float64 on the CPU. Both
# sides run the same solver with the same options, so they differ by
# float32 rounding plus where each stops inside its own tolerance. The
# knot residual's affine rows cancel O(10-100) terms down to ~1e-5, so
# float32 evaluation floors rvio near 1.2e-5 whatever the solver does,
# and the smallest honest knot tolerance is r_tol = 2e-5; at that
# tolerance a full solution z (forces and slacks included) is fixed to
# 5e-3, the configuration block q2 (what the MPC consumes) to 1e-3. The
# control u of one update and the sim step's q2 are held to 1e-3 too.
TOLERANCES = {
    "knot_z": 5e-3,
    "knot_q2": 1e-3,
    "policy_u": 1e-3,
    "sim_z": 5e-3,
    "sim_q2": 1e-3,
}
KAPPA_MPC = 2.0e-4
KNOT_ITERS = 16            # enough masked iterations to reach r_tol


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# plain reference: the same three computations in any dtype
# ---------------------------------------------------------------------------

def reference_inputs(n_knots: int, seed: int = SEED) -> dict:
    """Perturbations, in float64, shared by the card and the reference.

    Knots are perturbed in θ by 0.003·N(0, 1) away from their
    linearization point (a warm MPC knot); the control update starts
    from the gait's first two configurations offset by 0.002·N(0, 1) so
    the Newton solve iterates; the sim steps take the gait's own data
    with the control offset by 0.02·N(0, 1)·|u|max.
    """
    import contactimplicitmpc_tpu as ci
    from contactimplicitmpc_tpu.models import quadruped
    from contactimplicitmpc_tpu.models.base import dims_of

    dims = dims_of(quadruped, ci.flat_2d_lc)
    rng = np.random.default_rng(seed)
    return {
        "knot_dtheta": 0.003 * rng.standard_normal((n_knots, dims.ntheta)),
        "policy_dq": 0.002 * rng.standard_normal((2, dims.nq)),
        "sim_du": 0.02 * rng.standard_normal((n_knots, dims.nu)),
    }


def knot_options():
    from contactimplicitmpc_tpu.sim.interior_point import IPOptions
    return IPOptions(r_tol=2e-5, kappa_tol=KAPPA_MPC, max_iter=KNOT_ITERS,
                     undercut=5.0, gamma_reg=0.1, max_ls=3, refine=1)


def _quadruped(dtype):
    import contactimplicitmpc_tpu as ci
    from contactimplicitmpc_tpu.control import from_gait
    from contactimplicitmpc_tpu.models import quadruped
    from contactimplicitmpc_tpu.models.base import dims_of
    from contactimplicitmpc_tpu.utils.gaits import load_gait

    env = ci.flat_2d_lc
    ref = from_gait(quadruped, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=dtype)
    return quadruped, env, dims_of(quadruped, env), ref


def knot_outputs(inputs: dict, dtype) -> dict:
    """(a) the batched knot interior point, vmap(linearized_ip_fixed), on
    the first knots of gait2 perturbed in θ."""
    import jax
    import jax.numpy as jnp

    from contactimplicitmpc_tpu.control import linearize_trajectory
    from contactimplicitmpc_tpu.ops.fixed_ip import linearized_ip_fixed

    model, env, dims, ref = _quadruped(dtype)
    k = inputs["knot_dtheta"].shape[0]
    lin = linearize_trajectory(model, env, ref, KAPPA_MPC)
    opts = knot_options()
    knot = jax.jit(jax.vmap(
        lambda z0, th0, r0, rz0, rt0, th, q:
        linearized_ip_fixed(dims, z0, th0, r0, rz0, rt0,
                            jnp.zeros((dims.nc,), dtype), th, q, opts,
                            iters=KNOT_ITERS)))
    res = knot(lin.z0[:k], lin.theta0[:k], lin.r0[:k], lin.rz0[:k],
               lin.rtheta0[:k],
               ref.theta[:k] + jnp.asarray(inputs["knot_dtheta"], dtype),
               ref.q[2:k + 2])
    return {"knot_z": np.asarray(res.z),
            "knot_q2": np.asarray(res.z[:, dims.iq2]),
            "knot_converged": np.asarray(res.converged)}


def policy_outputs(inputs: dict, dtype) -> dict:
    """(b) one control update of ``__graft_entry__.entry()`` from the
    gait's first two configurations, perturbed."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import entry

    forward, (q0, q1) = entry(dtype)
    dq = jnp.asarray(inputs["policy_dq"], dtype)
    return {"policy_u": np.asarray(
        jax.jit(forward)(q0 + dq[0], q1 + dq[1]))}


def sim_outputs(inputs: dict, dtype) -> dict:
    """(c) one sim-path ``ip_solve`` step per knot at the shipped sim
    options, from the gait's own data with the control perturbed."""
    import jax
    import jax.numpy as jnp

    from contactimplicitmpc_tpu.hotpath import HotPathConfig
    from contactimplicitmpc_tpu.sim.interior_point import (ip_solve,
                                                           z_initialize)
    from contactimplicitmpc_tpu.sim.residual import pack_theta, residual

    model, env, dims, ref = _quadruped(dtype)
    k = inputs["sim_du"].shape[0]
    sim_opts = HotPathConfig().sim_ip_options()
    mu, h = model.mu_world, float(ref.h)
    r_fn = lambda z, th, kap: residual(model, env, z, th, kap)

    def sim_step(qa, qb, u, w):
        theta = pack_theta(qa, qb, u, w, mu, h)
        res = ip_solve(dims, r_fn, z_initialize(dims, qb), theta, sim_opts)
        return res.z, res.converged

    u = ref.u[:k] + (jnp.asarray(inputs["sim_du"], dtype)
                     * jnp.max(jnp.abs(ref.u)))
    z, conv = jax.jit(jax.vmap(sim_step))(ref.q[:k], ref.q[1:k + 1], u,
                                          ref.w[:k])
    return {"sim_z": np.asarray(z), "sim_q2": np.asarray(z[:, dims.iq2]),
            "sim_converged": np.asarray(conv)}


def reference_outputs(inputs: dict, dtype) -> dict:
    """(a), (b) and (c) in ``dtype`` on the default device, as numpy
    arrays."""
    return {**knot_outputs(inputs, dtype), **policy_outputs(inputs, dtype),
            **sim_outputs(inputs, dtype)}


def compare(got: dict, want: dict) -> list:
    """[(name, max abs error, tolerance, ok)] for each output named in
    ``TOLERANCES`` that both sides computed."""
    rows = []
    for name, tol in TOLERANCES.items():
        if name not in got or name not in want:
            continue
        err = float(np.max(np.abs(np.asarray(got[name], np.float64)
                                  - np.asarray(want[name], np.float64))))
        rows.append((name, err, tol, bool(err <= tol)))
    return rows


class CpuReference:
    """float64 reference outputs from a child process that runs on the
    CPU only (JAX_PLATFORMS=cpu: it never opens the card). It starts at
    once, so it overlaps the card's phases; ``result`` waits for it."""

    def __init__(self, inputs: dict):
        self._tmp = tempfile.TemporaryDirectory()
        src = os.path.join(self._tmp.name, "in.npz")
        self._dst = os.path.join(self._tmp.name, "out.npz")
        np.savez(src, **inputs)
        env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
        self.inputs = inputs
        self.started = time.perf_counter()
        self._proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cpu-reference",
             src, self._dst], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)

    def result(self, timeout: float = 1200.0) -> dict:
        try:
            out, err = self._proc.communicate(timeout=timeout)
            if self._proc.returncode != 0:
                raise RuntimeError(f"CPU reference failed:\n{out}\n{err}")
            with np.load(self._dst) as f:
                return {k: f[k] for k in f.files}
        finally:
            self.close()

    def close(self) -> None:
        if self._proc.poll() is None:
            self._proc.kill()
            self._proc.communicate()
        self._tmp.cleanup()


def _cpu_reference_child(src: str, dst: str) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    with np.load(src) as f:
        inputs = {k: f[k] for k in f.files}
    np.savez(dst, **reference_outputs(inputs, jnp.float64))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_gate():
    """Exit non-zero unless JAX's first device is a GPU."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX platform is "
              f"{devices[0].platform!r}; nothing was run", file=sys.stderr)
        sys.exit(2)
    import contactimplicitmpc_tpu  # noqa: F401  (sets "highest" precision)
    from contactimplicitmpc_tpu.utils.runtime import (
        enable_compile_cache, nvidia_smi_name_and_power_limit)
    cache = enable_compile_cache()
    log(f"device: platform={devices[0].platform} "
        f"kind={devices[0].device_kind} count={len(devices)}")
    log(f"jax {jax.__version__}; jax_default_matmul_precision="
        f"{jax.config.jax_default_matmul_precision}; compile cache {cache}")
    log(f"nvidia-smi name, power.limit: {nvidia_smi_name_and_power_limit()}")
    return devices


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    return (f"memory_analysis: arguments {m.argument_size_in_bytes} B, "
            f"outputs {m.output_size_in_bytes} B, temporaries "
            f"{m.temp_size_in_bytes} B, code {m.generated_code_size_in_bytes} B")


def _build_sweep(batch: int):
    import jax
    import jax.numpy as jnp

    from contactimplicitmpc_tpu.hotpath import (HotPathConfig,
                                                conf_initial_states,
                                                make_quadruped_rollout)
    cfg = HotPathConfig()
    rollout, ref, model, env, dims = make_quadruped_rollout(
        cfg, SWEEP_STEPS, jnp.float32)
    q1s, v1s = conf_initial_states(model, ref, batch,
                                   jax.random.PRNGKey(SEED), jnp.float32)
    return cfg, rollout, ref, q1s, v1s


def sweep_health(ref, traj, stats, n_sample) -> list:
    """Failures against the tests/test_hotpath.py health bar."""
    import jax
    import jax.numpy as jnp

    from contactimplicitmpc_tpu.control.trajectory import tracking_errors
    fails = []
    conv = np.asarray(traj.sim_converged)
    nominal_ok = bool(conv[0].all())
    q_err = float(tracking_errors(ref, traj.q[0], traj.u[0], traj.gamma[0],
                                  traj.b[0], n_sample)[0])
    per_lane = conv.mean(axis=1)
    share = float(np.mean(per_lane >= LANE_STEP_SHARE))
    finite = all(bool(jnp.all(jnp.isfinite(x)))
                 for x in jax.tree_util.tree_leaves((traj, stats)))
    log(f"health: nominal lane converged at every step={nominal_ok}; "
        f"nominal q_err={q_err:.5f} (limit {Q_ERR_LIMIT:.5f}); lanes with "
        f">={LANE_STEP_SHARE:.0%} steps converged={share:.4f} (limit "
        f"{LANE_SHARE}); min lane {per_lane.min():.3f}; all finite={finite}")
    log(f"sweep stats: success_rate={float(stats.success_rate):.4f} "
        f"q_err={float(stats.q_err):.5f} u_err={float(stats.u_err):.5f} "
        f"newton_iters/ctrl={float(stats.mean_newton_iters):.3f} "
        f"ip_iters/sim_step={float(stats.mean_sim_iters):.3f}")
    if not nominal_ok:
        fails.append("nominal lane has an unconverged sim step")
    if not q_err < Q_ERR_LIMIT:
        fails.append(f"nominal q_err {q_err} >= {Q_ERR_LIMIT}")
    if not share >= LANE_SHARE:
        fails.append(f"lane share {share} < {LANE_SHARE}")
    if not finite:
        fails.append("non-finite sweep output")
    return fails


def phase_sweep(devices) -> list:
    from contactimplicitmpc_tpu.parallel import (make_mesh,
                                                 make_sharded_mpc_rollouts)
    cfg, rollout, ref, q1s, v1s = _build_sweep(SWEEP_BATCH)
    run = make_sharded_mpc_rollouts(make_mesh(1), rollout, ref, cfg.n_sample)
    t0 = time.perf_counter()
    compiled = run.lower(q1s, v1s).compile()
    log(f"sweep {SWEEP_BATCH} lanes x {SWEEP_STEPS} steps: compile "
        f"(set-up) {time.perf_counter() - t0:.3f} s")
    log(_memory_line(compiled))
    (traj, stats), t_first = _timed(compiled, q1s, v1s)
    (traj, stats), t_warm = _timed(compiled, q1s, v1s)
    peak = (devices[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"sweep wall: first run {t_first:.4f} s, warm run {t_warm:.4f} s; "
        f"peak_bytes_in_use {peak}")
    return sweep_health(ref, traj, stats, cfg.n_sample)


def phase_policy(devices) -> list:
    import jax
    import jax.numpy as jnp

    import contactimplicitmpc_tpu as ci
    from __graft_entry__ import _quadruped_policy
    from contactimplicitmpc_tpu.control import initial_conditions
    from contactimplicitmpc_tpu.hotpath import HotPathConfig

    n_sample = 5   # _quadruped_policy's default
    model, env, ref, policy = _quadruped_policy(jnp.float32)
    q1, v1 = initial_conditions(ref)
    # the float32 sim tolerances of the shipped hot path, with the
    # adaptive loop that bench.py's batch-1 latency lane runs
    sim_opts = dataclasses.replace(HotPathConfig(),
                                   sim_fixed_iters=0).sim_ip_options()
    sim = jax.jit(lambda q, v: ci.simulate(
        model, env, POLICY_STEPS, float(ref.h) / n_sample, q, v,
        policy=policy, opts=sim_opts))
    t0 = time.perf_counter()
    compiled = sim.lower(q1, v1).compile()
    log(f"per-call policy, {POLICY_STEPS} sim steps: compile (set-up) "
        f"{time.perf_counter() - t0:.3f} s")
    traj, _ = _timed(compiled, q1, v1)
    traj, t_warm = _timed(compiled, q1, v1)
    n_calls = POLICY_STEPS // n_sample
    conv = np.asarray(traj.converged)
    log(f"per-call policy: warm {t_warm:.4f} s for {n_calls} control calls; "
        f"converged steps {int(conv.sum())}/{conv.size}")
    fails = []
    if not conv.all():
        fails.append("per-call policy: a sim step did not converge")
    if not all(bool(jnp.all(jnp.isfinite(x)))
               for x in jax.tree_util.tree_leaves(traj)):
        fails.append("per-call policy: non-finite output")
    return fails


def knot_ip_time(reps: int = 20) -> float:
    """Median warm time of vmap(linearized_ip_fixed) at the bench's shape:
    256 lanes × 9 knot solves (H_mpc − 1) = 2304 problems, float32,
    the shipped ``fixed_ip_iters`` and ``refine``."""
    import jax
    import jax.numpy as jnp

    from contactimplicitmpc_tpu.control import linearize_trajectory
    from contactimplicitmpc_tpu.control.linearized import gather
    from contactimplicitmpc_tpu.hotpath import HotPathConfig
    from contactimplicitmpc_tpu.ops.fixed_ip import linearized_ip_fixed

    cfg = HotPathConfig()
    n = SWEEP_BATCH * (cfg.h_mpc - 1)
    dtype = jnp.float32
    model, env, dims, ref = _quadruped(dtype)
    idx = jnp.arange(n) % ref.horizon
    lin = gather(linearize_trajectory(model, env, ref, cfg.kappa_mpc), idx)
    theta = ref.theta[idx] + 0.003 * jax.random.normal(
        jax.random.PRNGKey(SEED), (n, ref.theta.shape[1]), dtype)
    q2 = ref.q[2:][idx]
    alt = jnp.zeros((n, dims.nc), dtype)
    opts = cfg.mpc_ip_options()
    fn = jax.jit(jax.vmap(
        lambda z0, th0, r0, rz0, rt0, a, th, q:
        linearized_ip_fixed(dims, z0, th0, r0, rz0, rt0, a, th, q, opts,
                            iters=cfg.fixed_ip_iters)))
    args = (lin.z0, lin.theta0, lin.r0, lin.rz0, lin.rtheta0, alt, theta, q2)
    jax.block_until_ready(fn(*args))
    times = [_timed(fn, *args)[1] for _ in range(reps)]
    return float(np.median(times))


def start_reference() -> CpuReference:
    """The float64 reference over every knot of gait2 (60)."""
    from contactimplicitmpc_tpu.utils.gaits import load_gait
    n_knots = load_gait("quadruped", "gait2")["u"].shape[0]
    return CpuReference(reference_inputs(n_knots))


def phase_reference(devices, job: CpuReference | None = None) -> list:
    import jax
    import jax.numpy as jnp

    job = job or start_reference()
    got = reference_outputs(job.inputs, jnp.float32)
    want = job.result()
    n_knots = len(want["knot_converged"])
    log(f"reference: float64 on the CPU (child process) over {n_knots} "
        f"knots, done {time.perf_counter() - job.started:.3f} s after "
        f"its start")
    fails = []
    prec = jax.config.jax_default_matmul_precision
    for name, err, tol, ok in compare(got, want):
        log(f"reference {name}: max |f32 card - f64 cpu| = {err:.3e} "
            f"(tolerance {tol:.0e}, precision {prec}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"reference {name} error {err} > {tol}")
    for side, out in (("card", got), ("cpu", want)):
        log(f"reference converged ({side}): knots "
            f"{int(out['knot_converged'].sum())}/{n_knots}, sim steps "
            f"{int(out['sim_converged'].sum())}/{n_knots}")
    # the same knot solve with TF32 products, on record only (solver
    # algebra that asks for HIGHEST precision explicitly is unaffected)
    with jax.default_matmul_precision("tensorfloat32"):
        tf32 = knot_outputs(job.inputs, jnp.float32)
    for name in ("knot_z", "knot_q2"):
        err = float(np.max(np.abs(tf32[name] - want[name])))
        log(f"reference {name} under tensorfloat32: max |f32 card - f64 "
            f"cpu| = {err:.3e} (not gated)")
    log(f"knot interior point at the bench shape (2304 problems, f32, "
        f"8 iterations, refine 1): warm median {knot_ip_time():.6f} s")
    return fails


def phase_four(devices) -> list:
    """Sweep sharded over 4 GPUs vs a plain vmap on one GPU."""
    import jax
    import jax.numpy as jnp

    from contactimplicitmpc_tpu.control.trajectory import tracking_errors
    from contactimplicitmpc_tpu.parallel import (make_mesh,
                                                 make_sharded_mpc_rollouts)
    if len(devices) < 4:
        return [f"--four needs 4 GPUs, found {len(devices)}"]
    cfg, rollout, ref, q1s, v1s = _build_sweep(FOUR_BATCH)
    n1 = FOUR_BATCH // 4
    put = lambda x: jax.device_put(x[:n1], devices[0])
    q1_one, v1_one = put(q1s), put(v1s)
    run = make_sharded_mpc_rollouts(make_mesh(4), rollout, ref, cfg.n_sample)
    one = jax.jit(jax.vmap(rollout))
    t0 = time.perf_counter()
    lowered = [run.lower(q1s, v1s), one.lower(q1_one, v1_one)]
    # the two XLA compiles are independent: run them side by side
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        compiled4, compiled1 = pool.map(lambda lo: lo.compile(), lowered)
    log(f"sharded sweep ({FOUR_BATCH} lanes, 4 GPUs) and one-GPU vmap "
        f"({n1} lanes): trace + compile (set-up) "
        f"{time.perf_counter() - t0:.3f} s")
    log(_memory_line(compiled4))
    (traj4, stats4), t_first = _timed(compiled4, q1s, v1s)
    (traj4, stats4), t4 = _timed(compiled4, q1s, v1s)
    log(f"sharded sweep wall: first run {t_first:.4f} s, warm run "
        f"{t4:.4f} s")
    traj1, t1 = _timed(compiled1, q1_one, v1_one)
    log(f"one-GPU vmap of the first {n1} lanes: first run {t1:.4f} s")
    # health of the 1024 lanes, on record (this phase gates on agreement)
    sweep_health(ref, traj4, stats4, cfg.n_sample)
    fails = []

    # The overlapping lanes. The two programs are compiled separately and
    # round differently; the sim solve stops at a residual of 1e-3 and
    # the closed loop of contact events amplifies the difference until
    # lanes part ways (on the H100, 40 of 256 lanes stayed bit-equal over
    # 250 steps, and the first sim step already differed by 1.4e-3 in q
    # with identical controls). So the gate is what sharding can break:
    # every lane's inputs (its first two configurations) are bit-equal;
    # over the first control period (one solve, 5 sim steps) u agrees to
    # 1e-3 — the bound of one control update, whose f32 card vs f64 CPU
    # error is ~1.5e-4 — and q to 1e-2, the sim solve's reach at its
    # tolerance with a 7x margin over what was measured; and the number
    # of lanes converged at every step differs by at most 1% of lanes.
    # Growth after the first period is on record.
    q4, q1_ = np.asarray(traj4.q[:n1]), np.asarray(traj1.q)
    u4, u1_ = np.asarray(traj4.u[:n1]), np.asarray(traj1.u)
    same = np.all(q4 == q1_, axis=(1, 2)) & np.all(u4 == u1_, axis=(1, 2))
    inputs_equal = bool(np.all(q4[:, :2] == q1_[:, :2]))
    dq_q = np.max(np.abs(q4 - q1_), axis=(0, 2))      # per step, all lanes
    dq_u = np.max(np.abs(u4 - u1_), axis=(0, 2))
    first = cfg.n_sample
    dq0 = float(np.max(dq_q[2:first + 2]))
    du0 = float(np.max(dq_u[:first]))
    ok4 = np.asarray(traj4.sim_converged[:n1]).all(axis=1)
    ok1 = np.asarray(traj1.sim_converged).all(axis=1)
    log(f"sharded vs one-GPU, first {n1} lanes: bit-equal lanes "
        f"{int(same.sum())}/{n1}; inputs bit-equal {inputs_equal}; first "
        f"control period max |dq| {dq0:.3e} (tolerance 1e-2), max |du| "
        f"{du0:.3e} (tolerance 1e-3); lanes converged at every step "
        f"{int(ok4.sum())} (sharded) / {int(ok1.sum())} (one GPU)")
    growth = ", ".join(f"step {t}: {float(np.max(dq_q[:t + 2])):.3e}"
                       for t in (5, 10, 25, 50, 100, 250))
    log(f"sharded vs one-GPU max |dq| up to {growth}")
    differ = np.flatnonzero(np.any(q4 != q1_, axis=(0, 2)))
    log(f"first sim step at which any lane's q differs: "
        f"{differ[0] - 2 if differ.size else 'none'}")
    if not inputs_equal:
        fails.append("sharded lanes got other inputs than the one-GPU run")
    if not (dq0 <= 1e-2 and du0 <= 1e-3):
        fails.append(f"first control period differs: {dq0}, {du0}")
    if abs(int(ok4.sum()) - int(ok1.sum())) > n1 // 100:
        fails.append(f"converged lanes: {int(ok4.sum())} vs {int(ok1.sum())}")

    # the psum statistics against the same sums over the per-lane outputs
    conv = np.asarray(traj4.sim_converged)
    ok = conv.all(axis=1)
    errs = np.asarray(jax.vmap(lambda q, u, g, b: jnp.stack(tracking_errors(
        ref, q, u, g, b, cfg.n_sample)))(traj4.q, traj4.u, traj4.gamma,
                                         traj4.b))
    expect = {"n_rollouts": float(FOUR_BATCH),
              "success_rate": float(ok.mean()),
              "q_err": float(errs[ok, 0].mean()),
              "u_err": float(errs[ok, 1].mean()),
              "mean_sim_iters": float(np.asarray(
                  traj4.sim_iterations, np.float64).mean())}
    for name, want in expect.items():
        got = float(getattr(stats4, name))
        good = abs(got - want) <= 1e-5 * max(1.0, abs(want))
        log(f"psum {name}: {got:.6f} vs per-lane {want:.6f} "
            f"{'ok' if good else 'FAIL'}")
        if not good:
            fails.append(f"psum {name} {got} != per-lane {want}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded sweep")
    ap.add_argument("--cpu-reference", nargs=2, metavar=("IN", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_reference:
        _cpu_reference_child(*args.cpu_reference)
        return 0

    if args.four:
        # autotuning picks kernels by timing, one more source of
        # difference between the two compiles --four compares, and it
        # lengthens them; it is off for this phase
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_autotune_level=0").strip()
    devices = device_gate()
    job = None if args.four else start_reference()
    phases = ([phase_four] if args.four else
              [phase_sweep, phase_policy,
               functools.partial(phase_reference, job=job)])
    failed = []
    try:
        for phase in phases:
            name = getattr(phase, "func", phase).__name__
            log(f"--- {name}")
            try:
                fails = phase(devices)
            except Exception:  # report, go on to the next phase; exit 1
                traceback.print_exc()
                fails = [f"{name} raised"]
            for f in fails:
                log(f"FAIL: {f}")
            failed += fails
    finally:
        if job is not None:
            job.close()
    if failed:
        log(f"chip_smoke: {len(failed)} failure(s)")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
