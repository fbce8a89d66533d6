"""The shipped product hot-path configuration, as one importable object.

``bench.py`` (the headline benchmark), ``chip_smoke.py`` and the CI
regression test ``tests/test_hotpath.py`` all build their rollout from
THIS module, so the configuration the benchmark ships is — by
construction — the configuration CI guards: the bench defaults (f32,
fixed-iteration knot solves, duals-only warm start, bounded line-search
fallback, cold-restart scale) were tuned by hand-run sweeps, and a plain
refactor could silently break the product path.

Reference contract anchors:
* MPC recipe: ``/root/reference/examples/quadruped/flat.jl:25-29``
  (N_sample=5, H_mpc=10, κ_mpc=2e-4)
* tracking thresholds: ``/root/reference/test/controller/mpc_quadruped.jl:61-68``
* timing recipe: ``/root/reference/examples/quadruped/flat.jl:77-79``

Every non-reference default was chosen by sweeps run before the move to
the H100 and is not measured there yet (ROADMAP D3).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class HotPathConfig:
    """Every knob of the product Monte-Carlo rollout program.

    Defaults = the shipped f32 bench configuration. ``bench.py``
    overrides individual fields from ``CIMPC_BENCH_*`` environment
    variables; the CI test asserts closed-loop health at these exact
    defaults on the CPU backend.
    """

    h_mpc: int = 10
    n_sample: int = 5
    kappa_mpc: float = 2.0e-4
    newton_mode: str = "structure"

    # Newton options (control/newton.py provenance comments)
    newton_r_tol: float = 3.0e-4
    newton_iters: int = 5
    newton_max_ls: int = 6           # line-search halvings (newton.jl:249)
    fixed_ip_iters: int = 8          # fixed=8 + refine=1 (ROADMAP D3)
    trial_ip_iters: int = 0          # >0: reduced budget for LS trials
    fixed_newton_iters: int = 0      # 0 = adaptive while_loop
    ls_growth_allow: float = 2.0     # bounded no-accept fallback (f32)
    newton_reset_scale: float = 10.0  # cold-restart trapped warm starts

    # MPC-knot interior point
    mpc_r_tol: float = 1.0e-5
    mpc_ip_iters: int = 30
    gamma_reg: float = 0.1
    mpc_max_ls: int = 3
    refine: int = 1                  # knot-solve refinement (ROADMAP D3)
    mpc_unroll: int = 1              # unroll factor, knot fixed-ip loop

    # simulation-path interior point
    sim_r_tol: float = 1.0e-3
    sim_kappa_tol: float = 1.0e-5
    sim_iters: int = 40
    sim_max_ls: int = 6
    sim_refine: int = 0
    sim_fixed_iters: int = 24        # masked fixed-iteration sim solves
    #                                  (chosen over the adaptive loop at
    #                                  equal health before the move to
    #                                  the H100, ROADMAP D3; 0 =
    #                                  adaptive while_loop, which
    #                                  bench.py's latency lanes select)
    sim_unroll: int = 1              # unroll factor, sim fixed-ip loop
    sim_retries: int = 0

    # warm starts
    warm_start_floor: float = 1.0e-2
    structure_full_warm: bool = False  # duals-only (ROADMAP D3)

    def newton_options(self):
        from .control.newton import NewtonOptions
        return NewtonOptions(r_tol=self.newton_r_tol,
                             max_iter=self.newton_iters,
                             max_ls=self.newton_max_ls,
                             fixed_ip_iters=self.fixed_ip_iters,
                             trial_ip_iters=self.trial_ip_iters,
                             fixed_newton_iters=self.fixed_newton_iters,
                             ls_growth_allow=self.ls_growth_allow)

    def mpc_ip_options(self):
        from .sim.interior_point import IPOptions
        return IPOptions(r_tol=self.mpc_r_tol, kappa_tol=self.kappa_mpc,
                         max_iter=self.mpc_ip_iters, undercut=5.0,
                         gamma_reg=self.gamma_reg, diff_sol=True,
                         max_ls=self.mpc_max_ls, refine=self.refine,
                         unroll=self.mpc_unroll)

    def sim_ip_options(self):
        from .sim.interior_point import IPOptions
        return IPOptions(r_tol=self.sim_r_tol,
                         kappa_tol=self.sim_kappa_tol,
                         max_iter=self.sim_iters,
                         undercut=float("inf"), max_ls=self.sim_max_ls,
                         retries=self.sim_retries, refine=self.sim_refine,
                         fixed_iters=self.sim_fixed_iters,
                         unroll=self.sim_unroll)


def quadruped_tracking_weights(dims, h_mpc, dtype):
    """The flat-ground quadruped objective (mpc_quadruped.jl:23-27 /
    examples/quadruped/flat.jl:31-36)."""
    from .control import tracking_objective
    qw = 1e-2 * np.array([1.0, 0.02, 0.25] + [0.25] * (dims.nq - 3))
    return tracking_objective(
        dims, h_mpc, q=np.tile(qw, (h_mpc, 1)),
        u=3e-2 * np.ones((h_mpc, dims.nu)),
        gamma=1e-100 * np.ones((h_mpc, dims.nc)),
        b=1e-100 * np.ones((h_mpc, dims.nb)), dtype=dtype)


def conf_initial_states(model, ref, batch: int, key, dtype):
    """``(q1s, v1s)`` for a Monte-Carlo sweep of ``batch`` lanes drawn
    from the reference study's own distribution: kinematically-consistent
    standing poses sampled from leg-angle/pose ranges
    (examples/quadruped/monte_carlo.jl:80-89 via initial_configuration
    :94-116), at the gait's initial velocity.

    Lane 0 runs the reference's unperturbed initial condition
    (mpc_quadruped.jl:51-53), so its tracking error compares directly with
    the published nominal 0.0201.
    """
    import jax
    import jax.numpy as jnp

    from .control import initial_conditions
    from .models.quadruped import initial_configuration

    q1, v1 = initial_conditions(ref)
    cmin = jnp.asarray([0.0, 0.6, 0.6, 0.6, -0.2, -0.3], dtype)
    cmax = jnp.asarray([0.05, 0.8, 0.8, 0.8, 0.2, 0.1], dtype)
    conf = cmin + (cmax - cmin) * jax.random.uniform(key, (batch, 6), dtype)
    conf = conf.at[:, 5].set(jnp.maximum(conf[:, 5], 0.0))
    q1s = jax.vmap(lambda c: initial_configuration(
        model, c[0], c[1], c[2], c[3], c[4], c[5]))(conf).astype(dtype)
    q1s = q1s.at[0].set(q1.astype(dtype))
    v1s = jnp.broadcast_to(v1, (batch, q1.shape[0])).astype(dtype)
    return q1s, v1s


def make_quadruped_rollout(cfg: HotPathConfig, steps: int, dtype):
    """Build (rollout_fn, ref, model, env, dims) for the flat-ground
    quadruped Monte-Carlo program — the exact closure ``bench.py`` times.

    ``rollout_fn(q1, v1)`` runs one closed-loop rollout of ``steps`` sim
    steps; vmap/shard_map it for batches.
    """
    from . import flat_2d_lc
    from .control import from_gait
    from .control.implicit_dynamics import CONFIGURATION
    from .control.rollout import mpc_rollout
    from .models import quadruped as model
    from .models.base import dims_of
    from .utils.gaits import load_gait

    env = flat_2d_lc
    dims = dims_of(model, env)
    ref = from_gait(model, env, load_gait("quadruped", "gait2"),
                    update_friction=True, dtype=dtype)
    obj = quadruped_tracking_weights(dims, cfg.h_mpc, dtype)

    def rollout(q1, v1):
        return mpc_rollout(model, env, ref, obj, steps, cfg.h_mpc,
                           cfg.n_sample, cfg.kappa_mpc, CONFIGURATION,
                           q1, v1,
                           n_opts=cfg.newton_options(),
                           ip_opts=cfg.mpc_ip_options(),
                           sim_opts=cfg.sim_ip_options(),
                           warm_start_floor=cfg.warm_start_floor,
                           newton_mode=cfg.newton_mode,
                           newton_reset_scale=cfg.newton_reset_scale,
                           structure_full_warm=cfg.structure_full_warm)

    return rollout, ref, model, env, dims
