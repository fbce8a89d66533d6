"""Regression-test the SHIPPED hot-path configuration.

``bench.py`` and this test build their rollout from the same
``contactimplicitmpc_tpu.hotpath.HotPathConfig`` defaults, so any change
to a product hot-path default (fixed-iteration counts, refinement,
warm-start policy, line-search bound, reset scale) lands here before it
lands in the driver-run benchmark.

Runs in float32 on CPU (the bench dtype; conftest enables x64 globally
but all arrays here are created f32) at a reduced batch/steps budget.
Thresholds are the reference CI contract
(/root/reference/test/controller/mpc_quadruped.jl:61-68) for the nominal
lane plus a Monte-Carlo success floor set before the move to the H100
and not yet measured there (ROADMAP D3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from contactimplicitmpc_tpu.control.trajectory import tracking_errors
from contactimplicitmpc_tpu.hotpath import (HotPathConfig,
                                            conf_initial_states,
                                            make_quadruped_rollout)


@pytest.fixture(scope="module")
def hotpath_run():
    cfg = HotPathConfig()  # the shipped defaults — do NOT override here
    steps = 100
    batch = 16
    dtype = jnp.float32
    rollout, ref, model, env, dims = make_quadruped_rollout(
        cfg, steps, dtype)

    # bench "conf" distribution, lane 0 nominal
    q1s, v1s = conf_initial_states(model, ref, batch, jax.random.PRNGKey(0),
                                   dtype)
    out = jax.jit(jax.vmap(rollout))(q1s, v1s)
    jax.block_until_ready(out)
    return cfg, ref, out, batch


def test_hotpath_dtype_and_shapes(hotpath_run):
    cfg, ref, out, batch = hotpath_run
    assert out.q.dtype == jnp.float32
    assert out.q.shape[0] == batch


def test_hotpath_nominal_tracking(hotpath_run):
    """Nominal lane against mpc_quadruped.jl:61-68 thresholds (the same
    contract the bench's 'nominal lane' line reports)."""
    cfg, ref, out, _ = hotpath_run
    assert bool(jnp.all(out.sim_converged[0])), "nominal lane sim failed"
    qe, ue, ge, be = tracking_errors(
        ref, out.q[0], out.u[0], out.gamma[0], out.b[0], cfg.n_sample)
    print(f"hotpath nominal: q={float(qe):.4f} u={float(ue):.4f} "
          f"γ={float(ge):.4f} b={float(be):.4f}")
    assert float(qe) < 0.0201 * 1.5, float(qe)
    assert float(ue) < 0.0437 * 1.5, float(ue)
    assert float(ge) < 0.374 * 1.5, float(ge)
    assert float(be) < 0.0789 * 1.5, float(be)


def test_hotpath_batch_success(hotpath_run):
    """Monte-Carlo lane survival at the shipped defaults: every lane of
    this 16-pose sample of the reference distribution must finish with
    ≥95% converged sim steps (bench-wide success floor, ROADMAP D3)."""
    cfg, ref, out, batch = hotpath_run
    per_lane = jnp.mean(out.sim_converged.astype(jnp.float32), axis=1)
    success = jnp.mean((per_lane >= 0.95).astype(jnp.float32))
    print(f"hotpath batch success: {float(success):.3f} "
          f"(per-lane min {float(jnp.min(per_lane)):.3f})")
    assert float(success) >= 0.9, np.asarray(per_lane)


def test_hotpath_finite_health(hotpath_run):
    """No NaN/Inf leaks into the rollout outputs at the shipped config."""
    _, _, out, _ = hotpath_run
    for leaf in jax.tree_util.tree_leaves(out):
        assert bool(jnp.all(jnp.isfinite(leaf)))
