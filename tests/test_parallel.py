"""Sharded Monte-Carlo rollouts on a virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.models import particle_2d
from contactimplicitmpc_tpu.parallel import (make_mesh, monte_carlo_rollouts,
                                             sharded_rollout_stats,
                                             sharded_rollouts)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _batch(n):
    xs = jnp.linspace(-1.0, 1.0, n)
    q1 = jnp.stack([xs, jnp.ones(n)], axis=1)
    v1 = jnp.zeros((n, 2))
    return q1, v1


def test_mesh_shape(mesh):
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("dp",)


@pytest.mark.parametrize("n", [1, 3, 8])
def test_make_mesh_is_1d(n):
    """One data-parallel axis over the first n devices, in device order."""
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    mesh = make_mesh(n)
    assert mesh.devices.shape == (n,)
    assert mesh.axis_names == ("dp",)
    assert list(mesh.devices) == jax.devices()[:n]


def test_sharded_rollouts_match_local(mesh):
    q1, v1 = _batch(16)
    local = monte_carlo_rollouts(particle_2d, ci.flat_2d_lc, 30, 0.01,
                                 q1, v1)
    shard = sharded_rollouts(mesh, particle_2d, ci.flat_2d_lc, 30, 0.01,
                             q1, v1)
    np.testing.assert_allclose(np.asarray(local.q), np.asarray(shard.q),
                               atol=1e-12)
    assert bool(jnp.all(shard.converged))


def test_sharded_stats_psum(mesh):
    q1, v1 = _batch(16)
    stats = sharded_rollout_stats(mesh, particle_2d, ci.flat_2d_lc, 30,
                                  0.01, q1, v1)
    assert float(stats.n_rollouts) == 16.0
    assert float(stats.success_rate) == 1.0
    # mean final q across all shards == local mean
    local = monte_carlo_rollouts(particle_2d, ci.flat_2d_lc, 30, 0.01,
                                 q1, v1)
    np.testing.assert_allclose(np.asarray(stats.mean_final_q),
                               np.asarray(jnp.mean(local.q[:, -1], axis=0)),
                               atol=1e-6)


def test_dryrun_multichip_refuses_missing_devices():
    """The CPU rehearsal raises, never falls back, when the backend
    cannot give it the devices it needs."""
    from __graft_entry__ import dryrun_multichip
    with pytest.raises(RuntimeError, match="needs 16 CPU devices"):
        dryrun_multichip(16)
