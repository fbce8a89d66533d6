"""Worker program for the 2-process multi-host smoke test.

Run by tests/test_multihost.py with CIMPC_COORDINATOR / CIMPC_NUM_PROCESSES
/ CIMPC_PROCESS_ID set. Each process owns 4 virtual CPU devices; the global
mesh is one 8-device ``dp`` axis, each process owning a contiguous half.
The program is the sharded Monte-Carlo sweep (parallel/rollouts.py) over
the global batch: each process feeds only its local slice, statistics psum
across the full mesh, and every process checks the GLOBAL reductions — the
same SPMD shape as a sweep over several GPU hosts.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import contactimplicitmpc_tpu as ci
from contactimplicitmpc_tpu.models import particle_2d
from contactimplicitmpc_tpu.parallel import distributed
from contactimplicitmpc_tpu.parallel.rollouts import sharded_rollout_stats


def main():
    assert distributed.initialize(), "expected multi-process env vars"
    pid = jax.process_index()
    assert jax.process_count() == 2
    assert jax.local_device_count() == 4
    assert len(jax.devices()) == 8

    mesh = distributed.make_global_mesh()
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("dp",)
    # each process owns one contiguous block of the dp axis
    assert [d.process_index for d in mesh.devices] == [0] * 4 + [1] * 4

    # global batch 16 = 2 processes x 8 local lanes; distinct initial
    # heights per lane so the psum'd mean is a real cross-host reduction
    n_local = 8
    lane = pid * n_local + np.arange(n_local)
    q1_local = np.stack([0.1 * lane, np.ones(n_local)], axis=1)
    v1_local = np.zeros((n_local, 2))
    q1 = distributed.global_batch(mesh, q1_local)
    v1 = distributed.global_batch(mesh, v1_local)

    stats = sharded_rollout_stats(mesh, particle_2d, ci.flat_2d_lc, 30,
                                  0.01, q1, v1)
    n = float(stats.n_rollouts)
    succ = float(stats.success_rate)
    # particles drop to rest: mean final q = (mean x, ~0); x is conserved
    mean_x = float(stats.mean_final_q[0])
    expect_x = float(np.mean(0.1 * np.arange(16)))
    assert n == 16.0, n
    assert succ == 1.0, succ
    assert abs(mean_x - expect_x) < 1e-6, (mean_x, expect_x)
    print(f"MULTIHOST_OK pid={pid} n={n} succ={succ} mean_x={mean_x:.4f}",
          flush=True)


if __name__ == "__main__":
    main()
