#!/usr/bin/env python
"""Microbenchmark: direct-mode horizon-KKT solve backends on the GPU.

Workload = the direct-mode Newton's linear solve (newton.py:321-327):
one symmetric quasidefinite KKT matrix per rollout lane, batch of 256
lanes (the Monte-Carlo sweep shape), quadruped configuration mode at
H_mpc=10 → n = 10·(19+11) = 300.

Backends: unpivoted LDLᵀ (ops/linsolve.ldl_solve, QDLDL role) vs XLA's
pivoted LU (jnp.linalg.solve). Decides NewtonOptions.kkt_solver.
Correctness is cross-checked against the other backend on the same batch.

Run: python tools/kkt_solver_bench.py   (prints to stderr)
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import jax.numpy as jnp

from contactimplicitmpc_tpu.ops.linsolve import ldl_solve
from contactimplicitmpc_tpu.utils.runtime import enable_compile_cache

BATCH = 256
H, NR, ND = 10, 19, 11
N = H * (NR + ND)


def main():
    jax.config.update("jax_default_matmul_precision", "highest")
    enable_compile_cache()
    devices = jax.devices()
    print(f"device: {devices[0].platform} {devices[0].device_kind} "
          f"x{len(devices)}", file=sys.stderr, flush=True)
    key = jax.random.PRNGKey(0)
    # synthetic SQD KKT with the real block signature: SPD primal block,
    # negative-definite dual regularization, dense couplings
    k1, k2 = jax.random.split(key)
    a = 0.1 * jax.random.normal(k1, (BATCH, N, N), jnp.float32)
    sym = 0.5 * (a + jnp.swapaxes(a, 1, 2))
    npb = H * NR
    diag = jnp.concatenate([2.0 * jnp.ones((npb,)),
                            -2.0 * jnp.ones((N - npb,))]).astype(jnp.float32)
    mats = sym + jnp.diag(diag)[None]
    rhs = jax.random.normal(k2, (BATCH, N), jnp.float32)

    def timeit(name, fn):
        out = jax.block_until_ready(fn(mats, rhs))
        reps = 20
        t0 = time.time()
        for _ in range(reps):
            out = jax.block_until_ready(fn(mats, rhs))
        dt = (time.time() - t0) / reps
        res = jnp.einsum("bij,bj->bi", mats, out) - rhs
        rel = float(jnp.max(jnp.abs(res)) / jnp.max(jnp.abs(rhs)))
        print(f"{name:>8}: {BATCH / dt:>10.0f} KKT-solves/s "
              f"({dt * 1e3:.2f} ms/batch, max rel residual {rel:.2e})",
              file=sys.stderr, flush=True)
        return out

    x_ldl = timeit("ldl", jax.jit(jax.vmap(
        lambda m, b: ldl_solve(m, b[:, None])[:, 0])))
    x_lu = timeit("lu", jax.jit(jax.vmap(jnp.linalg.solve)))
    print(f"backend agreement: max|Δx| = "
          f"{float(jnp.max(jnp.abs(x_ldl - x_lu))):.2e}",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
