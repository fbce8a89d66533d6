"""Pivot-free small dense solvers vs numpy oracles (the reference tests
its QR/LU/Schur the same way: random matrices vs `\\`,
test/solver/{qr,lu,schur}.jl)."""

import jax
import jax.numpy as jnp
import numpy as np

from contactimplicitmpc_tpu.ops.linsolve import (gj_inverse, gj_solve,
                                                 mgs_qr, mgs_solve)


def _rand_spd_ish(key, n, batch=None):
    shape = (batch, n, n) if batch else (n, n)
    a = jax.random.normal(key, shape)
    return a + 3.0 * jnp.eye(n)


def test_gj_inverse_oracle():
    a = _rand_spd_ish(jax.random.PRNGKey(0), 16)
    inv = gj_inverse(a)
    np.testing.assert_allclose(np.asarray(inv @ a), np.eye(16), atol=1e-8)


def test_gj_solve_multi_rhs():
    key = jax.random.PRNGKey(1)
    a = _rand_spd_ish(key, 24)
    b = jax.random.normal(jax.random.PRNGKey(2), (24, 5))
    x = gj_solve(a, b)
    np.testing.assert_allclose(np.asarray(a @ x), np.asarray(b), atol=1e-8)


def test_gj_vmap_batch():
    a = _rand_spd_ish(jax.random.PRNGKey(3), 11, batch=32)
    b = jax.random.normal(jax.random.PRNGKey(4), (32, 11))
    x = jax.vmap(gj_solve)(a, b)
    res = jnp.einsum("bij,bj->bi", a, x) - b
    assert float(jnp.max(jnp.abs(res))) < 1e-8


def test_mgs_qr_oracle():
    """Q orthonormal, R upper triangular, QR = A (test/solver/qr.jl)."""
    a = jax.random.normal(jax.random.PRNGKey(5), (16, 16))
    q, r = mgs_qr(a)
    np.testing.assert_allclose(np.asarray(q.T @ q), np.eye(16), atol=1e-9)
    np.testing.assert_allclose(np.asarray(r), np.triu(np.asarray(r)))
    np.testing.assert_allclose(np.asarray(q @ r), np.asarray(a), atol=1e-9)


def test_mgs_solve_oracle():
    a = jax.random.normal(jax.random.PRNGKey(6), (20, 20))
    b = jax.random.normal(jax.random.PRNGKey(7), (20,))
    x = mgs_solve(a, b)
    np.testing.assert_allclose(np.asarray(a @ x), np.asarray(b), atol=1e-8)


def test_gj_pivot_boost_zero_diagonal():
    """A zero pivot is floored, not propagated as NaN."""
    a = jnp.eye(4).at[0, 0].set(0.0).at[0, 1].set(1.0).at[1, 0].set(1.0)
    x = gj_solve(a, jnp.ones((4,)), boost=1e-12)
    assert bool(jnp.all(jnp.isfinite(x)))


def test_ldl_factor_oracle():
    """LDLᵀ reconstructs a symmetric quasi-definite KKT (ldl.jl role:
    the ±β-regularized Newton KKT, newton.jl:280)."""
    from contactimplicitmpc_tpu.ops.linsolve import ldl_factor
    key = jax.random.PRNGKey(3)
    n = 14
    g = jax.random.normal(key, (8, 8))
    c = jax.random.normal(jax.random.PRNGKey(4), (6, 8))
    a = jnp.block([[g @ g.T + 0.1 * jnp.eye(8), c.T],
                   [c, -0.1 * jnp.eye(6)]])
    l, d = ldl_factor(a)
    np.testing.assert_allclose(np.asarray(l @ jnp.diag(d) @ l.T),
                               np.asarray(a), atol=1e-6)
    assert np.allclose(np.asarray(jnp.triu(l, 1)), 0.0)  # lower triangular
    assert (np.asarray(d)[:8] > 0).all() and (np.asarray(d)[8:] < 0).all()


def test_ldl_solve_oracle_and_vmap():
    from contactimplicitmpc_tpu.ops.linsolve import ldl_solve
    key = jax.random.PRNGKey(5)
    n = 12
    a0 = jax.random.normal(key, (4, n, n))
    a = a0 @ jnp.swapaxes(a0, 1, 2) + 0.5 * jnp.eye(n)
    b = jax.random.normal(jax.random.PRNGKey(6), (4, n, 3))
    x = jax.vmap(ldl_solve)(a, b)
    np.testing.assert_allclose(np.asarray(a @ x), np.asarray(b), atol=1e-7)
