"""Small-matrix dense solvers without pivoting.

XLA's pivoted LU (``lu_factor``/``jnp.linalg.solve``) lowers to a
sequential row-swap loop with per-step gathers. For the tiny systems this
framework solves (nq ≈ 2–18, ny ≈ 3–48) these replacements use
*unpivoted* elimination whose per-step work is pure elementwise/rank-1
arithmetic, so a ``vmap`` over problems (batch lanes, horizon knots)
vectorizes without gathers. The choice was made on another accelerator;
whether it beats batched LU on the H100 is not measured yet (ROADMAP S6).

Pivot-free is safe here by construction, mirroring the reference:

* the cone Schur complement S is exactly the matrix the reference
  factorizes with unpivoted modified Gram-Schmidt QR
  (``src/solver/qr.jl:4-177`` via ``src/solver/schur.jl:13-110``);
* the dynamics block Dx is mass-matrix dominated;
* the horizon KKT is symmetric quasidefinite once the Newton solve adds
  its ±β regularization (``newton.jl:280``), and SQD matrices are
  strongly factorizable without pivoting (Vanderbei 1995).

A tiny magnitude floor on the pivot (``boost``) guards exact zeros.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# f32 matmuls may run at reduced precision (TF32 on the H100); solver
# algebra needs full f32 products or unpivoted elimination loses digits
# and the IP iterations stop converging.
_P = jax.lax.Precision.HIGHEST


def pdot(a, b):
    """Full-precision matmul for solver algebra."""
    return jnp.matmul(a, b, precision=_P)


class GJFactors:
    """Opaque factor handle: Gauss-Jordan stores the inverse explicitly."""

    __slots__ = ("inv",)

    def __init__(self, inv):
        self.inv = inv


def _boost_pivot(piv, boost):
    mag = jnp.abs(piv)
    sign = jnp.where(piv >= 0, 1.0, -1.0).astype(piv.dtype)
    return jnp.where(mag < boost, sign * boost, piv)


def gj_inverse(a, boost: float = 0.0, unroll: int = 8):
    """Inverse by unpivoted Gauss-Jordan elimination.

    ``fori_loop`` over n steps; each step is a rank-1 update of the
    augmented (n, 2n) tableau — elementwise across any vmapped batch.
    """
    n = a.shape[0]
    dtype = a.dtype
    boost = jnp.asarray(boost if boost else jnp.finfo(dtype).tiny, dtype)
    ab = jnp.concatenate([a, jnp.eye(n, dtype=dtype)], axis=1)
    rows = jnp.arange(n)

    def step(k, ab):
        piv = _boost_pivot(ab[k, k], boost)
        row = ab[k] / piv
        col = ab[:, k]
        upd = ab - col[:, None] * row[None, :]
        ab = jnp.where((rows == k)[:, None], row[None, :], upd)
        return ab

    ab = jax.lax.fori_loop(0, n, step, ab, unroll=min(unroll, n))
    return ab[:, n:]


def gj_factor(a, boost: float = 0.0) -> GJFactors:
    return GJFactors(gj_inverse(a, boost))


def gj_apply(factors: GJFactors, b):
    return pdot(factors.inv, b)


def gj_solve(a, b, boost: float = 0.0, unroll: int = 8):
    """Solve ``a x = b`` (b may be a vector or a matrix of RHS)."""
    return pdot(gj_inverse(a, boost, unroll=unroll), b)


def mgs_qr(a):
    """Modified Gram-Schmidt QR — the reference's SDMGS factorization
    (``src/solver/qr.jl:62-118``), the inner factorization of its Schur
    complement (``src/solver/schur.jl``). Returns (Q, R) with Q (n, n)
    orthonormal columns, R (n, n) upper triangular.

    n sequential steps of elementwise column updates — vmap-friendly like
    Gauss-Jordan, with better conditioning (orthogonal eliminations) at
    ~2x the flops. Use where the Schur complement is ill-conditioned.
    """
    n = a.shape[0]
    dtype = a.dtype
    cols = jnp.arange(n)

    def step(j, carry):
        q, r = carry
        v = q[:, j]
        nrm = jnp.sqrt(jnp.sum(v * v))
        nrm = jnp.maximum(nrm, jnp.finfo(dtype).tiny)
        qj = v / nrm
        # project qj out of the remaining columns (MGS, qr.jl:84-96)
        proj = pdot(qj, q)                       # (n,) row of inner products
        mask = (cols > j).astype(dtype)
        q = q - jnp.outer(qj, proj * mask)
        q = q.at[:, j].set(qj)
        r = r.at[j].set(jnp.where(cols == j, nrm, proj * mask))
        return q, r

    q0 = a
    r0 = jnp.zeros((n, n), dtype)
    q, r = jax.lax.fori_loop(0, n, step, (q0, r0), unroll=min(8, n))
    return q, r


def mgs_solve(a, b):
    """Solve via MGS QR: x = R⁻¹ Qᵀ b (qr_solve!, qr.jl:24-39)."""
    q, r = mgs_qr(a)
    qtb = pdot(q.T, b)
    return jax.scipy.linalg.solve_triangular(r, qtb, lower=False)


def ldl_factor(a, boost: float = 0.0):
    """Unpivoted LDLᵀ of a symmetric (quasi-definite) matrix — the role
    the reference fills with QDLDL for the Newton KKT
    (``src/solver/ldl.jl:4-180``; the ±β-regularized horizon KKT is SQD,
    so no pivoting is needed — Vanderbei 1995, same argument as the
    module docstring). Returns (L, d) with L unit lower triangular and d
    the diagonal of D.

    n sequential rank-1 trailing updates, elementwise across a vmapped
    batch — the same gather-free shape as ``gj_inverse``.
    """
    n = a.shape[0]
    dtype = a.dtype
    boost = jnp.asarray(boost if boost else jnp.finfo(dtype).tiny, dtype)
    rows = jnp.arange(n)

    def step(k, carry):
        work, l, d = carry
        piv = _boost_pivot(work[k, k], boost)
        col = jnp.where(rows > k, work[:, k] / piv, 0.0)  # L column k
        work = work - piv * jnp.outer(col, col)
        l = l.at[:, k].set(jnp.where(rows == k, 1.0, col))
        # d must carry the SAME boosted pivot that scaled L's column, so
        # L diag(d) Lᵀ reproduces the boost-regularized matrix (returning
        # the raw near-zero work[k,k] would defeat the guard exactly in
        # the degenerate case it targets)
        d = d.at[k].set(piv)
        return work, l, d

    _, l, d = jax.lax.fori_loop(
        0, n, step, (a, jnp.zeros((n, n), dtype), jnp.zeros((n,), dtype)),
        unroll=min(8, n))
    return l, d


def ldl_solve(a, b, boost: float = 0.0):
    """Solve ``a x = b`` with ``a`` symmetric via LDLᵀ
    (``linear_solve!``, src/solver/ldl.jl — QDLDL's solve phase).
    ``b`` may be a vector or matrix of right-hand sides."""
    l, d = ldl_factor(a, boost)
    y = jax.scipy.linalg.solve_triangular(l, b, lower=True,
                                          unit_diagonal=True)
    dtype = a.dtype
    # d is already boost-floored by ldl_factor; this re-floor (with the
    # caller's boost, not finfo.tiny) only guards a user-supplied d=0
    dsafe = _boost_pivot(
        d, jnp.asarray(boost if boost else jnp.finfo(dtype).tiny, dtype))
    y = y / (dsafe[:, None] if b.ndim > 1 else dsafe)
    return jax.scipy.linalg.solve_triangular(l.T, y, lower=False,
                                             unit_diagonal=True)
