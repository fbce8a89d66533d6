"""Newton solve over the MPC horizon.

JAX redesign of the direct-mode Newton core
(``/root/reference/src/controller/newton.jl``,
``newton_indices.jl``, ``newton_residual.jl``, ``newton_jacobian.jl``).

Problem: track a reference contact trajectory subject to the smooth
implicit dynamics, with per-knot decision blocks ``[u, (γ, b,) q2]`` and
dynamics multipliers ν. The reference assembles a sparse KKT matrix through
pre-built views and factors it with LU/LDL; at these sizes (≤ ~10³) a dense
assembly via static index scatters + one batched dense solve is the
accelerator equivalent — XLA turns the scatters into fused dynamic-update
slices and the solve runs on the device.

Semantics matched to the reference:

* residual (newton_residual.jl:113-138, 178-281): objective gradient +
  sensitivity-transposed dual terms + dynamics violation − ν
* Jacobian (newton_jacobian.jl:148-248): objective Hessian, −I dual
  coupling, ∂z*/∂(q0,q1,u1) blocks + transposes, dual regularization
  ``−Σ_t β κ`` on the dual diagonal
* damped line search: α halving (≤ 6) on ``‖r‖₁²`` with Armijo constant
  1e-3 (newton.jl:222-269); here the 7 trial points are evaluated as one
  batched implicit-dynamics solve and the largest passing α selected —
  identical accept decision, one kernel launch
* β update: failures → ×1.3 (cap 1e2), successes → max(1e1, β/1.3)
  (newton.jl:280)
* fixed iteration budget replaces the wall-clock ``max_time`` (anytime
  behavior with deterministic device timing)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..dims import Dims
from ..sim.interior_point import IPOptions
from ..utils.vma import unify_varying
from .implicit_dynamics import (CONFIGURATION, CONFIGURATION_FORCE,
                                ImplicitDynamicsResult, implicit_dynamics,
                                nd_of)
from .linearized import LinearizedData
from .objective import TrackingObjective, TrackingVelocityObjective
from .trajectory import ContactTraj, update_theta, update_z


@dataclasses.dataclass(frozen=True)
class NewtonOptions:
    """NewtonOptions (newton.jl:2-11); ``max_time`` is replaced by the
    fixed ``max_iter`` budget."""

    r_tol: float = 1.0e-5
    max_iter: int = 10
    beta_init: float = 1.0e-5
    max_ls: int = 6
    fixed_ip_iters: int = 0  # >0: deterministic fixed-iteration knot solves
    trial_ip_iters: int = 0  # >0 and < fixed_ip_iters: line-search TRIAL
    #                          knot solves run this reduced budget; the
    #                          accepted candidate is re-solved at the
    #                          full budget (structure mode only) — the
    #                          7-trial residual evaluation is the
    #                          dominant Newton-stage cost
    fixed_newton_iters: int = 0  # >0: run exactly this many masked Newton
    #                              iterations (lax.fori_loop) instead of
    #                              the adaptive while_loop; converged
    #                              lanes pass through untouched.
    #                              Batched, each while trip is gated by
    #                              the slowest live lane. Chosen
    #                              before the move to the H100 and not
    #                              measured there yet (ROADMAP D3)
    kkt_solver: str = "ldl"  # horizon-KKT backend: "ldl" = unpivoted
    #                          LDLᵀ (ops/linsolve.py; the ±β-regularized
    #                          KKT is SQD so no pivoting is needed —
    #                          newton.jl:280 / QDLDL role, solver/ldl.jl),
    #                          "lu" = XLA's pivoted jnp.linalg.solve
    #                          (sequential row-swap loop)
    ls_growth_allow: float = float("inf")
    # line-search fallback residual-growth bound when NO trial passes
    # Armijo: inf reproduces the reference's unconditional forced step
    # (newton.jl:249 accept-after-6-halvings) — required on hard terrain
    # (parkour r_norm legitimately fluctuates 0.03→6 across steps);
    # finite values (e.g. 2.0) reject steps growing the residual by more
    # than that factor and keep the stale iterate instead — protects
    # float32 batch rollouts from garbage-KKT uphill steps that trap the
    # receding-horizon warm start (observed in f32 at batch ≥ 64)


class NewtonIndices:
    """Static block layout of the KKT system (newton_indices.jl:1-105).

    Per-knot primal block (size nr): ``[u, γ, b, q2]`` (configurationforce)
    or ``[u, q2]`` (configuration); dual blocks (size nd) follow all primal
    blocks.
    """

    def __init__(self, dims: Dims, horizon: int, mode: str):
        nq, nu, nc, nb = dims.nq, dims.nu, dims.nc, dims.nb
        self.mode = mode
        self.horizon = horizon
        self.nd = nd_of(dims, mode)
        if mode == CONFIGURATION_FORCE:
            self.nr = nu + nc + nb + nq
            self.iu = np.arange(nu)
            self.ig = nu + np.arange(nc)
            self.ib = nu + nc + np.arange(nb)
            self.iq = nu + nc + nb + np.arange(nq)
            self.iz = np.concatenate([self.iq, self.ig, self.ib])
        else:
            self.nr = nu + nq
            self.iu = np.arange(nu)
            self.iq = nu + np.arange(nq)
            self.iz = self.iq.copy()
        self.ntot = horizon * (self.nr + self.nd)
        self.primal_off = np.arange(horizon) * self.nr
        self.dual_off = horizon * self.nr + np.arange(horizon) * self.nd

    def q_rows(self, t: int) -> np.ndarray:
        return self.primal_off[t] + self.iq

    def u_rows(self, t: int) -> np.ndarray:
        return self.primal_off[t] + self.iu

    def nu_rows(self, t: int) -> np.ndarray:
        return self.dual_off[t] + np.arange(self.nd)


def _scatter_add_blocks(mat, rows, cols, blocks):
    """mat[rows[t], cols[t]] += blocks[t] for a stack of index grids;
    negative indices are dropped (out-of-horizon couplings)."""
    return mat.at[rows[..., :, None], cols[..., None, :]].add(
        blocks, mode="drop")


class NewtonAssembler:
    """Precomputed static index grids for one (dims, horizon, mode)."""

    def __init__(self, dims: Dims, horizon: int, mode: str):
        self.dims = dims
        self.ind = ind = NewtonIndices(dims, horizon, mode)
        h = horizon

        # objective Hessian diagonal positions (flattened primal diagonal)
        self.diag_primal = (ind.primal_off[:, None]
                            + np.arange(ind.nr)[None, :]).reshape(-1)
        self.diag_dual = (ind.dual_off[:, None]
                          + np.arange(ind.nd)[None, :]).reshape(-1)

        # −I coupling (IV/ITV): primal rows iz_t vs dual cols t
        self.iv_rows = (ind.primal_off[:, None] + ind.iz[None, :]).reshape(-1)
        self.iv_cols = (ind.dual_off[:, None]
                        + np.arange(ind.nd)[None, :]).reshape(-1)

        # sensitivity blocks: dual rows of knot t vs q2 cols of t−2 / t−1,
        # u cols of t. An out-of-bounds sentinel (ntot) drops the
        # out-of-horizon entries under scatter mode="drop" (negative
        # indices would wrap).
        sentinel = ind.ntot
        self.nu_rows = np.stack([ind.nu_rows(t) for t in range(h)])
        q0_cols, q1_cols = [], []
        for t in range(h):
            q0_cols.append(ind.q_rows(t - 2) if t >= 2
                           else np.full_like(ind.iq, sentinel))
            q1_cols.append(ind.q_rows(t - 1) if t >= 1
                           else np.full_like(ind.iq, sentinel))
        self.q0_cols = np.stack(q0_cols)
        self.q1_cols = np.stack(q1_cols)
        self.u_cols = np.stack([ind.u_rows(t) for t in range(h)])

        # velocity-objective off-diagonal pairs (q2[t−1], q2[t]) diagonals
        if h > 1:
            self.vel_rows = np.stack([ind.q_rows(t) for t in range(h - 1)])
            self.vel_cols = np.stack([ind.q_rows(t + 1) for t in range(h - 1)])
        else:
            self.vel_rows = np.zeros((0, dims.nq), np.int32)
            self.vel_cols = np.zeros((0, dims.nq), np.int32)

    # ------------------------------------------------------------------
    def hessian_diag(self, obj) -> jnp.ndarray:
        """Per-knot primal diagonal weights (hessian!, newton_jacobian.jl:
        200-248), including velocity-coupling additions."""
        ind = self.ind
        q_w = obj.q
        if isinstance(obj, TrackingVelocityObjective):
            q_w = q_w + obj.v
            # obj_q2[t−1] += v[t] (t ≥ 2, 1-based) → knot j gains v[j+1]
            q_w = q_w.at[:-1].add(obj.v[1:])
        if ind.mode == CONFIGURATION_FORCE:
            blocks = jnp.concatenate([obj.u, obj.gamma, obj.b, q_w], axis=1)
        else:
            blocks = jnp.concatenate([obj.u, q_w], axis=1)
        return blocks.reshape(-1)

    def jacobian(self, obj, imp: ImplicitDynamicsResult, beta, kappa,
                 dtype) -> jnp.ndarray:
        ind = self.ind
        h = ind.horizon
        mat = jnp.zeros((ind.ntot, ind.ntot), dtype)

        # objective Hessian diagonal
        mat = mat.at[self.diag_primal, self.diag_primal].add(
            self.hessian_diag(obj))

        # velocity off-diagonal couplings −v[t] (newton_jacobian.jl:218-233)
        if isinstance(obj, TrackingVelocityObjective) and h > 1:
            v = obj.v[1:]
            mat = mat.at[self.vel_rows, self.vel_cols].add(-v, mode="drop")
            mat = mat.at[self.vel_cols, self.vel_rows].add(-v, mode="drop")

        # −I dual coupling
        ones = jnp.ones((self.iv_rows.shape[0],), dtype)
        mat = mat.at[self.iv_rows, self.iv_cols].add(-ones)
        mat = mat.at[self.iv_cols, self.iv_rows].add(-ones)

        # sensitivity blocks and their transposes
        for rows, cols, blk in ((self.nu_rows, self.q0_cols, imp.dq0),
                                (self.nu_rows, self.q1_cols, imp.dq1),
                                (self.nu_rows, self.u_cols, imp.du1)):
            mat = _scatter_add_blocks(mat, rows, cols, blk)
            mat = _scatter_add_blocks(mat, cols, rows,
                                      jnp.swapaxes(blk, 1, 2))

        # dual regularization: each knot subtracts β·κ from the whole dual
        # diagonal (update_jacobian!, newton_jacobian.jl:183-186)
        mat = mat.at[self.diag_dual, self.diag_dual].add(
            -beta * kappa * h)
        return mat

    # ------------------------------------------------------------------
    def residual(self, obj, imp: ImplicitDynamicsResult, traj: ContactTraj,
                 ref: ContactTraj, nu: jnp.ndarray) -> jnp.ndarray:
        """newton_residual.jl:113-138 + gradient! variants (:178-281)."""
        ind = self.ind
        h = ind.horizon
        velocity = isinstance(obj, TrackingVelocityObjective)

        dq = traj.q[2:] - ref.q[2:h + 2]
        if velocity:
            dq = dq - obj.q_target
        g_q = obj.q * dq
        g_u = obj.u * (traj.u - ref.u)

        if velocity:
            vel = obj.v * (traj.q[2:] - traj.q[1:h + 1])
            if ind.mode == CONFIGURATION:
                vel = vel - obj.v * obj.v_target
            g_q = g_q + vel
            # res.q2[t−1] −= v[t]·(…) for t ≥ 2 (1-based)
            g_q = g_q.at[:-1].add(-vel[1:])

        # dual terms: res.q2[j] += δq0[j+2]ᵀν[j+2] + δq1[j+1]ᵀν[j+1]
        contrib_q0 = jnp.einsum("tij,ti->tj", imp.dq0, nu)  # (H, nq)
        contrib_q1 = jnp.einsum("tij,ti->tj", imp.dq1, nu)
        g_q = g_q.at[:-2].add(contrib_q0[2:])
        g_q = g_q.at[:-1].add(contrib_q1[1:])
        g_u = g_u + jnp.einsum("tij,ti->tj", imp.du1, nu)

        # −ν on the decision slots (rI)
        if ind.mode == CONFIGURATION_FORCE:
            nq, nc = self.dims.nq, self.dims.nc
            g_q = g_q - nu[:, :nq]
            g_g = obj.gamma * (traj.gamma - ref.gamma) - nu[:, nq:nq + nc]
            g_b = obj.b * (traj.b - ref.b) - nu[:, nq + nc:]
            primal = jnp.concatenate([g_u, g_g, g_b, g_q], axis=1)
        else:
            g_q = g_q - nu
            primal = jnp.concatenate([g_u, g_q], axis=1)

        return jnp.concatenate([primal.reshape(-1), imp.d.reshape(-1)])

    # ------------------------------------------------------------------
    def unpack_step(self, delta: jnp.ndarray):
        """Split the flat Newton step into per-knot (Δu, Δγ, Δb, Δq2, Δν)."""
        ind = self.ind
        h = ind.horizon
        primal = delta[:h * ind.nr].reshape(h, ind.nr)
        dnu = delta[h * ind.nr:].reshape(h, ind.nd)
        du = primal[:, ind.iu]
        dq = primal[:, ind.iq]
        if ind.mode == CONFIGURATION_FORCE:
            dg = primal[:, ind.ig]
            db = primal[:, ind.ib]
        else:
            dg = db = None
        return du, dg, db, dq, dnu

    def apply_step(self, dims: Dims, traj: ContactTraj, nu, delta, alpha):
        """update_traj! (newton_residual.jl:140-176)."""
        du, dg, db, dq, dnu = self.unpack_step(delta)
        q = traj.q.at[2:].add(-alpha * dq)
        u = traj.u - alpha * du
        gam = traj.gamma if dg is None else traj.gamma - alpha * dg
        b = traj.b if db is None else traj.b - alpha * db
        out = traj._replace(q=q, u=u, gamma=gam, b=b)
        out = update_theta(dims, update_z(dims, out))
        return out, nu - alpha * dnu


class NewtonResult(NamedTuple):
    traj: ContactTraj
    nu: jnp.ndarray
    beta: jnp.ndarray
    r_norm: jnp.ndarray
    iterations: jnp.ndarray


def newton_solve(
    dims: Dims,
    mode: str,
    assembler: NewtonAssembler,
    obj,
    lin: LinearizedData,          # gathered to the horizon window
    ref: ContactTraj,             # tracking reference over the horizon
    traj: ContactTraj,            # initial working trajectory (warm or ref)
    nu: jnp.ndarray,              # initial duals (H, nd)
    q0: jnp.ndarray,
    q1: jnp.ndarray,
    alt: jnp.ndarray,
    ip_opts: IPOptions,
    opts: NewtonOptions,
) -> NewtonResult:
    """One MPC Newton solve (newton_solve!, newton.jl:169-288)."""
    dtype = traj.q.dtype
    h = traj.horizon
    kappa = jnp.asarray(ip_opts.kappa_tol, dtype)

    # sanitize the warm start: any non-finite leaf (a diverged previous
    # f32 solve) falls back to the reference value — the same recovery
    # the structure solver applies (implicit_dynamics.jl:169-177
    # semantics); without it a poisoned warm trajectory re-enters every
    # subsequent receding-horizon solve
    traj = jax.tree_util.tree_map(
        lambda w, r: jnp.where(jnp.isfinite(w), w, r), traj, ref)
    nu = jnp.where(jnp.isfinite(nu), nu, jnp.zeros_like(nu))

    # reset (newton.jl:130-167): pin the measured configurations
    q = traj.q.at[0].set(q0).at[1].set(q1)
    traj = update_theta(dims, traj._replace(q=q))

    def imp_of(tr):
        return implicit_dynamics(dims, mode, lin, tr, alt, ip_opts,
                                 fixed_iters=opts.fixed_ip_iters)

    imp = imp_of(traj)
    r = assembler.residual(obj, imp, traj, ref, nu)
    r_norm = jnp.sum(jnp.abs(r))

    beta0 = jnp.asarray(opts.beta_init, dtype)
    n_ls = opts.max_ls + 1
    alphas = 0.5 ** jnp.arange(n_ls, dtype=dtype)

    def body(carry):
        traj_c, nu_c, beta, imp_c, r_c, r_norm_c, it = carry

        jac = assembler.jacobian(obj, imp_c, beta, kappa, dtype)
        # unpivoted LDLᵀ is safe on the SQD KKT only while the primal
        # diagonal stays meaningfully nonzero: in float32 the reference's
        # 1e-100 γ/b objective weights (CONFIGURATION_FORCE) underflow to
        # exactly 0, the boosted pivot lands at ~1e-38, and the rank-1
        # trailing update overflows — fall back to pivoted LU there
        use_ldl = (opts.kkt_solver == "ldl"
                   and not (dtype == jnp.float32
                            and mode == CONFIGURATION_FORCE))
        if use_ldl:
            from ..ops.linsolve import ldl_solve
            delta = ldl_solve(jac, r_c[:, None])[:, 0]
        else:
            delta = jnp.linalg.solve(jac, r_c)

        # batched line search over α ∈ {1, 1/2, …, 2⁻⁶}
        def trial(alpha):
            tr, nn = assembler.apply_step(dims, traj_c, nu_c, delta, alpha)
            im = imp_of(tr)
            rr = assembler.residual(obj, im, tr, ref, nn)
            return tr, nn, im, rr, jnp.sum(jnp.abs(rr))

        trs, nns, ims, rrs, rns = jax.vmap(trial)(alphas)
        accept = rns ** 2 < (1.0 - 1.0e-3 * alphas) * r_norm_c ** 2
        # first (largest-α) passing trial; else the fallback: with the
        # growth bound disabled (inf, the default) the reference's
        # smallest-α forced step (accept-after-6-halvings, newton.jl:249);
        # with a finite bound, the least-bad trial, so the `ok_fin` guard
        # below rejects as rarely as possible
        any_ok = jnp.any(accept)
        # mask non-finite trials so the least-bad fallback picks the best
        # FINITE candidate (NaN-propagating argmin would return a NaN
        # trial's index and force a rejection even when a finite
        # within-bound trial exists)
        fallback = (n_ls - 1 if not np.isfinite(opts.ls_growth_allow)
                    else jnp.argmin(jnp.where(jnp.isfinite(rns), rns,
                                              jnp.inf)))
        pick = jnp.where(any_ok, jnp.argmax(accept), fallback)

        # keep the current iterate on a non-finite step or (when
        # ls_growth_allow is finite) one growing the residual beyond the
        # bound — stale values + retry next period on rejection
        # (implicit_dynamics.jl:169-177)
        ok_fin = jnp.isfinite(rns[pick])
        if np.isfinite(opts.ls_growth_allow):
            ok_fin = ok_fin & (rns[pick] <=
                               opts.ls_growth_allow * r_norm_c)
        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(ok_fin, x, y), a, b)
        take = lambda x: jax.tree_util.tree_map(lambda a: a[pick], x)
        traj_n, nu_n, imp_n = (sel(take(trs), traj_c), sel(take(nns), nu_c),
                               sel(take(ims), imp_c))
        r_n = sel(rrs[pick], r_c)
        r_norm_n = jnp.where(ok_fin, rns[pick], r_norm_c)

        # regularization update (newton.jl:280)
        beta_n = jnp.where(any_ok,
                           jnp.maximum(jnp.asarray(1.0e1, dtype), beta / 1.3),
                           jnp.minimum(beta * 1.3, jnp.asarray(1.0e2, dtype)))

        return (traj_n, nu_n, beta_n, imp_n, r_n, r_norm_n, it + 1)

    def cond(carry):
        r_norm_c, it = carry[5], carry[6]
        converged = r_norm_c / r.shape[0] < opts.r_tol
        return jnp.logical_and(it < opts.max_iter,
                               jnp.logical_not(converged))

    carry = unify_varying(
        (traj, nu, beta0, imp, r, r_norm, jnp.zeros((), jnp.int32)))
    if opts.fixed_newton_iters > 0:
        # deterministic masked-iteration variant (see NewtonOptions):
        # converged lanes pass through untouched
        def fbody(_, c):
            conv = c[5] / r.shape[0] < opts.r_tol
            new = body(c)
            return jax.tree_util.tree_map(
                lambda n, o: jnp.where(conv, o, n), new, c)
        out = jax.lax.fori_loop(0, opts.fixed_newton_iters, fbody, carry)
    else:
        out = jax.lax.while_loop(cond, body, carry)
    traj, nu, beta, _, _, r_norm, it = out
    return NewtonResult(traj=traj, nu=nu, beta=beta, r_norm=r_norm,
                        iterations=it)
