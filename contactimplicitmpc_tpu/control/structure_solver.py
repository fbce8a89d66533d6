"""Structured O(H) horizon-KKT solver (Fast-MPC / Riccati-style block
elimination) — the completed version of the reference's unfinished
``newton_mode = :structure``.

Reference: ``/root/reference/src/controller/newton_structure_solver/
methods.jl`` (top-level ``solve!`` disabled at :571-582; the pieces are
unit-tested standalone). Problem (methods.jl:1-12)::

    [S  Cᵀ] [Δz]   [rlag]
    [C  0 ] [Δν] = [rdyn]

with per-stage states x_t = (qa_t, qb_t) = (q_{t}, q_{t+1}) duplicated so
that the constraint graph is strictly stage-adjacent:

* ν1_t:  qa_{t+1} − qb_t = 0                      (consistency)
* ν2_t:  qb_{t+1} − z*(qa_t, qb_t, u_t) = 0       (implicit dynamics)

Then ``Y = C S⁻¹ Cᵀ`` is block tridiagonal with 2nq blocks
(compute_Y!, methods.jl:386-448), factored by a block Cholesky sweep
(compute_L!, :466-486) and solved with one forward and one backward
substitution (compute_y!/compute_Δν!, :506-537) — an O(H) Riccati-like
recursion realized here as ``lax.scan``s over the stage axis; all
block algebra outside the sweeps is batched.

Index convention: arrays carry one dummy leading row so the formulas can
be transcribed verbatim from the 1-based reference.
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
from .implicit_dynamics import CONFIGURATION, implicit_dynamics
from .linearized import LinearizedData
from .newton import NewtonOptions
from .trajectory import ContactTraj, update_theta, update_z


class StructureObjective(NamedTuple):
    """Per-stage (qa, qb) objective blocks and their inverses
    (update_objective!, methods.jl:598-628). All arrays are 1-based padded:
    index 0 is a dummy row; valid stages are 1..H."""

    qa: jnp.ndarray    # (H+1, nq, nq)
    qb: jnp.ndarray
    qv: jnp.ndarray
    ra: jnp.ndarray    # (H+1, nu, nu)
    qat: jnp.ndarray   # inverses
    qbt: jnp.ndarray
    qvt: jnp.ndarray
    rat: jnp.ndarray


def build_structure_objective(dims: Dims, q_weight, v_weight, u_weight,
                              beta: float, horizon: int,
                              dtype=jnp.float64) -> StructureObjective:
    """Map per-knot diagonal weights (q: (H+1, nq), v: (H, nq),
    u: (H-1, nu), 1-based padded) to the (qa, qb) stage blocks."""
    h = horizon
    nq, nu = dims.nq, dims.nu

    t = jnp.arange(h + 1)
    c1 = jnp.where(t > 1, 0.5, 1.0).astype(dtype)
    c2 = jnp.where(t < h, 0.5, 1.0).astype(dtype)

    def diag_embed(v):
        return jax.vmap(jnp.diag)(v)

    qa = diag_embed(c1[:, None] * q_weight + v_weight) \
        + beta * jnp.eye(nq, dtype=dtype)
    qb = diag_embed(c2[:, None] * q_weight + v_weight) \
        + beta * jnp.eye(nq, dtype=dtype)
    qv = diag_embed(-v_weight)
    ra = diag_embed(u_weight) + beta * jnp.eye(nu, dtype=dtype)

    # block-2×2 inverse per stage
    big = jnp.concatenate([
        jnp.concatenate([qa, qv], axis=2),
        jnp.concatenate([jnp.swapaxes(qv, 1, 2), qb], axis=2)], axis=1)
    big_inv = jnp.linalg.inv(big)
    qat = big_inv[:, :nq, :nq]
    qbt = big_inv[:, nq:, nq:]
    qvt = big_inv[:, :nq, nq:]
    rat = jnp.linalg.inv(ra)
    return StructureObjective(qa=qa, qb=qb, qv=qv, ra=ra,
                              qat=qat, qbt=qbt, qvt=qvt, rat=rat)


def compute_y_blocks(obj: StructureObjective, aa, ab, ba, beta, horizon):
    """Y = C S⁻¹ Cᵀ block assembly (compute_Y!, methods.jl:386-448).

    ``aa, ab, ba`` are 1-based padded Jacobian stacks (rows 1..H-1 valid).
    Returns Yii (stages 1..H-1) and Yij (stages 1..H-2), 1-based padded.
    """
    nq = aa.shape[-1]
    h = horizon
    qat, qbt, qvt, rat = obj.qat, obj.qbt, obj.qvt, obj.rat

    t = jnp.arange(h)  # padded stage index; valid 1..h-1
    first = (t == 1)

    qat_n = qat[2:h + 1]   # Q̃a[t+1] for t=1..h-1
    qbt_n = qbt[2:h + 1]
    qvt_n = qvt[2:h + 1]
    qat_c = qat[1:h]       # Q̃a[t]
    qbt_c = qbt[1:h]
    qvt_c = qvt[1:h]
    aa_c, ab_c, ba_c = aa[1:h], ab[1:h], ba[1:h]
    rat_c = rat[1:h]

    mask = (jnp.arange(1, h) > 1).astype(aa.dtype)[:, None, None]

    yiia = qat_n + mask * qbt_c
    yiib = qvt_n + mask * (qvt_c @ jnp.swapaxes(aa_c, 1, 2)
                           + qbt_c @ jnp.swapaxes(ab_c, 1, 2))
    yiic = qvt_n + mask * (aa_c @ qvt_c + ab_c @ qbt_c)
    bab = ba_c @ rat_c @ jnp.swapaxes(ba_c, 1, 2)
    yiid = qbt_n + bab + mask * (
        aa_c @ qat_c @ jnp.swapaxes(aa_c, 1, 2)
        + aa_c @ qvt_c @ jnp.swapaxes(ab_c, 1, 2)
        + ab_c @ qvt_c @ jnp.swapaxes(aa_c, 1, 2)
        + ab_c @ qbt_c @ jnp.swapaxes(ab_c, 1, 2))

    eye = jnp.eye(nq, dtype=aa.dtype)
    yiia = yiia + beta * eye
    yiid = yiid + beta * eye

    # off-diagonal blocks for t = 1..h-2 (uses stage t+1 Jacobians)
    aa_n, ab_n = aa[2:h], ab[2:h]
    yija = -qvt[2:h]
    yijb = -(qat[2:h] @ jnp.swapaxes(aa_n, 1, 2)
             + qvt[2:h] @ jnp.swapaxes(ab_n, 1, 2))
    yijc = -qbt[2:h]
    yijd = -(qvt[2:h] @ jnp.swapaxes(aa_n, 1, 2)
             + qbt[2:h] @ jnp.swapaxes(ab_n, 1, 2))

    yii = jnp.concatenate([
        jnp.concatenate([yiia, yiib], axis=2),
        jnp.concatenate([yiic, yiid], axis=2)], axis=1)   # (h-1, 2nq, 2nq)
    yij = jnp.concatenate([
        jnp.concatenate([yija, yijb], axis=2),
        jnp.concatenate([yijc, yijd], axis=2)], axis=1)   # (h-2, 2nq, 2nq)
    return yii, yij


def block_tridiag_cholesky(yii, yij):
    """L of the block-tridiagonal Y via a lax.scan sweep
    (compute_L!, methods.jl:466-486). yij[k] couples stage k and k+1."""
    n = yii.shape[-1]
    yij_pad = jnp.concatenate([yij, jnp.zeros_like(yij[:1])], axis=0)

    def step(lji_prev, blocks):
        yii_t, yij_t = blocks
        m = yii_t - jnp.swapaxes(lji_prev, 0, 1) @ lji_prev
        lii = jnp.linalg.cholesky(m)
        lji = jax.scipy.linalg.solve_triangular(lii, yij_t, lower=True)
        return lji, (lii, lji)

    # carry seeded from a constant must match the sharded xs' varying axes
    init = unify_varying((jnp.zeros((n, n), yii.dtype), yii))[0]
    _, (lii, lji) = jax.lax.scan(step, init, (yii, yij_pad))
    return lii, lji[:-1]


def block_tridiag_solve(lii, lji, beta):
    """Solve Y x = β given the block Cholesky (compute_y!/compute_Δν!,
    methods.jl:506-537)."""
    lji_pad = jnp.concatenate([jnp.zeros_like(lji[:1]), lji], axis=0)

    def fwd(y_prev, blocks):
        lii_t, lji_tm1, b_t = blocks
        y_t = jax.scipy.linalg.solve_triangular(
            lii_t, b_t - jnp.swapaxes(lji_tm1, 0, 1) @ y_prev, lower=True)
        return y_t, y_t

    _, y = jax.lax.scan(fwd, unify_varying((jnp.zeros_like(beta[0]),
                                            beta))[0],
                        (lii, lji_pad, beta))

    lji_pad2 = jnp.concatenate([lji, jnp.zeros_like(lji[:1])], axis=0)

    def bwd(x_next, blocks):
        lii_t, lji_t, y_t = blocks
        x_t = jax.scipy.linalg.solve_triangular(
            lii_t, y_t - lji_t @ x_next, lower=True, trans="T")
        return x_t, x_t

    _, x = jax.lax.scan(bwd, unify_varying((jnp.zeros_like(beta[0]),
                                            beta))[0],
                        (lii, lji_pad2, y), reverse=True)
    return x


def structure_kkt_solve(dims: Dims, obj: StructureObjective, aa, ab, ba,
                        rlagu, rlagqa, rlagqb, rdyn1, rdyn2, beta,
                        horizon):
    """Full structured KKT solve: given residuals (1-based padded stacks),
    return (Δu, Δqa, Δqb, Δν1, Δν2) for stages 1..H-1 (padded).

    compute_β! (methods.jl:487-504), the tridiagonal solve, and
    compute_Δz! (methods.jl:539-557).
    """
    h = horizon
    nq = dims.nq
    qat, qbt, qvt, rat = obj.qat, obj.qbt, obj.qvt, obj.rat

    qat_n, qbt_n, qvt_n = qat[2:h + 1], qbt[2:h + 1], qvt[2:h + 1]
    qat_c, qbt_c, qvt_c = qat[1:h], qbt[1:h], qvt[1:h]
    aa_c, ab_c, ba_c, rat_c = aa[1:h], ab[1:h], ba[1:h], rat[1:h]
    ru, rqa, rqb = rlagu[1:h], rlagqa[1:h], rlagqb[1:h]
    rd1, rd2 = rdyn1[1:h], rdyn2[1:h]
    # previous-stage lagrangian rows (t-1), zero at the first stage
    rqa_p = jnp.concatenate([jnp.zeros_like(rqa[:1]), rqa[:-1]], axis=0)
    rqb_p = jnp.concatenate([jnp.zeros_like(rqb[:1]), rqb[:-1]], axis=0)
    mask = (jnp.arange(1, h) > 1).astype(rqa.dtype)[:, None]

    mv = lambda m, v: jnp.einsum("tij,tj->ti", m, v)

    beta1 = (-rd1 + mv(qat_n, rqa) + mv(qvt_n, rqb)
             - mask * (mv(qbt_c, rqb_p) + mv(qvt_c, rqa_p)))
    beta2 = (-rd2 - mv(ba_c, mv(rat_c, ru))
             + mv(qbt_n, rqb) + mv(qvt_n, rqa)
             - mask * (mv(aa_c, mv(qat_c, rqa_p))
                       + mv(ab_c, mv(qbt_c, rqb_p))
                       + mv(aa_c, mv(qvt_c, rqb_p))
                       + mv(ab_c, mv(qvt_c, rqa_p))))
    beta_n = jnp.concatenate([beta1, beta2], axis=1)  # (h-1, 2nq)

    yii, yij = compute_y_blocks(obj, aa, ab, ba, beta, h)
    lii, lji = block_tridiag_cholesky(yii, yij)
    dnu = block_tridiag_solve(lii, lji, beta_n)  # (h-1, 2nq)
    dnu1, dnu2 = dnu[:, :nq], dnu[:, nq:]

    # Δz recovery (compute_Δz!, methods.jl:539-557)
    dnu1_n = jnp.concatenate([dnu1[1:], jnp.zeros_like(dnu1[:1])], axis=0)
    dnu2_n = jnp.concatenate([dnu2[1:], jnp.zeros_like(dnu2[:1])], axis=0)
    aa_n = jnp.concatenate([aa[2:h], jnp.zeros_like(aa[:1])], axis=0)
    ab_n = jnp.concatenate([ab[2:h], jnp.zeros_like(ab[:1])], axis=0)
    mtv = lambda m, v: jnp.einsum("tji,tj->ti", m, v)

    du = mv(rat_c, ru + mtv(ba_c, dnu2))
    ea = rqa - dnu1 + mtv(aa_n, dnu2_n)
    eb = rqb - dnu2 + mtv(ab_n, dnu2_n) + dnu1_n
    dqa = mv(qat_n, ea) + mv(qvt_n, eb)
    dqb = mv(qbt_n, eb) + mv(qvt_n, ea)

    pad = lambda x: jnp.concatenate([jnp.zeros_like(x[:1]), x], axis=0)
    return pad(du), pad(dqa), pad(dqb), pad(dnu1), pad(dnu2)


# ---------------------------------------------------------------------------
# Full structure-mode Newton solve (methods.jl:640-882)
# ---------------------------------------------------------------------------

def structure_objective_from_tracking(dims: Dims, obj, beta: float,
                                      horizon: int,
                                      dtype) -> "StructureObjective":
    """Map per-knot tracking weights to 1-based padded stage weights
    (quadratic_objective / update_objective!, methods.jl:591-628)."""
    import numpy as _np

    from .objective import TrackingVelocityObjective

    def pad_rows(w, rows):
        w = jnp.asarray(w, dtype)
        idx = _np.minimum(_np.arange(rows), w.shape[0] - 1)
        return jnp.concatenate(
            [jnp.zeros((1, w.shape[1]), dtype), w[jnp.asarray(idx)]])

    q_w = pad_rows(obj.q, horizon)
    v_w = (pad_rows(obj.v, horizon)
           if isinstance(obj, TrackingVelocityObjective)
           else jnp.zeros((horizon + 1, dims.nq), dtype))
    u_w = pad_rows(obj.u, horizon)
    return build_structure_objective(dims, q_w, v_w, u_w, beta, horizon,
                                     dtype)


class StructureState(NamedTuple):
    """1-based padded stage trajectories (methods.jl:29-45)."""

    u: jnp.ndarray    # (H, nu)   valid 1..H-1
    qa: jnp.ndarray   # (H+1, nq) valid 1..H; qa[1] = q0 pinned
    qb: jnp.ndarray   # (H+1, nq) valid 1..H; qb[1] = q1 pinned
    nu1: jnp.ndarray  # (H, nq)   valid 1..H-1
    nu2: jnp.ndarray  # (H, nq)


def state_from_reference(q_ref, u_ref, dims: Dims, horizon: int,
                         dtype) -> StructureState:
    """initialize_trajectories! (methods.jl:755-795). ``q_ref`` is
    (H+1, nq) configurations (0-based rows 0..H), ``u_ref`` (H-1, nu)."""
    h = horizon
    qa = jnp.concatenate([jnp.zeros((1, dims.nq), dtype), q_ref[:h]])
    qb = jnp.concatenate([jnp.zeros((1, dims.nq), dtype), q_ref[1:h + 1]])
    u = jnp.concatenate([jnp.zeros((1, dims.nu), dtype), u_ref[:h - 1]])
    return StructureState(u=u, qa=qa, qb=qb,
                          nu1=jnp.zeros((h, dims.nq), dtype),
                          nu2=jnp.zeros((h, dims.nq), dtype))


def shift_state(st: StructureState, q_ref, u_ref,
                horizon: int) -> StructureState:
    """Receding-horizon warm start: advance the previous solution one knot
    so it aligns with the rotated reference window, filling the newly
    entered tail stage from the reference (rot_n_stride analog for the
    Newton warm start; the reference leaves core.traj unshifted,
    newton.jl:130-167, and relies on many Newton iterations to recover —
    at fixed small iteration budgets the aligned start tracks far better).

    ``q_ref``/``u_ref`` are the NEW window's references ((H+1, nq) and
    (H-1, nu), 0-based)."""
    h = horizon
    qa = st.qa.at[1:h].set(st.qa[2:h + 1]).at[h].set(q_ref[h - 1])
    qb = st.qb.at[1:h].set(st.qb[2:h + 1]).at[h].set(q_ref[h])
    u = st.u.at[1:h - 1].set(st.u[2:h]).at[h - 1].set(u_ref[h - 2])
    nu1 = st.nu1.at[1:h - 1].set(st.nu1[2:h])
    nu2 = st.nu2.at[1:h - 1].set(st.nu2[2:h])
    return StructureState(u=u, qa=qa, qb=qb, nu1=nu1, nu2=nu2)


def _implicit_stages(dims: Dims, lin: LinearizedData, state: StructureState,
                     theta_template, alt, opts: IPOptions, horizon: int,
                     fixed_iters: int = 0):
    """Per-stage linearized IP solves at (qa_t, qb_t, u_t), t = 1..H-1
    (methods.jl:683-704). ``lin`` must hold H-1 knots (window order);
    ``theta_template`` (H-1, nθ) supplies the w/μ/h slots.

    Returns (d, aa, ab, ba, converged) as 1-based padded stacks, where
    ``d[t]`` is the solved configuration z*_{q2} and aa/ab/ba are
    ∂z*q2/∂(q0, q1, u).

    ``fixed_iters > 0`` switches the per-knot solver to the deterministic
    fixed-iteration path (ops/fixed_ip.py) — masked ``fori_loop`` instead
    of a batched ``while_loop``, so converged lanes never gate the batch.
    """
    h = horizon
    th = theta_template
    th = th.at[:, dims.iq0].set(state.qa[1:h])
    th = th.at[:, dims.iq1].set(state.qb[1:h])
    th = th.at[:, dims.iu1].set(state.u[1:h])

    from .linearized import linearized_residual_fns, make_schur_solver

    if fixed_iters > 0:
        from ..ops.fixed_ip import linearized_ip_fixed

        def solve_knot(lz0, lth0, lr0, lrz0, lrt0, qinit, theta):
            return linearized_ip_fixed(dims, lz0, lth0, lr0, lrz0, lrt0,
                                       alt, theta, qinit, opts,
                                       iters=fixed_iters)
    else:
        def solve_knot(lz0, lth0, lr0, lrz0, lrt0, qinit, theta):
            r_fn, rz_fn, rt_fn = linearized_residual_fns(
                dims, lz0, lth0, lr0, lrz0, lrt0, alt)
            z0 = jnp.ones((dims.nz,), theta.dtype).at[dims.iq2].set(qinit)
            from ..sim.interior_point import ip_solve
            return ip_solve(dims, r_fn, z0, theta, opts,
                            jacobian_fn=rz_fn, rtheta_fn=rt_fn,
                            linear_solver=make_schur_solver(dims, lrz0, opts))

    res = jax.vmap(solve_knot)(lin.z0, lin.theta0, lin.r0, lin.rz0,
                               lin.rtheta0, state.qb[1:h], th)
    nq = dims.nq
    pad = lambda x: jnp.concatenate([jnp.zeros_like(x[:1]), x], axis=0)
    d = pad(res.z[:, :nq])
    aa = pad(res.dz[:, :nq, dims.iq0])
    ab = pad(res.dz[:, :nq, dims.iq1])
    ba = pad(res.dz[:, :nq, dims.iu1])
    return d, aa, ab, ba, res.converged


def structure_residuals(dims: Dims, obj: StructureObjective,
                        state: StructureState, q_ref, u_ref, d, aa, ab, ba,
                        horizon: int):
    """dynamics_constraints! + lagrangian_gradient!
    (methods.jl:640-681). Returns 1-based padded residual stacks."""
    h = horizon
    u, qa, qb, nu1, nu2 = state
    mv = lambda m, v: jnp.einsum("tij,tj->ti", m, v)
    mtv = lambda m, v: jnp.einsum("tji,tj->ti", m, v)

    rdyn1 = qa[2:h + 1] - qb[1:h]           # stages 1..H-1
    rdyn2 = qb[2:h + 1] - d[1:h]

    # objective terms (q_ref 0-based rows: stage t decision qa_{t+1} ~
    # q_ref[t], qb_{t+1} ~ q_ref[t+1])
    ru = mv(obj.ra[1:h], u[1:h] - u_ref[:h - 1])
    dqa = qa[2:h + 1] - q_ref[1:h]
    dqb = qb[2:h + 1] - q_ref[2:h + 1]
    rqa = mv(obj.qa[2:h + 1], dqa)
    rqb = mv(obj.qb[2:h + 1], dqb)
    vel = qb[2:h + 1] - qa[2:h + 1]
    rqa = rqa - mv(obj.qv[2:h + 1], vel)
    rqb = rqb + mv(obj.qv[2:h + 1], vel)

    # configuration equality duals
    rqa = rqa + nu1[1:h]
    rqb = rqb - jnp.concatenate([nu1[2:h], jnp.zeros_like(nu1[:1])], axis=0)

    # dynamics duals
    ru = ru - mtv(ba[1:h], nu2[1:h])
    rqb = rqb + nu2[1:h]
    aa_n = jnp.concatenate([aa[2:h], jnp.zeros_like(aa[:1])], axis=0)
    ab_n = jnp.concatenate([ab[2:h], jnp.zeros_like(ab[:1])], axis=0)
    nu2_n = jnp.concatenate([nu2[2:h], jnp.zeros_like(nu2[:1])], axis=0)
    rqa = rqa - mtv(aa_n, nu2_n)
    rqb = rqb - mtv(ab_n, nu2_n)

    pad = lambda x: jnp.concatenate([jnp.zeros_like(x[:1]), x], axis=0)
    return pad(ru), pad(rqa), pad(rqb), pad(rdyn1), pad(rdyn2)


def _residual_norm(parts):
    return sum(jnp.sum(jnp.abs(p)) for p in parts)


class StructureNewtonResult(NamedTuple):
    state: StructureState
    r_norm: jnp.ndarray
    iterations: jnp.ndarray


def structure_newton_solve(dims: Dims, sobj: StructureObjective,
                           lin: LinearizedData, q_ref, u_ref,
                           theta_template, q0, q1, state: StructureState,
                           alt, ip_opts: IPOptions, opts: NewtonOptions,
                           horizon: int) -> StructureNewtonResult:
    """Damped Newton on the stage-structured horizon KKT
    (newton_solve!, methods.jl:798-882) with the O(H) block-tridiagonal
    solve; the wall-clock budget is replaced by the fixed iteration
    budget, and the 7-point line search is evaluated as one batch."""
    h = horizon
    dtype = q_ref.dtype
    beta = jnp.asarray(opts.beta_init, dtype)

    # sanitize the warm start: any non-finite leaf (a diverged previous
    # solve in float32) falls back to the reference value — the batched
    # analog of the reference's failure -> stale/reset recovery
    # (implicit_dynamics.jl:169-177); then pin measured configurations
    # (methods.jl:786-791)
    ref_st = state_from_reference(q_ref, u_ref, dims, h, dtype)
    state = jax.tree_util.tree_map(
        lambda w, r: jnp.where(jnp.isfinite(w), w, r), state, ref_st)
    state = state._replace(qa=state.qa.at[1].set(q0),
                           qb=state.qb.at[1].set(q1))

    def residual_of(st, fixed_iters=None):
        d, aa, ab, ba, _ = _implicit_stages(
            dims, lin, st, theta_template, alt, ip_opts, h,
            fixed_iters=(opts.fixed_ip_iters if fixed_iters is None
                         else fixed_iters))
        parts = structure_residuals(dims, sobj, st, q_ref, u_ref,
                                    d, aa, ab, ba, h)
        return parts, (aa, ab, ba)

    parts, jacs = residual_of(state)
    r_norm = _residual_norm(parts)
    n_total = (h - 1) * (dims.nu + 4 * dims.nq)

    n_ls = opts.max_ls + 1
    alphas = 0.5 ** jnp.arange(n_ls, dtype=dtype)

    def apply_step(st, du, dqa, dqb, dnu1, dnu2, a):
        return StructureState(
            u=st.u.at[1:h].add(-a * du[1:h]),
            qa=st.qa.at[2:h + 1].add(-a * dqa[1:h]),
            qb=st.qb.at[2:h + 1].add(-a * dqb[1:h]),
            nu1=st.nu1.at[1:h].add(-a * dnu1[1:h]),
            nu2=st.nu2.at[1:h].add(-a * dnu2[1:h]))

    def body(carry):
        st, parts_c, jacs_c, r_norm_c, it = carry
        ru, rqa, rqb, rd1, rd2 = parts_c
        aa, ab, ba = jacs_c
        du, dqa, dqb, dnu1, dnu2 = structure_kkt_solve(
            dims, sobj, aa, ab, ba, ru, rqa, rqb, rd1, rd2, beta, h)

        cheap_trials = (0 < opts.trial_ip_iters < opts.fixed_ip_iters
                        and opts.fixed_ip_iters > 0)

        def trial(a):
            st_c = apply_step(st, du, dqa, dqb, dnu1, dnu2, a)
            # line-search trials may run a REDUCED knot-solve budget
            # (opts.trial_ip_iters): the trial residual only steers the
            # accept/step-size decision, and the accepted candidate is
            # re-evaluated at the full budget below before it becomes
            # the next iterate — cuts the dominant per-iteration cost
            # (7 trial solves of H−1 knots each) without degrading the
            # carried state's accuracy
            p, j = residual_of(
                st_c, opts.trial_ip_iters if cheap_trials else None)
            return st_c, p, j, _residual_norm(p)

        sts, ps, js, rns = jax.vmap(trial)(alphas)
        accept = rns ** 2 < (1.0 - 1.0e-3 * alphas) * r_norm_c ** 2
        # no-accept fallback: the reference's smallest-α forced step when
        # the growth bound is off (inf default, newton.jl:249 semantics);
        # the least-bad trial when it is on
        # mask non-finite trials so the least-bad fallback picks the best
        # FINITE candidate (NaN-propagating argmin would force a
        # rejection even when a finite within-bound trial exists)
        fallback = (n_ls - 1 if not np.isfinite(opts.ls_growth_allow)
                    else jnp.argmin(jnp.where(jnp.isfinite(rns), rns,
                                              jnp.inf)))
        pick = jnp.where(jnp.any(accept), jnp.argmax(accept), fallback)
        take = lambda tr: jax.tree_util.tree_map(lambda x: x[pick], tr)
        # reject non-finite steps always; additionally reject residual
        # growth beyond opts.ls_growth_allow when finite (float32
        # block-Cholesky on a near-indefinite Y can 10× the residual in
        # one forced uphill step and trap the receding-horizon warm
        # start — observed in f32 at batch ≥ 64; hard-terrain recipes
        # instead need unbounded nonmonotone escapes, the inf default).
        # Stale values + retry next control period on rejection is the
        # reference's failure semantics (implicit_dynamics.jl:169-177)
        ok = jnp.isfinite(rns[pick])
        if np.isfinite(opts.ls_growth_allow):
            ok = ok & (rns[pick] <= opts.ls_growth_allow * r_norm_c)
        if cheap_trials:
            # re-evaluate the CHOSEN candidate at the full knot budget:
            # the carried (parts, jacs, r_norm) must reflect the real
            # residual, and the finite/growth guard re-checks the exact
            # value
            st_pick = take(sts)
            p_x, j_x = residual_of(st_pick)
            rn_x = _residual_norm(p_x)
            ok = ok & jnp.isfinite(rn_x)
            if np.isfinite(opts.ls_growth_allow):
                ok = ok & (rn_x <= opts.ls_growth_allow * r_norm_c)
            sel = lambda a, b: jax.tree_util.tree_map(
                lambda x, y: jnp.where(ok, x, y), a, b)
            return (sel(st_pick, st), sel(p_x, parts_c),
                    sel(j_x, jacs_c), jnp.where(ok, rn_x, r_norm_c),
                    it + 1)
        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(ok, x, y), a, b)
        return (sel(take(sts), st), sel(take(ps), parts_c),
                sel(take(js), jacs_c), jnp.where(ok, rns[pick], r_norm_c),
                it + 1)

    def cond(carry):
        r_norm_c, it = carry[3], carry[4]
        return jnp.logical_and(it < opts.max_iter,
                               r_norm_c / n_total >= opts.r_tol)

    carry = unify_varying((state, parts, jacs, r_norm,
                           jnp.zeros((), jnp.int32)))
    if opts.fixed_newton_iters > 0:
        # deterministic masked-iteration variant (see NewtonOptions):
        # converged lanes pass through untouched — no batched-while
        # cross-lane gating, no per-trip dispatch overhead
        def fbody(_, c):
            conv = c[3] / n_total < opts.r_tol
            new = body(c)
            return jax.tree_util.tree_map(
                lambda n, o: jnp.where(conv, o, n), new, c)
        out = jax.lax.fori_loop(0, opts.fixed_newton_iters, fbody, carry)
    else:
        out = jax.lax.while_loop(cond, body, carry)
    state, _, _, r_norm, it = out
    return StructureNewtonResult(state=state, r_norm=r_norm, iterations=it)
