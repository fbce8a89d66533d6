"""Contact-implicit MPC policy.

JAX redesign of ``CIMPC`` / ``ci_mpc_policy``
(``/root/reference/src/controller/policy.jl``) and the receding-horizon
utilities (``src/controller/mpc_utils.jl``). The reference mutates a policy
object inside the simulator loop; here the policy is a pure function over an
explicit state pytree, so an entire closed-loop rollout jits into a single
``lax.scan`` and vmaps across Monte-Carlo batches.

Per control step (every ``N_sample`` sim steps, policy.jl:98-152):

1. optional altitude update from recent contact impulses
   (mpc_utils.jl:109-135)
2. warm-started Newton solve over the horizon against the rotating
   reference window
3. receding-horizon shift of the reference (rot_n_stride!) and window
   advance
4. emit ``u[0] / N_sample``
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..dims import Dims
from ..models.base import Model, dims_of
from ..sim.interior_point import IPOptions
from ..sim.simulator import PolicyObs
from ..utils.vma import unify_varying
from .implicit_dynamics import (CONFIGURATION_FORCE, default_mpc_ip_options,
                                nd_of)
from .linearized import gather, linearize_trajectory
from .newton import NewtonAssembler, NewtonOptions, newton_solve
from .trajectory import ContactTraj, get_stride, rot_n_stride


@dataclasses.dataclass(frozen=True)
class CIMPCOptions:
    """CIMPCOptions (policy.jl:5-14)."""

    altitude_update: bool = False
    altitude_impact_threshold: float = 1.0


class CIMPCState(NamedTuple):
    ref_traj: ContactTraj     # rotating reference (H_ref knots)
    newton_traj: ContactTraj  # warm-start working trajectory (H_mpc)
    nu: jnp.ndarray           # (H_mpc, nd) dynamics duals
    window: jnp.ndarray       # (H_mpc,) gait-knot indices for lin data
    q0: jnp.ndarray           # configuration at previous control step
    cnt: jnp.ndarray          # sample-and-hold counter
    u: jnp.ndarray            # latest control (unscaled)
    altitude: jnp.ndarray     # (nc,)
    gamma_buf: jnp.ndarray    # (N_sample, nc) recent contact impulses
    q_buf: jnp.ndarray        # (N_sample, nq) matching configurations


def _slice_horizon(traj: ContactTraj, horizon: int) -> ContactTraj:
    """First `horizon` knots (copy_traj!, newton.jl:105-128)."""
    return ContactTraj(h=traj.h, kappa=traj.kappa,
                       q=traj.q[:horizon + 2], u=traj.u[:horizon],
                       w=traj.w[:horizon], gamma=traj.gamma[:horizon],
                       b=traj.b[:horizon], z=traj.z[:horizon],
                       theta=traj.theta[:horizon])


def ci_mpc_policy(
    model: Model,
    env,
    ref_traj: ContactTraj,
    obj,
    h_mpc: int,
    n_sample: int = 1,
    kappa_mpc: float = 1.0e-4,
    mode: str = CONFIGURATION_FORCE,
    newton_mode: str = "direct",
    n_opts: Optional[NewtonOptions] = None,
    ip_opts: Optional[IPOptions] = None,
    mpc_opts: CIMPCOptions = CIMPCOptions(),
    stride_idx=(0,),
):
    """Build the (init_state, apply) pair consumed by ``simulate``
    (ci_mpc_policy, policy.jl:42-96).

    ``newton_mode``: ``"direct"`` assembles the dense horizon KKT (the
    reference's default); ``"structure"`` uses the O(H) block-tridiagonal
    Riccati sweep (the reference's unfinished :structure mode, completed
    here — configuration mode only).

    ``stride_idx``: configuration coordinates shifted by one gait period on
    each receding-horizon wrap. Default matches get_stride (x only,
    mpc_utils.jl:103-107); the hopper parkour example overrides with
    ``(0, 1)`` to stride x *and* z up the stairs (examples/hopper/
    parkour.jl:11-15).
    """
    dims = dims_of(model, env)
    nd = nd_of(dims, mode)
    h_ref = ref_traj.horizon
    dtype = ref_traj.q.dtype

    n_opts = n_opts or NewtonOptions(r_tol=3.0e-4, max_iter=5)
    ip_opts = ip_opts or default_mpc_ip_options(kappa_mpc)

    # one-time linearization about every gait knot
    # (ImplicitTrajectory, implicit_dynamics.jl:21-90)
    lin = linearize_trajectory(model, env, ref_traj, kappa_mpc)
    stride = jnp.zeros((dims.nq,), dtype)
    idxs = jnp.asarray(list(stride_idx), jnp.int32)
    stride = stride.at[idxs].set(ref_traj.q[-2, idxs] - ref_traj.q[0, idxs])
    assembler = NewtonAssembler(dims, h_mpc, mode)

    if newton_mode == "structure":
        return _structure_policy(model, env, dims, ref_traj, obj, lin,
                                 stride, h_mpc, n_sample, kappa_mpc,
                                 n_opts, ip_opts, mpc_opts)
    if newton_mode != "direct":
        raise ValueError(f"invalid newton_mode {newton_mode!r}")

    def init_state() -> CIMPCState:
        return CIMPCState(
            ref_traj=ref_traj,
            newton_traj=_slice_horizon(ref_traj, h_mpc),
            nu=jnp.zeros((h_mpc, nd), dtype),
            window=jnp.arange(h_mpc, dtype=jnp.int32),
            q0=ref_traj.q[0],
            cnt=jnp.asarray(n_sample, jnp.int32),
            u=ref_traj.u[0],
            altitude=jnp.zeros((dims.nc,), dtype),
            gamma_buf=jnp.zeros((n_sample, dims.nc), dtype),
            q_buf=jnp.zeros((n_sample, dims.nq), dtype),
        )

    def update_altitude(state: CIMPCState) -> jnp.ndarray:
        """mpc_utils.jl:109-135: per contact, take φ at the configuration
        of the recent step with the largest impulse, when it exceeds the
        threshold."""
        idx = jnp.argmax(state.gamma_buf, axis=0)          # (nc,)
        gamma_max = jnp.max(state.gamma_buf, axis=0)
        q_at = state.q_buf[idx]                            # (nc, nq)
        phi = jax.vmap(lambda q: model.phi(env, q))(q_at)  # (nc, nc)
        phi_i = jnp.diagonal(phi)
        return jnp.where(gamma_max > mpc_opts.altitude_impact_threshold,
                         phi_i, state.altitude)

    def control_update(state: CIMPCState, obs: PolicyObs) -> CIMPCState:
        warm = obs.t > 0
        alt = state.altitude
        if mpc_opts.altitude_update:
            alt = jnp.where(warm, update_altitude(state), alt)

        ref_window = _slice_horizon(state.ref_traj, h_mpc)
        lin_w = gather(lin, state.window)

        sel = lambda a, b: jax.tree_util.tree_map(
            lambda x, y: jnp.where(warm, x, y), a, b)
        traj0 = sel(state.newton_traj, ref_window)
        nu0 = jnp.where(warm, state.nu, jnp.zeros_like(state.nu))

        result = newton_solve(dims, mode, assembler, obj, lin_w, ref_window,
                              traj0, nu0, state.q0, obs.q1, alt,
                              ip_opts, n_opts)

        return state._replace(
            ref_traj=rot_n_stride(dims, state.ref_traj, stride),
            newton_traj=result.traj,
            nu=result.nu,
            window=(state.window + 1) % h_ref,
            q0=obs.q1,
            cnt=jnp.zeros((), jnp.int32),
            u=result.traj.u[0],
            altitude=alt,
        )

    def apply(state: CIMPCState, obs: PolicyObs):
        # ring buffers of (γ, matching q) for the altitude update
        state = state._replace(
            gamma_buf=jnp.roll(state.gamma_buf, -1, axis=0)
            .at[-1].set(obs.gamma),
            q_buf=jnp.roll(state.q_buf, -1, axis=0).at[-1].set(obs.q1))

        state = jax.lax.cond(state.cnt == n_sample,
                             lambda s: unify_varying(control_update(s, obs)),
                             lambda s: unify_varying(s), state)
        state = state._replace(cnt=state.cnt + 1)
        return state.u / n_sample, state

    return init_state, apply


class StructureCIMPCState(NamedTuple):
    """Structure-mode policy state: like CIMPCState but the warm start is
    the full previous ``StructureState`` (primal stages + duals)."""

    ref_traj: ContactTraj
    warm: "jax.Array"          # pytree: StructureState of the last solve
    window: jnp.ndarray
    q0: jnp.ndarray
    cnt: jnp.ndarray
    u: jnp.ndarray
    altitude: jnp.ndarray
    gamma_buf: jnp.ndarray
    q_buf: jnp.ndarray


def _structure_policy(model, env, dims, ref_traj, obj, lin, stride, h_mpc,
                      n_sample, kappa_mpc, n_opts, ip_opts, mpc_opts):
    """Structure-mode CIMPC (reference newton_mode=:structure,
    policy.jl:78-84, completed) with full warm starting and the altitude
    update (mpc_utils.jl:109-135) — parity with the direct-mode path."""
    from .structure_solver import (shift_state, state_from_reference,
                                   structure_newton_solve,
                                   structure_objective_from_tracking)

    h_ref = ref_traj.horizon
    dtype = ref_traj.q.dtype

    sobj = structure_objective_from_tracking(dims, obj, n_opts.beta_init,
                                             h_mpc, dtype)

    def st_ref_of(ref_window):
        return state_from_reference(ref_window.q[:h_mpc + 1],
                                    ref_window.u[:h_mpc - 1],
                                    dims, h_mpc, dtype)

    def init_state() -> StructureCIMPCState:
        return StructureCIMPCState(
            ref_traj=ref_traj,
            warm=st_ref_of(_slice_horizon(ref_traj, h_mpc)),
            window=jnp.arange(h_mpc, dtype=jnp.int32),
            q0=ref_traj.q[0],
            cnt=jnp.asarray(n_sample, jnp.int32),
            u=ref_traj.u[0],
            altitude=jnp.zeros((dims.nc,), dtype),
            gamma_buf=jnp.zeros((n_sample, dims.nc), dtype),
            q_buf=jnp.zeros((n_sample, dims.nq), dtype),
        )

    def update_altitude(state) -> jnp.ndarray:
        idx = jnp.argmax(state.gamma_buf, axis=0)
        gamma_max = jnp.max(state.gamma_buf, axis=0)
        q_at = state.q_buf[idx]
        phi_i = jnp.diagonal(
            jax.vmap(lambda q: model.phi(env, q))(q_at))
        return jnp.where(gamma_max > mpc_opts.altitude_impact_threshold,
                         phi_i, state.altitude)

    def control_update(state: StructureCIMPCState,
                       obs: PolicyObs) -> StructureCIMPCState:
        warm = obs.t > 0
        alt = state.altitude
        if mpc_opts.altitude_update:
            alt = jnp.where(warm, update_altitude(state), alt)

        ref_window = _slice_horizon(state.ref_traj, h_mpc)
        lin_w = gather(lin, state.window[:h_mpc - 1])

        q_ref = ref_window.q[:h_mpc + 1]
        u_ref = ref_window.u[:h_mpc - 1]
        theta_template = ref_window.theta[:h_mpc - 1]
        # full warm start: previous primal stages AND duals when warm,
        # shifted one knot to stay aligned with the rotated window
        # (reset!/warm_start semantics, newton.jl:130-167)
        st0 = jax.tree_util.tree_map(
            lambda x, y: jnp.where(warm, x, y),
            shift_state(state.warm, q_ref, u_ref, h_mpc),
            st_ref_of(ref_window))

        result = structure_newton_solve(
            dims, sobj, lin_w, q_ref, u_ref, theta_template,
            state.q0, obs.q1, st0, alt, ip_opts, n_opts, h_mpc)

        return state._replace(
            ref_traj=rot_n_stride(dims, state.ref_traj, stride),
            warm=result.state,
            window=(state.window + 1) % h_ref,
            q0=obs.q1,
            cnt=jnp.zeros((), jnp.int32),
            u=result.state.u[1],
            altitude=alt,
        )

    def apply(state: StructureCIMPCState, obs: PolicyObs):
        state = state._replace(
            gamma_buf=jnp.roll(state.gamma_buf, -1, axis=0)
            .at[-1].set(obs.gamma),
            q_buf=jnp.roll(state.q_buf, -1, axis=0).at[-1].set(obs.q1))
        state = jax.lax.cond(state.cnt == n_sample,
                             lambda s: unify_varying(control_update(s, obs)),
                             lambda s: unify_varying(s), state)
        state = state._replace(cnt=state.cnt + 1)
        return state.u / n_sample, state

    return init_state, apply
