"""Mixed-integer QP baseline on the wall pendulum — the paper's
"MIQP vs contact-implicit MPC" comparison experiment.

Mirror of ``/root/reference/examples/miqp/miqp.jl`` +
``methods/structures.jl``: a pendulum between two spring walls has three
piecewise-affine contact modes (none / left wall / right wall), each a
box domain in (θ, θ̇) with its own affine dynamics (A_i, B_i, c_i).
The reference solves the hybrid MPC as a big-M mixed-integer QP with
Gurobi (miqp.jl:28-58); a commercial branch-and-bound solver is neither
available nor batch-shaped, so this build solves the same hybrid program
by **batched explicit enumeration** — the accelerator-friendly
reformulation:

* enumerate mode sequences over the MPC horizon with at most
  ``max_switches`` mode changes (contact schedules are piecewise
  constant; the same restriction standard hybrid-MPC enumeration uses),
* for every sequence, condense the affine dynamics and solve the
  resulting equality-constrained QP in closed form — one batched dense
  solve over ALL sequences at once (one vmap),
* apply the reference's big-M idea in reverse: sequences whose optimal
  trajectory leaves their mode domains get an infeasibility penalty
  (β-scaled violation, miqp.jl:β=1e3), and the argmin over the batch is
  the MIQP optimum over the restricted schedule set.

Problem data (T, dt, Q, Qf, R, β, disturbance schedule) follows
miqp.jl:20-58 with a receding-horizon T suited to enumeration.

Run: python examples/miqp_wallpendulum.py [--steps 380] [--cpu]
"""

import argparse
import itertools
import sys
import time

sys.path.insert(0, ".")


def build_wall_pendulum(dt, mp=1.0, l=1.0, g=10.0, k=1e4, d=0.1):
    """Piecewise-affine wall-pendulum data (structures.jl:15-38):
    mode 0 = no contact, 1 = left wall, 2 = right wall."""
    import numpy as np

    B = dt * np.array([[0.0], [1.0 / (mp * l ** 2)]])
    A_free = np.eye(2) + dt * np.array([[0.0, 1.0], [g / l, 0.0]])
    A_wall = np.eye(2) + dt * np.array([[0.0, 1.0],
                                        [g / l - k / mp, 0.0]])
    c0 = np.zeros(2)
    c1 = dt * np.array([0.0, k * d / (mp * l)])
    c2 = dt * np.array([0.0, -k * d / (mp * l)])
    A = np.stack([A_free, A_wall, A_wall])
    Bs = np.stack([B, B, B])
    c = np.stack([c0, c1, c2])
    # box domains (structures.jl:100-130): θ in units of d/l
    th = d / l
    x_lo = np.array([[-th, -1.5], [th, -1.5], [-2 * th, -1.5]])
    x_hi = np.array([[th, 1.5], [2 * th, 1.5], [-th, 1.5]])
    u_lim = 4.0
    return A, Bs, c, x_lo, x_hi, u_lim, th


def mode_sequences(T, n_modes=3, max_switches=2, switch_window=None):
    """All mode sequences with ≤ max_switches changes — the contact
    schedules a pendulum can actually execute over a short horizon.
    ``switch_window`` restricts switch stages to the first k steps (a
    receding-horizon controller only needs near-term contact timing
    resolved; the tail mode holds), keeping enumeration O(k²)."""
    import numpy as np

    k = T if switch_window is None else min(T, switch_window)
    seqs = set()
    for m0 in range(n_modes):
        seqs.add((m0,) * T)
    for s1 in range(1, k):
        for m0 in range(n_modes):
            for m1 in range(n_modes):
                if m1 == m0:
                    continue
                seqs.add((m0,) * s1 + (m1,) * (T - s1))
                if max_switches >= 2:
                    for s2 in range(s1 + 1, k):
                        for m2 in range(n_modes):
                            if m2 == m1:
                                continue
                            seqs.add((m0,) * s1 + (m1,) * (s2 - s1)
                                     + (m2,) * (T - s2))
    return np.array(sorted(seqs), dtype=np.int32)




def make_wall_mpc(T=10, dt=0.04, Q=1.0, Qf=50.0, R=1.0, beta=1e3):
    """Build (mpc_step, sim_step, th) for the wall-pendulum hybrid MPC —
    module-level so tests and analysis reuse the controller."""
    import jax
    import jax.numpy as jnp

    A, B, c, x_lo, x_hi, u_lim, th = build_wall_pendulum(dt)
    seqs = mode_sequences(T, switch_window=12)

    A_j = jnp.asarray(A)
    B_j = jnp.asarray(B)
    c_j = jnp.asarray(c)
    xlo_j = jnp.asarray(x_lo)
    xhi_j = jnp.asarray(x_hi)
    seqs_j = jnp.asarray(seqs)

    def qp_for_sequence(seq, x0):
        """Condensed QP over u (T,) for one mode sequence: exact affine
        rollout x_{t+1} = A_m x_t + B_m u_t + c_m, quadratic cost, box-
        violation penalty. Returns (cost, u)."""
        As = A_j[seq]              # (T, 2, 2)
        Bs = B_j[seq][:, :, 0]     # (T, 2)
        cs = c_j[seq]              # (T, 2)

        # rollout maps: x_t = M_t x0 + sum_s G[t,s] u_s + g_t
        def step(carry, inp):
            M, g = carry
            A_t, c_t = inp
            return (A_t @ M, A_t @ g + c_t), (A_t @ M, A_t @ g + c_t)

        (Ms, gs) = jax.lax.scan(step, (jnp.eye(2), jnp.zeros(2)),
                                (As, cs))[1]
        # G[t, s] = A_t ... A_{s+1} B_s = Φ(t) Φ(s)⁻¹ B_s with
        # Φ(t) = Ms[t] — O(T²) tiny matmuls instead of O(T³)
        def inv2(M):
            det = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
            return jnp.array([[M[1, 1], -M[0, 1]],
                              [-M[1, 0], M[0, 0]]]) / det

        V = jax.vmap(lambda P, Bv: inv2(P) @ Bv)(Ms, Bs)   # (T, 2)
        tri = jnp.arange(T)[:, None] >= jnp.arange(T)[None, :]
        G = jnp.where(tri[:, :, None],
                      jnp.einsum("tij,sj->tsi", Ms, V), 0.0)  # (T, T, 2)

        # quadratic cost in u: sum_t w_t |x_t|^2 Q + R |u|^2, plus the
        # big-M analog: a β-weighted quadratic hinge keeping every stage
        # inside its mode's box domain (the reference enforces
        # S x + R u <= T as hard MIQP constraints, structures.jl:74-99 /
        # miqp.jl β=1e3). Solved by a few masked active-set Newton
        # passes — fixed trip count, so the whole sequence batch stays
        # one vmapped dense-solve kernel.
        w = jnp.concatenate([Q * jnp.ones(T - 1), jnp.array([Qf])])
        xb = Ms @ x0 + gs                        # (T, 2) base states
        # (x_t, u_t) ∈ C_{m_t}: row t of xs is x_{t+1}, governed by mode
        # seq[t+1] (the terminal state reuses the last stage's box)
        seq_next = jnp.concatenate([seq[1:], seq[-1:]])
        lo = xlo_j[seq_next]
        hi = xhi_j[seq_next]
        H0 = R * jnp.eye(T) + jnp.einsum("t,tsi,tri->sr", w, G, G)
        b0 = jnp.einsum("t,tsi,ti->s", w, G, xb)
        # stiff hinge: the mode dynamics jump discontinuously at the box
        # boundary (the wall spring constant k=1e4 enters c as a ±40
        # velocity offset per step), so even sliver violations invalidate
        # the sequence's model — the penalty must act as a hard
        # constraint. The reference's β=1e3 is Gurobi's big-M magnitude
        # (structures.jl:210-214); the quadratic hinge needs it scaled up
        # by ~1e4 to be boundary-stiff at this problem's units
        beta_q = 1.0e4 * beta
        u = jnp.clip(-jnp.linalg.solve(H0 + 1e-9 * jnp.eye(T), b0),
                     -u_lim, u_lim)
        for _ in range(6):
            xs = xb + jnp.einsum("tsi,s->ti", G, u)
            active = ((xs < lo) | (xs > hi)).astype(xs.dtype)
            wa = beta_q * active                 # (T, 2)
            tgt = jnp.clip(xs, lo, hi)
            H = H0 + jnp.einsum("ti,tsi,tri->sr", wa, G, G)
            b = b0 + jnp.einsum("ti,tsi,ti->s", wa, G, xb - tgt)
            u = jnp.clip(-jnp.linalg.solve(H + 1e-9 * jnp.eye(T), b),
                         -u_lim, u_lim)

        xs = xb + jnp.einsum("tsi,s->ti", G, u)  # (T, 2)
        cost = jnp.sum(w * jnp.sum(xs * xs, axis=1)) + R * jnp.sum(u * u)
        vio = jnp.sum(jnp.maximum(lo - xs, 0.0) +
                      jnp.maximum(xs - hi, 0.0))
        # initial state feasibility for mode seq[0]
        vio = vio + jnp.sum(jnp.maximum(xlo_j[seq[0]] - x0, 0.0) +
                            jnp.maximum(x0 - xhi_j[seq[0]], 0.0))
        # infeasible sequences are rejected outright (vio as tiebreak so
        # a least-infeasible fallback exists if every schedule fails)
        cost = jnp.where(vio > 1e-3, 1e9 * (1.0 + vio), cost)
        return cost, u[0]

    @jax.jit
    def mpc_step(x0):
        costs, u0s = jax.vmap(qp_for_sequence, in_axes=(0, None))(
            seqs_j, x0)
        i = jnp.argmin(costs)
        return u0s[i], costs[i]

    def true_mode(x):
        return jnp.where(x[0] > th, 1, jnp.where(x[0] < -th, 2, 0))

    @jax.jit
    def sim_step(x, u):
        m = true_mode(x)
        return A_j[m] @ x + B_j[m][:, 0] * u + c_j[m]
    return mpc_step, sim_step, th, len(seqs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=380)
    ap.add_argument("--horizon", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    dt = 0.04                      # miqp.jl:22
    T = args.horizon               # receding horizon (enumeration-sized)
    Q, Qf, R, beta = 1.0, 50.0, 1.0, 1e3   # miqp.jl:24-27
    mpc_step, sim_step, th, n_seq = make_wall_mpc(T, dt, Q, Qf, R, beta)
    print(f"wall pendulum MIQP: horizon {T}, {n_seq} mode sequences "
          f"(≤2 switches), dt={dt}")

    # disturbance schedule (miqp.jl:44-52): impulsive θ̇ kicks
    dist = {20: -15.5, 120: 15.5, 160: 15.5, 260: -11.5, 320: -10.5}

    x = jnp.array([0.0, 0.0])
    xs_out, us_out, solve_times = [np.asarray(x)], [], []
    # warm the compile before timing (reference reports warm solve times)
    mpc_step(x)[0].block_until_ready()
    for t in range(args.steps):
        if t in dist:
            x = x.at[1].add(dist[t] * dt)  # impulse → velocity jump
        t0 = time.time()
        u, cost = mpc_step(x)
        u.block_until_ready()
        solve_times.append(time.time() - t0)
        x = sim_step(x, float(u))
        xs_out.append(np.asarray(x))
        us_out.append(float(u))

    xs_out = np.stack(xs_out)
    st = np.array(solve_times)
    # miqp.jl:61-64 reporting: mean/max solve time vs the control period
    print(f"solve time: mean {st.mean() * 1e3:.2f} ms, "
          f"max {st.max() * 1e3:.2f} ms "
          f"(control period {dt * 1e3:.0f} ms; "
          f"speed ratio {dt / st.mean():.2f}x)")
    print(f"|θ| final {abs(xs_out[-1, 0]):.4f}, "
          f"max |θ| {np.abs(xs_out[:, 0]).max():.4f} "
          f"(wall at {th:.2f}, domain edge {2 * th:.2f})")
    ok = abs(xs_out[-1, 0]) < 0.05 and np.abs(xs_out[:, 0]).max() < 0.21
    print(f"recovered upright through {len(dist)} pushes: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
