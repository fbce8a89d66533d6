"""Live plotting during a jitted rollout.

The reference's ``CIMPCOptions.live_plotting`` debug loop
(``/root/reference/src/controller/mpc_utils.jl:156-183``) re-plots the
tracked configurations/controls from inside the solve. Under XLA the
rollout is one compiled program, so the recast streams each
step's state to the host through ``jax.debug.callback`` (cheap: a few
scalars per sim step, fully async until the plot refresh) and refreshes
a PNG every ``every`` steps — tail it with any image viewer for the
live view.

Usage::

    from contactimplicitmpc_tpu.utils.live import LivePlotter
    lp = LivePlotter(ref_q=ref.q, n_sample=5, path="live.png")
    traj = ci.simulate(model, env, H, h, q1, v1, policy=p,
                       live_plotter=lp)
    lp.flush()          # final refresh
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class LivePlotter:
    def __init__(self, ref_q=None, n_sample: int = 1,
                 coords=None, every: int = 50,
                 path: str = "live_plot.png"):
        self.ref_q = None if ref_q is None else np.asarray(ref_q)
        self.n_sample = n_sample
        self.coords = coords
        self.every = max(1, every)
        self.path = path
        self.ts: list = []
        self.qs: list = []
        self.us: list = []
        self.gammas: list = []

    # called from inside the compiled rollout via jax.debug.callback
    def record(self, t, q, u, gamma):
        self.ts.append(int(t))
        self.qs.append(np.asarray(q))
        self.us.append(np.asarray(u))
        self.gammas.append(np.asarray(gamma))
        if len(self.ts) % self.every == 0:
            self.flush()

    def flush(self) -> Optional[str]:
        if not self.qs:
            return None
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        qs = np.stack(self.qs)
        coords = (list(self.coords) if self.coords is not None
                  else list(range(min(4, qs.shape[1]))))
        fig, axes = plt.subplots(len(coords) + 2, 1,
                                 figsize=(8, 2 * (len(coords) + 2)),
                                 sharex=True)
        t = np.asarray(self.ts)
        for ax, c in zip(axes, coords):
            ax.plot(t, qs[:, c], lw=1.2, label=f"sim q[{c}]")
            if self.ref_q is not None:
                tr = np.arange(self.ref_q.shape[0]) * self.n_sample
                m = tr <= t.max() + self.n_sample
                ax.plot(tr[m], self.ref_q[m, c], "--", lw=1.0,
                        label=f"ref q[{c}]")
            ax.legend(loc="best", fontsize=8)
        us = np.stack(self.us)
        for i in range(us.shape[1]):
            axes[-2].plot(t, us[:, i], lw=0.9, label=f"u[{i}]")
        axes[-2].legend(loc="best", fontsize=8)
        gam = np.stack(self.gammas)
        for i in range(gam.shape[1]):
            axes[-1].plot(t, gam[:, i], lw=0.9, label=f"γ[{i}]")
        axes[-1].legend(loc="best", fontsize=8)
        axes[-1].set_xlabel("sim step")
        fig.suptitle(f"live rollout (t = {t.max()})")
        fig.tight_layout()
        fig.savefig(self.path, dpi=110)
        plt.close(fig)
        return self.path
