"""Device-mesh helpers.

The reference's only parallelism is ``Threads.@threads`` over per-knot IP
solves (implicit_dynamics.jl:166-171) and serial Monte-Carlo loops
(examples/hopper/monte_carlo.jl:78-91). Here Monte-Carlo rollouts (seeds /
initial conditions) are the one scaling axis, ``dp``: the cards of one
host are joined all to all by NVLink, so a single data-parallel axis is
the whole layout. The horizon/knot dimension stays on-device: per-knot IP
solves are vmap-batched (they share one program), and the Riccati sweep
is sequential per rollout.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D ``("dp",)`` mesh over the first ``n_devices`` devices (all of
    them by default)."""
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.asarray(devices[:n]), ("dp",))
