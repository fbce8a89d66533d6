"""contactimplicitmpc_tpu — contact-implicit model-predictive control in
JAX.

A from-scratch JAX/XLA re-design of the capabilities of
ContactImplicitMPC.jl (Le Cleac'h, Howell, Schwager, Manchester,
arXiv:2107.05616): contact dynamics as nonlinear complementarity problems,
interior-point physics simulation, and real-time contact-implicit MPC —
batched, jit-compiled, and shardable across GPU meshes.
"""

import os as _os

import jax as _jax

# On an H100, XLA may run float32 matmuls in TF32 (10 mantissa bits).
# Every number this library produces flows through interior-point
# residuals and Newton steps whose convergence tests sit at 1e-3..1e-8,
# which reduced-precision products can floor and so silently break
# convergence. Force true f32 products for the process; opt out with
# CIMPC_NO_PRECISION_FIX=1 and pass explicit `precision=` at your own
# call sites.
if not _os.environ.get("CIMPC_NO_PRECISION_FIX"):
    _jax.config.update("jax_default_matmul_precision", "highest")

from .dims import Dims
from .env import (ENVIRONMENTS, Environment, circular_bowl_3d_nc,
                  environment_2d, environment_2d_flat, environment_3d,
                  environment_3d_flat, flat_2d_lc, flat_2d_nc, flat_3d_lc,
                  flat_3d_nc, piecewise1_2d_lc, piecewise2_2d_lc,
                  quadratic_bowl_3d_lc, quadratic_bowl_3d_nc, sine1_2d_lc,
                  sine1_3d_lc, sine2_2d_lc, sine2_3d_lc, sine3_2d_lc,
                  sine3_3d_lc, slope1_2d_lc, slope_smooth_2d_lc,
                  smoothed_stairs_2d_lc, stairs3_2d_lc)
from .models.base import Model, dims_of, dynamics
from .sim.interior_point import IPOptions, IPResult, ip_solve, z_initialize
from .sim.residual import (pack_theta, pack_z, pack_z_consistent, residual,
                           residual_theta_jacobian, residual_z_jacobian,
                           unpack_theta, unpack_z)
from .sim.simulator import (SimTrajectory, control_saturation,
                            default_sim_options,
                            empty_disturbances, empty_policy,
                            impulse_disturbances, open_loop_disturbances,
                            open_loop_policy, random_disturbances, saturated_policy, simulate,
                            status)

__version__ = "0.1.0"
