"""Terrain environments: surface height fields, contact-frame rotations,
friction-cone metadata.

JAX redesign of the reference's ``src/simulator/environment.jl`` and
``/root/reference/src/simulation/environments/*.jl``. The reference derives
surface gradients with Symbolics at construction time; here ``jax.grad``
supplies them at trace time unless an explicit gradient is given (needed for
terrains whose "gradient" intentionally differs from the true derivative,
e.g. the hard stairs at stairs.jl:1-46 which report slope 0).

All terrain branches use ``jnp.where`` — the direct analog of the
reference's branchless ``IfElse.ifelse`` chains (piecewise.jl, stairs.jl),
and the only jit-compatible form.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import jax
import jax.numpy as jnp

LINEARIZED_CONE = "linearized"
NONLINEAR_CONE = "nonlinear"


@dataclasses.dataclass(frozen=True, eq=False)
class Environment:
    """Terrain + friction-cone description (environment.jl:12-23).

    ``surf`` maps the horizontal coordinates (shape ``(ne-1,)``) to a scalar
    height; ``surf_grad`` maps them to the gradient (shape ``(ne-1,)``).
    """

    dim: int  # world dimension: 2 or 3 (environment.jl:123-124)
    surf: Callable
    surf_grad: Callable
    cone: str = LINEARIZED_CONE

    @property
    def friction_dim(self) -> int:
        """environment.jl:126-130."""
        if self.cone == LINEARIZED_CONE:
            return 2 if self.dim == 2 else 4
        return 1 if self.dim == 2 else 2

    def friction_mapping(self, dtype=jnp.float32) -> jnp.ndarray:
        """environment.jl:105-121."""
        if self.cone == LINEARIZED_CONE:
            if self.dim == 2:
                return jnp.asarray([[1.0, -1.0]], dtype=dtype)
            return jnp.asarray(
                [[1.0, 0.0, -1.0, 0.0], [0.0, 1.0, 0.0, -1.0]], dtype=dtype
            )
        return jnp.eye(self.dim - 1, dtype=dtype)

    def rotation(self, x: jnp.ndarray) -> jnp.ndarray:
        """World→surface rotation at horizontal position ``x``.

        2D: environment.jl:79-92; 3D: environment.jl:59-77 (Rodrigues).
        """
        if self.dim == 2:
            sg = jnp.reshape(self.surf_grad(x), ())
            n = jnp.stack([-sg, jnp.ones_like(sg)])
            ns = n / jnp.linalg.norm(n)
            # ang = atan2(1, 0) - atan2(ns2, ns1)
            ang = 0.5 * jnp.pi - jnp.arctan2(ns[1], ns[0])
            c, s = jnp.cos(ang), jnp.sin(ang)
            return jnp.stack(
                [jnp.stack([c, -s]), jnp.stack([s, c])]
            )
        sg = jnp.reshape(self.surf_grad(x), (2,))
        n = jnp.concatenate([-sg, jnp.ones((1,), dtype=sg.dtype)])
        a = n / jnp.linalg.norm(n)
        b = jnp.asarray([0.0, 0.0, 1.0], dtype=sg.dtype)
        v = jnp.cross(a, b)
        c = jnp.dot(a, b)
        sk = jnp.asarray(
            [
                [0.0 * c, -v[2], v[1]],
                [v[2], 0.0 * c, -v[0]],
                [-v[1], v[0], 0.0 * c],
            ]
        )
        return jnp.eye(3, dtype=sg.dtype) + sk + (sk @ sk) / (1.0 + c)


def _autograd_surface(surf: Callable, nxy: int) -> Callable:
    """Gradient of a scalar surface function via jax.grad
    (replaces the Symbolics jacobian at environment.jl:25-51)."""

    def g(x):
        x = jnp.reshape(x, (nxy,))
        return jax.grad(lambda xx: jnp.reshape(surf(xx), ()))(x)

    return g


def environment_2d(surf: Callable, surf_grad: Optional[Callable] = None,
                   cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:25-37."""
    return Environment(2, surf, surf_grad or _autograd_surface(surf, 1), cone)


def environment_3d(surf: Callable, surf_grad: Optional[Callable] = None,
                   cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:39-51."""
    return Environment(3, surf, surf_grad or _autograd_surface(surf, 2), cone)


def environment_2d_flat(cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:17-19."""
    return Environment(2, lambda x: jnp.zeros((), jnp.result_type(x)),
                       lambda x: jnp.zeros_like(jnp.reshape(x, (1,))), cone)


def environment_3d_flat(cone: str = LINEARIZED_CONE) -> Environment:
    """environment.jl:21-23."""
    return Environment(3, lambda x: jnp.zeros((), jnp.result_type(x)),
                       lambda x: jnp.zeros_like(jnp.reshape(x, (2,))), cone)


# ---------------------------------------------------------------------------
# Terrain instances (src/simulation/environments/)
# ---------------------------------------------------------------------------

flat_2d_lc = environment_2d_flat()
flat_3d_lc = environment_3d_flat()
flat_2d_nc = environment_2d_flat(cone=NONLINEAR_CONE)
flat_3d_nc = environment_3d_flat(cone=NONLINEAR_CONE)

# slope.jl
_T_SS = 25.0
_M_SS10 = math.tan(math.radians(10.0))
_X_OFF = 0.5


def _slope_smooth(x):
    x = jnp.reshape(x, (1,))[0]
    return _M_SS10 / _T_SS * jnp.log1p(jnp.exp(_T_SS * (x - _X_OFF)))


slope_smooth_2d_lc = environment_2d(_slope_smooth)
slope1_2d_lc = environment_2d(lambda x: 0.5 * jnp.reshape(x, (1,))[0])

# sinusoidal.jl
sine1_3d_lc = environment_3d(
    lambda x: jnp.sin(jnp.reshape(x, (2,))[0]) + jnp.sin(jnp.reshape(x, (2,))[1]))
sine2_3d_lc = environment_3d(
    lambda x: 0.075 * jnp.sin(2 * jnp.pi * jnp.reshape(x, (2,))[0]))
sine3_3d_lc = environment_3d(
    lambda x: 0.075 * jnp.sin(2 * jnp.pi * jnp.reshape(x, (2,))[0])
    * jnp.sin(2 * jnp.pi * jnp.reshape(x, (2,))[1]))

sine1_2d_lc = environment_2d(
    lambda x: 0.05 * (jnp.cos(jnp.pi * jnp.reshape(x, (1,))[0]) - 1.0))
sine2_2d_lc = environment_2d(
    lambda x: 0.10 * jnp.sin(2 * jnp.pi * jnp.reshape(x, (1,))[0]))
sine3_2d_lc = environment_2d(
    lambda x: 0.03 * (jnp.cos(jnp.pi * jnp.reshape(x, (1,))[0]) - 1.0))

# quadratic.jl
quadratic_bowl_3d_lc = environment_3d(
    lambda x: jnp.sum(jnp.square(jnp.reshape(x, (2,)))))
quadratic_bowl_3d_nc = environment_3d(
    lambda x: jnp.sum(jnp.square(jnp.reshape(x, (2,)))), cone=NONLINEAR_CONE)


def _circular_bowl(x):
    x = jnp.reshape(x, (2,))
    return -jnp.sqrt(2.5 ** 2 - x[0] ** 2 - x[1] ** 2) + 2.5


circular_bowl_3d_nc = environment_3d(_circular_bowl, cone=NONLINEAR_CONE)


# stairs.jl:1-46 — hard 4-step staircase with declared slope 0.
def _stairs3(x):
    x = jnp.reshape(x, (1,))[0]
    y = jnp.where(
        x < 0.125, 0.0,
        jnp.where(x < 0.375, 0.25,
                  jnp.where(x < 0.625, 0.5,
                            jnp.where(x < 0.875, 0.75, 0.0))))
    return jnp.asarray(y, jnp.result_type(x))


stairs3_2d_lc = Environment(
    2, _stairs3, lambda x: jnp.zeros_like(jnp.reshape(x, (1,))))


def smoothed_stairs(x):
    """stairs.jl:27-46 — softmax-kernel smoothed staircase."""
    x = jnp.reshape(x, (1,))[0]
    c = jnp.asarray([0.0, 0.5, 1.0, 1.5, 2.0], jnp.result_type(x))
    a = jnp.asarray([0.0, 0.25, 0.5, 0.75, 0.0], jnp.result_type(x))
    r, s = 0.25, 3.0
    v = s * (1.0 - jnp.square((x - c) / r))
    w = jax.nn.softmax(v)
    return jnp.dot(w, a)


smoothed_stairs_2d_lc = environment_2d(smoothed_stairs)


# piecewise.jl — 10-degree slope-up-then-down with cubic-smoothed kinks.
def _cubic_fit(x1, y1, m1, x2, y2, m2):
    import numpy as np

    amat = np.array(
        [
            [x1 ** 3, x1 ** 2, x1, 1.0],
            [x2 ** 3, x2 ** 2, x2, 1.0],
            [3 * x1 ** 2, 2 * x1, 1.0, 0.0],
            [3 * x2 ** 2, 2 * x2, 1.0, 0.0],
        ]
    )
    return np.linalg.solve(amat, np.array([y1, y2, m1, m2]))


def _make_piecewise(m_ss: float):
    a1 = _cubic_fit(0.4, 0.0, 0.0, 0.6, m_ss * 0.1, m_ss)
    a2 = _cubic_fit(1.4, m_ss * 1.4, m_ss, 1.6, m_ss * 1.5 - 0.25 * m_ss * 0.1,
                    -0.25 * m_ss)

    def poly(a, z):
        return a[3] + a[2] * z + a[1] * z ** 2 + a[0] * z ** 3

    def d_poly(a, z):
        return a[2] + 2 * a[1] * z + 3 * a[0] * z ** 2

    def surf(x):
        x = jnp.reshape(x, (1,))[0]
        return jnp.where(
            x < 0.4, 0.0,
            jnp.where(x < 0.6, poly(a1, x),
                      jnp.where(x < 1.9, m_ss * x - 0.5 * m_ss,
                                jnp.where(x < 2.1, poly(a2, x - 0.5),
                                          -0.25 * m_ss * (x - 2.0) + 1.5 * m_ss))))

    def grad(x):
        x0 = jnp.reshape(x, (1,))[0]
        g = jnp.where(
            x0 < 0.4, 0.0,
            jnp.where(x0 < 0.6, d_poly(a1, x0),
                      jnp.where(x0 < 1.9, m_ss,
                                jnp.where(x0 < 2.1, d_poly(a2, x0 - 0.5),
                                          -0.25 * m_ss))))
        return jnp.reshape(g, (1,))

    return surf, grad


_p1, _dp1 = _make_piecewise(math.tan(math.radians(10.0)))
piecewise1_2d_lc = Environment(2, _p1, _dp1)
_p2, _dp2 = _make_piecewise(math.tan(math.radians(-10.0)))
piecewise2_2d_lc = Environment(2, _p2, _dp2)


ENVIRONMENTS = {
    "flat_2D_lc": flat_2d_lc,
    "flat_3D_lc": flat_3d_lc,
    "flat_2D_nc": flat_2d_nc,
    "flat_3D_nc": flat_3d_nc,
    "slope_smooth_2D_lc": slope_smooth_2d_lc,
    "slope1_2D_lc": slope1_2d_lc,
    "sine1_2D_lc": sine1_2d_lc,
    "sine2_2D_lc": sine2_2d_lc,
    "sine3_2D_lc": sine3_2d_lc,
    "sine1_3D_lc": sine1_3d_lc,
    "sine2_3D_lc": sine2_3d_lc,
    "sine3_3D_lc": sine3_3d_lc,
    "quadratic_bowl_3D_lc": quadratic_bowl_3d_lc,
    "quadratic_bowl_3D_nc": quadratic_bowl_3d_nc,
    "circular_bowl_3D_nc": circular_bowl_3d_nc,
    "stairs3_2D_lc": stairs3_2d_lc,
    "smoothed_stairs_2D_lc": smoothed_stairs_2d_lc,
    "piecewise1_2D_lc": piecewise1_2d_lc,
    "piecewise2_2D_lc": piecewise2_2d_lc,
}
