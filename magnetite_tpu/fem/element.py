"""CST (constant-strain-triangle) element kernels, batched over all elements.

Where the reference computes per-element 6x6 stiffness matrices one at a time
in a Rust loop (src/solver.rs:263-278, 543-567), we compute every element at
once as a single batched einsum -- one fused XLA computation on device.

Math (documented in reference under-the-hood.md:541-606):
  area  A = 0.5*(x0(y1-y2) + x1(y2-y0) + x2(y0-y1))     (src/solver.rs:187-193)
  B [3,6] from beta_i = y_{i+1}-y_{i+2}, gamma_i = x_{i+2}-x_{i+1}, / 2A
                                                         (src/solver.rs:204-230)
  D [3,3] = E/(1-nu^2) * [[1,nu,0],[nu,1,0],[0,0,(1-nu)/2]]
                                                         (src/solver.rs:240-250)
  ke [6,6] = B^T D B * A * t                             (src/solver.rs:263-278)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gather_element_coords(coords: jax.Array, tris: jax.Array) -> jax.Array:
    """coords [N,2], tris [E,3] -> [E,3,2] per-element corner coordinates."""
    return coords[tris]


def element_areas(ecoords: jax.Array) -> jax.Array:
    """Signed areas of all elements. ecoords [E,3,2] -> [E]."""
    x, y = ecoords[..., 0], ecoords[..., 1]
    return 0.5 * (
        x[..., 0] * (y[..., 1] - y[..., 2])
        + x[..., 1] * (y[..., 2] - y[..., 0])
        + x[..., 2] * (y[..., 0] - y[..., 1])
    )


def strain_displacement_matrices(
    ecoords: jax.Array, areas: jax.Array
) -> jax.Array:
    """Batched B matrices. ecoords [E,3,2] -> [E,3,6].

    Row layout (strain = [eps_x, eps_y, gamma_xy]):
      [beta0  0      beta1  0      beta2  0    ]
      [0      gam0   0      gam1   0      gam2 ]   all / (2A)
      [gam0   beta0  gam1   beta1  gam2   beta2]
    """
    x, y = ecoords[..., 0], ecoords[..., 1]
    # beta_i = y_{i+1} - y_{i+2}, gamma_i = x_{i+2} - x_{i+1} (cyclic)
    beta = jnp.stack(
        [y[..., 1] - y[..., 2], y[..., 2] - y[..., 0], y[..., 0] - y[..., 1]],
        axis=-1,
    )  # [E,3]
    gamma = jnp.stack(
        [x[..., 2] - x[..., 1], x[..., 0] - x[..., 2], x[..., 1] - x[..., 0]],
        axis=-1,
    )  # [E,3]
    zero = jnp.zeros_like(beta)
    row0 = jnp.stack([beta, zero], axis=-1).reshape(*beta.shape[:-1], 6)
    row1 = jnp.stack([zero, gamma], axis=-1).reshape(*beta.shape[:-1], 6)
    row2 = jnp.stack([gamma, beta], axis=-1).reshape(*beta.shape[:-1], 6)
    b = jnp.stack([row0, row1, row2], axis=-2)  # [E,3,6]
    return b / (2.0 * areas)[..., None, None]


def stress_strain_matrix(youngs_modulus, poisson_ratio, dtype=jnp.float64):
    """Plane-stress isotropic D [3,3]."""
    nu = jnp.asarray(poisson_ratio, dtype=dtype)
    e = jnp.asarray(youngs_modulus, dtype=dtype)
    one = jnp.ones((), dtype=dtype)
    zero = jnp.zeros((), dtype=dtype)
    d = jnp.stack(
        [
            jnp.stack([one, nu, zero]),
            jnp.stack([nu, one, zero]),
            jnp.stack([zero, zero, (one - nu) / 2.0]),
        ]
    )
    return d * (e / (one - nu * nu))


def pair_block_fields(
    coords: jax.Array,
    tris: jax.Array,
    youngs_modulus,
    poisson_ratio,
    part_thickness,
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Closed-form per-node-pair stiffness blocks as four scalar fields.

    Returns (k00, k01, k10, k11), each [3, 3, E] (a-major, E minormost):
    the 2x2 block coupling local nodes (a, b) of every element, WITHOUT
    materializing the [E,6,6] stiffness tensor. Same math as
    `element_stiffness_matrices` (k_ab = t/(4A) * B_a^T D B_b expanded;
    reference src/solver.rs:204-278) but laid out as dense scalar planes,
    so the irregular assemblies (DIA/hybrid/ELL) scatter four scalar
    fields instead of [E*9,2,2] blocks with tiny trailing dimensions.
    """
    at = tris.astype(jnp.int32).T  # [3, E]
    p = coords[at]  # [3, E, 2]
    x, y = p[..., 0], p[..., 1]
    beta = jnp.stack([y[1] - y[2], y[2] - y[0], y[0] - y[1]])  # [3, E]
    gamma = jnp.stack([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area2 = x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
    coef = part_thickness / (2.0 * area2)  # t / (4A)
    d0 = youngs_modulus / (1.0 - poisson_ratio * poisson_ratio)
    d1 = poisson_ratio * d0
    d2 = 0.5 * (1.0 - poisson_ratio) * d0
    ba, bb = beta[:, None, :], beta[None, :, :]  # [3,3,E]
    ga, gb = gamma[:, None, :], gamma[None, :, :]
    k00 = coef * (d0 * ba * bb + d2 * ga * gb)
    k01 = coef * (d1 * ba * gb + d2 * ga * bb)
    k10 = coef * (d1 * ga * bb + d2 * ba * gb)
    k11 = coef * (d0 * ga * gb + d2 * ba * bb)
    return k00, k01, k10, k11


def element_stiffness_matrices(
    coords: jax.Array,
    tris: jax.Array,
    youngs_modulus,
    poisson_ratio,
    part_thickness,
) -> jax.Array:
    """All element stiffness matrices in one batched einsum chain.

    Returns ke [E,6,6] with ke = B^T D B * A * t.
    """
    ecoords = gather_element_coords(coords, tris)
    areas = element_areas(ecoords)
    b = strain_displacement_matrices(ecoords, areas)  # [E,3,6]
    d = stress_strain_matrix(youngs_modulus, poisson_ratio, dtype=coords.dtype)
    db = jnp.einsum("rs,esj->erj", d, b, precision="highest")  # [E,3,6]
    ke = jnp.einsum("eri,erj->eij", b, db, precision="highest")  # [E,6,6]
    scale = (areas * jnp.asarray(part_thickness, dtype=coords.dtype))[:, None, None]
    return ke * scale
