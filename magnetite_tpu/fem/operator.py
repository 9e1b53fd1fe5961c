"""Matrix-vector products for the global stiffness operator.

All operators act on displacement fields shaped [N, 2] (node-major), the
natural layout for the block-ELL data and for vmapped batch axes.

Boundary conditions are imposed by masking, not by row/column partitioning:
the reference gathers the rows/cols of unknown DOFs into a smaller dense
system (src/solver.rs:365-404) -- a data-dependent shape that XLA cannot
compile. The masked operator

    A(v) = free * K(free * v) + (1 - free) * v

is the same reduced system padded back to full size with an identity on the
constrained DOFs: symmetric positive definite, static shape, jit-friendly.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

MatVec = Callable[[jax.Array], jax.Array]


def ell_matvec(ell_data: jax.Array, cols: jax.Array, u: jax.Array) -> jax.Array:
    """Block-ELL SpMV: y[n,i] = sum_k sum_j data[n,k,i,j] * u[cols[n,k], j].

    One gather ([N,K,2]) + one contraction -- the fixed-width form of the
    reference's CSR SpMV (src/solver.rs:31-37), with static shapes.
    """
    gathered = u[cols]  # [N, K, 2]
    return jnp.einsum("nkij,nkj->ni", ell_data, gathered, precision="highest")


def make_ell_operator(ell_data: jax.Array, cols: jax.Array) -> MatVec:
    def op(u: jax.Array) -> jax.Array:
        return ell_matvec(ell_data, cols, u)

    return op


def make_constrained_operator(matvec: MatVec, free_mask: jax.Array) -> MatVec:
    """Wrap K into the BC-reduced SPD operator (identity on fixed DOFs)."""

    def op(v: jax.Array) -> jax.Array:
        kv = matvec(free_mask * v)
        return free_mask * kv + (1.0 - free_mask) * v

    return op


def reduced_rhs(
    matvec: MatVec,
    free_mask: jax.Array,
    u_fixed: jax.Array,
    f_applied: jax.Array,
) -> jax.Array:
    """RHS of the reduced system: b = free*(f - K u_fixed) + (1-free)*u_fixed.

    Equivalent to the reference's -K_known*u_known row-sum plus known forces
    (src/solver.rs:390-432); with this RHS the masked solve returns the
    prescribed values exactly on fixed DOFs.
    """
    return free_mask * (f_applied - matvec(u_fixed)) + (1.0 - free_mask) * u_fixed


def block_jacobi_preconditioner(
    diag_blocks: jax.Array, free_mask: jax.Array
) -> MatVec:
    """Inverse of the 2x2 diagonal blocks of the reduced operator.

    The reduced operator's diagonal block at node n is
        free_n * K_nn * free_n + diag(1 - free_n)
    (a 2x2 SPD matrix); we invert each in closed form. [N,2,2] -> apply fn.
    """
    f = free_mask  # [N, 2]
    outer = f[:, :, None] * f[:, None, :]  # [N,2,2]
    eye = jnp.eye(2, dtype=diag_blocks.dtype)
    d = diag_blocks * outer + eye * (1.0 - f)[:, :, None] * eye
    # closed-form 2x2 inverse
    a, b = d[:, 0, 0], d[:, 0, 1]
    c, e = d[:, 1, 0], d[:, 1, 1]
    det = a * e - b * c
    inv = (
        jnp.stack(
            [jnp.stack([e, -b], axis=-1), jnp.stack([-c, a], axis=-1)], axis=-2
        )
        / det[:, None, None]
    )

    def apply(r: jax.Array) -> jax.Array:
        return jnp.einsum("nij,nj->ni", inv, r, precision="highest")

    return apply


def jacobi_preconditioner(diag_blocks: jax.Array, free_mask: jax.Array) -> MatVec:
    """Scalar Jacobi: divide by the reduced operator's diagonal entries."""
    diag = jnp.stack([diag_blocks[:, 0, 0], diag_blocks[:, 1, 1]], axis=-1)
    d = free_mask * diag + (1.0 - free_mask)

    def apply(r: jax.Array) -> jax.Array:
        return r / d

    return apply


def identity_preconditioner() -> MatVec:
    return lambda r: r
