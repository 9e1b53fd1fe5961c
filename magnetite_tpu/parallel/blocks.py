"""Shared 2x2 nodal-block helpers for the parallel solvers.

Every banded/sharded path needs the same two pieces around the (ux, uy)
diagonal blocks of the stiffness operator:

  * BC reduction: free * D * free + (1 - free) * I -- the reduced
    operator is the identity on fixed DOFs, so block-Jacobi smoothing
    leaves prescribed displacements untouched.
  * A guarded closed-form 2x2 inverse / solve (Cramer): blocks whose
    determinant is exactly zero (padding rows, fully-constrained nodes
    before reduction) pass through with det := 1, which on reduced
    operators only ever touches rows that are identity anyway.

One implementation here keeps the degenerate-block guard identical across
the node-sharded DIA path (dia_shard), the AMG lane sweeps, and the
material lane sweeps (sweep.py).
"""

from __future__ import annotations

import jax.numpy as jnp


def reduce_diag_blocks(d, free):
    """BC-reduce 2x2 diagonal blocks: free*D*free + (1-free)*I.

    d [2, 2, *dims], free [2, *tail] with *tail broadcastable against
    *dims (e.g. d [2,2,N,B] with free [2,N,1])."""
    d = d * (free[:, None] * free[None, :])
    d = d.at[0, 0].add(1.0 - free[0])
    d = d.at[1, 1].add(1.0 - free[1])
    return d


def guarded_inv2(d):
    """Closed-form inverse of 2x2 blocks d [2, 2, *dims], det==0 -> I/1.

    Returns the same [2, 2, *dims] layout."""
    a_, b_ = d[0, 0], d[0, 1]
    c_, e_ = d[1, 0], d[1, 1]
    det = a_ * e_ - b_ * c_
    det = jnp.where(det == 0, jnp.ones_like(det), det)
    return jnp.stack([jnp.stack([e_, -b_]), jnp.stack([-c_, a_])]) / det


def apply_blocks(d, r):
    """Per-block 2x2 apply: d [2, 2, *dims] @ r [2, *dims] -> [2, *dims].

    Explicit FMAs -- exact in the field dtype and fused with their
    neighbours, where an einsum would be a separate contraction (and an
    f32 one may run in TF32 on the GPU). One implementation keeps the smoother /
    block-Jacobi apply identical across the sharded stencil and DIA paths."""
    return jnp.stack(
        [
            d[0, 0] * r[0] + d[0, 1] * r[1],
            d[1, 0] * r[0] + d[1, 1] * r[1],
        ]
    )


def solve2(d, r):
    """Guarded per-block 2x2 solve: d [2,2,*dims], r [2,*dims] -> d^-1 r.

    Same guard as guarded_inv2 (det==0 -> det:=1); Cramer applied to r
    directly, so no inverse is materialized."""
    a_, b_ = d[0, 0], d[0, 1]
    c_, e_ = d[1, 0], d[1, 1]
    det = a_ * e_ - b_ * c_
    det = jnp.where(det == 0, jnp.ones_like(det), det)
    x0 = (e_ * r[0] - b_ * r[1]) / det
    x1 = (-c_ * r[0] + a_ * r[1]) / det
    return jnp.stack([x0, x1])
