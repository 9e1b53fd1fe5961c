"""2D stencil (9-point block) operator for structured grid meshes.

For meshes whose nodes form a logical (rows x cols) grid (Mesh.grid_shape),
every stiffness coupling is between grid neighbors: (dr, dt) in {-1,0,1}^2,
with the col axis optionally periodic (annulus wrap). The operator is stored
as stencil[9, 2, 2, rows, cols] -- cols minormost, so every shifted read is
contiguous -- and SpMV is nine shifted fused multiply-adds on [2, rows, cols] fields:

    y[i,r,c] = sum_{dr,dt} sum_j stencil[(dr,dt),i,j,r,c] * u[j, r+dr, c+dt]

No gather anywhere. This is also the foundation of the geometric-multigrid
preconditioner (fem/multigrid.py): coarsening preserves the 9-point block
stencil form exactly (Galerkin RAP with bilinear transfer).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

# stencil offset enumeration, index = (dr+1)*3 + (dt+1)
OFFSETS = [(dr, dt) for dr in (-1, 0, 1) for dt in (-1, 0, 1)]
CENTER = 4  # index of (0, 0)


@dataclass
class StencilStructure:
    """Scatter pattern mapping element blocks into the stencil array."""

    slot_ids: np.ndarray  # [E*9] int64: ((dr+1)*3+(dt+1))*R*C + r*C + c
    rows: int
    cols: int
    wrap_cols: bool


def build_stencil_structure(
    tris: np.ndarray, rows: int, cols: int, wrap_cols: bool
) -> Optional[StencilStructure]:
    """Build the pattern, or None if any coupling is not grid-local."""
    tris = np.asarray(tris, dtype=np.int64)
    a = np.repeat(tris, 3, axis=1).reshape(-1)  # row node of each pair
    b = np.tile(tris, (1, 3)).reshape(-1)  # col node
    ra, ca = a // cols, a % cols
    rb, cb = b // cols, b % cols
    dr = rb - ra
    dt = cb - ca
    if wrap_cols:
        dt = np.where(dt > cols // 2, dt - cols, dt)
        dt = np.where(dt < -(cols // 2), dt + cols, dt)
    if (np.abs(dr) > 1).any() or (np.abs(dt) > 1).any():
        return None
    s_idx = (dr + 1) * 3 + (dt + 1)
    slot_ids = s_idx * (rows * cols) + a
    return StencilStructure(
        slot_ids=slot_ids.astype(np.int64),
        rows=rows,
        cols=cols,
        wrap_cols=wrap_cols,
    )


def assemble_stencil(
    ke: jax.Array, slot_ids, rows: int, cols: int
) -> jax.Array:
    """Device assembly -> stencil [9, 2, 2, rows, cols]."""
    from .assembly import element_blocks

    blocks = element_blocks(ke)  # [E*9(pairs), 2, 2]
    flat = jax.ops.segment_sum(
        blocks, jnp.asarray(slot_ids), num_segments=9 * rows * cols
    )  # [9*R*C, 2, 2]
    return flat.reshape(9, rows, cols, 2, 2).transpose(0, 3, 4, 1, 2)


def assemble_stencil_fused(
    coords: jax.Array,
    tris: jax.Array,
    e_mod,
    nu,
    thickness,
    rows: int,
    cols: int,
    wrap_cols: bool,
) -> jax.Array:
    """Element stiffness + scatter in one pass -> stencil [9,2,2,R,C].

    Never materializes the [E,6,6] stiffness tensor. The CST block for node
    pair (a, b) has the closed form (reference math: src/solver.rs:204-278,
    under-the-hood.md:541-606)

        k_ab = t/(4A) * [[d0*ba*bb + d2*ga*gb,  d1*ba*gb + d2*ga*bb],
                         [d1*ga*bb + d2*ba*gb,  d0*ga*gb + d2*ba*bb]]

    with ba = y_{a+1}-y_{a+2}, ga = x_{a+2}-x_{a+1} and d0 = E/(1-nu^2),
    d1 = nu*d0, d2 = (1-nu)/2*d0. Each of the four components is a scalar
    field over pairs, laid out [3, 3, E] with E minormost, so every buffer
    in the chain is a dense elementwise field with no small trailing block
    dimensions.
    """
    tris = tris.astype(jnp.int32)
    at = tris.T  # [3, E]
    p = coords[at]  # [3, E, 2]
    x, y = p[..., 0], p[..., 1]  # [3, E]
    beta = jnp.stack([y[1] - y[2], y[2] - y[0], y[0] - y[1]])  # [3, E]
    gamma = jnp.stack([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area2 = (
        x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
    )  # 2A, [E]
    coef = thickness / (2.0 * area2)  # t / (4A)
    d0 = e_mod / (1.0 - nu * nu)
    d1 = nu * d0
    d2 = 0.5 * (1.0 - nu) * d0

    ba, bb = beta[:, None, :], beta[None, :, :]  # [3,3,E] (a-major)
    ga, gb = gamma[:, None, :], gamma[None, :, :]
    k00 = coef * (d0 * ba * bb + d2 * ga * gb)
    k01 = coef * (d1 * ba * gb + d2 * ga * bb)
    k10 = coef * (d1 * ga * bb + d2 * ba * gb)
    k11 = coef * (d0 * ga * gb + d2 * ba * bb)

    # pair-major scatter pattern [3,3,E] matching the value layout
    a3, b3 = at[:, None, :], at[None, :, :]
    dr = b3 // cols - a3 // cols
    dt = b3 % cols - a3 % cols
    if wrap_cols:
        dt = jnp.where(dt > cols // 2, dt - cols, dt)
        dt = jnp.where(dt < -(cols // 2), dt + cols, dt)
    slot = ((dr + 1) * 3 + (dt + 1)) * (rows * cols) + a3  # [3,3,E]
    slot = slot.reshape(-1)

    def scatter(k):
        return jax.ops.segment_sum(
            k.reshape(-1), slot, num_segments=9 * rows * cols
        ).reshape(9, rows, cols)

    s00, s01, s10, s11 = scatter(k00), scatter(k01), scatter(k10), scatter(k11)
    return jnp.stack(
        [jnp.stack([s00, s01], axis=1), jnp.stack([s10, s11], axis=1)], axis=1
    )


# canonical cell split shared by the mesh generators: every grid cell
# (r, t) -> two triangles along the (r,t)-(r+1,t+1) diagonal
_CELL_TRIS = (
    ((0, 0), (0, 1), (1, 1)),
    ((0, 0), (1, 0), (1, 1)),
)


def assemble_stencil_structured(
    coords: jax.Array,  # [R*C, 2]
    e_mod,
    nu,
    thickness,
    rows: int,
    cols: int,
    wrap_cols: bool,
    dcoefs=None,
) -> jax.Array:
    """Scatter-free assembly for canonical generator grids -> [9,2,2,R,C].

    `dcoefs`, when given, overrides the plane-stress coefficients
    (d0, d1, d2) of D = [[d0,d1,0],[d1,d0,0],[0,0,d2]] directly -- the
    stencil is LINEAR in them, which is how material design sweeps assemble
    three basis stencils once (unit d0 / d1 / d2, thickness 1) and combine
    them per lane with scalar weights (parallel/sweep.material_sweep_solve).

    Connectivity is implied by the grid (two triangles per cell along the
    (r,t)-(r+1,t+1) diagonal, the convention of meshing.generators), so the
    segment_sum scatter disappears entirely: each of the 2 triangle types
    x 9 node pairs contributes one shifted add of a per-cell value grid into
    the stencil band -- pure rolls/pads/FMAs, no scatter at all.

    Orientation-independent: uses |2A|, and the beta/gamma products are
    invariant under vertex-order reversal, so the generators' per-element
    CCW fixes don't need to be replayed here.
    """
    xg = coords[:, 0].reshape(rows, cols)
    yg = coords[:, 1].reshape(rows, cols)
    ct = cols if wrap_cols else cols - 1  # cells per row

    def node_grid(g, dr, dt):
        """Value of g at (cell_r + dr, cell_t + dt), on the cell grid."""
        v = g[dr : dr + rows - 1, :]
        if wrap_cols:
            return jnp.roll(v, -dt, axis=1) if dt else v
        return v[:, dt : dt + ct]

    if dcoefs is None:
        d0 = e_mod / (1.0 - nu * nu)
        d1 = nu * d0
        d2 = 0.5 * (1.0 - nu) * d0
    else:
        d0, d1, d2 = dcoefs

    stencil = jnp.zeros((9, 2, 2, rows, cols), dtype=coords.dtype)
    for tri in _CELL_TRIS:
        x = [node_grid(xg, dr, dt) for dr, dt in tri]  # 3 x [R-1, ct]
        y = [node_grid(yg, dr, dt) for dr, dt in tri]
        beta = [y[1] - y[2], y[2] - y[0], y[0] - y[1]]
        gamma = [x[2] - x[1], x[0] - x[2], x[1] - x[0]]
        area2 = (
            x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
        )
        coef = thickness / (2.0 * jnp.abs(area2))  # t / (4|A|)

        for a in range(3):
            ra, ta = tri[a]
            for b in range(3):
                ba_, bb_ = beta[a], beta[b]
                ga_, gb_ = gamma[a], gamma[b]
                k00 = coef * (d0 * ba_ * bb_ + d2 * ga_ * gb_)
                k01 = coef * (d1 * ba_ * gb_ + d2 * ga_ * bb_)
                k10 = coef * (d1 * ga_ * bb_ + d2 * ba_ * gb_)
                k11 = coef * (d0 * ga_ * gb_ + d2 * ba_ * bb_)
                kblk = jnp.stack(
                    [jnp.stack([k00, k01]), jnp.stack([k10, k11])]
                )  # [2, 2, R-1, ct]

                # destination: band (db - da), node (cell + da)
                dr_s = tri[b][0] - ra
                dt_s = tri[b][1] - ta
                s = (dr_s + 1) * 3 + (dt_s + 1)
                # place the cell grid at node rows [ra, ra+R-1)
                kblk = jnp.pad(
                    kblk,
                    ((0, 0), (0, 0), (ra, rows - (rows - 1) - ra), (0, 0)),
                )
                if wrap_cols:
                    if ta:
                        kblk = jnp.roll(kblk, ta, axis=-1)
                else:
                    kblk = jnp.pad(
                        kblk, ((0, 0), (0, 0), (0, 0), (ta, cols - ct - ta))
                    )
                stencil = stencil.at[s].add(kblk)
    return stencil


def shift2d(u: jax.Array, dr: int, dt: int, wrap_cols: bool) -> jax.Array:
    """u [..., R, C] -> value at (r+dr, c+dt); zero-padded rows, wrapped or
    zero-padded cols."""
    out = u
    if dr:
        out = jnp.roll(out, -dr, axis=-2)
        if dr > 0:
            out = out.at[..., -dr:, :].set(0.0)
        else:
            out = out.at[..., :(-dr), :].set(0.0)
    if dt:
        out = jnp.roll(out, -dt, axis=-1)
        if not wrap_cols:
            if dt > 0:
                out = out.at[..., -dt:].set(0.0)
            else:
                out = out.at[..., :(-dt)].set(0.0)
    return out


def stencil_matvec(
    stencil: jax.Array, u: jax.Array, wrap_cols: bool
) -> jax.Array:
    """y = K u on grid fields u [2, R, C] -> [2, R, C] (shifted FMAs that
    XLA fuses into one elementwise pass).

    Row-shift zero padding is belt-and-braces: boundary stencil entries that
    would reach outside the grid are already zero by construction.
    """
    y0 = jnp.zeros_like(u[0])
    y1 = jnp.zeros_like(u[1])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = shift2d(u, dr, dt, wrap_cols)
        blk = stencil[s]
        # explicit 2x2 block FMAs: exact in the field dtype, and fused with
        # the shifts (an einsum would be a separate contraction)
        y0 = y0 + blk[0, 0] * us[0] + blk[0, 1] * us[1]
        y1 = y1 + blk[1, 0] * us[0] + blk[1, 1] * us[1]
    return jnp.stack([y0, y1])


def stencil_diag_blocks(stencil: jax.Array) -> jax.Array:
    """Diagonal 2x2 blocks, [2, 2, R, C]."""
    return stencil[CENTER]


def make_stencil_operator(stencil: jax.Array, wrap_cols: bool):
    """op(u) = K u, closing over the stencil."""

    def op(u: jax.Array) -> jax.Array:
        return stencil_matvec(stencil, u, wrap_cols)

    return op


def stencil_to_dense(stencil: np.ndarray, wrap_cols: bool) -> np.ndarray:
    """Expand to a dense (2RC, 2RC) matrix (testing only)."""
    _, _, _, r, c = stencil.shape
    n = r * c
    k = np.zeros((n, 2, n, 2))
    for s, (dr, dt) in enumerate(OFFSETS):
        for rr in range(r):
            r2 = rr + dr
            if r2 < 0 or r2 >= r:
                continue
            for cc in range(c):
                c2 = cc + dt
                if wrap_cols:
                    c2 %= c
                elif c2 < 0 or c2 >= c:
                    continue
                k[rr * c + cc, :, r2 * c + c2, :] += stencil[s, :, :, rr, cc]
    return k.reshape(2 * n, 2 * n)
