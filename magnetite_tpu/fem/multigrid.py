"""Geometric multigrid V-cycle preconditioner for structured-grid problems.

Mesh-independent CG convergence: block-Jacobi PCG iteration counts grow like
O(1/h) (3.5k iterations at 1M elements); a V-cycle preconditioner holds them
at a few dozen. All pieces are XLA-friendly grid ops:

  * transfers: bilinear prolongation / its exact adjoint restriction on the
    logical (rows, cols) grid, wrap-aware in cols (annulus)
  * coarse operators: Galerkin RAP computed ON DEVICE by stencil probing --
    apply R(A(P(.))) to a few periodic comb vectors and read off all nine
    coarse 2x2 blocks exactly (reach 1 < comb period), so no re-meshing and
    no host round trip
  * smoother: damped block-Jacobi (symmetric, so the V-cycle stays SPD and
    CG-compatible)

The preconditioner operates on [2, rows, cols] displacement fields, matching
fem/stencil.py's operator layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp

from .stencil import (
    CENTER,
    OFFSETS,
    make_stencil_operator,
)


# ----------------------------- transfers ---------------------------------


def prolong(uc: jax.Array, wrap_cols: bool) -> jax.Array:
    """Bilinear interpolation coarse -> fine on [..., Rc, Cc] grids.

    Fine dims: rows 2*Rc-1; cols 2*Cc if wrap_cols else 2*Cc-1.
    Fine even nodes coincide with coarse nodes; odd nodes average neighbors.
    """
    # interpolate along cols
    if wrap_cols:
        mid = 0.5 * (uc + jnp.roll(uc, -1, axis=-1))
        x = jnp.stack([uc, mid], axis=-1).reshape(*uc.shape[:-1], -1)
    else:
        a = uc[..., :-1]
        mid = 0.5 * (uc[..., :-1] + uc[..., 1:])
        body = jnp.stack([a, mid], axis=-1).reshape(*uc.shape[:-1], -1)
        x = jnp.concatenate([body, uc[..., -1:]], axis=-1)
    # interpolate along rows (never wrapped)
    a = x[..., :-1, :]
    mid = 0.5 * (x[..., :-1, :] + x[..., 1:, :])
    body = jnp.stack([a, mid], axis=-2).reshape(
        *x.shape[:-2], -1, x.shape[-1]
    )
    return jnp.concatenate([body, x[..., -1:, :]], axis=-2)


def restrict(rf: jax.Array, wrap_cols: bool) -> jax.Array:
    """Exact adjoint of `prolong` (P^T), fine -> coarse."""
    # rows adjoint
    even = rf[..., ::2, :]
    odd = rf[..., 1::2, :]
    up = jnp.pad(odd, [(0, 0)] * (odd.ndim - 2) + [(1, 0), (0, 0)])[
        ..., : even.shape[-2], :
    ]
    down = jnp.pad(odd, [(0, 0)] * (odd.ndim - 2) + [(0, 1), (0, 0)])[
        ..., : even.shape[-2], :
    ]
    x = even + 0.5 * (up + down)
    # cols adjoint
    even = x[..., ::2]
    odd = x[..., 1::2]
    if wrap_cols:
        left = jnp.roll(odd, 1, axis=-1)
        return even + 0.5 * (odd + left)
    up = jnp.pad(odd, [(0, 0)] * (odd.ndim - 1) + [(1, 0)])[
        ..., : even.shape[-1]
    ]
    down = jnp.pad(odd, [(0, 0)] * (odd.ndim - 1) + [(0, 1)])[
        ..., : even.shape[-1]
    ]
    return even + 0.5 * (up + down)


# --------------------------- Galerkin coarsening ---------------------------


def galerkin_coarse_stencil(
    op_fine: Callable[[jax.Array], jax.Array],
    rc: int,
    cc: int,
    wrap_cols: bool,
    dtype,
) -> jax.Array:
    """Coarse stencil [9, 2, 2, rc, cc] of R o A_fine o P by comb probing.

    Probe vectors are 1 on coarse nodes with (r % 3 == p, c % pc == q) for
    one displacement component; the coarse operator's reach is 1 in each grid
    direction, so every output entry is attributable to exactly one stencil
    offset. pc = 4 for wrapped cols (power-of-two cols stay comb-consistent
    across the seam), 3 otherwise.
    """
    pc = 4 if wrap_cols else 3
    if wrap_cols and cc % pc != 0:
        raise ValueError(
            f"wrapped cols must be divisible by {pc} for probing, got {cc}"
        )

    r_ids = jnp.arange(rc)[:, None] % 3  # [rc,1]
    c_ids = jnp.arange(cc)[None, :] % pc  # [1,cc]

    # build all probes: [3*pc*2, 2, rc, cc]
    probes = []
    for p in range(3):
        for q in range(pc):
            comb = ((r_ids == p) & (c_ids == q)).astype(dtype)  # [rc,cc]
            for comp in range(2):
                v = jnp.zeros((2, rc, cc), dtype=dtype)
                v = v.at[comp].set(comb)
                probes.append(v)
    probes = jnp.stack(probes)  # [P, 2, rc, cc]

    def apply_rap(v):
        return restrict(op_fine(prolong(v, wrap_cols)), wrap_cols)

    ys = jax.vmap(apply_rap)(probes)  # [P, 2, rc, cc]
    ys = ys.reshape(3, pc, 2, 2, rc, cc)  # [p, q, comp_in, comp_out, r, c]

    out = []
    for dr, dt in OFFSETS:
        p_sel = (r_ids + dr) % 3  # [rc,1]
        q_sel = (c_ids + dt) % pc  # [1,cc]
        if not wrap_cols:
            # non-wrapped: out-of-range neighbors have zero contribution
            # automatically (probe comb has no node there)
            pass
        # gather y[p_sel, q_sel, :, :, r, c] via one-hot sums (tiny: 3*pc)
        acc = jnp.zeros((2, 2, rc, cc), dtype=dtype)
        for p in range(3):
            for q in range(pc):
                mask = ((p_sel == p) & (q_sel == q)).astype(dtype)  # [rc,cc]
                acc = acc + ys[p, q].transpose(1, 0, 2, 3) * mask
        out.append(acc)
    return jnp.stack(out)  # [9, 2(out), 2(in), rc, cc]


# ------------------------------ hierarchy ---------------------------------


@dataclass
class MGLevel:
    stencil: jax.Array  # [9, 2, 2, R, C]
    diag_inv: jax.Array  # [2, 2, R, C] inverse center blocks (damped Jacobi)
    rows: int
    cols: int
    op: Callable[[jax.Array], jax.Array] = None  # level matvec
    # dense inverse of the whole level operator [2RC, 2RC], node-major
    # (set on the coarsest level when small): exact coarse-grid solve as one
    # matmul instead of dozens of smoothing sweeps
    dense_inv: jax.Array = None


# exact coarse solves above this many DOFs would cost more than they save
_DENSE_COARSE_MAX_DOF = 2048


def stencil_to_dense_device(stencil: jax.Array, wrap_cols: bool) -> jax.Array:
    """Expand [9,2,2,R,C] to a dense (2RC, 2RC) matrix, jit-friendly.

    Node-major DOF order (node*2 + component), matching
    fem/stencil.stencil_to_dense.
    """
    from .stencil import OFFSETS

    _, _, _, rows, cols = stencil.shape
    n = rows * cols
    r = jnp.arange(rows)[:, None]
    c = jnp.arange(cols)[None, :]
    k = jnp.zeros((n, 2, n, 2), dtype=stencil.dtype)
    for s, (dr, dt) in enumerate(OFFSETS):
        r2 = jnp.broadcast_to(r + dr, (rows, cols))
        c2 = jnp.broadcast_to(c + dt, (rows, cols))
        valid = (r2 >= 0) & (r2 < rows)
        if wrap_cols:
            c2 = c2 % cols
        else:
            valid = valid & (c2 >= 0) & (c2 < cols)
            c2 = jnp.clip(c2, 0, cols - 1)
        row_flat = (r * cols + c + jnp.zeros_like(c2)).reshape(-1)
        col_flat = (jnp.clip(r2, 0, rows - 1) * cols + c2).reshape(-1)
        vals = stencil[s].transpose(2, 3, 0, 1).reshape(n, 2, 2)
        vals = vals * valid.reshape(-1)[:, None, None].astype(stencil.dtype)
        k = k.at[row_flat, :, col_flat, :].add(vals)
    return k.reshape(2 * n, 2 * n)


def dense_coarse_inverse(stencil: jax.Array, wrap_cols: bool) -> jax.Array:
    """Inverse of the (SPD, BC-reduced) level operator for exact coarse
    solves; computed once per hierarchy build, in the stencil's dtype."""
    return jnp.linalg.inv(stencil_to_dense_device(stencil, wrap_cols))


def apply_dense_inverse(dense_inv: jax.Array, r: jax.Array) -> jax.Array:
    """Exact coarse solve on a [2, R, C] field (node-major flattening)."""
    two, rows, cols = r.shape
    r_flat = r.transpose(1, 2, 0).reshape(-1)
    e = jnp.matmul(dense_inv, r_flat, precision="highest")
    return e.reshape(rows, cols, 2).transpose(2, 0, 1)


def _center_inverse(stencil: jax.Array) -> jax.Array:
    d = stencil[CENTER]  # [2,2,R,C]
    a, b = d[0, 0], d[0, 1]
    c, e = d[1, 0], d[1, 1]
    det = a * e - b * c
    det = jnp.where(jnp.abs(det) < 1e-30, 1.0, det)
    return jnp.stack(
        [jnp.stack([e, -b]), jnp.stack([-c, a])]
    ) / det


def can_coarsen(rows: int, cols: int, wrap_cols: bool, min_size: int = 8) -> bool:
    if rows < 2 * min_size + 1 or (rows - 1) % 2:
        return False
    if wrap_cols:
        return cols >= 2 * min_size and cols % 2 == 0 and (cols // 2) % 4 == 0
    return cols >= 2 * min_size + 1 and (cols - 1) % 2 == 0


def build_hierarchy(
    fine_stencil: jax.Array,
    free: jax.Array,  # [2, R, C]
    wrap_cols: bool,
    max_levels: int = 10,
) -> list[MGLevel]:
    """Build the level list (finest first). The fine stencil must already be
    the BC-REDUCED operator (identity on fixed DOFs) so every level inherits
    the boundary conditions through RAP."""
    rows, cols = fine_stencil.shape[-2], fine_stencil.shape[-1]
    dtype = fine_stencil.dtype
    levels = [
        MGLevel(
            stencil=fine_stencil,
            diag_inv=_center_inverse(fine_stencil),
            rows=rows,
            cols=cols,
            op=make_stencil_operator(fine_stencil, wrap_cols),
        )
    ]
    while len(levels) < max_levels and can_coarsen(rows, cols, wrap_cols):
        rc = (rows - 1) // 2 + 1
        cc = cols // 2 if wrap_cols else (cols - 1) // 2 + 1
        op = make_stencil_operator(levels[-1].stencil, wrap_cols)
        coarse = galerkin_coarse_stencil(op, rc, cc, wrap_cols, dtype)
        levels.append(
            MGLevel(
                stencil=coarse,
                diag_inv=_center_inverse(coarse),
                rows=rc,
                cols=cc,
                op=make_stencil_operator(coarse, wrap_cols),
            )
        )
        rows, cols = rc, cc
    # exact coarse solve: one dense inverse of the coarsest operator
    # replaces dozens of smoothing sweeps per V-cycle
    last = levels[-1]
    if len(levels) > 1 and 2 * last.rows * last.cols <= _DENSE_COARSE_MAX_DOF:
        last.dense_inv = dense_coarse_inverse(last.stencil, wrap_cols)
    return levels


# ------------------------------- V-cycle ----------------------------------


def _smooth(level: MGLevel, wrap_cols, e, r, sweeps: int, omega: float):
    """Damped block-Jacobi: e += omega * D^-1 (r - A e)."""
    for _ in range(sweeps):
        res = r - level.op(e)
        e = e + omega * jnp.einsum("ijrc,jrc->irc", level.diag_inv, res, precision="highest")
    return e


def vcycle_preconditioner(
    levels: list[MGLevel],
    wrap_cols: bool,
    pre_sweeps: int = 2,
    post_sweeps: int = 2,
    # the coarsest grid is tiny (<=17x32), so a deep Jacobi "solve" there is
    # nearly free and measurably tightens the V-cycle (1M-plate tuning)
    coarse_sweeps: int = 48,
    omega: float = 0.7,
):
    """Returns apply(r [2,R,C]) -> approximate solution of A e = r.

    Symmetric by construction (matching pre/post Jacobi sweeps), hence a
    valid SPD preconditioner for CG.
    """

    def cycle(l: int, r: jax.Array) -> jax.Array:
        level = levels[l]
        zero = jnp.zeros_like(r)
        if l == len(levels) - 1:
            if level.dense_inv is not None:
                return apply_dense_inverse(level.dense_inv, r)
            return _smooth(level, wrap_cols, zero, r, coarse_sweeps, omega)
        e = _smooth(level, wrap_cols, zero, r, pre_sweeps, omega)
        res = r - level.op(e)
        ec = cycle(l + 1, restrict(res, wrap_cols))
        e = e + prolong(ec, wrap_cols)
        return _smooth(level, wrap_cols, e, r, post_sweeps, omega)

    def apply(r: jax.Array) -> jax.Array:
        return cycle(0, r)

    return apply
