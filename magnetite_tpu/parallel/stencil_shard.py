"""Row-sharded stencil PCG over a device mesh: halo exchange, not gather.

The ELL multi-chip path (parallel/sharding.py) all_gathers the displacement
vector and gathers through column indices -- correct, but it moves the whole
vector every matvec. Structured-grid problems shard the [2, R, C] fields by
ROWS instead: each device owns a contiguous row band of the grid plus the
stencil rows that act on it, and one 9-point matvec needs exactly ONE row of halo from each neighbor:

    per iteration: 2 x jax.lax.ppermute of a [2, 1, C] row  (+ psum scalars)

i.e. 8*C bytes between devices per step vs the 8*R*C all_gather --
communication shrinks by the shard count. The shard-local compute runs
through the SAME single-chip operator as the unsharded solver
(fem/stencil.make_stencil_operator). The halo rows enter as one zero-row
stencil pad, so the local operator needs no halo-awareness.

Grid rows are never periodic (wrap is in columns, unsharded), so shard 0 /
shard n-1 receive zeros from the missing neighbor -- exactly the zero
padding semantics of the single-device operator (fem/stencil.py shift2d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bc import BCArrays
from ..config import ModelMetadata
from ..errors import SolverError
from ..fem.cg import CGResult, pcg
from ..fem.stencil import OFFSETS, CENTER
from ..meshing.core import Mesh as FemMesh

# shared 2x2 block apply (parallel/blocks.py); module-level binding so the
# preconditioner-selection tests can observe/poison every call site here
from .blocks import apply_blocks as _apply_dinv


@dataclass
class ShardedStencilProblem:
    """Device-ready row-sharded structured-grid FEA system.

    All grid arrays are padded to rows divisible by the shard count; pad
    rows carry identity stencil rows (free=0) so the operator stays SPD.
    """

    device_mesh: Mesh
    axis: str
    reduced: jax.Array  # [9, 2, 2, Rp, C] BC-reduced stencil, row-sharded
    raw: jax.Array  # [9, 2, 2, Rp, C] unreduced (force recovery)
    free_g: jax.Array  # [2, Rp, C]
    u_fixed_g: jax.Array  # [2, Rp, C]
    f_g: jax.Array  # [2, Rp, C]
    diag_inv: jax.Array  # [2, 2, Rp, C] inverse reduced center blocks
    rows: int  # un-padded row count
    cols: int
    wrap_cols: bool
    # set by the 2D prepare: name of the col mesh axis (None = 1D rows-only)
    col_axis: Optional[str] = None


def _pad_grid_rows(a: np.ndarray, rows_pad: int, row_axis: int) -> np.ndarray:
    pad = [(0, 0)] * a.ndim
    pad[row_axis] = (0, rows_pad - a.shape[row_axis])
    return np.pad(a, pad)


def _build_host_arrays(fem_mesh, bca, metadata, rows_pad, dtype):
    """Assemble + BC-reduce (one device jit), return row-padded HOST arrays
    (raw, reduced, diag_inv, free_g, u_fixed_g, f_g); pad rows carry
    identity stencil rows (free=0 semantics). Shared by the 1D and 2D
    prepares so each does exactly one host->device placement."""
    rows, cols = fem_mesh.grid_shape
    wrap = fem_mesh.wrap_cols
    from ..fem.solve import _grid, _reduce_stencil
    from ..fem.stencil import (
        assemble_stencil_fused,
        assemble_stencil_structured,
    )

    coords = jnp.asarray(fem_mesh.coords, dtype=dtype)
    free_g = _grid(jnp.asarray(~bca.u_known, dtype=dtype), rows, cols)
    u_fixed_g = _grid(jnp.asarray(bca.u_value, dtype=dtype), rows, cols)
    f_g = _grid(jnp.asarray(bca.f_value, dtype=dtype), rows, cols)

    @jax.jit
    def build(coords, tris, free_g):
        if fem_mesh.canonical_grid:
            raw = assemble_stencil_structured(
                coords,
                metadata.youngs_modulus,
                metadata.poisson_ratio,
                metadata.part_thickness,
                rows,
                cols,
                wrap,
            )
        else:
            raw = assemble_stencil_fused(
                coords,
                tris,
                metadata.youngs_modulus,
                metadata.poisson_ratio,
                metadata.part_thickness,
                rows,
                cols,
                wrap,
            )
        reduced = _reduce_stencil(raw, free_g, wrap)
        d = reduced[CENTER]
        a_, b_ = d[0, 0], d[0, 1]
        c_, e_ = d[1, 0], d[1, 1]
        det = a_ * e_ - b_ * c_
        det = jnp.where(det == 0, 1.0, det)
        diag_inv = (
            jnp.stack([jnp.stack([e_, -b_]), jnp.stack([-c_, a_])]) / det
        )
        return raw, reduced, diag_inv

    raw, reduced, diag_inv = build(
        coords, jnp.asarray(fem_mesh.tris, dtype=jnp.int32), free_g
    )

    raw_np = _pad_grid_rows(np.asarray(raw), rows_pad, 3).astype(dtype)
    red_np = _pad_grid_rows(np.asarray(reduced), rows_pad, 3).astype(dtype)
    dinv_np = _pad_grid_rows(np.asarray(diag_inv), rows_pad, 2).astype(dtype)
    if rows_pad != rows:
        red_np[CENTER, 0, 0, rows:, :] = 1.0
        red_np[CENTER, 1, 1, rows:, :] = 1.0
        dinv_np[0, 0, rows:, :] = 1.0
        dinv_np[1, 1, rows:, :] = 1.0
    return (
        raw_np,
        red_np,
        dinv_np,
        _pad_grid_rows(np.asarray(free_g), rows_pad, 1),
        _pad_grid_rows(np.asarray(u_fixed_g), rows_pad, 1),
        _pad_grid_rows(np.asarray(f_g), rows_pad, 1),
    )


def prepare_sharded_stencil_problem(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh: Mesh,
    axis: str = "rows",
    dtype=np.float32,
) -> ShardedStencilProblem:
    """Assemble the BC-reduced stencil and lay it out row-sharded."""
    if fem_mesh.grid_shape is None:
        raise SolverError("sharded stencil solve needs a structured grid mesh")
    rows, cols = fem_mesh.grid_shape
    wrap = fem_mesh.wrap_cols
    n_shards = device_mesh.shape[axis]
    rows_pad = math.ceil(rows / n_shards) * n_shards

    raw_np, red_np, dinv_np, free_np, u_fixed_np, f_np = _build_host_arrays(
        fem_mesh, bca, metadata, rows_pad, dtype
    )

    shard5 = NamedSharding(device_mesh, P(None, None, None, axis, None))
    shard4 = NamedSharding(device_mesh, P(None, None, axis, None))
    shard3 = NamedSharding(device_mesh, P(None, axis, None))

    return ShardedStencilProblem(
        device_mesh=device_mesh,
        axis=axis,
        reduced=jax.device_put(red_np, shard5),
        raw=jax.device_put(raw_np, shard5),
        free_g=jax.device_put(free_np, shard3),
        u_fixed_g=jax.device_put(u_fixed_np, shard3),
        f_g=jax.device_put(f_np, shard3),
        diag_inv=jax.device_put(dinv_np, shard4),
        rows=rows,
        cols=cols,
        wrap_cols=wrap,
    )


def exchange_halo_rows(u_local: jax.Array, axis: str) -> jax.Array:
    """[2, Rl, C] -> [2, Rl+2, C] with one neighbor row above and below.

    Shard i receives the last row of shard i-1 and the first row of shard
    i+1; edge shards get zeros -- exactly the zero row-padding semantics of
    the single-device operator (fem/stencil.py shift2d)."""
    n = jax.lax.axis_size(axis)
    from_above = jax.lax.ppermute(
        u_local[:, -1:, :], axis, [(j, j + 1) for j in range(n - 1)]
    )
    from_below = jax.lax.ppermute(
        u_local[:, :1, :], axis, [(j + 1, j) for j in range(n - 1)]
    )
    return jnp.concatenate([from_above, u_local, from_below], axis=1)


def make_halo_stencil_operator(
    st_local: jax.Array,  # [9, 2, 2, Rl, C]
    axis: str,
    wrap_cols: bool,
):
    """Shard-local op(u) = K u: halo exchange + the single-chip operator.

    The local stencil is padded with one ZERO row above and below (done once
    at closure creation, so the pad never re-runs inside CG loops);
    applying the ordinary single-device operator to the halo-extended field
    then computes exactly the sharded rows -- output rows 0 and Rl+1 are
    zero by construction and sliced off.
    """
    from ..fem.stencil import make_stencil_operator

    rl = st_local.shape[-2]
    st_ext = jnp.pad(st_local, ((0, 0), (0, 0), (0, 0), (1, 1), (0, 0)))
    local_op = make_stencil_operator(st_ext, wrap_cols)

    def op(u_local: jax.Array) -> jax.Array:
        y_ext = local_op(exchange_halo_rows(u_local, axis))
        return jax.lax.slice_in_dim(y_ext, 1, 1 + rl, axis=1)

    return op


def halo_stencil_matvec(
    st_local: jax.Array,  # [9, 2, 2, Rl, C]
    u_local: jax.Array,  # [2, Rl, C]
    axis: str,
    wrap_cols: bool,
) -> jax.Array:
    """One-shot y = K u per shard: 2 single-row ppermutes + local
    slices/rolls/FMAs (no padded copy of the stencil)."""
    rl = u_local.shape[-2]
    u_ext = exchange_halo_rows(u_local, axis)

    y0 = jnp.zeros_like(u_local[0])
    y1 = jnp.zeros_like(u_local[1])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = jax.lax.slice_in_dim(u_ext, 1 + dr, 1 + dr + rl, axis=1)
        if dt:
            us = jnp.roll(us, -dt, axis=-1)
            if not wrap_cols:
                if dt > 0:
                    us = us.at[..., -dt:].set(0.0)
                else:
                    us = us.at[..., : (-dt)].set(0.0)
        blk = st_local[s]
        # explicit 2x2 block FMAs, fused with the shifts
        y0 = y0 + blk[0, 0] * us[0] + blk[0, 1] * us[1]
        y1 = y1 + blk[1, 0] * us[0] + blk[1, 1] * us[1]
    return jnp.stack([y0, y1])




def _sharded_mg_preconditioner(
    reduced_local,
    diag_inv_local,
    coarse_levels: tuple,  # ((stencil, diag_inv), ...) replicated, finest+1 first
    *,
    axis: str,
    wrap: bool,
    rows: int,  # true (un-padded) row count
    sweeps: int = 2,
    omega: float = 0.7,
):
    """V-cycle with SHARDED fine-level smoothing + REPLICATED coarse solve.

    The finest level holds ~75% of the V-cycle's work and all of its memory
    pressure; it smooths shard-locally with halo matvecs. The coarse-grid
    correction (everything below the finest level, 1/4 the work shrinking
    geometrically) is solved redundantly on every chip from one all_gather
    of the fine residual -- the standard redundant-coarse-solve layout:
    one [2,R,C] gather per V-cycle instead of halo plumbing through every
    restriction, at the cost of duplicated (cheap) coarse flops.
    """
    from ..fem.multigrid import (
        MGLevel,
        prolong,
        restrict,
        vcycle_preconditioner,
    )
    from ..fem.stencil import make_stencil_operator

    levels = [
        MGLevel(
            stencil=st,
            diag_inv=di,
            rows=st.shape[-2],
            cols=st.shape[-1],
            op=make_stencil_operator(st, wrap),
        )
        for st, di in coarse_levels
    ]
    coarse_cycle = (
        vcycle_preconditioner(levels, wrap) if levels else None
    )
    fine_op = make_halo_stencil_operator(reduced_local, axis, wrap)

    def smooth(e, r):
        for _ in range(sweeps):
            res = r - fine_op(e)
            e = e + omega * _apply_dinv(diag_inv_local, res)
        return e

    def apply(r):
        rl = r.shape[-2]
        e = smooth(jnp.zeros_like(r), r)
        if coarse_cycle is None:
            return e
        res = r - fine_op(e)
        # one gather of the fine residual; coarse correction is replicated
        res_full = jax.lax.all_gather(res, axis, axis=1, tiled=True)
        ec = coarse_cycle(restrict(res_full[:, :rows, :], wrap))
        e_full = prolong(ec, wrap)  # [2, rows, C]
        rows_pad = res_full.shape[1]
        e_full = jnp.pad(e_full, ((0, 0), (0, rows_pad - rows), (0, 0)))
        i = jax.lax.axis_index(axis)
        zero = jnp.zeros((), dtype=i.dtype)
        e = e + jax.lax.dynamic_slice(
            e_full, (zero, i * rl, zero), (2, rl, e_full.shape[-1])
        )
        return smooth(e, r)

    return apply


def _local_pcg(
    reduced,
    raw,
    free_g,
    u_fixed_g,
    f_g,
    diag_inv,
    coarse_levels,
    *,
    axis,
    wrap,
    rows,
    rtol,
    maxiter,
    preconditioner,
    history=0,
):
    raw_mv = make_halo_stencil_operator(raw, axis, wrap)
    op = make_halo_stencil_operator(reduced, axis, wrap)

    if preconditioner == "multigrid":
        precond = _sharded_mg_preconditioner(
            reduced, diag_inv, coarse_levels, axis=axis, wrap=wrap, rows=rows,
        )
    elif preconditioner == "none":
        precond = None
    else:

        def precond(r):
            return _apply_dinv(diag_inv, r)

    def dot(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis)

    b = free_g * (f_g - raw_mv((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g
    result = pcg(
        op,
        b,
        preconditioner=precond,
        x0=u_fixed_g,
        rtol=rtol,
        maxiter=maxiter,
        dot=dot,
        history=history,
    )
    ku = raw_mv(result.x)
    return (
        result.x,
        ku,
        result.iterations,
        result.residual_norm,
        result.converged,
        result.history,
    )


def _build_coarse_levels(problem: ShardedStencilProblem) -> tuple:
    """Replicated (stencil, diag_inv) pairs for levels below the finest."""
    from ..fem.multigrid import build_hierarchy

    rows, cols = problem.rows, problem.cols
    # slice off row AND col padding (the 2D prepare pads unwrapped cols)
    reduced_full = np.asarray(problem.reduced)[:, :, :, :rows, :cols]
    free_full = np.asarray(problem.free_g)[:, :rows, :cols]
    levels = build_hierarchy(
        jnp.asarray(reduced_full), jnp.asarray(free_full), problem.wrap_cols
    )
    replicated = NamedSharding(problem.device_mesh, P())
    return tuple(
        (
            jax.device_put(np.asarray(lv.stencil), replicated),
            jax.device_put(np.asarray(lv.diag_inv), replicated),
        )
        for lv in levels[1:]
    )


def sharded_stencil_pcg_solve(
    problem: ShardedStencilProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
    preconditioner: str = "auto",
    history: int = 0,
):
    """Row-sharded PCG. preconditioner: "auto" = multigrid when the grid can
    coarsen (sharded fine smoothing + replicated coarse V-cycle), else
    block-Jacobi. history > 0 records the GLOBAL ||r|| of
    the first `history` iterations (CGResult.history, replicated). Returns
    (CGResult, ku) with grid-shaped row-sharded x [2, Rp, C] and ku = K x
    for force recovery."""
    from ..fem.multigrid import can_coarsen

    axis = problem.axis
    if problem.reduced.dtype == jnp.float32:
        from ..fem.solve import _f32_rtol_floor
        from ..utils.logging import log

        floor = _f32_rtol_floor()
        if rtol < floor:
            log(
                f"warning: requested rtol {rtol:.1e} is below the f32 floor;"
                f" clamping to {floor:.1e} (prepare with dtype=np.float64 and"
                " sharded_stencil_refined_solve for f64-grade residuals)"
            )
            rtol = floor
    if preconditioner == "auto":
        preconditioner = (
            "multigrid"
            if can_coarsen(problem.rows, problem.cols, problem.wrap_cols)
            else "block_jacobi"
        )
    coarse_levels = (
        _build_coarse_levels(problem)
        if preconditioner == "multigrid"
        else ()
    )

    spec5 = P(None, None, None, axis, None)
    spec4 = P(None, None, axis, None)
    spec3 = P(None, axis, None)
    coarse_specs = tuple((P(), P()) for _ in coarse_levels)

    solve = jax.jit(
        jax.shard_map(
            partial(
                _local_pcg,
                axis=axis,
                wrap=problem.wrap_cols,
                rows=problem.rows,
                rtol=rtol,
                maxiter=maxiter,
                preconditioner=preconditioner,
                history=int(history),
            ),
            mesh=problem.device_mesh,
            in_specs=(spec5, spec5, spec3, spec3, spec3, spec4, coarse_specs),
            out_specs=(spec3, spec3, P(), P(), P(), P()),
            check_vma=False,
        )
    )
    x, ku, iters, resnorm, converged, hist = solve(
        problem.reduced,
        problem.raw,
        problem.free_g,
        problem.u_fixed_g,
        problem.f_g,
        problem.diag_inv,
        coarse_levels,
    )
    return (
        CGResult(
            x=x,
            iterations=iters,
            residual_norm=resnorm,
            converged=converged,
            history=hist,
        ),
        ku,
    )


def _local_refined(
    reduced64,
    raw64,
    free_g,
    u_fixed_g,
    f_g,
    diag_inv64,
    coarse_levels,
    *,
    axis,
    wrap,
    rows,
    rtol,
    inner_maxiter,
    max_outer,
    preconditioner,
):
    """Shard-local mixed-precision refinement body (runs under shard_map).

    f64 operator + residual checks, f32 inner halo-PCG; every reduction is
    a psum so the refinement loop converges on the GLOBAL residual."""
    from ..fem.refine import mixed_precision_solve

    f32 = jnp.float32
    reduced32 = reduced64.astype(f32)
    diag_inv32 = diag_inv64.astype(f32)
    op64 = make_halo_stencil_operator(reduced64, axis, wrap)
    raw_mv64 = make_halo_stencil_operator(raw64, axis, wrap)
    op32 = make_halo_stencil_operator(reduced32, axis, wrap)

    if preconditioner == "multigrid":
        coarse32 = tuple(
            (st.astype(f32), di.astype(f32)) for st, di in coarse_levels
        )
        precond32 = _sharded_mg_preconditioner(
            reduced32, diag_inv32, coarse32, axis=axis, wrap=wrap, rows=rows,
        )
    elif preconditioner == "none":
        precond32 = None
    else:

        def precond32(r):
            return _apply_dinv(diag_inv32, r)

    def dot(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis)

    b = free_g * (f_g - raw_mv64((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g
    result = mixed_precision_solve(
        op64,
        op32,
        b,
        preconditioner32=precond32,
        x0=u_fixed_g,
        rtol=rtol,
        inner_maxiter=inner_maxiter,
        max_outer=max_outer,
        dot=dot,
    )
    ku = raw_mv64(result.x)
    return (
        result.x,
        ku,
        result.inner_iterations,
        result.residual_norm,
        result.converged,
    )


def sharded_stencil_refined_solve(
    problem: ShardedStencilProblem,
    rtol: float = 1e-8,
    inner_maxiter: int = 200,
    max_outer: int = 8,
    preconditioner: str = "auto",
):
    """Row-sharded f64/f32 mixed-precision refinement: 1e-8-grade residuals
    on a device mesh. The problem must be prepared with dtype=np.float64
    (f64 operator + residuals; inner solves cast to f32 per shard). Returns
    (CGResult, ku) like `sharded_stencil_pcg_solve`, with iterations = total
    f32 inner iterations."""
    from ..fem.multigrid import can_coarsen

    if problem.reduced.dtype != jnp.float64:
        raise SolverError(
            "sharded refined solve needs an f64 problem: prepare with "
            "dtype=np.float64 (and jax_enable_x64)"
        )
    axis = problem.axis
    if preconditioner == "auto":
        preconditioner = (
            "multigrid"
            if can_coarsen(problem.rows, problem.cols, problem.wrap_cols)
            else "block_jacobi"
        )
    coarse_levels = (
        _build_coarse_levels(problem)
        if preconditioner == "multigrid"
        else ()
    )

    spec5 = P(None, None, None, axis, None)
    spec4 = P(None, None, axis, None)
    spec3 = P(None, axis, None)
    coarse_specs = tuple((P(), P()) for _ in coarse_levels)

    solve = jax.jit(
        jax.shard_map(
            partial(
                _local_refined,
                axis=axis,
                wrap=problem.wrap_cols,
                rows=problem.rows,
                rtol=rtol,
                inner_maxiter=inner_maxiter,
                max_outer=max_outer,
                preconditioner=preconditioner,
            ),
            mesh=problem.device_mesh,
            in_specs=(spec5, spec5, spec3, spec3, spec3, spec4, coarse_specs),
            out_specs=(spec3, spec3, P(), P(), P()),
            check_vma=False,
        )
    )
    x, ku, iters, resnorm, converged = solve(
        problem.reduced,
        problem.raw,
        problem.free_g,
        problem.u_fixed_g,
        problem.f_g,
        problem.diag_inv,
        coarse_levels,
    )
    return (
        CGResult(
            x=x, iterations=iters, residual_norm=resnorm, converged=converged
        ),
        ku,
    )


# ------------------------- 2D (rows x cols) sharding ------------------------
#
# Sharding BOTH grid axes keeps each device's boundary (and so its halo
# traffic) shrinking as the device grid grows in either direction. The
# 9-point stencil's corner neighbors ride along for free with the standard
# sequential exchange: rows first, then cols ON THE ROW-EXTENDED block. A wrapped
# (annulus) col axis becomes a ppermute ring pair -- the local operator
# never wraps, because the halos supply the periodic neighbors.


def _ring_pairs(n, forward: bool, wrap: bool):
    pairs = (
        [(j, j + 1) for j in range(n - 1)]
        if forward
        else [(j + 1, j) for j in range(n - 1)]
    )
    if wrap and n > 1:
        pairs.append((n - 1, 0) if forward else (0, n - 1))
    return pairs


def exchange_halo_2d(
    u_local: jax.Array,  # [2, rl, cl]
    row_axis: str,
    col_axis: str,
    wrap_cols: bool,
) -> jax.Array:
    """[2, rl, cl] -> [2, rl+2, cl+2] with all 8 neighbor halos.

    Row edges receive zeros at the grid boundary (zero-padding semantics);
    col edges receive zeros only when the col axis is not periodic.
    """
    nc = jax.lax.axis_size(col_axis)
    u_ext = exchange_halo_rows(u_local, row_axis)
    # cols on the row-extended block: corners arrive with the halo columns.
    # single-col shard with wrap: the periodic neighbor is the shard itself
    if wrap_cols and nc == 1:
        from_left = u_ext[:, :, -1:]
        from_right = u_ext[:, :, :1]
    else:
        from_left = jax.lax.ppermute(
            u_ext[:, :, -1:], col_axis, _ring_pairs(nc, True, wrap_cols)
        )
        from_right = jax.lax.ppermute(
            u_ext[:, :, :1], col_axis, _ring_pairs(nc, False, wrap_cols)
        )
    return jnp.concatenate([from_left, u_ext, from_right], axis=2)


def make_halo_stencil_operator_2d(
    st_local: jax.Array,  # [9, 2, 2, rl, cl]
    row_axis: str,
    col_axis: str,
    wrap_cols: bool,
):
    """2D-sharded op(u) = K u: one 8-neighbor halo exchange + the local
    stencil on the extended block (zero-padded local stencil, never
    wrapping -- periodicity lives entirely in the exchange).

    """
    from ..fem.stencil import make_stencil_operator

    rl, cl = st_local.shape[-2], st_local.shape[-1]
    st_ext = jnp.pad(st_local, ((0, 0),) * 3 + ((1, 1), (1, 1)))
    apply_local = make_stencil_operator(st_ext, wrap_cols=False)

    def op(u_local):
        u_ext = exchange_halo_2d(u_local, row_axis, col_axis, wrap_cols)
        y_ext = apply_local(u_ext)
        return jax.lax.slice(y_ext, (0, 1, 1), (2, 1 + rl, 1 + cl))

    return op


def _sharded_mg_preconditioner_2d(
    reduced_local,
    diag_inv_local,
    coarse_levels: tuple,  # ((stencil, diag_inv), ...) replicated
    *,
    row_axis: str,
    col_axis: str,
    wrap: bool,
    rows: int,  # true (un-padded) grid dims
    cols: int,
    sweeps: int = 2,
    omega: float = 0.7,
):
    """2D-grid V-cycle: SHARDED fine smoothing + REPLICATED coarse solve.

    The 1D row-sharded layout's machinery (``_sharded_mg_preconditioner``)
    carried to both grid axes: fine-level smoothing runs shard-local over
    the 8-neighbor halo operator, and the coarse-grid correction gathers the
    fine residual over BOTH device axes (two tiled all_gathers) and solves
    redundantly on every device. Iteration
    counts match the 1D multigrid path; only the halo/gather pattern
    differs."""
    from ..fem.multigrid import (
        MGLevel,
        prolong,
        restrict,
        vcycle_preconditioner,
    )
    from ..fem.stencil import make_stencil_operator

    levels = [
        MGLevel(
            stencil=st,
            diag_inv=di,
            rows=st.shape[-2],
            cols=st.shape[-1],
            op=make_stencil_operator(st, wrap),
        )
        for st, di in coarse_levels
    ]
    coarse_cycle = vcycle_preconditioner(levels, wrap) if levels else None
    fine_op = make_halo_stencil_operator_2d(
        reduced_local, row_axis, col_axis, wrap
    )

    def smooth(e, r):
        for _ in range(sweeps):
            res = r - fine_op(e)
            e = e + omega * _apply_dinv(diag_inv_local, res)
        return e

    def apply(r):
        rl, cl = r.shape[-2], r.shape[-1]
        e = smooth(jnp.zeros_like(r), r)
        if coarse_cycle is None:
            return e
        res = r - fine_op(e)
        # gather the fine residual over both device axes; the coarse
        # correction is replicated (redundant-coarse-solve layout)
        res_full = jax.lax.all_gather(res, row_axis, axis=1, tiled=True)
        res_full = jax.lax.all_gather(res_full, col_axis, axis=2, tiled=True)
        ec = coarse_cycle(restrict(res_full[:, :rows, :cols], wrap))
        e_full = prolong(ec, wrap)  # [2, rows, cols]
        rows_pad, cols_pad = res_full.shape[1], res_full.shape[2]
        e_full = jnp.pad(
            e_full, ((0, 0), (0, rows_pad - rows), (0, cols_pad - cols))
        )
        i = jax.lax.axis_index(row_axis)
        j = jax.lax.axis_index(col_axis)
        zero = jnp.zeros((), dtype=i.dtype)
        e = e + jax.lax.dynamic_slice(
            e_full, (zero, i * rl, j * cl), (2, rl, cl)
        )
        return smooth(e, r)

    return apply


def prepare_sharded_stencil_problem_2d(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh: Mesh,
    row_axis: str = "rows",
    col_axis: str = "cols",
    dtype=np.float32,
) -> ShardedStencilProblem:
    """Assemble + lay out over a 2D (rows x cols) device mesh.

    Rows pad to a multiple of the row shards (identity pad rows, free=0).
    Cols must divide evenly when wrapped (padding would break periodicity);
    unwrapped cols pad like rows.
    """
    if fem_mesh.grid_shape is None:
        raise SolverError("sharded stencil solve needs a structured grid mesh")
    rows, cols = fem_mesh.grid_shape
    wrap = fem_mesh.wrap_cols
    n_row_shards = device_mesh.shape[row_axis]
    n_col_shards = device_mesh.shape[col_axis]
    rows_pad = math.ceil(rows / n_row_shards) * n_row_shards
    if wrap:
        if cols % n_col_shards:
            raise SolverError(
                f"wrapped cols ({cols}) must divide evenly over "
                f"{n_col_shards} col shards (padding breaks periodicity)"
            )
        cols_pad = cols
    else:
        cols_pad = math.ceil(cols / n_col_shards) * n_col_shards

    raw_np, red_np, dinv_np, free_np, u_fixed_np, f_np = _build_host_arrays(
        fem_mesh, bca, metadata, rows_pad, dtype
    )

    def pad_cols(a: np.ndarray) -> np.ndarray:
        pad = [(0, 0)] * a.ndim
        pad[-1] = (0, cols_pad - cols)
        return np.pad(a, pad)

    raw_np, red_np, dinv_np = pad_cols(raw_np), pad_cols(red_np), pad_cols(dinv_np)
    if cols_pad != cols:
        red_np[CENTER, 0, 0, :, cols:] = 1.0
        red_np[CENTER, 1, 1, :, cols:] = 1.0
        dinv_np[0, 0, :, cols:] = 1.0
        dinv_np[1, 1, :, cols:] = 1.0

    shard5 = NamedSharding(
        device_mesh, P(None, None, None, row_axis, col_axis)
    )
    shard4 = NamedSharding(device_mesh, P(None, None, row_axis, col_axis))
    shard3 = NamedSharding(device_mesh, P(None, row_axis, col_axis))
    return ShardedStencilProblem(
        device_mesh=device_mesh,
        axis=row_axis,
        reduced=jax.device_put(red_np, shard5),
        raw=jax.device_put(raw_np, shard5),
        free_g=jax.device_put(pad_cols(free_np), shard3),
        u_fixed_g=jax.device_put(pad_cols(u_fixed_np), shard3),
        f_g=jax.device_put(pad_cols(f_np), shard3),
        diag_inv=jax.device_put(dinv_np, shard4),
        rows=rows,
        cols=cols,
        wrap_cols=wrap,
        col_axis=col_axis,
    )


def _local_pcg_2d(
    reduced, raw, free_g, u_fixed_g, f_g, diag_inv, coarse_levels,
    *, row_axis, col_axis, wrap, rows, cols, rtol, maxiter, preconditioner,
    history=0,
):
    raw_mv = make_halo_stencil_operator_2d(
        raw, row_axis, col_axis, wrap
    )
    op = make_halo_stencil_operator_2d(
        reduced, row_axis, col_axis, wrap
    )

    if preconditioner == "multigrid":
        precond = _sharded_mg_preconditioner_2d(
            reduced, diag_inv, coarse_levels,
            row_axis=row_axis, col_axis=col_axis, wrap=wrap,
            rows=rows, cols=cols,
        )
    elif preconditioner == "none":
        precond = None
    else:

        def precond(r):
            return _apply_dinv(diag_inv, r)

    def dot(a, b):
        return jax.lax.psum(jnp.sum(a * b), (row_axis, col_axis))

    b = free_g * (f_g - raw_mv((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g
    result = pcg(
        op, b, preconditioner=precond, x0=u_fixed_g,
        rtol=rtol, maxiter=maxiter, dot=dot, history=history,
    )
    ku = raw_mv(result.x)
    return (
        result.x,
        ku,
        result.iterations,
        result.residual_norm,
        result.converged,
        result.history,
    )


def sharded_stencil_pcg_solve_2d(
    problem: ShardedStencilProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
    preconditioner: str = "auto",
    history: int = 0,
):
    """2D (rows x cols) sharded PCG. Returns (CGResult, ku) with x, ku
    [2, Rp, Cp] sharded over both axes.

    Use `prepare_sharded_stencil_problem_2d` for the problem layout.
    preconditioner "auto" = multigrid when the grid can coarsen (sharded
    fine smoothing + both-axis-gathered replicated coarse V-cycle,
    iteration counts matching the 1D path), else block-Jacobi."""
    from ..fem.multigrid import can_coarsen

    row_axis, col_axis = problem.axis, problem.col_axis
    if col_axis is None:
        raise SolverError(
            "problem was prepared 1D; use prepare_sharded_stencil_problem_2d"
        )
    if problem.reduced.dtype == jnp.float32:
        from ..fem.solve import _f32_rtol_floor
        from ..utils.logging import log

        floor = _f32_rtol_floor()
        if rtol < floor:
            log(
                f"warning: requested rtol {rtol:.1e} is below the f32 floor;"
                f" clamping to {floor:.1e}"
            )
            rtol = floor
    if preconditioner == "auto":
        preconditioner = (
            "multigrid"
            if can_coarsen(problem.rows, problem.cols, problem.wrap_cols)
            else "block_jacobi"
        )
    coarse_levels = (
        _build_coarse_levels(problem)
        if preconditioner == "multigrid"
        else ()
    )
    spec5 = P(None, None, None, row_axis, col_axis)
    spec4 = P(None, None, row_axis, col_axis)
    spec3 = P(None, row_axis, col_axis)
    coarse_specs = tuple((P(), P()) for _ in coarse_levels)
    solve = jax.jit(
        jax.shard_map(
            partial(
                _local_pcg_2d,
                row_axis=row_axis,
                col_axis=col_axis,
                wrap=problem.wrap_cols,
                rows=problem.rows,
                cols=problem.cols,
                rtol=rtol,
                maxiter=maxiter,
                preconditioner=preconditioner,
                history=int(history),
            ),
            mesh=problem.device_mesh,
            in_specs=(
                spec5, spec5, spec3, spec3, spec3, spec4, coarse_specs,
            ),
            out_specs=(spec3, spec3, P(), P(), P(), P()),
            check_vma=False,
        )
    )
    x, ku, iters, resnorm, converged, hist = solve(
        problem.reduced, problem.raw, problem.free_g,
        problem.u_fixed_g, problem.f_g, problem.diag_inv, coarse_levels,
    )
    return (
        CGResult(
            x=x,
            iterations=iters,
            residual_norm=resnorm,
            converged=converged,
            history=hist,
        ),
        ku,
    )


def _local_refined_2d(
    reduced64, raw64, free_g, u_fixed_g, f_g, diag_inv64, coarse_levels,
    *, row_axis, col_axis, wrap, rows, cols, rtol, maxiter, preconditioner,
    history=0,
):
    """2D-sharded f64 CG with an f32 preconditioner (multigrid when the
    grid coarsens, block-Jacobi otherwise)."""
    f32 = jnp.float32
    raw_mv = make_halo_stencil_operator_2d(raw64, row_axis, col_axis, wrap)
    op = make_halo_stencil_operator_2d(reduced64, row_axis, col_axis, wrap)
    diag_inv32 = diag_inv64.astype(f32)

    if preconditioner == "multigrid":
        coarse32 = tuple(
            (st.astype(f32), di.astype(f32)) for st, di in coarse_levels
        )
        mg32 = _sharded_mg_preconditioner_2d(
            reduced64.astype(f32), diag_inv32, coarse32,
            row_axis=row_axis, col_axis=col_axis, wrap=wrap,
            rows=rows, cols=cols,
        )

        def precond(r):
            return mg32(r.astype(f32)).astype(r.dtype)

    elif preconditioner == "none":
        precond = None
    else:

        def precond(r):
            return _apply_dinv(diag_inv32, r.astype(f32)).astype(r.dtype)

    def dot(a, b):
        return jax.lax.psum(jnp.sum(a * b), (row_axis, col_axis))

    b = free_g * (f_g - raw_mv((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g
    result = pcg(
        op, b, preconditioner=precond, x0=u_fixed_g,
        rtol=rtol, maxiter=maxiter, dot=dot, history=history,
    )
    ku = raw_mv(result.x)
    return (
        result.x,
        ku,
        result.iterations,
        result.residual_norm,
        result.converged,
        result.history,
    )


def sharded_stencil_refined_solve_2d(
    problem: ShardedStencilProblem,
    rtol: float = 1e-9,
    maxiter: int = 100_000,
    preconditioner: str = "auto",
    history: int = 0,
):
    """2D-sharded f64-accurate solve (prepare with dtype=np.float64).

    f64 CG over the 2D halo operator with an f32 preconditioner (sharded
    multigrid when the grid coarsens -- iteration counts matching the 1D
    refined path -- block-Jacobi otherwise); psum reductions over both
    device axes."""
    from ..fem.multigrid import can_coarsen

    row_axis, col_axis = problem.axis, problem.col_axis
    if col_axis is None:
        raise SolverError(
            "problem was prepared 1D; use prepare_sharded_stencil_problem_2d"
        )
    if problem.reduced.dtype != jnp.float64:
        raise SolverError(
            "2D refined solve needs an f64 problem: prepare with "
            "dtype=np.float64 (and jax_enable_x64)"
        )
    if preconditioner == "auto":
        preconditioner = (
            "multigrid"
            if can_coarsen(problem.rows, problem.cols, problem.wrap_cols)
            else "block_jacobi"
        )
    coarse_levels = (
        _build_coarse_levels(problem)
        if preconditioner == "multigrid"
        else ()
    )
    spec5 = P(None, None, None, row_axis, col_axis)
    spec4 = P(None, None, row_axis, col_axis)
    spec3 = P(None, row_axis, col_axis)
    coarse_specs = tuple((P(), P()) for _ in coarse_levels)
    solve = jax.jit(
        jax.shard_map(
            partial(
                _local_refined_2d,
                row_axis=row_axis,
                col_axis=col_axis,
                wrap=problem.wrap_cols,
                rows=problem.rows,
                cols=problem.cols,
                rtol=rtol,
                maxiter=maxiter,
                preconditioner=preconditioner,
                history=int(history),
            ),
            mesh=problem.device_mesh,
            in_specs=(
                spec5, spec5, spec3, spec3, spec3, spec4, coarse_specs,
            ),
            out_specs=(spec3, spec3, P(), P(), P(), P()),
            check_vma=False,
        )
    )
    x, ku, iters, resnorm, converged, hist = solve(
        problem.reduced, problem.raw, problem.free_g,
        problem.u_fixed_g, problem.f_g, problem.diag_inv, coarse_levels,
    )
    return (
        CGResult(
            x=x,
            iterations=iters,
            residual_norm=resnorm,
            converged=converged,
            history=hist,
        ),
        ku,
    )
