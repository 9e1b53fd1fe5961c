"""Row-sharded UNSTRUCTURED solves: DIA bands + AMG over a device mesh.

parallel/stencil_shard.py covers structured grids; this module gives
arbitrary (delaunay/gmsh) meshes the same multi-chip story. After the
band-friendly renumbering (meshing/reorder.py) every stiffness coupling
lives within max|col - row| = H of the diagonal, so sharding NODES in
contiguous blocks makes the operator's communication a fixed-width halo:

    per matvec: 2 x jax.lax.ppermute of a [2, H] slab (+ psum scalars),

H ~ one lattice row (~sqrt(N) nodes) regardless of shard count -- tens of
KB between devices per iteration at 1M nodes, vs the all-gather ELL formulation's
full-vector exchange (parallel/sharding.py, kept as the fallback for
band-hostile meshes).

The smoothed-aggregation AMG preconditioner (fem/amg.py) shards the same
way: level-0 smoothing runs shard-locally on the banded operator; the
prolongator rows are node-sharded (each shard owns its fine rows of P, and
restriction is one segment_sum + psum into the REPLICATED coarse residual);
everything below level 0 -- 9x smaller and shrinking geometrically -- is
solved redundantly on every chip, the standard redundant-coarse-solve
layout.

Accuracy: `refined=True` runs f64 CG with the f32 V-cycle preconditioner
and psum reductions -- the same scheme as the single-chip unstructured
path (fem/solve.py), reaching 1e-8-grade GLOBAL relative residuals.
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
from ..meshing.core import Mesh as FemMesh


@dataclass
class ShardedDiaProblem:
    """Device-ready node-sharded unstructured FEA system.

    Node arrays are padded to a multiple of the shard count; pad nodes
    carry identity diagonal blocks (free=0), so the operator stays SPD.
    `perm` (perm[new] = old) is set when the mesh was renumbered for
    bandedness -- gather results as x[:, :n][:, inverse] to report in the
    caller's order.
    """

    device_mesh: Mesh
    axis: str
    offsets: tuple  # static band offsets (empty for kind="ell")
    halo: int  # max |offset| (kind="ell": max |col - row|)
    # kind="dia": [D, 2, 2, Np] band values. kind="ell": [Np, W, 2, 2]
    # block-ELL values (both node-sharded, solve dtype)
    bands: jax.Array
    free: jax.Array  # [2, Np]
    u_fixed: jax.Array  # [2, Np]
    f: jax.Array  # [2, Np]
    amg: tuple  # device pytree: (p_cols, p_vals) sharded + replicated tail
    n_nodes: int  # un-padded
    perm: Optional[np.ndarray] = None
    # operator kind: "dia" (static band slices; the fast path) or "ell"
    # (shard-local gather through halo-extended indices; the fallback for
    # renumbered meshes whose bandwidth is small but whose DISTINCT
    # (col - row) offset count exceeds max_diags -- coarse/graded meshes)
    kind: str = "dia"
    # kind="ell": [Np, W] indices into the halo-extended local vector
    ell_lidx: Optional[jax.Array] = None
    # the host-side AMG hierarchy this problem was prepared with -- expose it
    # so callers can persist.save_amg it (skips the dominant host setup cost
    # on re-runs, same contract as fem.solve.CompiledProblem.amg_setup)
    amg_setup: object = None


def _fwd_pairs(n):
    return [(j, j + 1) for j in range(n - 1)]


def _bwd_pairs(n):
    return [(j + 1, j) for j in range(n - 1)]


def exchange_halo(u_local: jax.Array, halo: int, axis: str) -> jax.Array:
    """[2, nl] -> [2, nl + 2*halo]: `halo` boundary entries from each
    neighbor; edge shards get zeros (band entries reaching outside the
    global index range are zero by construction)."""
    n = jax.lax.axis_size(axis)
    from_above = jax.lax.ppermute(u_local[:, -halo:], axis, _fwd_pairs(n))
    from_below = jax.lax.ppermute(u_local[:, :halo], axis, _bwd_pairs(n))
    return jnp.concatenate([from_above, u_local, from_below], axis=1)


def make_halo_dia_operator(bands_local, offsets: tuple, halo: int, axis: str):
    """Shard-local y = K u: one halo exchange + static-slice band FMAs.

    Requires halo <= local shard size (guaranteed by `prepare`)."""

    def op(u_local):
        nl = u_local.shape[-1]
        u_ext = exchange_halo(u_local, halo, axis)
        y0 = jnp.zeros_like(u_local[0])
        y1 = jnp.zeros_like(u_local[1])
        for d_idx, off in enumerate(offsets):
            us = jax.lax.slice_in_dim(
                u_ext, halo + off, halo + off + nl, axis=1
            )
            b = bands_local[d_idx]
            # explicit 2x2 block FMAs, fused with the slices
            y0 = y0 + b[0, 0] * us[0] + b[0, 1] * us[1]
            y1 = y1 + b[1, 0] * us[0] + b[1, 1] * us[1]
        return jnp.stack([y0, y1])

    return op


def _inv_reduced_diag(d0, free_local):
    """Closed-form inverse of the BC-reduced diagonal blocks.

    d0 [2,2,nl] raw diagonal blocks -> [2,2,nl] inverse of
    free*d0*free + (1-free)*I. Shared guard semantics: parallel/blocks."""
    from .blocks import guarded_inv2, reduce_diag_blocks

    return guarded_inv2(reduce_diag_blocks(d0, free_local))


def _jacobi_inverse(bands_local, offsets: tuple, free_local):
    return _inv_reduced_diag(bands_local[offsets.index(0)], free_local)


def make_halo_ell_operator(ell_local, lidx_local, halo: int, axis: str):
    """Shard-local y = K u for the block-ELL fallback: one halo exchange +
    a width-W gather through pre-shifted local indices.

    ell_local [nl, W, 2, 2]; lidx_local [nl, W] indexes the halo-extended
    [2, nl + 2*halo] vector (padding slots point at the row itself and hold
    zero blocks, so gathers never leave the extended range)."""

    def op(u_local):
        u_ext = exchange_halo(u_local, halo, axis)  # [2, nl+2h]
        un = u_ext.T[lidx_local]  # [nl, W, 2]
        y = jnp.einsum("nwij,nwj->ni", ell_local, un, precision="highest")
        return y.T

    return op


def _ell_diag_t(ell_local, lidx_local, halo: int):
    """[2,2,nl] raw diagonal blocks of the local ELL rows (the diagonal
    slot is wherever lidx points at the row's own extended index; padding
    slots also do but hold zeros, so summing is exact)."""
    nl = ell_local.shape[0]
    own = (
        lidx_local == (jnp.arange(nl, dtype=lidx_local.dtype)[:, None] + halo)
    ).astype(ell_local.dtype)
    return jnp.einsum("nk,nkij->ijn", own, ell_local, precision="highest")


def make_sharded_amg_preconditioner(
    amg_local: tuple,
    op0,
    jac0,
    axis: str,
    *,
    pre_sweeps: int = 1,
    post_sweeps: int = 1,
    omega0: float = 0.7,
    omega: float = 0.7,
    coarse_sweeps: int = 24,
    coarse_level_sweeps=None,
):
    """Sharded V(1,1)-cycle: local level-0 smoothing, psum restriction into
    a replicated coarse hierarchy (fem/amg.py arrays), local prolongation.

    amg_local: ((p_cols_local, p_vals_local), coarse_transfers, coarse_ops,
    coarsest_inv_tuple) -- the first transfer is node-sharded by fine row,
    the rest replicated.

    Coarse levels below the fine one default to V(1,1) regardless of the
    fine schedule -- the SAME policy as the single-device
    fem/amg.make_amg_preconditioner, so a pinned amg_sweeps smooths
    identically on both paths; `coarse_level_sweeps` pins it explicitly.
    """
    from ..fem.amg import make_coarse_cycle

    (p_cols, p_vals), transfers_tail, coarse, ci = amg_local
    n_coarse_levels = len(coarse)
    cls = 1 if coarse_level_sweeps is None else int(coarse_level_sweeps)
    cycle = make_coarse_cycle(
        transfers_tail,
        coarse,
        ci,
        pre_sweeps=cls,
        post_sweeps=cls,
        omega=omega,
        coarse_sweeps=coarse_sweeps,
    )

    n1 = int(coarse[0][0].shape[0]) if n_coarse_levels else 0

    def restrict0(res_t):  # [2, nl] -> replicated [n1, 3]
        res_nodes = res_t.T  # [nl, 2]
        contrib = jnp.einsum(
            "nwij,ni->nwj", p_vals, res_nodes, precision="highest"
        )  # [nl, wp, 3]
        partial_rc = jax.ops.segment_sum(
            contrib.reshape(-1, contrib.shape[-1]),
            p_cols.reshape(-1),
            num_segments=n1,
        )
        return jax.lax.psum(partial_rc, axis)

    def prolong0(ec):  # replicated [n1, 3] -> [2, nl]
        return jnp.einsum(
            "nwij,nwj->ni", p_vals, ec[p_cols], precision="highest"
        ).T

    def apply(r):
        if n_coarse_levels == 0:
            return omega0 * jac0(r)
        e = omega0 * jac0(r)
        for _ in range(pre_sweeps - 1):
            e = e + omega0 * jac0(r - op0(e))
        rc = restrict0(r - op0(e))
        ec = cycle(0, rc)
        e = e + prolong0(ec)
        for _ in range(post_sweeps):
            e = e + omega0 * jac0(r - op0(e))
        return e

    return apply


def prepare_sharded_dia_problem(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh: Mesh,
    axis: str = "nodes",
    dtype=np.float32,
    amg_setup=None,
    max_diags: int = 64,
    cell_factor: float = 3.0,
    preconditioner: str = "amg",
) -> ShardedDiaProblem:
    """Host prep: band structure (+renumber if needed), device assembly,
    AMG hierarchy, node-sharded layout.

    preconditioner: "amg" (default) builds/uses the SA hierarchy;
    "block_jacobi" skips the hierarchy build entirely -- the V-cycle
    machinery with an empty hierarchy degrades to damped block-Jacobi,
    so the solve path is identical."""
    from ..fem.amg import build_amg_setup
    from ..fem.dia import assemble_dia_fused, build_dia_structure

    mesh = fem_mesh
    perm = None
    dia = build_dia_structure(mesh.tris, mesh.num_nodes, max_diags=max_diags)
    if dia is None:
        from ..meshing.reorder import renumber

        mesh, perm, _ = renumber(mesh)
        bca = BCArrays(
            u_known=bca.u_known[perm],
            u_value=bca.u_value[perm],
            f_value=bca.f_value[perm],
        )
        dia = build_dia_structure(mesh.tris, mesh.num_nodes, max_diags=max_diags)
    n = mesh.num_nodes
    ell_struct = None
    if dia is not None:
        kind = "dia"
        offsets = tuple(int(o) for o in dia.offsets)
        halo = max(-min(offsets), max(offsets))
    else:
        # bandwidth is bounded after renumbering but the DISTINCT offset
        # count exceeds max_diags (coarse/graded meshes): fall back to a
        # shard-local block-ELL gather over the same halo exchange
        from ..fem.assembly import build_ell_structure
        from ..utils.logging import log

        kind = "ell"
        offsets = ()
        ell_struct = build_ell_structure(mesh.tris, n)
        halo = max(
            1,
            int(
                np.abs(
                    ell_struct.cols.astype(np.int64)
                    - np.arange(n, dtype=np.int64)[:, None]
                ).max()
            ),
        )
        log(
            "info: mesh has too many distinct band offsets for the DIA "
            f"operator; sharding with the block-ELL gather (halo {halo})"
        )
    n_shards = device_mesh.shape[axis]
    np_pad = math.ceil(n / n_shards) * n_shards
    if np_pad // n_shards < halo:
        raise SolverError(
            f"shard size {np_pad // n_shards} smaller than the band halo "
            f"{halo}; use fewer shards for this mesh"
        )

    # assemble: host C++ closed-form pass when available (one memcpy, no
    # device round trip), device jit otherwise; pad on host
    from ..fem.solve import DiaParams, _assemble_host

    lidx_np = None
    if kind == "dia":
        host = _assemble_host(
            "dia", DiaParams(offsets), mesh, None, dia.slot_ids, metadata
        )
        if host is None:
            host = (
                np.asarray(
                    jax.jit(
                        lambda c, t: assemble_dia_fused(
                            c,
                            t,
                            metadata.youngs_modulus,
                            metadata.poisson_ratio,
                            metadata.part_thickness,
                            jnp.asarray(dia.slot_ids),
                            n,
                            len(offsets),
                        )
                    )(
                        jnp.asarray(mesh.coords, dtype=np.float64),
                        jnp.asarray(mesh.tris),
                    )
                ),
            )
        bands_np = np.zeros((len(offsets), 2, 2, np_pad))
        bands_np[:, :, :, :n] = host[0]
        zero_idx = offsets.index(0)
        bands_np[zero_idx, 0, 0, n:] = 1.0
        bands_np[zero_idx, 1, 1, n:] = 1.0
    else:
        from ..fem.solve import assemble_ell_arrays_fused

        width = ell_struct.cols.shape[1]
        host = _assemble_host(
            "ell", None, mesh, ell_struct.cols, ell_struct.slot_ids, metadata
        )
        if host is None:
            host = (
                np.asarray(
                    jax.jit(
                        lambda c, t: assemble_ell_arrays_fused(
                            c,
                            t,
                            metadata.youngs_modulus,
                            metadata.poisson_ratio,
                            metadata.part_thickness,
                            jnp.asarray(ell_struct.slot_ids),
                            n,
                            width,
                        )
                    )(
                        jnp.asarray(mesh.coords, dtype=np.float64),
                        jnp.asarray(mesh.tris),
                    )
                ),
            )
        bands_np = np.zeros((np_pad, width, 2, 2))
        bands_np[:n] = host[0]
        bands_np[n:, 0, 0, 0] = 1.0  # pad rows: identity blocks on
        bands_np[n:, 0, 1, 1] = 1.0  # their self-pointing first slot
        cols_pad = np.tile(
            np.arange(np_pad, dtype=np.int64)[:, None], (1, width)
        )
        cols_pad[:n] = ell_struct.cols
        local_n = np_pad // n_shards
        owner = np.arange(np_pad, dtype=np.int64) // local_n
        lidx_np = (cols_pad - owner[:, None] * local_n + halo).astype(
            np.int32
        )

    free = np.zeros((2, np_pad))
    free[:, :n] = (~bca.u_known).astype(np.float64).T
    u_fixed = np.zeros((2, np_pad))
    u_fixed[:, :n] = bca.u_value.T
    f = np.zeros((2, np_pad))
    f[:, :n] = bca.f_value.T

    if preconditioner not in ("amg", "block_jacobi"):
        raise SolverError(
            "sharded unstructured solves support preconditioner='amg' or "
            f"'block_jacobi'; got '{preconditioner}'"
        )
    if preconditioner == "block_jacobi":
        amg_setup = None
    if amg_setup is not None:
        from ..fem.amg import setup_matches

        if not setup_matches(
            amg_setup,
            mesh.coords,
            mesh.tris,
            (~bca.u_known).astype(np.float64),
            metadata,
            float(cell_factor),
            perm,
        ):
            from ..utils.logging import log

            log(
                "warning: provided AMG hierarchy does not match the sharded "
                "problem (mesh ordering, BCs, material, or an older cache "
                "format); rebuilding"
            )
            amg_setup = None
    if amg_setup is None and preconditioner == "amg":
        amg_setup = build_amg_setup(
            mesh.coords,
            mesh.tris,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
            (~bca.u_known).astype(np.float64),
            cell_factor=float(cell_factor),
        )
    # first transfer is node-sharded by fine row (pad rows scatter zeros
    # into coarse id 0); the tail of the hierarchy is replicated. Problems
    # small enough that the hierarchy never coarsened degrade to damped
    # block-Jacobi (empty transfer/coarse tuples).
    if amg_setup is not None and amg_setup.transfers:
        pc, pv, _, _ = amg_setup.transfers[0]
        p_cols = np.zeros((np_pad, pc.shape[1]), dtype=pc.dtype)
        p_cols[:n] = pc
        p_vals = np.zeros((np_pad,) + pv.shape[1:])
        p_vals[:n] = pv
    else:
        p_cols = np.zeros((np_pad, 1), dtype=np.int32)
        p_vals = np.zeros((np_pad, 1, 2, 3))

    shard_b = NamedSharding(
        device_mesh,
        P(None, None, None, axis) if kind == "dia" else P(axis, None, None, None),
    )
    shard_v = NamedSharding(device_mesh, P(None, axis))
    shard_n = NamedSharding(device_mesh, P(axis))
    repl = NamedSharding(device_mesh, P())

    def put_repl(a, int_idx=False):
        arr = jnp.asarray(a, dtype=jnp.int32 if int_idx else dtype)
        return jax.device_put(arr, repl)

    transfers_tail = tuple(
        (
            put_repl(t[0], int_idx=True),
            put_repl(t[1]),
            put_repl(t[2], int_idx=True),
            put_repl(t[3]),
        )
        for t in (amg_setup.transfers[1:] if amg_setup is not None else ())
    )
    coarse = tuple(
        (put_repl(c[0], int_idx=True), put_repl(c[1]), put_repl(c[2]))
        for c in (amg_setup.coarse_ops if amg_setup is not None else ())
    )
    ci = (
        (jax.device_put(jnp.asarray(amg_setup.coarsest_inv, dtype=dtype), repl),)
        if amg_setup is not None and amg_setup.coarsest_inv is not None
        else ()
    )
    amg_local = (
        (
            jax.device_put(jnp.asarray(p_cols, dtype=jnp.int32), shard_n),
            jax.device_put(jnp.asarray(p_vals, dtype=dtype), shard_n),
        ),
        transfers_tail,
        coarse,
        ci,
    )

    return ShardedDiaProblem(
        device_mesh=device_mesh,
        axis=axis,
        offsets=offsets,
        halo=int(halo),
        bands=jax.device_put(bands_np.astype(dtype), shard_b),
        free=jax.device_put(free.astype(dtype), shard_v),
        u_fixed=jax.device_put(u_fixed.astype(dtype), shard_v),
        f=jax.device_put(f.astype(dtype), shard_v),
        amg=amg_local,
        n_nodes=n,
        perm=perm,
        amg_setup=amg_setup,
        kind=kind,
        ell_lidx=(
            jax.device_put(jnp.asarray(lidx_np), NamedSharding(device_mesh, P(axis, None)))
            if lidx_np is not None
            else jax.device_put(
                jnp.zeros((1, 1), dtype=jnp.int32), repl
            )
        ),
    )


def _local_dia_solve(
    bands,
    free,
    u_fixed,
    f,
    amg_local,
    lidx,
    *,
    kind,
    offsets,
    halo,
    axis,
    rtol,
    maxiter,
    amg_sweeps=0,
    history=0,
):
    f32 = jnp.float32

    def make_mv(vals):
        if kind == "ell":
            return make_halo_ell_operator(vals, lidx, halo, axis)
        return make_halo_dia_operator(vals, offsets, halo, axis)

    raw_mv = make_mv(bands)

    def reduced(mv, fr):
        def op(v):
            return fr * mv(fr * v) + (1.0 - fr) * v

        return op

    op = reduced(raw_mv, free)
    bands32 = bands.astype(f32)
    free32 = free.astype(f32)
    mv32 = make_mv(bands32)
    op32 = reduced(mv32, free32)
    if kind == "ell":
        jac32 = _inv_reduced_diag(_ell_diag_t(bands32, lidx, halo), free32)
    else:
        jac32 = _jacobi_inverse(bands32, offsets, free32)
    amg32 = jax.tree.map(
        lambda a: a.astype(f32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        amg_local,
    )
    # f64 bands <=> refined (f64 CG over the always-f32 V-cycle): the
    # shared schedule policy picks V(3,3) there, V(1,1) same-precision
    # (fem.amg.amg_sweep_schedule; amg_sweeps pins an explicit schedule)
    from ..fem.amg import amg_sweep_schedule

    sweeps = amg_sweep_schedule(bands.dtype == jnp.float64, amg_sweeps)
    from .blocks import apply_blocks

    vcycle32 = make_sharded_amg_preconditioner(
        amg32,
        op32,
        lambda r: apply_blocks(jac32, r),
        axis,
        pre_sweeps=sweeps,
        post_sweeps=sweeps,
    )

    def dot(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis)

    b = free * (f - raw_mv((1.0 - free) * u_fixed)) + (1.0 - free) * u_fixed

    # the V-cycle always runs f32 (f64 CG + f32 preconditioner is the same
    # scheme as fem/solve's unstructured refine path); casts are no-ops
    # when the solve dtype is already f32. The GLOBAL residual norm scales
    # the cast (mirrors refine.py): extreme magnitudes would otherwise
    # under/overflow the f32 V-cycle input, and the cycle is linear, so
    # rescaling its output is exact.
    def precond(r):
        nrm = jnp.sqrt(dot(r, r))
        safe = jnp.where(nrm == 0, 1.0, nrm)
        z = vcycle32((r / safe).astype(f32)).astype(b.dtype)
        return z * safe
    result = pcg(
        op,
        b,
        preconditioner=precond,
        x0=u_fixed,
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


def sharded_dia_pcg_solve(
    problem: ShardedDiaProblem,
    rtol: float = 1e-6,
    maxiter: int = 100_000,
    refined: bool = False,
    amg_sweeps: int = 0,
    history: int = 0,
):
    """Node-sharded AMG-PCG. refined=True needs f64 problem arrays (f64 CG
    with the f32 V-cycle, 1e-8-grade global residuals). amg_sweeps pins
    the V-cycle schedule (0 = auto, fem.amg.amg_sweep_schedule). history
    > 0 records the GLOBAL ||r|| of the first `history` CG iterations
    (CGResult.history, replicated). Returns (CGResult, ku) with x, ku [2, Np] node-sharded."""
    if refined and problem.bands.dtype != jnp.float64:
        raise SolverError(
            "refined sharded solve needs dtype=np.float64 problem arrays"
        )
    if not refined and problem.bands.dtype == jnp.float32:
        from ..fem.solve import _f32_rtol_floor
        from ..utils.logging import log

        floor = _f32_rtol_floor()
        if rtol < floor:
            log(
                f"warning: requested rtol {rtol:.1e} is below the f32 floor;"
                f" clamping to {floor:.1e} (prepare with dtype=np.float64 and"
                " refined=True for f64-grade residuals)"
            )
            rtol = floor
    axis = problem.axis
    spec_b = (
        P(None, None, None, axis)
        if problem.kind == "dia"
        else P(axis, None, None, None)
    )
    spec_lidx = P(axis, None) if problem.kind == "ell" else P(None, None)
    spec_v = P(None, axis)
    amg_spec = (
        (P(axis), P(axis)),
        tuple((P(), P(), P(), P()) for _ in problem.amg[1]),
        tuple((P(), P(), P()) for _ in problem.amg[2]),
        tuple(P() for _ in problem.amg[3]),
    )
    solve = jax.jit(
        jax.shard_map(
            partial(
                _local_dia_solve,
                kind=problem.kind,
                offsets=problem.offsets,
                halo=problem.halo,
                axis=axis,
                rtol=rtol,
                maxiter=maxiter,
                amg_sweeps=int(amg_sweeps),
                history=int(history),
            ),
            mesh=problem.device_mesh,
            in_specs=(spec_b, spec_v, spec_v, spec_v, amg_spec, spec_lidx),
            out_specs=(spec_v, spec_v, P(), P(), P(), P()),
            check_vma=False,
        )
    )
    x, ku, iters, resnorm, converged, hist = solve(
        problem.bands, problem.free, problem.u_fixed, problem.f, problem.amg,
        problem.ell_lidx,
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
