"""Multi-chip sharded solves over a jax.sharding.Mesh.

The reference is strictly single-threaded (SURVEY.md section 2, native note);
scaling there means a bigger dense matrix. Here the solve scales across
devices the XLA way: rows of the block-ELL operator are sharded over a device
mesh axis, the PCG loop runs under `shard_map`, and the only communication
per iteration is

  * one `all_gather` of the displacement vector (u is tiny -- N*2*4
    bytes -- vs the N*K*16-byte matrix read, so this rides well under the
    memory-bound SpMV), and
  * `psum` scalars for the CG dot products.

Rows are padded to a multiple of the shard count with identity rows (free
mask 0, value 0), which the masked operator treats as already-solved DOFs.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bc import BCArrays
from ..config import ModelMetadata
from ..fem.assembly import EllStructure, build_ell_structure
from ..fem.cg import CGResult
from ..fem.solve import assemble_ell_arrays
from ..fem.element import element_stiffness_matrices
from ..fem.operator import reduced_rhs
from ..meshing.core import Mesh as FemMesh


@dataclass
class ShardedProblem:
    """Device-ready row-sharded FEA system."""

    mesh_axis: Mesh
    ell_data: jax.Array  # [Np, K, 2, 2]  sharded over rows
    cols: jax.Array  # [Np, K]       sharded over rows
    free: jax.Array  # [Np, 2]       sharded
    u_fixed: jax.Array  # [Np, 2]    sharded
    f_applied: jax.Array  # [Np, 2]  sharded
    diag_inv: jax.Array  # [Np, 2, 2] sharded (block-Jacobi inverse)
    n_nodes: int  # un-padded node count


def _pad_rows(arr: np.ndarray, n_pad: int) -> np.ndarray:
    pad = [(0, n_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def prepare_sharded_problem(
    fem_mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    device_mesh: Mesh,
    axis: str = "rows",
    dtype=np.float32,
    structure: EllStructure | None = None,
) -> ShardedProblem:
    """Assemble on device and lay the system out row-sharded over `axis`.

    Assembly (element einsum + segment_sum) runs under jit with sharding
    constraints; XLA inserts the scatter collectives.
    """
    n = fem_mesh.num_nodes
    n_shards = device_mesh.shape[axis]
    n_pad = math.ceil(n / n_shards) * n_shards

    if structure is None:
        structure = build_ell_structure(fem_mesh.tris, n)
    k = structure.width

    cols = _pad_rows(structure.cols, n_pad)
    # padded rows self-reference (zero blocks)
    pad_rows = np.arange(n, n_pad, dtype=structure.cols.dtype)
    cols[n:] = pad_rows[:, None]

    free = _pad_rows((~bca.u_known).astype(dtype), n_pad)
    u_fixed = _pad_rows(bca.u_value.astype(dtype), n_pad)
    f_applied = _pad_rows(bca.f_value.astype(dtype), n_pad)

    row_sharding = NamedSharding(device_mesh, P(axis))
    replicated = NamedSharding(device_mesh, P())

    coords = jax.device_put(fem_mesh.coords.astype(dtype), replicated)
    tris = jax.device_put(fem_mesh.tris.astype(np.int32), replicated)
    slot_ids = jax.device_put(structure.slot_ids, replicated)

    @partial(jax.jit, static_argnums=(3, 4, 5), out_shardings=row_sharding)
    def assemble(coords, tris, slot_ids, n_nodes, width, n_pad):
        ke = element_stiffness_matrices(
            coords,
            tris,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
        )
        ell = assemble_ell_arrays(ke, slot_ids, n_nodes, width)
        return jnp.pad(ell, ((0, n_pad - n_nodes), (0, 0), (0, 0), (0, 0)))

    ell_data = assemble(coords, tris, slot_ids, n, k, n_pad)

    cols_d = jax.device_put(cols, row_sharding)
    free_d = jax.device_put(free, row_sharding)
    u_fixed_d = jax.device_put(u_fixed, row_sharding)
    f_applied_d = jax.device_put(f_applied, row_sharding)

    @partial(jax.jit, out_shardings=row_sharding)
    def block_diag_inv(ell, cols, free):
        n_rows = ell.shape[0]
        own = (
            jnp.arange(n_rows, dtype=cols.dtype)[:, None] == cols
        ).astype(ell.dtype)
        d = jnp.einsum("nk,nkij->nij", own, ell, precision="highest")
        outer = free[:, :, None] * free[:, None, :]
        eye = jnp.eye(2, dtype=ell.dtype)
        d = d * outer + eye * (1.0 - free)[:, :, None]
        a, b = d[:, 0, 0], d[:, 0, 1]
        c, e = d[:, 1, 0], d[:, 1, 1]
        det = a * e - b * c
        det = jnp.where(det == 0, 1.0, det)
        return (
            jnp.stack(
                [jnp.stack([e, -b], -1), jnp.stack([-c, a], -1)], axis=-2
            )
            / det[:, None, None]
        )

    diag_inv = block_diag_inv(ell_data, cols_d, free_d)

    return ShardedProblem(
        mesh_axis=device_mesh,
        ell_data=ell_data,
        cols=cols_d,
        free=free_d,
        u_fixed=u_fixed_d,
        f_applied=f_applied_d,
        diag_inv=diag_inv,
        n_nodes=n,
    )


def _local_pcg(
    ell,
    cols,
    free,
    u_fixed,
    f_applied,
    diag_inv,
    axis: str,
    rtol: float,
    maxiter: int,
):
    """PCG body running per-shard under shard_map."""

    def matvec(u_local):
        u_full = jax.lax.all_gather(u_local, axis, tiled=True)  # [Np,2]
        gathered = u_full[cols]  # [Nl,K,2]
        return jnp.einsum("nkij,nkj->ni", ell, gathered, precision="highest")

    def op(v):
        return free * matvec(free * v) + (1.0 - free) * v

    def precond(r):
        return jnp.einsum("nij,nj->ni", diag_inv, r, precision="highest")

    def dot(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis)

    b = reduced_rhs(matvec, free, u_fixed, f_applied)

    from ..fem.cg import pcg

    result = pcg(
        op,
        b,
        preconditioner=precond,
        x0=u_fixed,
        rtol=rtol,
        maxiter=maxiter,
        dot=dot,
    )
    return result.x, result.iterations, result.residual_norm, result.converged


def sharded_batch_pcg_solve(
    problem: ShardedProblem,
    u_fixed_batch: jax.Array,  # [B, Np, 2]
    f_applied_batch: jax.Array,  # [B, Np, 2]
    axis_rows: str = "rows",
    axis_batch: str = "batch",
    iterations: int = 200,
) -> jax.Array:
    """Design sweep across a 2D device mesh: batch lanes sharded over
    `axis_batch` (data-parallel analog), operator rows over `axis_rows`
    (sequence/tensor-parallel analog). Returns u [B, Np, 2].

    Fixed-iteration PCG keeps every lane in lockstep so the two mesh axes
    compose without per-lane control flow.
    """
    mesh = problem.mesh_axis

    def local(ell, cols, free, diag_inv, u_fixed_b, f_applied_b):
        from ..fem.cg import pcg_fixed_iterations

        def matvec(u_local):
            u_full = jax.lax.all_gather(u_local, axis_rows, tiled=True)
            return jnp.einsum("nkij,nkj->ni", ell, u_full[cols], precision="highest")

        def op(v):
            return free * matvec(free * v) + (1.0 - free) * v

        def precond(r):
            return jnp.einsum("nij,nj->ni", diag_inv, r, precision="highest")

        def dot(a, b):
            return jax.lax.psum(jnp.sum(a * b), axis_rows)

        def lane(u_fixed, f_applied):
            b = reduced_rhs(matvec, free, u_fixed, f_applied)
            return pcg_fixed_iterations(
                op,
                b,
                preconditioner=precond,
                x0=u_fixed,
                iterations=iterations,
                dot=dot,
            ).x

        return jax.vmap(lane)(u_fixed_b, f_applied_b)

    solve = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                P(axis_rows),
                P(axis_rows),
                P(axis_rows),
                P(axis_rows),
                P(axis_batch, axis_rows),
                P(axis_batch, axis_rows),
            ),
            out_specs=P(axis_batch, axis_rows),
        )
    )
    return solve(
        problem.ell_data,
        problem.cols,
        problem.free,
        problem.diag_inv,
        u_fixed_batch,
        f_applied_batch,
    )


def sharded_pcg_solve(
    problem: ShardedProblem,
    axis: str = "rows",
    rtol: float = 1e-6,
    maxiter: int = 100_000,
) -> CGResult:
    """Run the row-sharded PCG. Returns CGResult with u [Np,2] (row-sharded)."""
    mesh = problem.mesh_axis
    # every axis other than `axis` is unused here; close over none of them
    spec_rows = P(axis)

    solve = jax.jit(
        jax.shard_map(
            partial(_local_pcg, axis=axis, rtol=rtol, maxiter=maxiter),
            mesh=mesh,
            in_specs=(spec_rows,) * 6,
            out_specs=(spec_rows, P(), P(), P()),
        )
    )
    x, iters, resnorm, converged = solve(
        problem.ell_data,
        problem.cols,
        problem.free,
        problem.u_fixed,
        problem.f_applied,
        problem.diag_inv,
    )
    return CGResult(
        x=x, iterations=iters, residual_norm=resnorm, converged=converged
    )
