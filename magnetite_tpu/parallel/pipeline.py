"""End-to-end multi-chip FEA pipeline: sharded solve + force/stress recovery.

The reference runs its whole pipeline behind one command -- mesh, solve,
force recovery, stress recovery, CSVs, plot (src/main.rs:53-76,
src/solver.rs:412-535). The sharded solvers (parallel/stencil_shard.py,
parallel/dia_shard.py) cover the linear solve on a device mesh; this module
carries the rest of the pipeline across the same mesh so a multi-chip run
produces the SAME `fem.solve.SolveResult` a single-chip `solve_system` does:

  * force recovery is elementwise on the node-sharded arrays
    (f = K u on constrained DOFs, reference src/solver.rs:457-469);
  * stress recovery (sigma = D B u_e per element, src/solver.rs:496-535) is
    SHARD-LOCAL: each shard owns the elements whose minimum node falls in
    its node range, and -- because banded/structured layouts bound every
    intra-element index spread by the operator halo -- one halo exchange of
    the solution vector makes all three nodal displacements of every owned
    element locally addressable. No gather of the global solution, no
    host-side stress loop: per-shard [Emax] element batches through the
    same vectorized B/D kernels as the single-chip path (fem/stress.py).

Entry points: `compile_sharded_problem` -> `CompiledShardedProblem.solve()`,
or `fem.solve.solve_system(..., device_mesh=...)`, or the CLI `--shard`
flag. Operator dispatch mirrors the single-chip auto rules: structured
grid-local meshes take the row-sharded stencil path (halo matvec +
sharded multigrid), everything else the node-sharded DIA+AMG path
(band-renumbering arbitrary meshes first).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bc import BCArrays
from ..config import ModelMetadata, SolverOptions
from ..errors import SolverError
from ..meshing.core import Mesh as FemMesh

AXIS = "shard"


def default_device_mesh(axis: str = AXIS) -> Mesh:
    """1D mesh over every visible device (the CLI --shard layout)."""
    return jax.make_mesh((len(jax.devices()),), (axis,))


def parse_device_mesh(layout: str) -> Mesh:
    """Build a device mesh from a CLI layout string.

    "auto" (or "") -> the 1D mesh over every visible device; "RxC" (e.g.
    "2x2") -> a 2D rows x cols mesh for grid-sharded structured grids.
    R*C must equal the visible device count."""
    from ..errors import InputError

    layout = (layout or "auto").strip().lower()
    if layout in ("auto", "1d"):
        return default_device_mesh()
    parts = layout.split("x")
    if len(parts) != 2:
        raise InputError(
            f"invalid --shard layout {layout!r}: expected 'auto' or 'RxC' "
            "(e.g. '2x4')"
        )
    try:
        n_r, n_c = int(parts[0]), int(parts[1])
    except ValueError:
        raise InputError(
            f"invalid --shard layout {layout!r}: R and C must be integers"
        ) from None
    if n_r < 1 or n_c < 1:
        raise InputError(
            f"invalid --shard layout {layout!r}: R and C must be >= 1"
        )
    n_dev = len(jax.devices())
    if n_r * n_c != n_dev:
        raise InputError(
            f"--shard layout {layout!r} needs {n_r * n_c} devices but "
            f"{n_dev} are visible"
        )
    return jax.make_mesh((n_r, n_c), ("rows", "cols"))


# ------------------------- sharded stress recovery --------------------------


def _build_recovery(tris, coords, n_shards: int, local_n: int):
    """Bucket elements by owning shard; return host arrays for the
    shard-local sigma = D B u_e gather.

    Element e belongs to the shard owning min(tris[e]). Returns
    (eids [S,Emax], valid [S,Emax], lidx [S,Emax,3], ecoords [S,Emax,3,2],
    halo) where lidx indexes the halo-extended local solution
    [2, local_n + 2*halo] and halo is the minimal exchange width that makes
    every owned element's nodes locally addressable.
    """
    e_count = tris.shape[0]
    tris64 = tris.astype(np.int64)
    emin = tris64.min(axis=1)
    etop = tris64.max(axis=1)
    owner = emin // local_n
    # upper overhang only: emin >= owner*local_n by construction
    halo = int(max(1, (etop - (owner + 1) * local_n + 1).max())) if e_count else 1
    if halo > local_n:
        raise SolverError(
            f"stress-recovery halo {halo} exceeds the shard size {local_n}; "
            "use fewer shards for this mesh"
        )
    lflat = tris64 - (owner * local_n)[:, None] + halo
    return _bucket_elements(owner, lflat, tris, coords, n_shards) + (halo,)


def _bucket_elements(owner, lflat, tris, coords, n_shards: int):
    """Shared bucketing tail for the recovery builders: group elements by
    owning shard into padded [S, Emax] arrays.

    `owner` [E] is each element's shard; `lflat` [E,3] its nodes' indices
    into that shard's halo-extended local solution. Returns (eids, valid,
    lidx, ecoords)."""
    counts = np.bincount(owner, minlength=n_shards)
    emax = max(int(counts.max()), 1)
    order = np.argsort(owner, kind="stable")
    eids = np.zeros((n_shards, emax), dtype=np.int64)
    valid = np.zeros((n_shards, emax), dtype=bool)
    lidx = np.zeros((n_shards, emax, 3), dtype=np.int32)
    ecoords = np.zeros((n_shards, emax, 3, 2))
    # pad elements point at local node 0 with a dummy unit right triangle
    # (nonzero area keeps B finite); their outputs are masked on the host
    ecoords[..., 1, 0] = 1.0
    ecoords[..., 2, 1] = 1.0
    pos = 0
    for s in range(n_shards):
        c = int(counts[s])
        ids = order[pos : pos + c]
        pos += c
        eids[s, :c] = ids
        valid[s, :c] = True
        lidx[s, :c] = lflat[ids].astype(np.int32)
        ecoords[s, :c] = coords[tris[ids]]
    return eids, valid, lidx, ecoords


def _local_sigma(u_ext, lidx, ecoords, e, nu, sign_threshold):
    """Per-shard element stress from the halo-extended local solution.

    u_ext [2, nl+2h]; lidx [1,Emax,3] (leading shard dim from the sharded
    input); ecoords [1,Emax,3,2]. Same math as fem/stress.py.
    """
    from ..fem.element import (
        element_areas,
        strain_displacement_matrices,
        stress_strain_matrix,
    )
    from ..fem.stress import scalar_stress, von_mises_stress

    ec = ecoords[0]
    areas = element_areas(ec)
    bmat = strain_displacement_matrices(ec, areas)  # [Emax,3,6]
    d = stress_strain_matrix(e, nu, dtype=u_ext.dtype)
    ue = u_ext.T[lidx[0]].reshape(lidx.shape[1], 6)  # [x0,y0,x1,y1,x2,y2]
    strain = jnp.einsum("erj,ej->er", bmat, ue, precision="highest")
    sigma = jnp.einsum("rs,es->er", d, strain, precision="highest")
    return (
        sigma,
        scalar_stress(sigma, sign_threshold=sign_threshold),
        von_mises_stress(sigma),
    )


def _dia_recover_local(
    x, ku, bands, free, u_fixed, f_app, lidx, ecoords, op_lidx,
    *, kind, offsets, op_halo, rec_halo, axis, e, nu, sign_threshold,
):
    from .dia_shard import (
        exchange_halo,
        make_halo_dia_operator,
        make_halo_ell_operator,
    )

    if kind == "ell":
        raw_mv = make_halo_ell_operator(bands, op_lidx, op_halo, axis)
    else:
        raw_mv = make_halo_dia_operator(bands, offsets, op_halo, axis)
    b = free * (f_app - raw_mv((1.0 - free) * u_fixed)) + (1.0 - free) * u_fixed
    bnorm = jnp.sqrt(jax.lax.psum(jnp.sum(b * b), axis))
    f = free * f_app + (1.0 - free) * ku
    u_ext = exchange_halo(x, rec_halo, axis)
    sigma, stress, vm = _local_sigma(u_ext, lidx, ecoords, e, nu, sign_threshold)
    return f, sigma, stress, vm, bnorm


def _stencil_recover_local(
    x, ku, raw, free_g, u_fixed_g, f_g, lidx, ecoords,
    *, rec_halo, axis, wrap, e, nu, sign_threshold,
):
    from .dia_shard import exchange_halo
    from .stencil_shard import make_halo_stencil_operator

    # one matvec for ||b||
    raw_mv = make_halo_stencil_operator(raw, axis, wrap)
    b = free_g * (f_g - raw_mv((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g
    bnorm = jnp.sqrt(jax.lax.psum(jnp.sum(b * b), axis))
    f = free_g * f_g + (1.0 - free_g) * ku
    u_ext = exchange_halo(x.reshape(2, -1), rec_halo, axis)
    sigma, stress, vm = _local_sigma(u_ext, lidx, ecoords, e, nu, sign_threshold)
    return f, sigma, stress, vm, bnorm


def _build_recovery_2d(tris, coords, rows, cols, wrap, n_r, n_c, rl, cl):
    """Bucket elements by owning (row, col) device tile; return host arrays
    for the shard-local sigma = D B u_e gather over the 2D halo block.

    Structured-grid node ids are row-major (id = r*cols + c) and every
    element spans <= 2 adjacent grid rows/cols (wrapped elements span
    {cols-1, 0}), so ONE halo ring -- exactly what the operator's
    exchange_halo_2d provides -- makes all three nodes of every owned
    element locally addressable. Returns (eids [S,Emax], valid [S,Emax],
    lidx [S,Emax,3], ecoords [S,Emax,3,2]) with S = n_r*n_c (row-major
    shard order) and lidx indexing the FLATTENED [2, (rl+2)*(cl+2)]
    halo-extended tile."""
    t64 = tris.astype(np.int64)
    er = t64 // cols  # [E,3] grid rows
    ec = t64 % cols  # [E,3] grid cols
    anchor_r = er.min(axis=1)
    if wrap:
        spans = ec.max(axis=1) - ec.min(axis=1) > 1  # wrap-crossing elements
        # a wrapped element's cols are in {0, cols-1}: anchor at cols-1,
        # its c=0 nodes sit one step to the RIGHT (the periodic halo)
        anchor_c = np.where(spans, cols - 1, ec.min(axis=1))
        dc = (
            np.where(spans[:, None] & (ec == 0), anchor_c[:, None] + 1, ec)
            - anchor_c[:, None]
        )
    else:
        anchor_c = ec.min(axis=1)
        dc = ec - anchor_c[:, None]
    owner_r = anchor_r // rl
    owner_c = anchor_c // cl
    owner = owner_r * n_c + owner_c
    lr = er - (owner_r * rl)[:, None] + 1  # in [1, rl+1]
    lc = (anchor_c - owner_c * cl)[:, None] + dc + 1  # in [1, cl+1]
    lflat = lr * (cl + 2) + lc
    return _bucket_elements(owner, lflat, tris, coords, n_r * n_c)


def _stencil_recover_local_2d(
    x, ku, raw, free_g, u_fixed_g, f_g, lidx, ecoords,
    *, row_axis, col_axis, wrap, e, nu, sign_threshold,
):
    from .stencil_shard import (
        exchange_halo_2d,
        make_halo_stencil_operator_2d,
    )

    raw_mv = make_halo_stencil_operator_2d(raw, row_axis, col_axis, wrap)
    b = free_g * (f_g - raw_mv((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g
    bnorm = jnp.sqrt(jax.lax.psum(jnp.sum(b * b), (row_axis, col_axis)))
    f = free_g * f_g + (1.0 - free_g) * ku
    u_ext = exchange_halo_2d(x, row_axis, col_axis, wrap)  # [2, rl+2, cl+2]
    sigma, stress, vm = _local_sigma(
        u_ext.reshape(2, -1), lidx, ecoords, e, nu, sign_threshold
    )
    return f, sigma[None], stress[None], vm[None], bnorm


# ------------------------------ compiled problem ----------------------------


@dataclass
class CompiledShardedProblem:
    """A mesh+BC system laid out over a device mesh, solve-ready.

    `solve()` runs the sharded linear solve + sharded force/stress recovery
    and returns the same `fem.solve.SolveResult` as the single-chip path
    (results in the caller's original node order).
    """

    kind: str  # "stencil" | "stencil2d" | "dia"
    problem: object
    run_solver: object  # () -> (CGResult, ku)
    recover: object  # jitted shard_map
    recover_args: tuple
    eids: np.ndarray  # [S, Emax]
    valid: np.ndarray  # [S, Emax]
    n_nodes: int
    n_elements: int
    grid_rows: int  # stencil only (0 for dia)
    grid_cols: int
    perm: Optional[np.ndarray]
    timings: dict
    debug_nans: bool = False
    amg_setup: object = None

    def solve(self):
        from ..fem.solve import SolveResult

        timings = dict(self.timings)
        t0 = time.perf_counter()
        result, ku = self.run_solver()
        f_d, sigma_d, stress_d, vm_d, bnorm = self.recover(
            result.x, ku, *self.recover_args
        )
        jax.block_until_ready((result.x, f_d, sigma_d, stress_d, vm_d))
        timings["solve_s"] = time.perf_counter() - t0

        n = self.n_nodes
        if self.kind == "stencil":
            rows, cols = self.grid_rows, self.grid_cols
            u = np.asarray(result.x)[:, :rows, :].reshape(2, -1).T
            f = np.asarray(f_d)[:, :rows, :].reshape(2, -1).T
        elif self.kind == "stencil2d":
            rows, cols = self.grid_rows, self.grid_cols
            # both grid axes may be padded on a 2D device mesh
            u = np.asarray(result.x)[:, :rows, :cols].reshape(2, -1).T
            f = np.asarray(f_d)[:, :rows, :cols].reshape(2, -1).T
        else:
            u = np.asarray(result.x)[:, :n].T
            f = np.asarray(f_d)[:, :n].T
        s_flat = np.asarray(sigma_d).reshape(self.eids.shape + (3,))
        st_flat = np.asarray(stress_d).reshape(self.eids.shape)
        vm_flat = np.asarray(vm_d).reshape(self.eids.shape)
        sigma = np.zeros((self.n_elements, 3), dtype=s_flat.dtype)
        stress = np.zeros(self.n_elements, dtype=st_flat.dtype)
        vm = np.zeros(self.n_elements, dtype=vm_flat.dtype)
        ids = self.eids[self.valid]
        sigma[ids] = s_flat[self.valid]
        stress[ids] = st_flat[self.valid]
        vm[ids] = vm_flat[self.valid]

        if self.perm is not None:
            u_o, f_o = np.empty_like(u), np.empty_like(f)
            u_o[self.perm], f_o[self.perm] = u, f
            u, f = u_o, f_o
        if self.debug_nans:
            for name, arr in (
                ("displacements", u), ("forces", f), ("stresses", sigma)
            ):
                if not np.isfinite(arr).all():
                    raise SolverError(
                        f"non-finite values in solved {name} (debug_nans): "
                        "check material properties, mesh quality, and "
                        "boundary conditions"
                    )
        if not bool(result.converged):
            raise SolverError(
                f"conjugate gradient failed to converge in "
                f"{int(result.iterations)} iterations "
                f"(residual norm {float(result.residual_norm):.3e})"
            )
        # stencil refined runs report an empty history (the inner solves
        # restart each pass -- same contract as the single-chip refine mode)
        hist = getattr(result, "history", None)
        return SolveResult(
            u=u,
            f=f,
            sigma=sigma,
            stress=stress,
            von_mises=vm,
            iterations=int(result.iterations),
            residual_norm=float(result.residual_norm),
            residual_rel=float(result.residual_norm)
            / max(float(bnorm), 1e-300),
            converged=True,
            timings=timings,
            residual_history=(
                np.asarray(hist) if hist is not None else np.zeros(0)
            ),
        )


def _require_constraints(bca: BCArrays) -> None:
    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is "
            "singular"
        )


def _precision_plan(options: SolverOptions, *, use_stencil: bool):
    """Shared precision/refinement derivation for every sharded path.

    Mirrors the single-chip rules (fem/solve.py): refine="auto" engages
    only for the stencil operator (scatter-free f64 assembly is cheap
    there; irregular-format f64 prep is a compile/memory jump unstructured
    users opt into explicitly with refine="on"). The non-refined f32
    solvers clamp sub-floor rtols themselves, logging the same warning as
    the single-chip path. Returns (rtol, refined, prep_dtype)."""
    from ..fem.solve import _f32_rtol_floor, default_dtype

    dtype = default_dtype(options)
    x64 = bool(jax.config.jax_enable_x64)
    rtol = float(options.cg_rtol)
    if options.refine == "on" and not x64:
        raise SolverError(
            "refine='on' requires jax_enable_x64 (f64 residuals)"
        )
    refined = options.refine == "on" or (
        options.refine == "auto"
        and use_stencil
        and x64
        and dtype == np.float32
        and rtol < _f32_rtol_floor()
    )
    prep_dtype = (
        np.float64 if (refined or dtype == np.float64) else np.float32
    )
    return rtol, refined, prep_dtype


def _stencil_precond(options: SolverOptions) -> str:
    """Validate/normalize the preconditioner flag for sharded stencil
    solves (both 1D and 2D layouts): reject 'amg', downgrade 'jacobi'
    to block_jacobi with the warning the single-chip path logs."""
    precond = options.preconditioner
    if precond == "amg":
        raise SolverError(
            "amg preconditioner applies to unstructured operators; "
            "structured sharded solves use 'multigrid'"
        )
    if precond == "jacobi":
        from ..utils.logging import log

        log(
            "warning: sharded stencil solves do not implement "
            "preconditioner='jacobi'; using block_jacobi"
        )
        precond = "block_jacobi"
    return precond


def _is_grid_local(mesh: FemMesh) -> bool:
    if mesh.grid_shape is None:
        return False
    if mesh.grid_local:
        return True
    from ..fem.stencil import build_stencil_structure

    rows, cols = mesh.grid_shape
    return (
        build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols)
        is not None
    )


def compile_sharded_problem(
    mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    device_mesh: Optional[Mesh] = None,
    amg_setup=None,
) -> CompiledShardedProblem:
    """Lay one FEA problem out over a device mesh, end to end.

    Operator dispatch follows the single-chip auto rules (fem/solve.py):
    grid-local structured meshes shard by grid rows (stencil operator,
    sharded multigrid); everything else shards by nodes (DIA bands + AMG,
    renumbering band-hostile meshes first). `options.refine`/f64 dtype give
    the same deep-accuracy schemes as single-chip (mixed-precision
    refinement on stencil, f64-CG + f32 V-cycle on DIA).

    A TWO-axis device mesh lays a structured grid out over a 2D device grid
    (rows x cols tiles, `stencil_shard`'s 2D halo operator + sharded
    multigrid) with the same end-to-end recovery; unstructured meshes are
    node-sharded and need a 1D device mesh.

    Meshes too small for the requested shard count (the band/stress halo
    must fit inside one shard) retry on a halved device mesh with a
    warning, down to a single device -- small problems stay runnable under
    the same flag that scales big ones. (2D meshes don't retry: their
    stress halo is always one ring, and a wrapped-cols divisibility
    failure needs a different layout, not fewer devices.)
    """
    if device_mesh is None:
        device_mesh = default_device_mesh()
    if len(device_mesh.axis_names) == 2:
        return _compile_sharded_2d(
            mesh, bca, metadata, options, device_mesh
        )
    if len(device_mesh.axis_names) != 1:
        raise SolverError(
            "the sharded pipeline uses a 1D device mesh (or 2D for "
            "structured grids); got "
            f"{len(device_mesh.axis_names)} axes"
        )
    axis = device_mesh.axis_names[0]
    while True:
        try:
            return _compile_sharded(
                mesh, bca, metadata, options, device_mesh, amg_setup
            )
        except SolverError as err:
            n = int(device_mesh.shape[axis])
            shard_bound = (
                "smaller than the band halo" in str(err)
                or "exceeds the shard size" in str(err)
            )
            if n <= 1 or not shard_bound:
                raise
            from ..utils.logging import log

            half = max(n // 2, 1)
            log(
                f"warning: mesh too small for {n} shards ({err}); "
                f"retrying on {half}"
            )
            devices = np.asarray(device_mesh.devices).reshape(-1)[:half]
            device_mesh = Mesh(devices, (axis,))


def _compile_sharded(
    mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions,
    device_mesh: Mesh,
    amg_setup,
) -> CompiledShardedProblem:
    axis = device_mesh.axis_names[0]
    n_shards = int(device_mesh.shape[axis])
    timings: dict = {}

    _require_constraints(bca)
    if options.operator in ("ell", "hybrid"):
        raise SolverError(
            f"operator='{options.operator}' has no sharded pipeline; use "
            "'auto', 'stencil', or 'dia' (band-hostile meshes are "
            "renumbered automatically)"
        )

    use_stencil = options.operator in ("auto", "stencil") and _is_grid_local(
        mesh
    )
    if options.operator == "stencil" and not use_stencil:
        raise SolverError(
            "mesh connectivity is not grid-local; stencil operator "
            "unavailable"
        )

    rtol, refined, prep_dtype = _precision_plan(
        options, use_stencil=use_stencil
    )

    e = metadata.youngs_modulus
    nu = metadata.poisson_ratio
    thr = float(options.stress_sign_threshold)

    if use_stencil:
        from .stencil_shard import (
            prepare_sharded_stencil_problem,
            sharded_stencil_pcg_solve,
            sharded_stencil_refined_solve,
        )

        t0 = time.perf_counter()
        problem = prepare_sharded_stencil_problem(
            mesh, bca, metadata, device_mesh, axis=axis, dtype=prep_dtype
        )
        timings["prepare_s"] = time.perf_counter() - t0
        timings["operator"] = "stencil-sharded"
        rows, cols = mesh.grid_shape
        rows_pad = problem.free_g.shape[1]
        local_n = (rows_pad // n_shards) * cols
        eids, valid, lidx, ecoords, rec_halo = _build_recovery(
            mesh.tris, mesh.coords, n_shards, local_n
        )

        precond = _stencil_precond(options)
        if refined:
            run_solver = partial(
                sharded_stencil_refined_solve,
                problem,
                rtol=rtol,
                inner_maxiter=int(options.refine_inner_iters),
                max_outer=int(options.refine_max_outer),
                preconditioner=precond,
            )
        else:
            run_solver = partial(
                sharded_stencil_pcg_solve,
                problem,
                rtol=rtol,
                maxiter=int(options.max_cg_iters),
                preconditioner=precond,
                history=int(options.residual_history),
            )
        spec5 = P(None, None, None, axis, None)
        spec3 = P(None, axis, None)
        spec_e = P(axis)
        recover = jax.jit(
            jax.shard_map(
                partial(
                    _stencil_recover_local,
                    rec_halo=rec_halo,
                    axis=axis,
                    wrap=problem.wrap_cols,
                    e=prep_dtype(e),
                    nu=prep_dtype(nu),
                    sign_threshold=thr,
                ),
                mesh=device_mesh,
                in_specs=(
                    spec3, spec3, spec5, spec3, spec3, spec3,
                    P(axis, None, None), P(axis, None, None, None),
                ),
                out_specs=(spec3, P(axis, None), spec_e, spec_e, P()),
                check_vma=False,
            )
        )
        shard_e = NamedSharding(device_mesh, P(axis))
        recover_args = (
            problem.raw,
            problem.free_g,
            problem.u_fixed_g,
            problem.f_g,
            jax.device_put(jnp.asarray(lidx), shard_e),
            jax.device_put(jnp.asarray(ecoords, dtype=prep_dtype), shard_e),
        )
        return CompiledShardedProblem(
            kind="stencil",
            problem=problem,
            run_solver=run_solver,
            recover=recover,
            recover_args=recover_args,
            eids=eids,
            valid=valid,
            n_nodes=mesh.num_nodes,
            n_elements=mesh.num_elements,
            grid_rows=rows,
            grid_cols=cols,
            perm=None,
            timings=timings,
            debug_nans=bool(options.debug_nans),
        )

    # ----- unstructured: node-sharded DIA + AMG -----
    from ..meshing.reorder import apply_permutation
    from .dia_shard import (
        prepare_sharded_dia_problem,
        sharded_dia_pcg_solve,
    )

    # the single-chip path honors this flag; silently solving with AMG
    # would make identical flags mean different solvers
    dia_precond = {
        "auto": "amg",
        "amg": "amg",
        "block_jacobi": "block_jacobi",
        "jacobi": "block_jacobi",
    }.get(options.preconditioner)
    if dia_precond is None:
        raise SolverError(
            "sharded unstructured solves support preconditioner="
            "'amg'/'block_jacobi' (or 'auto'); got "
            f"'{options.preconditioner}' -- drop --shard or the "
            "preconditioner override"
        )
    if options.preconditioner == "jacobi":
        from ..utils.logging import log

        log(
            "warning: sharded unstructured solves do not implement "
            "preconditioner='jacobi'; using block_jacobi"
        )

    # the sharded layout prefers a wider band budget than the single-chip
    # default (its ELL fallback pays a width-W gather per matvec), so the
    # DEFAULT budget is raised to 64 -- but an explicit user max_diags is
    # honored, same as the single-chip path
    max_diags = int(options.max_diags)
    if max_diags == SolverOptions.max_diags:
        max_diags = max(max_diags, 64)

    t0 = time.perf_counter()
    problem = prepare_sharded_dia_problem(
        mesh,
        bca,
        metadata,
        device_mesh,
        axis=axis,
        dtype=prep_dtype,
        amg_setup=amg_setup,
        max_diags=max_diags,
        cell_factor=float(options.amg_cell_factor),
        preconditioner=dia_precond,
    )
    timings["prepare_s"] = time.perf_counter() - t0
    timings["operator"] = "dia-sharded"
    timings["preconditioner"] = dia_precond

    mesh_r = (
        apply_permutation(mesh, problem.perm)
        if problem.perm is not None
        else mesh
    )
    np_pad = problem.free.shape[1]
    local_n = np_pad // n_shards
    eids, valid, lidx, ecoords, rec_halo = _build_recovery(
        mesh_r.tris, mesh_r.coords, n_shards, local_n
    )

    dia_refined = refined or prep_dtype == np.float64
    run_solver = partial(
        sharded_dia_pcg_solve,
        problem,
        rtol=rtol,
        maxiter=int(options.max_cg_iters),
        refined=dia_refined,
        amg_sweeps=int(options.amg_sweeps),
        history=int(options.residual_history),
    )
    spec_b = (
        P(None, None, None, axis)
        if problem.kind == "dia"
        else P(axis, None, None, None)
    )
    spec_oplidx = P(axis, None) if problem.kind == "ell" else P(None, None)
    spec_v = P(None, axis)
    spec_e = P(axis)
    recover = jax.jit(
        jax.shard_map(
            partial(
                _dia_recover_local,
                kind=problem.kind,
                offsets=problem.offsets,
                op_halo=problem.halo,
                rec_halo=rec_halo,
                axis=axis,
                e=prep_dtype(e),
                nu=prep_dtype(nu),
                sign_threshold=thr,
            ),
            mesh=device_mesh,
            in_specs=(
                spec_v, spec_v, spec_b, spec_v, spec_v, spec_v,
                P(axis, None, None), P(axis, None, None, None), spec_oplidx,
            ),
            out_specs=(spec_v, P(axis, None), spec_e, spec_e, P()),
            check_vma=False,
        )
    )
    shard_e = NamedSharding(device_mesh, P(axis))
    recover_args = (
        problem.bands,
        problem.free,
        problem.u_fixed,
        problem.f,
        jax.device_put(jnp.asarray(lidx), shard_e),
        jax.device_put(jnp.asarray(ecoords, dtype=prep_dtype), shard_e),
        problem.ell_lidx,
    )
    return CompiledShardedProblem(
        kind="dia",
        problem=problem,
        run_solver=run_solver,
        recover=recover,
        recover_args=recover_args,
        eids=eids,
        valid=valid,
        n_nodes=mesh.num_nodes,
        n_elements=mesh.num_elements,
        grid_rows=0,
        grid_cols=0,
        perm=problem.perm,
        timings=timings,
        debug_nans=bool(options.debug_nans),
        amg_setup=problem.amg_setup,
    )


def _compile_sharded_2d(
    mesh: FemMesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions,
    device_mesh: Mesh,
) -> CompiledShardedProblem:
    """2D (rows x cols) device-mesh pipeline for structured grids.

    Same end-to-end contract as the 1D path (sharded solve + force/stress
    recovery -> SolveResult); the operator/multigrid run over
    stencil_shard's 2D halo machinery, so halo traffic runs along both
    device-mesh axes. The device mesh's FIRST axis shards grid rows, the second
    grid cols."""
    from .stencil_shard import (
        prepare_sharded_stencil_problem_2d,
        sharded_stencil_pcg_solve_2d,
        sharded_stencil_refined_solve_2d,
    )

    row_axis, col_axis = device_mesh.axis_names
    n_r = int(device_mesh.shape[row_axis])
    n_c = int(device_mesh.shape[col_axis])
    timings: dict = {}

    _require_constraints(bca)
    if options.operator not in ("auto", "stencil") or not _is_grid_local(
        mesh
    ):
        raise SolverError(
            "a 2D device mesh shards the structured stencil operator; this "
            "mesh/operator combination needs a 1D device mesh (node-sharded "
            "DIA/AMG)"
        )

    rtol, refined, prep_dtype = _precision_plan(options, use_stencil=True)
    precond = _stencil_precond(options)

    t0 = time.perf_counter()
    problem = prepare_sharded_stencil_problem_2d(
        mesh, bca, metadata, device_mesh,
        row_axis=row_axis, col_axis=col_axis, dtype=prep_dtype,
    )
    timings["prepare_s"] = time.perf_counter() - t0
    timings["operator"] = "stencil-sharded-2d"
    rows, cols = mesh.grid_shape
    rl = problem.free_g.shape[1] // n_r
    cl = problem.free_g.shape[2] // n_c
    eids, valid, lidx, ecoords = _build_recovery_2d(
        mesh.tris, mesh.coords, rows, cols, mesh.wrap_cols, n_r, n_c, rl, cl
    )

    if refined:
        run_solver = partial(
            sharded_stencil_refined_solve_2d,
            problem,
            rtol=rtol,
            maxiter=int(options.max_cg_iters),
            preconditioner=precond,
            history=int(options.residual_history),
        )
    else:
        run_solver = partial(
            sharded_stencil_pcg_solve_2d,
            problem,
            rtol=rtol,
            maxiter=int(options.max_cg_iters),
            preconditioner=precond,
            history=int(options.residual_history),
        )

    spec5 = P(None, None, None, row_axis, col_axis)
    spec3 = P(None, row_axis, col_axis)
    spec_e3 = P((row_axis, col_axis), None, None)
    recover = jax.jit(
        jax.shard_map(
            partial(
                _stencil_recover_local_2d,
                row_axis=row_axis,
                col_axis=col_axis,
                wrap=problem.wrap_cols,
                e=prep_dtype(metadata.youngs_modulus),
                nu=prep_dtype(metadata.poisson_ratio),
                sign_threshold=float(options.stress_sign_threshold),
            ),
            mesh=device_mesh,
            in_specs=(
                spec3, spec3, spec5, spec3, spec3, spec3,
                spec_e3, P((row_axis, col_axis), None, None, None),
            ),
            out_specs=(
                spec3,
                spec_e3,
                P((row_axis, col_axis), None),
                P((row_axis, col_axis), None),
                P(),
            ),
            check_vma=False,
        )
    )
    shard_e = NamedSharding(device_mesh, P((row_axis, col_axis)))
    recover_args = (
        problem.raw,
        problem.free_g,
        problem.u_fixed_g,
        problem.f_g,
        jax.device_put(jnp.asarray(lidx), shard_e),
        jax.device_put(jnp.asarray(ecoords, dtype=prep_dtype), shard_e),
    )
    return CompiledShardedProblem(
        kind="stencil2d",
        problem=problem,
        run_solver=run_solver,
        recover=recover,
        recover_args=recover_args,
        eids=eids,
        valid=valid,
        n_nodes=mesh.num_nodes,
        n_elements=mesh.num_elements,
        grid_rows=rows,
        grid_cols=cols,
        perm=None,
        timings=timings,
        debug_nans=bool(options.debug_nans),
    )
