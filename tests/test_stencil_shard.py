"""Row-sharded stencil PCG (ppermute halo exchange) on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from magnetite_tpu.bc import BCArrays
from magnetite_tpu.config import SolverOptions
from magnetite_tpu.fem.solve import solve_system
from magnetite_tpu.meshing.generators import (
    plate_with_hole_mesh,
    rect_mesh,
    tensile_bcs_for_rect,
)
from magnetite_tpu.parallel.stencil_shard import (
    halo_stencil_matvec,
    prepare_sharded_stencil_problem,
    sharded_stencil_pcg_solve,
)


@pytest.fixture(scope="module")
def device_mesh():
    devices = jax.devices()
    assert len(devices) >= 8, "conftest must provide 8 virtual CPU devices"
    return jax.make_mesh((8,), ("rows",))


def _plate_case(nr, nt):
    mesh = plate_with_hole_mesh(nr, nt)
    n = mesh.num_nodes
    c = mesh.coords
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    left = np.isclose(c[:, 0], c[:, 0].min())
    right = np.isclose(c[:, 0], c[:, 0].max())
    u_known[left] = True
    u_known[right, 0] = True
    u_value[right, 0] = 0.01
    return mesh, BCArrays(
        u_known=u_known, u_value=u_value, f_value=np.zeros((n, 2))
    )


def test_halo_matvec_matches_single_device(metadata, device_mesh):
    """Sharded halo matvec == single-device stencil matvec, incl. padding."""
    from magnetite_tpu.fem.solve import _grid, _reduce_stencil
    from magnetite_tpu.fem.stencil import (
        assemble_stencil_structured,
        stencil_matvec,
    )
    from jax.sharding import PartitionSpec as P
    from functools import partial

    mesh, bca = _plate_case(21, 16)  # 22 rows -> padded to 24
    rows, cols = mesh.grid_shape
    problem = prepare_sharded_stencil_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    rows_pad = problem.free_g.shape[1]

    rng = np.random.default_rng(0)
    v = np.zeros((2, rows_pad, cols))
    v[:, :rows, :] = rng.standard_normal((2, rows, cols))
    from jax.sharding import NamedSharding

    v_d = jax.device_put(
        v, NamedSharding(device_mesh, P(None, "rows", None))
    )

    mv = jax.jit(
        jax.shard_map(
            partial(
                halo_stencil_matvec, axis="rows", wrap_cols=mesh.wrap_cols
            ),
            mesh=device_mesh,
            in_specs=(P(None, None, None, "rows", None), P(None, "rows", None)),
            out_specs=P(None, "rows", None),
        )
    )
    got = np.asarray(mv(problem.raw, v_d))

    coords = jax.numpy.asarray(mesh.coords)
    raw_ref = assemble_stencil_structured(
        coords,
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
        rows,
        cols,
        mesh.wrap_cols,
    )
    want = np.asarray(
        stencil_matvec(raw_ref, jax.numpy.asarray(v[:, :rows]), mesh.wrap_cols)
    )
    scale = np.abs(want).max()
    np.testing.assert_allclose(got[:, :rows], want, atol=1e-12 * scale)


def test_sharded_multigrid_matches_and_holds_iterations(metadata, device_mesh):
    """Sharded MG (sharded fine smoothing + replicated coarse V-cycle):
    solution parity AND an iteration count in the multigrid regime."""
    mesh, bca = _plate_case(32, 32)  # 33 rows: coarsenable
    problem = prepare_sharded_stencil_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    result, _ = sharded_stencil_pcg_solve(
        problem, rtol=1e-10, preconditioner="multigrid"
    )
    assert bool(result.converged)
    assert int(result.iterations) < 60  # block-Jacobi needs hundreds here

    rows, cols = mesh.grid_shape
    u_sharded = np.asarray(result.x)[:, :rows, :].reshape(2, -1).T
    reference = solve_system(
        mesh, bca, metadata, SolverOptions(cg_rtol=1e-12)
    )
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-8 * scale
    )


@pytest.mark.parametrize(
    "case",
    [
        lambda: _plate_case(23, 16),  # annulus, wrapped cols, 24 rows
        lambda: (
            rect_mesh(13, 12, width=2.0),
            None,  # filled below
        ),
    ],
)
def test_sharded_stencil_pcg_matches_single_device(metadata, device_mesh, case):
    mesh, bca = case()
    if bca is None:
        bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    problem = prepare_sharded_stencil_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    result, ku = sharded_stencil_pcg_solve(problem, rtol=1e-11)
    assert bool(result.converged)

    rows, cols = mesh.grid_shape
    u_sharded = (
        np.asarray(result.x)[:, :rows, :].reshape(2, -1).T
    )  # [N, 2]

    reference = solve_system(
        mesh, bca, metadata, SolverOptions(cg_rtol=1e-12)
    )
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-8 * scale
    )

    # force recovery parity on constrained nodes
    f_sharded = np.asarray(ku)[:, :rows, :].reshape(2, -1).T
    np.testing.assert_allclose(
        f_sharded[bca.u_known],
        reference.f[bca.u_known],
        rtol=1e-6,
        atol=1e-6 * np.abs(reference.f).max(),
    )


def test_sharded_refined_solve_reaches_1e8(metadata, device_mesh):
    """Sharded mixed-precision refinement: f64 residual + f32 inner halo-PCG
    reaches 1e-8-grade GLOBAL relative residual and matches the
    single-device refined solve."""
    from magnetite_tpu.parallel.stencil_shard import (
        sharded_stencil_refined_solve,
    )

    mesh, bca = _plate_case(32, 32)  # coarsenable
    problem = prepare_sharded_stencil_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    result, ku = sharded_stencil_refined_solve(problem, rtol=1e-9)
    assert bool(result.converged)

    rows, cols = mesh.grid_shape
    u_sharded = np.asarray(result.x)[:, :rows, :].reshape(2, -1).T
    reference = solve_system(
        mesh, bca, metadata,
        SolverOptions(dtype="float32", refine="on", cg_rtol=1e-9),
    )
    assert reference.residual_rel <= 1e-9
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-8 * scale
    )


def test_sharded_refined_requires_f64(metadata, device_mesh):
    from magnetite_tpu.errors import SolverError
    from magnetite_tpu.parallel.stencil_shard import (
        sharded_stencil_refined_solve,
    )

    mesh, bca = _plate_case(16, 16)
    problem = prepare_sharded_stencil_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float32
    )
    with pytest.raises(SolverError, match="f64"):
        sharded_stencil_refined_solve(problem)


@pytest.fixture(scope="module")
def device_mesh_2d():
    assert len(jax.devices()) >= 8
    return jax.make_mesh((2, 4), ("rows", "cols"))


@pytest.mark.parametrize(
    "case",
    [
        lambda: _plate_case(23, 16),  # annulus: wrapped cols over 4 shards
        lambda: (rect_mesh(13, 12, width=2.0), None),  # unwrapped, col pad
    ],
)
def test_2d_sharded_stencil_matches_single_device(metadata, device_mesh_2d, case):
    """rows x cols sharding (2D grid layout): 8-neighbor halo exchange
    parity vs the single-device solver, wrapped and unwrapped cols."""
    from magnetite_tpu.parallel.stencil_shard import (
        prepare_sharded_stencil_problem_2d,
        sharded_stencil_pcg_solve_2d,
    )

    mesh, bca = case()
    if bca is None:
        bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    problem = prepare_sharded_stencil_problem_2d(
        mesh, bca, metadata, device_mesh_2d, dtype=np.float64
    )
    result, ku = sharded_stencil_pcg_solve_2d(problem, rtol=1e-11)
    assert bool(result.converged)

    rows, cols = mesh.grid_shape
    u_sharded = np.asarray(result.x)[:, :rows, :cols].reshape(2, -1).T
    reference = solve_system(mesh, bca, metadata, SolverOptions(cg_rtol=1e-12))
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-8 * scale
    )
    f_sharded = np.asarray(ku)[:, :rows, :cols].reshape(2, -1).T
    np.testing.assert_allclose(
        f_sharded[bca.u_known],
        reference.f[bca.u_known],
        rtol=1e-6,
        atol=1e-6 * np.abs(reference.f).max(),
    )


def test_2d_wrapped_cols_must_divide(metadata, device_mesh_2d):
    from magnetite_tpu.errors import SolverError
    from magnetite_tpu.parallel.stencil_shard import (
        prepare_sharded_stencil_problem_2d,
    )

    mesh, bca = _plate_case(15, 18)  # 18 wrapped cols over 4 shards: no
    with pytest.raises(SolverError, match="divide"):
        prepare_sharded_stencil_problem_2d(
            mesh, bca, metadata, device_mesh_2d, dtype=np.float64
        )


def test_2d_refined_solve_reaches_deep_tolerance(metadata, device_mesh_2d):
    from magnetite_tpu.parallel.stencil_shard import (
        prepare_sharded_stencil_problem_2d,
        sharded_stencil_refined_solve_2d,
    )

    mesh, bca = _plate_case(23, 16)
    problem = prepare_sharded_stencil_problem_2d(
        mesh, bca, metadata, device_mesh_2d, dtype=np.float64
    )
    result, _ = sharded_stencil_refined_solve_2d(problem, rtol=1e-10)
    assert bool(result.converged)
    rows, cols = mesh.grid_shape
    u_sharded = np.asarray(result.x)[:, :rows, :cols].reshape(2, -1).T
    reference = solve_system(mesh, bca, metadata, SolverOptions(cg_rtol=1e-12))
    np.testing.assert_allclose(
        u_sharded, reference.u, atol=1e-9 * np.abs(reference.u).max()
    )


def test_2d_sharded_multigrid_matches_and_holds_iterations(
    metadata, device_mesh_2d
):
    """the 2D rows x cols layout gets the 1D path's multigrid
    -- sharded fine smoothing over the 8-neighbor halo operator, coarse
    correction gathered over BOTH device axes and solved replicated.
    Iteration count must sit in the multigrid regime (block-Jacobi needs
    hundreds here), solution must match the single-device solver."""
    from magnetite_tpu.parallel.stencil_shard import (
        prepare_sharded_stencil_problem_2d,
        sharded_stencil_pcg_solve_2d,
    )

    mesh = rect_mesh(32, 32, width=2.0)  # 33x33: coarsenable both axes
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    problem = prepare_sharded_stencil_problem_2d(
        mesh, bca, metadata, device_mesh_2d, dtype=np.float64
    )
    result, _ = sharded_stencil_pcg_solve_2d(
        problem, rtol=1e-10, preconditioner="multigrid"
    )
    assert bool(result.converged)
    assert int(result.iterations) < 60

    rows, cols = mesh.grid_shape
    u_sharded = np.asarray(result.x)[:, :rows, :cols].reshape(2, -1).T
    reference = solve_system(mesh, bca, metadata, SolverOptions(cg_rtol=1e-12))
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-8 * scale
    )


def test_2d_refined_multigrid_reaches_deep_tolerance(metadata, device_mesh_2d):
    """2D refined solve with the f32 sharded-MG preconditioner: 1e-10
    relative residual at multigrid iteration counts."""
    from magnetite_tpu.parallel.stencil_shard import (
        prepare_sharded_stencil_problem_2d,
        sharded_stencil_refined_solve_2d,
    )

    mesh = rect_mesh(32, 32, width=2.0)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    problem = prepare_sharded_stencil_problem_2d(
        mesh, bca, metadata, device_mesh_2d, dtype=np.float64
    )
    result, _ = sharded_stencil_refined_solve_2d(
        problem, rtol=1e-10, preconditioner="multigrid"
    )
    assert bool(result.converged)
    assert int(result.iterations) < 80
    rows, cols = mesh.grid_shape
    u_sharded = np.asarray(result.x)[:, :rows, :cols].reshape(2, -1).T
    reference = solve_system(mesh, bca, metadata, SolverOptions(cg_rtol=1e-12))
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-8 * scale
    )


def test_refined_and_2d_honor_preconditioner_none(metadata, device_mesh,
                                                  device_mesh_2d, monkeypatch):
    """preconditioner='none' must run UNpreconditioned CG on every sharded
    stencil path (refined 1D, plain 2D, refined 2D) -- not silently fall
    back to block-Jacobi. _apply_dinv is the only way any stencil-shard
    preconditioner touches a residual, so poisoning it proves no
    preconditioner ran (trace-time lookup: the jitted bodies call it while
    tracing)."""
    from magnetite_tpu.parallel import stencil_shard as ss

    def _poisoned(diag_inv, r):  # pragma: no cover - must never trace
        raise AssertionError(
            "preconditioner ran despite preconditioner='none'"
        )

    monkeypatch.setattr(ss, "_apply_dinv", _poisoned)

    mesh, bca = _plate_case(23, 16)
    problem = ss.prepare_sharded_stencil_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    result, _ = ss.sharded_stencil_refined_solve(
        problem, rtol=1e-8, preconditioner="none", inner_maxiter=4000
    )
    assert bool(result.converged)

    problem2d = ss.prepare_sharded_stencil_problem_2d(
        mesh, bca, metadata, device_mesh_2d, dtype=np.float64
    )
    result, _ = ss.sharded_stencil_pcg_solve_2d(
        problem2d, rtol=1e-8, preconditioner="none", maxiter=8000
    )
    assert bool(result.converged)
    result, _ = ss.sharded_stencil_refined_solve_2d(
        problem2d, rtol=1e-8, preconditioner="none", maxiter=8000
    )
    assert bool(result.converged)
