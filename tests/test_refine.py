"""Mixed-precision iterative refinement + new solver-core plumbing tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magnetite_tpu.bc import BCArrays
from magnetite_tpu.config import SolverOptions
from magnetite_tpu.errors import SolverError
from magnetite_tpu.fem.refine import mixed_precision_solve
from magnetite_tpu.fem.solve import compile_problem, solve_system
from magnetite_tpu.meshing.generators import plate_with_hole_mesh, rect_mesh


def _plate_case(nr=32, nt=64):
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


def test_mixed_precision_reaches_f64_residual():
    """IR on a small SPD system: residual far below f32 single-solve floor."""
    rng = np.random.default_rng(3)
    m = rng.standard_normal((40, 40))
    a64 = jnp.asarray(m @ m.T + 40 * np.eye(40), dtype=jnp.float64)
    a32 = a64.astype(jnp.float32)
    b = jnp.asarray(rng.standard_normal(40), dtype=jnp.float64)

    result = mixed_precision_solve(
        lambda v: a64 @ v,
        lambda v: a32 @ v,
        b,
        rtol=1e-12,
        inner_rtol=1e-4,
        inner_maxiter=200,
        max_outer=10,
    )
    assert bool(result.converged)
    r = np.asarray(b - a64 @ result.x)
    rel = np.linalg.norm(r) / np.linalg.norm(np.asarray(b))
    assert rel <= 1e-12
    assert int(result.outer_steps) >= 2  # f32 alone cannot reach 1e-12


def test_stencil_refine_hits_tight_tolerance(metadata):
    """f32 storage + refinement reaches rtol far below the f32 clamp."""
    mesh, bca = _plate_case()
    options = SolverOptions(dtype="float32", cg_rtol=1e-10, refine="on")
    problem = compile_problem(mesh, bca, metadata, options)
    assert problem.mode == "stencil" and problem.refine
    res = problem.solve()
    assert res.converged

    # verify the residual claim against an independent f64 reassembly
    ref = solve_system(
        mesh, bca, metadata, SolverOptions(dtype="float64", cg_rtol=1e-12)
    )
    rel_u = np.abs(res.u - ref.u).max() / np.abs(ref.u).max()
    assert rel_u < 1e-8


@pytest.mark.parametrize("operator", ["dia", "hybrid", "ell"])
def test_refine_on_irregular_operators(metadata, operator):
    """refine='on' reaches f64-grade accuracy on every sparse format."""
    mesh, bca = _plate_case(16, 32)
    options = SolverOptions(
        dtype="float32", cg_rtol=1e-10, refine="on", operator=operator
    )
    problem = compile_problem(mesh, bca, metadata, options)
    assert problem.mode == operator and problem.refine
    res = problem.solve()
    assert res.converged and res.residual_rel <= 1e-10

    ref = solve_system(
        mesh, bca, metadata,
        SolverOptions(dtype="float64", cg_rtol=1e-12, operator=operator),
    )
    rel_u = np.abs(res.u - ref.u).max() / np.abs(ref.u).max()
    assert rel_u < 1e-8


@pytest.mark.parametrize("operator", ["stencil", "dia"])
def test_refined_stress_is_f64_grade(metadata, operator):
    """Refined solves recover stress in f64: an f32 cast of u loses
    ~eps_f32 * extent / h of it to the strain differences across an
    element (the single-device and sharded paths must agree)."""
    mesh, bca = _plate_case(16, 32)
    res = solve_system(
        mesh, bca, metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-10, refine="on",
                      operator=operator),
    )
    ref = solve_system(
        mesh, bca, metadata,
        SolverOptions(dtype="float64", cg_rtol=1e-12, operator=operator),
    )
    assert res.sigma.dtype == np.float64
    rel = np.abs(res.sigma - ref.sigma).max() / np.abs(ref.sigma).max()
    assert rel < 1e-7


def test_refine_auto_engages_below_f32_floor(metadata):
    mesh, bca = _plate_case(16, 32)
    problem = compile_problem(
        mesh, bca, metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-9, refine="auto"),
    )
    assert problem.refine
    problem = compile_problem(
        mesh, bca, metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-4, refine="auto"),
    )
    assert not problem.refine


def test_structured_assembly_matches_fused():
    """Scatter-free canonical-grid assembly == segment_sum assembly."""
    from magnetite_tpu.fem.stencil import (
        assemble_stencil_fused,
        assemble_stencil_structured,
    )

    for mesh in (plate_with_hole_mesh(9, 16), rect_mesh(7, 11)):
        rows, cols = mesh.grid_shape
        coords = jnp.asarray(mesh.coords)
        tris = jnp.asarray(mesh.tris)
        a = assemble_stencil_fused(
            coords, tris, 69e9, 0.33, 0.5, rows, cols, mesh.wrap_cols
        )
        b = assemble_stencil_structured(
            coords, 69e9, 0.33, 0.5, rows, cols, mesh.wrap_cols
        )
        scale = float(jnp.abs(a).max())
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), atol=1e-9 * scale
        )


def test_generator_meshes_marked_grid_local():
    assert plate_with_hole_mesh(4, 8).grid_local
    assert rect_mesh(4, 4).grid_local


def test_debug_nans_raises_typed_error(metadata):
    mesh, bca = _plate_case(8, 16)
    from magnetite_tpu.config import ModelMetadata

    bad = ModelMetadata(
        youngs_modulus=float("nan"),
        poisson_ratio=metadata.poisson_ratio,
        part_thickness=metadata.part_thickness,
        characteristic_length_min=0.0,
        characteristic_length_max=0.3,
    )
    with pytest.raises(SolverError, match="non-finite"):
        solve_system(
            mesh, bca, bad,
            SolverOptions(debug_nans=True, max_cg_iters=50, cg_rtol=1e-3),
        )


def test_refine_on_without_x64_raises(metadata):
    mesh, bca = _plate_case(8, 16)
    with jax.enable_x64(False):  # simulate an x64-disabled session
        with pytest.raises(SolverError, match="x64"):
            compile_problem(
                mesh, bca, metadata, SolverOptions(refine="on", dtype="float32")
            )


def test_refine_insensitive_to_inner_cap(metadata):
    """Refinement converges to the same answer whether the inner cap binds
    (small cap, more outer passes) or not (one deep inner solve)."""
    mesh, bca = _plate_case(16, 32)
    results = []
    for cap in (25, 400):
        res = solve_system(
            mesh, bca, metadata,
            SolverOptions(
                dtype="float32", cg_rtol=1e-10, refine="on",
                refine_inner_iters=cap, refine_max_outer=20,
            ),
        )
        assert res.converged and res.residual_rel <= 1e-10
        results.append(res.u)
    scale = np.abs(results[1]).max()
    assert np.abs(results[0] - results[1]).max() < 1e-9 * scale
