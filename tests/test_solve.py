"""Full-solve integration tests: JAX pipeline vs the dense NumPy oracle."""

import numpy as np
import pytest

from magnetite_tpu import oracle
from magnetite_tpu.bc import BCArrays
from magnetite_tpu.config import SolverOptions
from magnetite_tpu.errors import SolverError
from magnetite_tpu.fem.solve import solve_system
from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect


def _compare_with_oracle(mesh, bca, metadata, options=SolverOptions()):
    result = solve_system(mesh, bca, metadata, options)
    u_ref, f_ref, sigma_ref = oracle.solve(mesh.coords, mesh.tris, bca, metadata)
    u_scale = np.abs(u_ref).max()
    np.testing.assert_allclose(result.u, u_ref, rtol=1e-8, atol=1e-8 * u_scale)
    s_scale = np.abs(sigma_ref).max()
    np.testing.assert_allclose(
        result.sigma, sigma_ref, rtol=1e-6, atol=1e-8 * s_scale
    )
    stress_ref = oracle.scalar_stress(sigma_ref)
    np.testing.assert_allclose(
        result.stress, stress_ref, rtol=1e-6, atol=1e-8 * s_scale
    )
    return result


def test_tensile_rect_matches_oracle(metadata):
    mesh = rect_mesh(8, 4, width=2.0, height=1.0)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    result = _compare_with_oracle(mesh, bca, metadata)
    assert result.converged
    assert result.iterations > 0


def test_force_loaded_rect_matches_oracle(metadata):
    mesh = rect_mesh(6, 3, width=3.0, height=1.0)
    n = mesh.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    f_value = np.zeros((n, 2))
    left = np.isclose(mesh.coords[:, 0], 0.0)
    right = np.isclose(mesh.coords[:, 0], 3.0)
    u_known[left] = True
    f_value[right, 0] = 1e6  # applied force on the free right edge
    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=f_value)
    _compare_with_oracle(mesh, bca, metadata)


def test_mixed_bc_per_axis_matches_oracle(metadata):
    """ux fixed but fy force-loaded on the same node set (mixed per-axis)."""
    mesh = rect_mesh(5, 5)
    n = mesh.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    f_value = np.zeros((n, 2))
    bottom = np.isclose(mesh.coords[:, 1], 0.0)
    top = np.isclose(mesh.coords[:, 1], 1.0)
    u_known[bottom] = True
    u_known[top, 0] = True  # x pinned on top...
    u_value[top, 0] = 0.002
    f_value[top, 1] = 5e5  # ...but y force-loaded
    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=f_value)
    _compare_with_oracle(mesh, bca, metadata)


def test_dense_path_matches_sparse(metadata):
    mesh = rect_mesh(4, 4)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.005)
    sparse = solve_system(mesh, bca, metadata, SolverOptions())
    dense = solve_system(
        mesh, bca, metadata, SolverOptions(dense_cutoff=10_000)
    )
    np.testing.assert_allclose(sparse.u, dense.u, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("precond", ["none", "jacobi", "block_jacobi"])
def test_preconditioners_agree(metadata, precond):
    mesh = rect_mesh(6, 4)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    result = solve_system(
        mesh, bca, metadata, SolverOptions(preconditioner=precond)
    )
    u_ref, _, _ = oracle.solve(mesh.coords, mesh.tris, bca, metadata)
    np.testing.assert_allclose(
        result.u, u_ref, rtol=1e-7, atol=1e-9 * np.abs(u_ref).max()
    )


def test_block_jacobi_converges_fastest(metadata):
    mesh = rect_mesh(12, 6, width=4.0)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    iters = {}
    for precond in ["none", "block_jacobi"]:
        r = solve_system(
            mesh, bca, metadata, SolverOptions(preconditioner=precond)
        )
        iters[precond] = r.iterations
    assert iters["block_jacobi"] <= iters["none"]


def test_unconstrained_model_raises(metadata):
    mesh = rect_mesh(3, 3)
    n = mesh.num_nodes
    bca = BCArrays(
        u_known=np.zeros((n, 2), dtype=bool),
        u_value=np.zeros((n, 2)),
        f_value=np.zeros((n, 2)),
    )
    with pytest.raises(SolverError):
        solve_system(mesh, bca, metadata)


def test_nonconvergence_raises(metadata):
    mesh = rect_mesh(10, 5)
    bca = tensile_bcs_for_rect(mesh.coords)
    with pytest.raises(SolverError, match="converge"):
        solve_system(
            mesh, bca, metadata, SolverOptions(max_cg_iters=2, cg_rtol=1e-14)
        )


def test_prescribed_displacements_exact(metadata):
    """Fixed DOFs come back exactly at their prescribed values."""
    mesh = rect_mesh(7, 3, width=2.0)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.0123)
    result = solve_system(mesh, bca, metadata)
    np.testing.assert_array_equal(
        result.u[bca.u_known], bca.u_value[bca.u_known]
    )


def test_reaction_forces_balance(metadata):
    """Sum of recovered reaction forces equals zero in equilibrium (no
    applied external forces except reactions)."""
    mesh = rect_mesh(6, 4, width=2.0)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    result = solve_system(mesh, bca, metadata)
    total = result.f.sum(axis=0)
    scale = np.abs(result.f).max()
    np.testing.assert_allclose(total / scale, 0.0, atol=1e-8)


def test_dense_mode_pins_matmul_precision(metadata):
    """Every contraction of the dense-mode core asks for full precision (an
    f32 matmul could otherwise run in TF32 on the GPU)."""
    import jax

    from magnetite_tpu.fem.solve import compile_problem

    mesh = rect_mesh(4, 3)
    problem = compile_problem(
        mesh, tensile_bcs_for_rect(mesh.coords), metadata,
        SolverOptions(dtype="float32", dense_cutoff=10**6, cg_rtol=1e-5),
    )
    assert problem.mode == "dense"

    def dots(jaxpr):  # dot_general precisions, nested jaxprs included
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn.params["precision"]
            for param in eqn.params.values():
                for sub in param if isinstance(param, (list, tuple)) else [param]:
                    inner = getattr(sub, "jaxpr", None)
                    if inner is not None:
                        yield from dots(getattr(inner, "jaxpr", inner))

    found = list(dots(jax.make_jaxpr(problem.core)(*problem.args).jaxpr))
    assert found
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in found), found
