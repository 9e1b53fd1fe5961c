"""Stencil operator + geometric multigrid tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from magnetite_tpu import oracle
from magnetite_tpu.config import SolverOptions
from magnetite_tpu.fem.element import element_stiffness_matrices
from magnetite_tpu.fem.multigrid import (
    build_hierarchy,
    can_coarsen,
    galerkin_coarse_stencil,
    prolong,
    restrict,
    vcycle_preconditioner,
)
from magnetite_tpu.fem.solve import solve_system
from magnetite_tpu.fem.stencil import (
    assemble_stencil,
    build_stencil_structure,
    make_stencil_operator,
    stencil_matvec,
    stencil_to_dense,
)
from magnetite_tpu.meshing.generators import (
    plate_with_hole_mesh,
    rect_mesh,
    tensile_bcs_for_rect,
)


def _stencil_for(mesh, metadata):
    rows, cols = mesh.grid_shape
    st = build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols)
    assert st is not None
    ke = element_stiffness_matrices(
        jnp.asarray(mesh.coords),
        jnp.asarray(mesh.tris),
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
    )
    return assemble_stencil(ke, st.slot_ids, rows, cols)


def test_stencil_matvec_matches_oracle_rect(metadata):
    mesh = rect_mesh(6, 4, width=2.0)
    stencil = _stencil_for(mesh, metadata)
    k = oracle.global_stiffness(
        mesh.coords, mesh.tris,
        metadata.youngs_modulus, metadata.poisson_ratio,
        metadata.part_thickness,
    )
    rng = np.random.default_rng(0)
    u = rng.standard_normal((mesh.num_nodes, 2))
    ug = jnp.asarray(u.T.reshape(2, *mesh.grid_shape))
    y = np.asarray(stencil_matvec(stencil, ug, False)).reshape(2, -1).T
    y_ref = (k @ u.reshape(-1)).reshape(-1, 2)
    np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-4)


def test_stencil_matvec_matches_oracle_annulus(metadata):
    mesh = plate_with_hole_mesh(6, 16)
    stencil = _stencil_for(mesh, metadata)
    k = oracle.global_stiffness(
        mesh.coords, mesh.tris,
        metadata.youngs_modulus, metadata.poisson_ratio,
        metadata.part_thickness,
    )
    rng = np.random.default_rng(1)
    u = rng.standard_normal((mesh.num_nodes, 2))
    ug = jnp.asarray(u.T.reshape(2, *mesh.grid_shape))
    y = np.asarray(stencil_matvec(stencil, ug, True)).reshape(2, -1).T
    y_ref = (k @ u.reshape(-1)).reshape(-1, 2)
    np.testing.assert_allclose(y, y_ref, rtol=1e-10, atol=1e-3)


@pytest.mark.parametrize("wrap", [False, True])
def test_prolong_restrict_adjoint(wrap):
    """<P uc, vf> == <uc, P^T vf> exactly (restriction is the true adjoint)."""
    rng = np.random.default_rng(2)
    rc, cc = 9, 12 if wrap else 9
    uc = jnp.asarray(rng.standard_normal((2, rc, cc)))
    rf_rows = 2 * rc - 1
    rf_cols = 2 * cc if wrap else 2 * cc - 1
    vf = jnp.asarray(rng.standard_normal((2, rf_rows, rf_cols)))
    lhs = float(jnp.sum(prolong(uc, wrap) * vf))
    rhs = float(jnp.sum(uc * restrict(vf, wrap)))
    assert lhs == pytest.approx(rhs, rel=1e-12)


def test_prolong_exact_on_coarse_nodes():
    rng = np.random.default_rng(3)
    uc = jnp.asarray(rng.standard_normal((2, 5, 5)))
    uf = prolong(uc, False)
    np.testing.assert_allclose(np.asarray(uf[:, ::2, ::2]), np.asarray(uc))


@pytest.mark.parametrize("wrap", [False, True])
def test_galerkin_rap_matches_dense(metadata, wrap):
    """Probed coarse stencil == dense R K P computed explicitly."""
    if wrap:
        mesh = plate_with_hole_mesh(8, 16)
    else:
        mesh = rect_mesh(8, 8)
    rows, cols = mesh.grid_shape
    stencil = _stencil_for(mesh, metadata)
    op = make_stencil_operator(stencil, wrap)
    rc = (rows - 1) // 2 + 1
    cc = cols // 2 if wrap else (cols - 1) // 2 + 1
    coarse = galerkin_coarse_stencil(op, rc, cc, wrap, stencil.dtype)

    # dense comparison: K_c = P^T K P column by column
    nc = rc * cc
    kc_dense = np.zeros((2 * nc, 2 * nc))
    for j in range(nc):
        for comp in range(2):
            v = np.zeros((2, rc, cc))
            v[comp, j // cc, j % cc] = 1.0
            y = restrict(op(prolong(jnp.asarray(v), wrap)), wrap)
            kc_dense[:, 2 * j + comp] = (
                np.asarray(y).reshape(2, -1).T.reshape(-1)
            )
    kc_stencil = stencil_to_dense(np.asarray(coarse), wrap)
    scale = np.abs(kc_dense).max()
    np.testing.assert_allclose(
        kc_stencil, kc_dense, rtol=1e-6, atol=1e-9 * scale
    )


def test_vcycle_reduces_residual(metadata):
    """One V-cycle must shrink the residual substantially."""
    mesh = rect_mesh(32, 32)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    rows, cols = mesh.grid_shape
    stencil = _stencil_for(mesh, metadata)
    free = jnp.asarray((~bca.u_known).astype(np.float64).T.reshape(2, rows, cols))
    from magnetite_tpu.fem.stencil import OFFSETS, CENTER, shift2d

    reduced = []
    for s, (dr, dt) in enumerate(OFFSETS):
        fin = shift2d(free, dr, dt, False)
        blk = stencil[s] * free[:, None] * fin[None, :]
        if s == CENTER:
            blk = blk.at[0, 0].add(1.0 - free[0])
            blk = blk.at[1, 1].add(1.0 - free[1])
        reduced.append(blk)
    reduced = jnp.stack(reduced)
    levels = build_hierarchy(reduced, free, False)
    assert len(levels) >= 2
    pre = vcycle_preconditioner(levels, False)
    op = make_stencil_operator(reduced, False)

    rng = np.random.default_rng(5)
    b = free * jnp.asarray(rng.standard_normal((2, rows, cols)))
    e = pre(b)
    res = b - op(e)
    ratio = float(jnp.linalg.norm(res) / jnp.linalg.norm(b))
    assert ratio < 0.25, f"V-cycle residual reduction too weak: {ratio}"


def test_solve_multigrid_matches_oracle(metadata):
    mesh = rect_mesh(32, 16, width=2.0)
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    result = solve_system(
        mesh, bca, metadata, SolverOptions(preconditioner="multigrid")
    )
    assert result.timings["operator"] == "stencil"
    assert result.timings["preconditioner"] == "multigrid"
    u_ref, _, _ = oracle.solve(mesh.coords, mesh.tris, bca, metadata)
    scale = np.abs(u_ref).max()
    np.testing.assert_allclose(result.u, u_ref, rtol=1e-6, atol=1e-8 * scale)


def test_multigrid_iteration_count_mesh_independent(metadata):
    """The whole point: iterations must NOT grow ~O(1/h) like Jacobi PCG."""
    iters = {}
    for n in (16, 32, 64):
        mesh = rect_mesh(n, n)
        bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
        r = solve_system(
            mesh, bca, metadata, SolverOptions(preconditioner="multigrid")
        )
        iters[n] = r.iterations
    assert iters[64] <= 2 * iters[16] + 10, iters
    assert iters[64] < 60, iters


def test_auto_preconditioner_picks_multigrid_on_large_grid(metadata):
    mesh = rect_mesh(40, 40)
    bca = tensile_bcs_for_rect(mesh.coords)
    r = solve_system(mesh, bca, metadata, SolverOptions())
    assert r.timings["preconditioner"] == "multigrid"


def test_can_coarsen_rules():
    assert can_coarsen(33, 33, False)
    assert not can_coarsen(16, 33, False)  # even rows
    assert can_coarsen(17, 32, True)
    assert not can_coarsen(17, 20, True)  # 10 % 4 != 0


def test_dense_expansion_matches_reference(metadata):
    """jit-friendly dense expansion == the numpy testing version."""
    import jax.numpy as jnp
    from magnetite_tpu.fem.multigrid import stencil_to_dense_device
    from magnetite_tpu.fem.stencil import (
        assemble_stencil_fused,
        stencil_to_dense,
    )
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh, rect_mesh

    for mesh in (plate_with_hole_mesh(5, 8), rect_mesh(5, 4)):
        rows, cols = mesh.grid_shape
        st = assemble_stencil_fused(
            jnp.asarray(mesh.coords), jnp.asarray(mesh.tris),
            69e9, 0.33, 0.5, rows, cols, mesh.wrap_cols,
        )
        dense_np = stencil_to_dense(np.asarray(st), mesh.wrap_cols)
        dense_dev = np.asarray(
            stencil_to_dense_device(st, mesh.wrap_cols)
        )
        np.testing.assert_allclose(dense_dev, dense_np, atol=1e-6 * np.abs(dense_np).max())


def test_dense_coarse_solve_is_exact(metadata):
    """Coarsest-level dense inverse solves A e = r to machine precision."""
    import jax.numpy as jnp
    from magnetite_tpu.fem.multigrid import apply_dense_inverse, build_hierarchy
    from magnetite_tpu.fem.solve import _grid, _reduce_stencil
    from magnetite_tpu.fem.stencil import assemble_stencil_fused
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh

    mesh = plate_with_hole_mesh(32, 32)
    rows, cols = mesh.grid_shape
    n = mesh.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_known[np.isclose(mesh.coords[:, 0], mesh.coords[:, 0].min())] = True
    free = _grid(jnp.asarray(~u_known, jnp.float64), rows, cols)
    raw = assemble_stencil_fused(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.tris),
        69e9, 0.33, 0.5, rows, cols, True,
    )
    reduced = _reduce_stencil(raw, free, True)
    levels = build_hierarchy(reduced, free, True)
    last = levels[-1]
    assert last.dense_inv is not None

    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.standard_normal((2, last.rows, last.cols)))
    e = apply_dense_inverse(last.dense_inv, r)
    back = np.asarray(last.op(e))
    np.testing.assert_allclose(back, np.asarray(r), rtol=1e-8, atol=1e-8 * np.abs(np.asarray(r)).max())


@pytest.mark.parametrize("wrap", [True, False])
def test_dense_coarse_inverse_is_native_f64(metadata, wrap):
    """f64 hierarchies invert the coarsest operator in f64 itself: the
    inverse matches numpy's to f64 roundoff and stays symmetric."""
    import jax.numpy as jnp
    from magnetite_tpu.fem.multigrid import dense_coarse_inverse
    from magnetite_tpu.fem.solve import _grid, _reduce_stencil
    from magnetite_tpu.fem.stencil import assemble_stencil_fused
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh, rect_mesh

    mesh = plate_with_hole_mesh(6, 16) if wrap else rect_mesh(10, 8)
    rows, cols = mesh.grid_shape
    u_known = np.zeros((mesh.num_nodes, 2), dtype=bool)
    u_known[np.isclose(mesh.coords[:, 0], mesh.coords[:, 0].min())] = True
    raw = assemble_stencil_fused(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.tris),
        metadata.youngs_modulus, metadata.poisson_ratio,
        metadata.part_thickness, rows, cols, wrap,
    )
    free = _grid(jnp.asarray(~u_known, jnp.float64), rows, cols)
    reduced = _reduce_stencil(raw, free, wrap)
    inv = dense_coarse_inverse(reduced, wrap)
    assert inv.dtype == jnp.float64
    want = np.linalg.inv(stencil_to_dense(np.asarray(reduced), wrap))
    got = np.asarray(inv)
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())
    np.testing.assert_allclose(got, got.T, atol=1e-10 * np.abs(got).max())
