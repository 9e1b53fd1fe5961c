"""The sparse f64 oracle against the dense oracle it vectorizes."""

import numpy as np
import pytest

from magnetite_tpu import oracle
from magnetite_tpu.bc import BCArrays
from magnetite_tpu.meshing.generators import (
    plate_with_hole_mesh,
    rect_mesh,
    tensile_bcs_for_rect,
)


def _delaunay():
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    return triangulate([outer, hole], 0.0, 0.15)


MESHES = {
    "rect": lambda: rect_mesh(12, 6, width=2.0),
    "annulus": lambda: plate_with_hole_mesh(6, 16),
    "delaunay": _delaunay,
}


def _loaded_bcs(mesh):
    """Clamp left, pull right, and push one interior node: displacement and
    force loads both enter the right-hand side."""
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    f = bca.f_value.copy()
    f[mesh.num_nodes // 2] = [1e5, -2e5]
    return BCArrays(bca.u_known, bca.u_value, f)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sparse_stiffness_matches_dense(metadata, name):
    mesh = MESHES[name]()
    args = (metadata.youngs_modulus, metadata.poisson_ratio,
            metadata.part_thickness)
    dense = oracle.global_stiffness(mesh.coords, mesh.tris, *args)
    sparse = oracle.sparse_stiffness(mesh.coords, mesh.tris, *args)
    np.testing.assert_allclose(
        sparse.toarray(), dense, atol=1e-13 * np.abs(dense).max()
    )


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sparse_solve_matches_dense_solve(metadata, name):
    mesh = MESHES[name]()
    bca = _loaded_bcs(mesh)
    u_d, f_d, s_d = oracle.solve(mesh.coords, mesh.tris, bca, metadata)
    u_s, f_s, s_s = oracle.sparse_solve(mesh.coords, mesh.tris, bca, metadata)
    for got, want in ((u_s, u_d), (f_s, f_d), (s_s, s_d)):
        np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_true_relative_residual(metadata):
    """~1e-16 for the direct solution; exactly the perturbation's residual
    for a perturbed one; prescribed DOFs are taken from the BCs."""
    mesh = MESHES["delaunay"]()
    bca = _loaded_bcs(mesh)
    k = oracle.sparse_stiffness(
        mesh.coords, mesh.tris, metadata.youngs_modulus,
        metadata.poisson_ratio, metadata.part_thickness,
    )
    u, _, _ = oracle.sparse_solve(mesh.coords, mesh.tris, bca, metadata, k=k)
    assert oracle.true_relative_residual(k, bca, u) < 1e-12
    bumped = u.copy()
    bumped[bca.u_known] += 1.0  # ignored: prescribed values win
    assert oracle.true_relative_residual(k, bca, bumped) < 1e-12
    free = ~bca.u_known.reshape(-1)
    delta = np.zeros(u.size)
    delta[np.flatnonzero(free)[7]] = 1e-6
    known, f = bca.u_known.reshape(-1), bca.f_value.reshape(-1)
    rhs = f[free] - (k @ np.where(known, bca.u_value.reshape(-1), 0.0))[free]
    want = np.linalg.norm((k @ delta)[free]) / np.linalg.norm(rhs)
    got = oracle.true_relative_residual(k, bca, u + delta.reshape(-1, 2))
    assert abs(got - want) < 1e-6 * want
