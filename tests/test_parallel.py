"""Sharded PCG + vmapped sweep tests on the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from magnetite_tpu import oracle
from magnetite_tpu.config import SolverOptions
from magnetite_tpu.fem.solve import solve_system
from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
from magnetite_tpu.parallel.sharding import (
    prepare_sharded_problem,
    sharded_pcg_solve,
)
from magnetite_tpu.parallel.sweep import sweep_solve


@pytest.fixture(scope="module")
def device_mesh():
    devices = jax.devices()
    assert len(devices) >= 8, "conftest must provide 8 virtual CPU devices"
    return jax.make_mesh((8,), ("rows",))


def test_sharded_pcg_matches_single_device(metadata, device_mesh):
    mesh = rect_mesh(13, 7, width=2.0)  # N=112 not divisible by 8 -> padding
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.01)

    problem = prepare_sharded_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    result = sharded_pcg_solve(problem, rtol=1e-11)
    assert bool(result.converged)

    u_sharded = np.asarray(result.x)[: mesh.num_nodes]
    reference = solve_system(mesh, bca, metadata, SolverOptions())
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-7, atol=1e-9 * scale
    )


def test_sharded_padding_rows_inert(metadata, device_mesh):
    mesh = rect_mesh(5, 3)  # N=24 -> no padding vs N=28 cases both fine
    bca = tensile_bcs_for_rect(mesh.coords, pull=0.002)
    problem = prepare_sharded_problem(
        mesh, bca, metadata, device_mesh, dtype=np.float64
    )
    result = sharded_pcg_solve(problem, rtol=1e-10)
    x = np.asarray(result.x)
    # padded rows (if any) stay exactly zero
    np.testing.assert_array_equal(x[mesh.num_nodes :], 0.0)


def test_sweep_matches_individual_solves(metadata):
    mesh = rect_mesh(6, 4, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    pulls = np.array([0.005, 0.01, 0.02, 0.04])
    b = pulls.size

    u_values = np.tile(base.u_value[None], (b, 1, 1))
    right_x = np.isclose(mesh.coords[:, 0], 2.0)
    for i, p in enumerate(pulls):
        u_values[i][right_x, 0] = p
    f_values = np.zeros((b, mesh.num_nodes, 2))
    k_scales = np.ones(b)

    sweep = sweep_solve(
        mesh,
        base,
        metadata,
        u_values,
        f_values,
        k_scales,
        iterations=300,
        dtype=np.float64,
    )
    assert sweep.u.shape == (b, mesh.num_nodes, 2)

    for i, p in enumerate(pulls):
        bca_i = tensile_bcs_for_rect(mesh.coords, pull=p)
        ref = solve_system(mesh, bca_i, metadata, SolverOptions())
        scale = np.abs(ref.u).max()
        np.testing.assert_allclose(
            np.asarray(sweep.u[i]), ref.u, rtol=1e-6, atol=1e-8 * scale
        )


def test_sweep_lanes_matches_vmap(metadata):
    """The lane-batched (batch-minor) sweep must agree with the vmap path."""
    mesh = rect_mesh(6, 4, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    b = 8
    rng = np.random.default_rng(7)
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    right = np.isclose(mesh.coords[:, 0], 2.0)
    u_values[:, right, 0] = rng.uniform(0.005, 0.02, b)[:, None]
    f_values = np.zeros((b, mesh.num_nodes, 2))
    k_scales = rng.uniform(0.5, 2.0, b)

    kwargs = dict(iterations=300, dtype=np.float64)
    lanes = sweep_solve(
        mesh, base, metadata, u_values, f_values, k_scales,
        impl="lanes", **kwargs,
    )
    vmapped = sweep_solve(
        mesh, base, metadata, u_values, f_values, k_scales,
        impl="vmap", **kwargs,
    )
    scale = np.abs(np.asarray(vmapped.u)).max()
    np.testing.assert_allclose(
        np.asarray(lanes.u), np.asarray(vmapped.u), rtol=1e-8,
        atol=1e-10 * scale,
    )
    np.testing.assert_allclose(
        np.asarray(lanes.von_mises),
        np.asarray(vmapped.von_mises),
        rtol=1e-7,
    )


def test_sweep_k_scale_linearity(metadata):
    """Displacement-driven: u independent of stiffness scale; von Mises
    scales linearly with the Young's-modulus factor."""
    mesh = rect_mesh(5, 3)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    b = 3
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    f_values = np.zeros((b, mesh.num_nodes, 2))
    k_scales = np.array([1.0, 2.0, 4.0])
    sweep = sweep_solve(
        mesh, base, metadata, u_values, f_values, k_scales,
        iterations=200, dtype=np.float64,
    )
    u = np.asarray(sweep.u)
    np.testing.assert_allclose(u[1], u[0], rtol=1e-9, atol=1e-12)
    vm = np.asarray(sweep.von_mises)
    np.testing.assert_allclose(vm[1], 2 * vm[0], rtol=1e-9)
    np.testing.assert_allclose(vm[2], 4 * vm[0], rtol=1e-9)


def test_stencil_mg_sweep_matches_individual_solves(metadata):
    """Lane-batched stencil sweep with a SHARED multigrid hierarchy: a few
    iterations converge all variants; parity vs one-at-a-time solves."""
    from magnetite_tpu.fem.multigrid import can_coarsen
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.config import ModelMetadata

    mesh = rect_mesh(32, 16, width=2.0)  # grid (17, 33): coarsenable
    assert can_coarsen(*mesh.grid_shape, mesh.wrap_cols)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    pulls = np.array([0.005, 0.01, 0.02, 0.04])
    k_scales = np.array([0.5, 1.0, 1.5, 2.0])
    b = pulls.size
    right = np.isclose(mesh.coords[:, 0], 2.0)
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    u_values[:, right, 0] = pulls[:, None]
    f_values = np.zeros((b, mesh.num_nodes, 2))

    result = sweep_solve(
        mesh, base, metadata, u_values, f_values, k_scales,
        iterations=20, dtype=np.float64, impl="stencil",
    )
    rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
    assert rel.max() < 1e-8  # 20 MG-PCG iterations must be deep convergence

    for i in range(b):
        bca_i = BCArrays(
            u_known=base.u_known, u_value=u_values[i], f_value=f_values[i]
        )
        md_i = ModelMetadata(
            youngs_modulus=metadata.youngs_modulus * k_scales[i],
            poisson_ratio=metadata.poisson_ratio,
            part_thickness=metadata.part_thickness,
            characteristic_length_min=0.0,
            characteristic_length_max=0.3,
        )
        ref = solve_system(mesh, bca_i, md_i, SolverOptions(cg_rtol=1e-11))
        scale = np.abs(ref.u).max()
        np.testing.assert_allclose(
            np.asarray(result.u)[i], ref.u, atol=1e-8 * scale
        )
        np.testing.assert_allclose(
            np.asarray(result.von_mises)[i],
            ref.von_mises,
            rtol=1e-6,
        )


def test_vmap_sweep_fallback_matches_lanes(metadata):
    """The gather-ELL vmap fallback (for meshes with no band structure)
    agrees with the DIA lanes path on the same inputs."""
    from magnetite_tpu.parallel.sweep import _sweep_vmap, _sweep_lanes
    from magnetite_tpu.fem.dia import build_dia_structure

    mesh = rect_mesh(6, 4, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    pulls = np.array([0.005, 0.02])
    k_scales = np.array([0.8, 1.6])
    b = pulls.size
    right = np.isclose(mesh.coords[:, 0], 2.0)
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    u_values[:, right, 0] = pulls[:, None]
    f_values = np.zeros((b, mesh.num_nodes, 2))

    dia = build_dia_structure(mesh.tris, mesh.num_nodes)
    lanes = _sweep_lanes(
        mesh, base, metadata, u_values, f_values, k_scales, 400, np.float64,
        dia,
    )
    vmapped = _sweep_vmap(
        mesh, base, metadata, u_values, f_values, k_scales, 400, np.float64,
        None,
    )
    scale = np.abs(np.asarray(lanes.u)).max()
    np.testing.assert_allclose(
        np.asarray(vmapped.u), np.asarray(lanes.u), atol=1e-9 * scale
    )
    np.testing.assert_allclose(
        np.asarray(vmapped.von_mises),
        np.asarray(lanes.von_mises),
        rtol=1e-7,
    )


def test_sharded_2d_batch_sweep_matches_individual(metadata):
    """Batch x rows sharding over a 2D device mesh (dp x sp analog):
    every lane of the sharded sweep matches a single-device solve."""
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.parallel.sharding import sharded_batch_pcg_solve

    devices = jax.devices()
    assert len(devices) >= 8
    device_mesh = jax.make_mesh((2, 4), ("batch", "rows"))

    mesh = rect_mesh(9, 5, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    problem = prepare_sharded_problem(
        mesh, base, metadata, device_mesh, axis="rows", dtype=np.float64
    )

    b_lanes = 4
    n_pad = problem.free.shape[0]
    scales = 1.0 + np.arange(b_lanes)
    u_fixed = np.tile(np.asarray(problem.u_fixed)[None], (b_lanes, 1, 1))
    u_fixed *= scales[:, None, None]
    f_applied = np.zeros((b_lanes, n_pad, 2))

    u_batch = np.asarray(
        sharded_batch_pcg_solve(
            problem,
            jax.numpy.asarray(u_fixed),
            jax.numpy.asarray(f_applied),
            iterations=400,
        )
    )

    for i in range(b_lanes):
        bca_i = BCArrays(
            u_known=base.u_known,
            u_value=base.u_value * scales[i],
            f_value=np.zeros_like(base.f_value),
        )
        ref = solve_system(
            mesh, bca_i, metadata, SolverOptions(cg_rtol=1e-11)
        )
        scale = np.abs(ref.u).max()
        np.testing.assert_allclose(
            u_batch[i, : mesh.num_nodes], ref.u, atol=1e-8 * scale
        )


def test_material_sweep_matches_individual_solves(metadata):
    """True material sweep: per-lane (E, nu, t) via the basis-stencil
    decomposition, exact per-lane multigrid. Parity vs one-at-a-time
    solve_system calls (bar: nu in [0.25, 0.35] to 1e-5)."""
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.parallel.sweep import material_sweep_solve

    mesh = rect_mesh(32, 16, width=2.0)  # grid (17, 33): coarsenable
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    nus = np.array([0.25, 0.29, 0.33, 0.35])
    e_moduli = np.array([69e9, 100e9, 69e9, 200e9])
    thicknesses = np.array([0.5, 0.5, 0.25, 1.0])
    b = nus.size
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    f_values = np.zeros((b, mesh.num_nodes, 2))

    result = material_sweep_solve(
        mesh, base, u_values, f_values, e_moduli, nus, thicknesses,
        iterations=25, dtype=np.float64,
    )
    rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
    assert rel.max() < 1e-8

    for i in range(b):
        md_i = ModelMetadata(
            youngs_modulus=e_moduli[i],
            poisson_ratio=nus[i],
            part_thickness=thicknesses[i],
            characteristic_length_min=0.0,
            characteristic_length_max=0.3,
        )
        ref = solve_system(mesh, base, md_i, SolverOptions(cg_rtol=1e-11))
        scale = np.abs(ref.u).max()
        np.testing.assert_allclose(
            np.asarray(result.u)[i], ref.u, atol=1e-5 * scale
        )
        np.testing.assert_allclose(
            np.asarray(result.von_mises)[i], ref.von_mises, rtol=1e-5
        )


def test_material_sweep_force_driven_lane(metadata):
    """A force-driven lane: u scales as 1/(E t) -- catches weight mixups."""
    from magnetite_tpu.parallel.sweep import material_sweep_solve

    mesh = rect_mesh(32, 16, width=2.0)
    n = mesh.num_nodes
    right = np.isclose(mesh.coords[:, 0], 2.0)
    left = np.isclose(mesh.coords[:, 0], 0.0)
    u_known = np.zeros((n, 2), dtype=bool)
    u_known[left] = True
    from magnetite_tpu.bc import BCArrays

    base = BCArrays(
        u_known=u_known,
        u_value=np.zeros((n, 2)),
        f_value=np.zeros((n, 2)),
    )
    f_values = np.zeros((2, n, 2))
    f_values[:, right, 0] = 1e6
    u_values = np.zeros((2, n, 2))
    e_moduli = np.array([69e9, 138e9])  # lane 1 = 2x stiffer
    nus = np.array([0.3, 0.3])
    thicknesses = np.array([0.5, 0.5])

    result = material_sweep_solve(
        mesh, base, u_values, f_values, e_moduli, nus, thicknesses,
        iterations=25, dtype=np.float64,
    )
    u = np.asarray(result.u)
    np.testing.assert_allclose(u[0], 2.0 * u[1], rtol=1e-6, atol=1e-12)


def test_material_sweep_requires_canonical_grid(metadata):
    from magnetite_tpu.meshing.core import Mesh
    from magnetite_tpu.parallel.sweep import material_sweep_solve

    mesh = rect_mesh(6, 4)
    plain = Mesh(coords=mesh.coords, tris=mesh.tris)
    base = tensile_bcs_for_rect(mesh.coords)
    with pytest.raises(ValueError, match="canonical"):
        material_sweep_solve(
            plain, base,
            np.zeros((1, mesh.num_nodes, 2)),
            np.zeros((1, mesh.num_nodes, 2)),
            np.array([69e9]), np.array([0.3]), np.array([0.5]),
        )


def test_material_sweep_shards_over_lanes(metadata):
    """Design lanes are independent, so the material sweep data-parallels
    over a device mesh by just sharding the batch axis of its inputs --
    GSPMD partitions the compiled solve with no code changes. Parity vs
    the replicated run."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from magnetite_tpu.parallel.sweep import compile_material_sweep

    mesh = rect_mesh(32, 16, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    compiled = compile_material_sweep(mesh, base, iterations=25, dtype=np.float64)

    b = 16
    rng = np.random.default_rng(2)
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    f_values = np.zeros((b, mesh.num_nodes, 2))
    e_moduli = rng.uniform(50e9, 200e9, b)
    nus = rng.uniform(0.25, 0.35, b)
    ts = rng.uniform(0.3, 1.0, b)

    plain = compiled.solve(u_values, f_values, e_moduli, nus, ts)

    device_mesh = jax.make_mesh((8,), ("lanes",))
    lane = NamedSharding(device_mesh, P("lanes"))
    args = [
        jax.device_put(np.asarray(a), lane)
        for a in (u_values, f_values, e_moduli, nus, ts)
    ]
    sharded = compiled.solve(*args)
    # the batched result must itself come back lane-sharded (no gather)
    assert not sharded.u.sharding.is_fully_replicated
    np.testing.assert_allclose(
        np.asarray(sharded.u), np.asarray(plain.u), rtol=0, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(sharded.von_mises),
        np.asarray(plain.von_mises),
        rtol=1e-12,
    )


def test_unstructured_amg_sweep_matches_individual_solves(metadata):
    """Fast sweeps on ARBITRARY meshes. One shared AMG
    hierarchy preconditions every k_scale lane exactly (V((sK))^-1 =
    (1/s)V(K)^-1), so lockstep iteration counts stay mesh-independent.
    Parity per lane vs the per-variant single solve, and TRUE relative
    residuals (pcg_fixed_iterations recomputes ||b - K x||) under 1e-5."""
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.04)
    assert mesh.grid_shape is None  # genuinely unstructured

    from tests.conftest import make_rule
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion

    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.04)

    b = 4
    k_scales = np.array([0.5, 1.0, 1.7, 3.0])
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    f_values = np.tile(bca.f_value[None], (b, 1, 1))
    # one force-driven lane: zero pull, distributed load on the right edge
    u_values[2] = np.where(bca.u_known, 0.0, u_values[2])
    f_values[2] = 0.0
    right = mesh.coords[:, 0] > 3.0 - 1e-6
    f_values[2, right, 1] = 1e6

    compiled = compile_unstructured_sweep(
        mesh, bca, md, iterations=30, dtype=np.float32
    )
    result = compiled.solve(u_values, f_values, k_scales)

    rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
    assert (rel < 1e-5).all(), rel

    for lane in range(b):
        md_l = ModelMetadata(69e9 * k_scales[lane], 0.33, 0.5, 0.0, 0.04)
        bca_l = bca
        if lane == 2:
            from magnetite_tpu.bc import BCArrays

            bca_l = BCArrays(
                u_known=bca.u_known,
                u_value=np.where(bca.u_known, 0.0, bca.u_value),
                f_value=f_values[2],
            )
        single = solve_system(mesh, bca_l, md_l, SolverOptions(cg_rtol=1e-10))
        scale_u = max(np.abs(single.u).max(), 1e-30)
        scale_vm = max(np.abs(single.von_mises).max(), 1e-30)
        assert np.abs(result.u[lane] - single.u).max() < 2e-4 * scale_u
        assert (
            np.abs(result.von_mises[lane] - single.von_mises).max()
            < 2e-4 * scale_vm
        )


def test_unstructured_amg_sweep_renumbers_band_hostile(metadata):
    """A shuffled node order must not break the sweep: compile renumbers,
    solves in the banded order, and returns results in the CALLER's order."""
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.meshing.core import Mesh
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep
    from tests.conftest import make_rule
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    base_mesh = triangulate([outer], 0.0, 0.06)
    rng = np.random.default_rng(7)
    shuffle = rng.permutation(base_mesh.num_nodes)  # new_id = shuffle[old]
    inv = np.empty_like(shuffle)
    inv[shuffle] = np.arange(base_mesh.num_nodes)
    mesh = Mesh(
        coords=base_mesh.coords[inv], tris=shuffle[base_mesh.tris]
    )

    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.06)

    compiled = compile_unstructured_sweep(
        mesh, bca, md, iterations=30, dtype=np.float32
    )
    assert compiled.perm is not None  # shuffled order forced a renumber

    b = 2
    result = compiled.solve(
        np.tile(bca.u_value[None], (b, 1, 1)),
        np.tile(bca.f_value[None], (b, 1, 1)),
        np.array([1.0, 2.0]),
    )
    single = solve_system(mesh, bca, md, SolverOptions(cg_rtol=1e-10))
    scale = max(np.abs(single.u).max(), 1e-30)
    assert np.abs(result.u[0] - single.u).max() < 2e-4 * scale
    # lane 1 at double stiffness, displacement-driven: same u
    assert np.abs(result.u[1] - single.u).max() < 2e-4 * scale


def test_unstructured_material_sweep_matches_individual_solves(metadata):
    """TRUE (E, nu, t) material sweep on a delaunay mesh: three basis DIA
    band sets + the basis AMG hierarchy (shared transfers, per-lane
    operators and diagonals combined on the fly) give every lane the exact
    V-cycle of its own material. Parity per lane vs solve_system."""
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.sweep import (
        compile_unstructured_material_sweep,
    )
    from tests.conftest import make_rule
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.04)

    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)

    b = 4
    rng = np.random.default_rng(3)
    e_mods = rng.uniform(50e9, 200e9, b)
    nus = rng.uniform(0.22, 0.38, b)
    ts = rng.uniform(0.2, 1.0, b)
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    f_values = np.tile(bca.f_value[None], (b, 1, 1))
    # one force-driven lane (exercises the deep-accuracy mixed path)
    u_values[1] = np.where(bca.u_known, 0.0, u_values[1])
    f_values[1] = 0.0
    right = mesh.coords[:, 0] > 3.0 - 1e-6
    f_values[1, right, 1] = 1e6

    compiled = compile_unstructured_material_sweep(
        mesh, bca, iterations=35, dtype=np.float32
    )
    result = compiled.solve(u_values, f_values, e_mods, nus, ts)

    rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
    assert (rel < 1e-5).all(), rel

    from magnetite_tpu.bc import BCArrays

    for lane in range(b):
        md_l = ModelMetadata(e_mods[lane], nus[lane], ts[lane], 0.0, 0.04)
        bca_l = bca
        if lane == 1:
            bca_l = BCArrays(
                u_known=bca.u_known,
                u_value=np.where(bca.u_known, 0.0, bca.u_value),
                f_value=f_values[1],
            )
        single = solve_system(mesh, bca_l, md_l, SolverOptions(cg_rtol=1e-10))
        scale_u = max(np.abs(single.u).max(), 1e-30)
        scale_vm = max(np.abs(single.von_mises).max(), 1e-30)
        assert np.abs(result.u[lane] - single.u).max() < 2e-4 * scale_u, lane
        assert (
            np.abs(result.von_mises[lane] - single.von_mises).max()
            < 2e-4 * scale_vm
        ), lane


def _unstructured_sweep_case():
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion, ModelMetadata
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from tests.conftest import make_rule

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.05)
    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
    return mesh, bca, md


def test_sweep_device_mesh_api_shards_and_matches():
    """compile_sweep(device_mesh=...): plain numpy batches in, the lane
    axis sharded over the mesh, results matching the single-device
    compile bit-for-bit (lane math never crosses lanes, so sharding must
    not change the arithmetic)."""
    from magnetite_tpu.parallel.sweep import compile_sweep

    mesh = rect_mesh(32, 16, width=2.0)  # grid (17, 33): coarsenable
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    from magnetite_tpu.config import ModelMetadata

    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.1)
    b = 16
    rng = np.random.default_rng(5)
    u_values = np.tile(base.u_value[None], (b, 1, 1))
    f_values = np.zeros((b, mesh.num_nodes, 2))
    k_scales = rng.uniform(0.5, 3.0, b)

    plain = compile_sweep(mesh, base, md, iterations=20, dtype=np.float64)
    res_1 = plain.solve(u_values, f_values, k_scales)

    device_mesh = jax.make_mesh((8,), ("lanes",))
    sharded = compile_sweep(
        mesh, base, md, iterations=20, dtype=np.float64,
        device_mesh=device_mesh,
    )
    res_s = sharded.solve(u_values, f_values, k_scales)
    assert not res_s.u.sharding.is_fully_replicated  # stayed lane-sharded
    np.testing.assert_allclose(
        np.asarray(res_s.u), np.asarray(res_1.u), rtol=0, atol=1e-13
    )
    np.testing.assert_allclose(
        np.asarray(res_s.von_mises), np.asarray(res_1.von_mises), rtol=1e-12
    )


def test_unstructured_sweep_device_mesh_parity():
    """AMG-lane sweeps shard their batch over a device mesh: replicated
    bands + hierarchy, lane-sliced variants, no solve-time collectives."""
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    mesh, bca, md = _unstructured_sweep_case()
    b = 8
    rng = np.random.default_rng(7)
    k_scales = rng.uniform(0.5, 3.0, b)
    u_values = np.tile(bca.u_value[None], (b, 1, 1))
    f_values = np.tile(bca.f_value[None], (b, 1, 1))

    plain = compile_unstructured_sweep(
        mesh, bca, md, iterations=25, dtype=np.float32
    )
    res_1 = plain.solve(u_values, f_values, k_scales)

    device_mesh = jax.make_mesh((8,), ("lanes",))
    sharded = compile_unstructured_sweep(
        mesh, bca, md, iterations=25, dtype=np.float32,
        device_mesh=device_mesh, amg_setup=plain.amg_setup,
    )
    res_s = sharded.solve(u_values, f_values, k_scales)
    assert not res_s.u.sharding.is_fully_replicated
    rel = np.asarray(res_s.residual_norm) / np.asarray(res_s.rhs_norm)
    assert (rel < 1e-5).all(), rel
    np.testing.assert_allclose(
        np.asarray(res_s.u), np.asarray(res_1.u), rtol=0, atol=1e-11
    )


def test_unstructured_material_sweep_device_mesh_parity():
    from magnetite_tpu.parallel.sweep import (
        compile_unstructured_material_sweep,
    )

    mesh, bca, _ = _unstructured_sweep_case()
    b = 8
    rng = np.random.default_rng(9)
    u_values = np.tile(bca.u_value[None], (b, 1, 1)).astype(np.float32)
    f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)
    e_moduli = rng.uniform(50e9, 200e9, b).astype(np.float32)
    nus = rng.uniform(0.25, 0.35, b).astype(np.float32)
    ts = rng.uniform(0.3, 1.0, b).astype(np.float32)

    plain = compile_unstructured_material_sweep(
        mesh, bca, iterations=30, dtype=np.float32
    )
    res_1 = plain.solve(u_values, f_values, e_moduli, nus, ts)

    device_mesh = jax.make_mesh((8,), ("lanes",))
    sharded = compile_unstructured_material_sweep(
        mesh, bca, iterations=30, dtype=np.float32, device_mesh=device_mesh
    )
    res_s = sharded.solve(u_values, f_values, e_moduli, nus, ts)
    assert not res_s.u.sharding.is_fully_replicated
    np.testing.assert_allclose(
        np.asarray(res_s.u), np.asarray(res_1.u), rtol=0, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(res_s.von_mises),
        np.asarray(res_1.von_mises),
        rtol=1e-5,
    )


def test_sweep_device_mesh_rejects_ragged_batch():
    from magnetite_tpu.parallel.sweep import compile_sweep
    from magnetite_tpu.config import ModelMetadata

    mesh = rect_mesh(32, 16, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.1)
    device_mesh = jax.make_mesh((8,), ("lanes",))
    compiled = compile_sweep(
        mesh, base, md, iterations=5, dtype=np.float64,
        device_mesh=device_mesh,
    )
    b = 12  # not divisible by 8
    with pytest.raises(ValueError, match="divide"):
        compiled.solve(
            np.tile(base.u_value[None], (b, 1, 1)),
            np.zeros((b, mesh.num_nodes, 2)),
            np.ones(b),
        )


def test_unstructured_sweep_amg_sweeps_override(metadata):
    """amg_sweeps reaches the lane V-cycle: at the SAME fixed iteration
    budget a pinned V(3,3) is a strictly stronger preconditioner than the
    V(1,1) auto default, so every lane's true relative residual must
    drop. (Auto stays V(1,1) in the fixed-budget cores -- a static budget
    cannot harvest an iteration cut -- so stronger cycles are opt-in for
    callers who also shrink the budget.)"""
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    mesh = triangulate([outer], 0.0, 0.03)

    from tests.conftest import make_rule
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion

    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.03)

    k_scales = np.array([0.5, 1.0, 2.0])
    u_values = np.tile(bca.u_value[None], (3, 1, 1))
    f_values = np.tile(bca.f_value[None], (3, 1, 1))

    v11 = compile_unstructured_sweep(mesh, bca, md, iterations=6)
    # the premise needs a real multi-level hierarchy: a too-small mesh
    # would take the exact dense-coarse path, where sweeps are moot
    assert v11.amg_setup.transfers
    v33 = compile_unstructured_sweep(
        mesh, bca, md, iterations=6, amg_sweeps=3, amg_setup=v11.amg_setup
    )
    r11 = v11.solve(u_values, f_values, k_scales)
    r33 = v33.solve(u_values, f_values, k_scales)
    rel11 = np.asarray(r11.residual_norm) / np.asarray(r11.rhs_norm)
    rel33 = np.asarray(r33.residual_norm) / np.asarray(r33.rhs_norm)
    assert (rel33 < rel11).all(), (rel33, rel11)


def _small_unstructured_case():
    """Shared fixture-builder: a tiny delaunay plate-with-hole + BCs."""
    from magnetite_tpu.config import BoundaryRegion, ModelMetadata
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.bc import apply_boundary_conditions
    from tests.conftest import make_rule

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.06)
    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.06)
    return mesh, bca, md


def test_unstructured_sweep_solve_factors_matches_dense(metadata):
    """solve_factors builds u = u_factors[b]*u_base, f = f_factors[b]*f_base
    on device from three [B] vectors; results must be identical (same jitted
    PCG, same lanes) to the dense solve() fed the equivalent [B, N, 2]
    fields. Guards the factor-form I/O shortcut bench.py relies on."""
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    mesh, bca, md = _small_unstructured_case()
    compiled = compile_unstructured_sweep(
        mesh, bca, md, iterations=20, dtype=np.float32
    )

    u_factors = np.array([1.0, 0.5, 2.0, 0.0])
    f_factors = np.array([1.0, 1.0, 0.25, 3.0])
    k_scales = np.array([1.0, 0.7, 1.0, 2.0])
    b = len(k_scales)

    u_values = u_factors[:, None, None] * np.tile(bca.u_value[None], (b, 1, 1))
    f_values = f_factors[:, None, None] * np.tile(bca.f_value[None], (b, 1, 1))

    dense = compiled.solve(u_values, f_values, k_scales)
    fact = compiled.solve_factors(u_factors, f_factors, k_scales)

    np.testing.assert_allclose(
        np.asarray(fact.u), np.asarray(dense.u), rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(fact.von_mises), np.asarray(dense.von_mises), rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(fact.residual_norm),
        np.asarray(dense.residual_norm),
        rtol=1e-6,
    )


def test_unstructured_material_sweep_solve_factors_matches_dense(metadata):
    """Material-lane analog: per-lane (E, nu, t) plus factor-scaled BCs must
    reproduce the dense-field solve exactly."""
    from magnetite_tpu.parallel.sweep import compile_unstructured_material_sweep

    mesh, bca, _ = _small_unstructured_case()
    compiled = compile_unstructured_material_sweep(
        mesh, bca, iterations=20, dtype=np.float32
    )

    u_factors = np.array([1.0, 0.5, 2.0])
    f_factors = np.array([1.0, 1.0, 0.25])
    e_moduli = np.array([69e9, 100e9, 50e9])
    nus = np.array([0.33, 0.3, 0.25])
    ts = np.array([0.5, 0.4, 0.6])
    b = len(e_moduli)

    u_values = u_factors[:, None, None] * np.tile(bca.u_value[None], (b, 1, 1))
    f_values = f_factors[:, None, None] * np.tile(bca.f_value[None], (b, 1, 1))

    dense = compiled.solve(u_values, f_values, e_moduli, nus, ts)
    fact = compiled.solve_factors(u_factors, f_factors, e_moduli, nus, ts)

    np.testing.assert_allclose(
        np.asarray(fact.u), np.asarray(dense.u), rtol=0, atol=0
    )
    np.testing.assert_allclose(
        np.asarray(fact.von_mises), np.asarray(dense.von_mises), rtol=0, atol=0
    )


def test_unstructured_sweep_solve_factors_device_mesh_parity():
    """solve_factors under a lane-sharded device mesh: the [B] factor
    vectors shard over lanes, u_base/f_base replicate, and the on-device
    field build + renumbering gather must reproduce the unsharded
    factor solve exactly."""
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    mesh, bca, md = _unstructured_sweep_case()
    b = 8
    rng = np.random.default_rng(11)
    u_factors = rng.uniform(0.5, 2.0, b).astype(np.float32)
    f_factors = np.ones(b, dtype=np.float32)
    k_scales = rng.uniform(0.5, 3.0, b)

    plain = compile_unstructured_sweep(
        mesh, bca, md, iterations=25, dtype=np.float32
    )
    res_1 = plain.solve_factors(u_factors, f_factors, k_scales)

    device_mesh = jax.make_mesh((8,), ("lanes",))
    sharded = compile_unstructured_sweep(
        mesh, bca, md, iterations=25, dtype=np.float32,
        device_mesh=device_mesh, amg_setup=plain.amg_setup,
    )
    res_s = sharded.solve_factors(u_factors, f_factors, k_scales)
    rel = np.asarray(res_s.residual_norm) / np.asarray(res_s.rhs_norm)
    assert (rel < 1e-5).all(), rel
    np.testing.assert_allclose(
        np.asarray(res_s.u), np.asarray(res_1.u), rtol=0, atol=1e-11
    )
