"""Smoothed-aggregation AMG: Galerkin exactness, SPD symmetry, convergence.

The reference has no preconditioner at all (unpreconditioned argmin CG,
src/solver.rs:119-177); AMG is what makes the rebuild's unstructured-mesh
solves mesh-independent. These tests pin the algebra (A1 == P^T A0 P), the
CG-compatibility contract (symmetric V-cycle), and the convergence win.
"""

import numpy as np
import pytest

from magnetite_tpu.bc import apply_boundary_conditions
from magnetite_tpu.config import (
    BoundaryRegion,
    ModelMetadata,
    SolverOptions,
)
from magnetite_tpu.errors import SolverError
from magnetite_tpu.fem.amg import (
    _assemble_block_coo,
    amg_device_arrays,
    build_amg_setup,
    make_amg_preconditioner,
)
from magnetite_tpu.fem.solve import compile_problem, solve_system
from magnetite_tpu.meshing.delaunay_backend import triangulate
from tests.conftest import make_rule


@pytest.fixture
def plate():
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    # h=0.04 -> ~2.1k nodes: above the dense-coarsest threshold, so the
    # hierarchy really coarsens (712-node meshes stay single-level)
    return triangulate([outer, hole], 0.0, 0.04)


def _rules():
    return (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )


E, NU, T = 69e9, 0.33, 0.5
MD = ModelMetadata(E, NU, T, 0.0, 0.04)


def _dense_from_blocks(rows, cols, vals, n_rows, n_cols):
    """Scatter block-COO/ELL entries into a dense matrix (accumulating)."""
    mi, mj = vals.shape[-2], vals.shape[-1]
    d = np.zeros((n_rows * mi, n_cols * mj))
    for i in range(mi):
        for j in range(mj):
            np.add.at(d, (rows * mi + i, cols * mj + j), vals[..., i, j].reshape(-1))
    return d


def test_galerkin_coarse_operator_is_ptap(plate):
    """coarse_ops[0] must equal P^T A0 P exactly (dense cross-check)."""
    bca = apply_boundary_conditions(plate.coords, _rules())
    free = (~bca.u_known).astype(np.float64)
    setup = build_amg_setup(plate.coords, plate.tris, E, NU, T, free)
    n0 = plate.num_nodes

    rows, cols, vals = _assemble_block_coo(
        plate.coords, plate.tris, E, NU, T, free
    )
    a0 = _dense_from_blocks(rows, cols, vals, n0, n0)

    p_cols, p_vals, _, _ = setup.transfers[0]
    n1 = setup.level_sizes[1][0]
    wp = p_cols.shape[1]
    p_rows = np.repeat(np.arange(n0), wp)
    p = _dense_from_blocks(p_rows, p_cols.reshape(-1), p_vals.reshape(-1, 2, 3), n0, n1)

    a_cols, a_vals, _ = setup.coarse_ops[0]
    wa = a_cols.shape[1]
    a_rows = np.repeat(np.arange(n1), wa)
    a1 = _dense_from_blocks(a_rows, a_cols.reshape(-1), a_vals.reshape(-1, 3, 3), n1, n1)

    expected = p.T @ a0 @ p
    scale = np.abs(expected).max()
    np.testing.assert_allclose(a1, expected, atol=1e-8 * scale)


def test_rigid_body_modes_in_range_of_tentative_p(plate):
    """Unconstrained rigid-body motion must be reproducible through P
    (the SA design invariant): check on a BC-free setup."""
    free = np.ones((plate.num_nodes, 2))
    setup = build_amg_setup(plate.coords, plate.tris, E, NU, T, free)
    p_cols, p_vals, _, _ = setup.transfers[0]
    n0, n1 = setup.level_sizes[0][0], setup.level_sizes[1][0]
    wp = p_cols.shape[1]
    p_rows = np.repeat(np.arange(n0), wp)
    p = _dense_from_blocks(p_rows, p_cols.reshape(-1), p_vals.reshape(-1, 2, 3), n0, n1)
    c0 = plate.coords - plate.coords.mean(axis=0)
    # rotation mode [-y, x] per node, interleaved [ux0, uy0, ux1, ...]
    rot = np.stack([-c0[:, 1], c0[:, 0]], axis=-1).reshape(-1)
    # smoothing P preserves range(P0) up to (I - w Dinv A) action; the
    # EXACT invariant is that rot lies in range(P0), and since
    # P = (I - w Dinv A) P0 and A rot = 0 (no BCs), P c = (I - w Dinv A) rot
    # = rot for the coarse coefficients c that reproduce rot through P0.
    coeff, *_ = np.linalg.lstsq(p, rot, rcond=None)
    np.testing.assert_allclose(p @ coeff, rot, atol=1e-9 * np.abs(rot).max())


def test_vcycle_preconditioner_is_symmetric(plate):
    """<M r1, r2> == <r1, M r2> -- required for PCG correctness."""
    import jax.numpy as jnp

    from magnetite_tpu.fem.dia import (
        assemble_dia,
        block_jacobi_inverse_t,
        build_dia_structure,
        dia_diag_blocks,
        make_dia_operator,
    )
    from magnetite_tpu.fem.element import element_stiffness_matrices

    bca = apply_boundary_conditions(plate.coords, _rules())
    free = (~bca.u_known).astype(np.float64)
    setup = build_amg_setup(plate.coords, plate.tris, E, NU, T, free)
    amg = amg_device_arrays(setup, jnp.float64)

    n = plate.num_nodes
    s = build_dia_structure(plate.tris, n)
    ke = element_stiffness_matrices(
        jnp.asarray(plate.coords), jnp.asarray(plate.tris), E, NU, T
    )
    bands = assemble_dia(ke, s.slot_ids, n, s.n_diags)
    offsets = tuple(int(o) for o in s.offsets)
    matvec = make_dia_operator(bands, offsets)
    free_t = jnp.asarray(free.T)

    def op(v):
        return free_t * matvec(free_t * v) + (1.0 - free_t) * v

    jac0 = block_jacobi_inverse_t(dia_diag_blocks(bands, offsets), free_t)

    def a_op(v):
        return free_t * matvec(free_t * v)

    m = make_amg_preconditioner(amg, op, jac0, layout="t", a_op=a_op)

    rng = np.random.default_rng(0)
    r1 = jnp.asarray(rng.standard_normal((2, n)))
    r2 = jnp.asarray(rng.standard_normal((2, n)))
    lhs = float(jnp.sum(m(r1) * r2))
    rhs = float(jnp.sum(r1 * m(r2)))
    assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), abs(rhs))


def test_factored_transfers_match_stored_ell(plate):
    """The factored level-0 transfer composition P = (I - w Dinv A) P0
    (AMGSetup.fast0, applied band-matvec-side) must produce the SAME
    V-cycle as the stored smoothed-P ELL pair, and must refuse to run
    without the masked operator it needs."""
    import dataclasses

    import jax.numpy as jnp

    from magnetite_tpu.fem.dia import (
        assemble_dia,
        block_jacobi_inverse_t,
        build_dia_structure,
        dia_diag_blocks,
        make_dia_operator,
    )
    from magnetite_tpu.fem.element import element_stiffness_matrices

    bca = apply_boundary_conditions(plate.coords, _rules())
    free = (~bca.u_known).astype(np.float64)
    setup = build_amg_setup(plate.coords, plate.tris, E, NU, T, free)
    assert setup.fast0 is not None

    n = plate.num_nodes
    s = build_dia_structure(plate.tris, n)
    ke = element_stiffness_matrices(
        jnp.asarray(plate.coords), jnp.asarray(plate.tris), E, NU, T
    )
    bands = assemble_dia(ke, s.slot_ids, n, s.n_diags)
    offsets = tuple(int(o) for o in s.offsets)
    matvec = make_dia_operator(bands, offsets)
    free_t = jnp.asarray(free.T)

    def op(v):
        return free_t * matvec(free_t * v) + (1.0 - free_t) * v

    def a_op(v):
        return free_t * matvec(free_t * v)

    jac0 = block_jacobi_inverse_t(dia_diag_blocks(bands, offsets), free_t)

    amg_fast = amg_device_arrays(setup, jnp.float64)
    assert amg_fast[3]  # fast0 present
    assert amg_fast[0][0][0].size == 0  # stored level-0 pair NOT uploaded
    stored_setup = dataclasses.replace(setup, fast0=None)
    amg_stored = amg_device_arrays(stored_setup, jnp.float64)

    m_fast = make_amg_preconditioner(
        amg_fast, op, jac0, layout="t", a_op=a_op
    )
    m_stored = make_amg_preconditioner(amg_stored, op, jac0, layout="t")

    rng = np.random.default_rng(1)
    r = jnp.asarray(rng.standard_normal((2, n)))
    zf = np.asarray(m_fast(r))
    zs = np.asarray(m_stored(r))
    # identical math, different summation order: f64 roundoff only
    np.testing.assert_allclose(zf, zs, atol=1e-11 * np.abs(zs).max())

    with pytest.raises(ValueError, match="a_op"):
        make_amg_preconditioner(amg_fast, op, jac0, layout="t")

    # node-major layout parity too (the ELL solver path)
    def op_n(v):
        return op(v.T).T

    def a_op_n(v):
        return a_op(v.T).T

    def jac_n(v):
        return jac0(v.T).T

    m_fast_n = make_amg_preconditioner(
        amg_fast, op_n, jac_n, layout="n", a_op=a_op_n
    )
    np.testing.assert_allclose(
        np.asarray(m_fast_n(r.T)), zf.T, atol=1e-12 * np.abs(zf).max()
    )


def test_banded_coarse_levels_match_ell(plate):
    """Coarse levels converted to DIA bands (amg_device_arrays derives
    them from the ELL arrays) must give the SAME V-cycle as the gather
    ELL path -- identical math, different summation order."""
    import jax.numpy as jnp

    from magnetite_tpu.fem.amg import BandedOp, _block_ell_matvec
    from magnetite_tpu.fem.dia import (
        assemble_dia,
        block_jacobi_inverse_t,
        build_dia_structure,
        dia_diag_blocks,
        make_dia_operator,
    )
    from magnetite_tpu.fem.element import element_stiffness_matrices

    bca = apply_boundary_conditions(plate.coords, _rules())
    free = (~bca.u_known).astype(np.float64)
    setup = build_amg_setup(plate.coords, plate.tris, E, NU, T, free)
    amg = amg_device_arrays(setup, jnp.float64)
    assert len(amg) == 5
    coarse_bands = amg[4]
    assert len(coarse_bands) == len(setup.coarse_ops)
    # spatially-keyed aggregation keeps coarse graphs banded
    assert any(cb is not None for cb in coarse_bands)
    # single-vector uploads drop the (never-applied) ELL values of banded
    # levels; lane uploads keep ELL and drop the bands
    for (a_cols, a_vals, _), cb in zip(amg[1], coarse_bands):
        if cb is not None:
            assert a_vals.size == 0
    amg_lanes = amg_device_arrays(setup, jnp.float64, lanes=True)
    assert all(cb is None for cb in amg_lanes[4])
    # each BandedOp reproduces its ELL level exactly (ELL reference from
    # the host setup arrays)
    rng = np.random.default_rng(5)
    for (a_cols, a_vals, _), cb in zip(setup.coarse_ops, coarse_bands):
        if cb is None:
            continue
        assert isinstance(cb, BandedOp)
        x = jnp.asarray(rng.standard_normal((a_cols.shape[0], 3)))
        y_ell = np.asarray(
            _block_ell_matvec(jnp.asarray(a_cols), jnp.asarray(a_vals), x)
        )
        y_dia = np.asarray(make_dia_operator(cb.bands, cb.offsets)(x.T).T)
        np.testing.assert_allclose(
            y_dia, y_ell, atol=1e-11 * max(np.abs(y_ell).max(), 1e-30)
        )

    n = plate.num_nodes
    s = build_dia_structure(plate.tris, n)
    ke = element_stiffness_matrices(
        jnp.asarray(plate.coords), jnp.asarray(plate.tris), E, NU, T
    )
    bands = assemble_dia(ke, s.slot_ids, n, s.n_diags)
    offsets = tuple(int(o) for o in s.offsets)
    matvec = make_dia_operator(bands, offsets)
    free_t = jnp.asarray(free.T)

    def op(v):
        return free_t * matvec(free_t * v) + (1.0 - free_t) * v

    def a_op(v):
        return free_t * matvec(free_t * v)

    jac0 = block_jacobi_inverse_t(dia_diag_blocks(bands, offsets), free_t)

    m_banded = make_amg_preconditioner(amg, op, jac0, layout="t", a_op=a_op)
    m_ell = make_amg_preconditioner(
        amg_lanes[:4], op, jac0, layout="t", a_op=a_op
    )
    r = jnp.asarray(rng.standard_normal((2, n)))
    zb = np.asarray(m_banded(r))
    ze = np.asarray(m_ell(r))
    np.testing.assert_allclose(zb, ze, atol=1e-11 * np.abs(ze).max())


def test_amg_beats_block_jacobi_and_matches(plate):
    bca = apply_boundary_conditions(plate.coords, _rules())
    amg = solve_system(
        plate, bca, MD, SolverOptions(preconditioner="amg", cg_rtol=1e-10)
    )
    bj = solve_system(
        plate, bca, MD, SolverOptions(preconditioner="block_jacobi", cg_rtol=1e-10)
    )
    assert amg.iterations < bj.iterations / 5
    assert amg.residual_rel < 1e-9
    np.testing.assert_allclose(amg.u, bj.u, atol=1e-9 * np.abs(bj.u).max())


def test_amg_with_mixed_precision_refinement(plate):
    bca = apply_boundary_conditions(plate.coords, _rules())
    res = solve_system(
        plate,
        bca,
        MD,
        SolverOptions(preconditioner="amg", refine="on", cg_rtol=1e-11),
    )
    assert res.residual_rel < 1e-10
    exact = solve_system(
        plate, bca, MD, SolverOptions(preconditioner="amg", cg_rtol=1e-12)
    )
    np.testing.assert_allclose(
        res.u, exact.u, atol=1e-8 * np.abs(exact.u).max()
    )


def test_tiny_mesh_auto_amg_is_exact_dense_inverse():
    """Meshes that never coarsen (2N under the dense-coarsest cap) must
    auto-select "amg" and converge in a handful of CG iterations via the
    single-level exact inverse -- not run O(1/h) block-Jacobi counts
    (the 465-node linkedin case measured 170 iterations before this)."""
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.07)
    assert 2 * mesh.num_nodes <= 3072  # the tiny band this test pins
    bca = apply_boundary_conditions(mesh.coords, _rules())
    md = ModelMetadata(E, NU, T, 0.0, 0.07)
    problem = compile_problem(mesh, bca, md, SolverOptions(cg_rtol=1e-10))
    assert problem.preconditioner == "amg"
    assert problem.amg_setup.coarsest_inv is not None
    assert len(problem.amg_setup.level_sizes) == 1
    res = problem.solve()
    assert res.iterations <= 5
    assert res.residual_rel < 1e-10
    bj = solve_system(
        mesh, bca, md,
        SolverOptions(preconditioner="block_jacobi", cg_rtol=1e-10),
    )
    np.testing.assert_allclose(res.u, bj.u, atol=1e-9 * np.abs(bj.u).max())


def test_auto_picks_amg_above_threshold(plate):
    bca = apply_boundary_conditions(plate.coords, _rules())
    small = compile_problem(
        plate, bca, MD, SolverOptions(amg_auto_min_nodes=10**9)
    )
    assert small.preconditioner == "block_jacobi"
    big = compile_problem(plate, bca, MD, SolverOptions(amg_auto_min_nodes=1))
    assert big.preconditioner == "amg"


def test_amg_on_stencil_grid_raises():
    from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect

    mesh = rect_mesh(12, 8)
    bca = tensile_bcs_for_rect(mesh.coords)
    with pytest.raises(SolverError, match="amg"):
        solve_system(mesh, bca, MD, SolverOptions(preconditioner="amg"))


def test_amg_setup_persistence_roundtrip(plate, tmp_path):
    """save_amg/load_amg round-trip + compile_problem reuse: the cached
    hierarchy must produce the identical preconditioned solve."""
    from magnetite_tpu.persist import load_amg, save_amg

    bca = apply_boundary_conditions(plate.coords, _rules())
    opts = SolverOptions(preconditioner="amg", cg_rtol=1e-10)
    p1 = compile_problem(plate, bca, MD, opts)
    assert p1.amg_setup is not None
    path = str(tmp_path / "case.amg.npz")
    save_amg(path, p1.amg_setup)

    loaded = load_amg(path)
    p2 = compile_problem(plate, bca, MD, opts, amg_setup=loaded)
    assert p2.timings["amg_setup_s"] < p1.timings["amg_setup_s"]
    r1, r2 = p1.solve(), p2.solve()
    assert r1.iterations == r2.iterations
    np.testing.assert_allclose(r2.u, r1.u, rtol=0, atol=1e-14)

    # stale cache (node-count mismatch) silently rebuilds
    smaller = triangulate(
        [np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])], 0.0, 0.2
    )
    from magnetite_tpu.bc import BCArrays

    n = smaller.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_known[np.isclose(smaller.coords[:, 0], 0.0)] = True
    bca_s = BCArrays(
        u_known=u_known, u_value=np.zeros((n, 2)), f_value=np.zeros((n, 2))
    )
    bca_s.f_value[np.isclose(smaller.coords[:, 0], 1.0), 0] = 1e3
    p3 = compile_problem(smaller, bca_s, MD, opts, amg_setup=loaded)
    assert p3.solve().converged


def test_aggregation_caps_oversized_cells():
    """Graded meshes can pack thousands of nodes into one median-sized
    cell; the aggregation must split them so the padded per-aggregate QR
    stays bounded (found by review: multi-GB allocation otherwise)."""
    from magnetite_tpu.fem.amg import _MAX_AGG_SIZE, _aggregate_cells

    rng = np.random.default_rng(0)
    cluster = rng.uniform(0.0, 0.01, (5000, 2))  # one dense blob
    spread = rng.uniform(0.0, 10.0, (200, 2))
    coords = np.concatenate([cluster, spread])
    agg, centroids = _aggregate_cells(coords, cell=1.0)
    counts = np.bincount(agg)
    assert counts.max() <= _MAX_AGG_SIZE
    assert centroids.shape[0] == int(agg.max()) + 1
    # every node assigned, ids dense
    assert counts.min() >= 1


def test_amg_on_graded_mesh_converges():
    """Strongly graded mesh (local refinement ~8x): the aggregate-size cap
    keeps setup bounded and convergence must stay in the AMG regime."""
    from scipy.spatial import Delaunay

    from magnetite_tpu.meshing.core import Mesh, normalize_orientation

    rng = np.random.default_rng(3)
    # coarse background + a dense refined blob around (0.5, 0.5)
    xs = np.linspace(0, 2, 29)
    ys = np.linspace(0, 1, 15)
    gx, gy = np.meshgrid(xs, ys)
    coarse = np.stack([gx.ravel(), gy.ravel()], -1)
    coarse += rng.uniform(-0.01, 0.01, coarse.shape) * (
        (coarse[:, :1] > 0) & (coarse[:, :1] < 2)
    )
    blob = np.array([0.5, 0.5]) + rng.uniform(-0.12, 0.12, (1200, 2))
    pts = np.unique(np.concatenate([coarse, blob]), axis=0)
    tri = Delaunay(pts)
    mesh = normalize_orientation(
        Mesh(coords=pts, tris=tri.simplices.astype(np.int32))
    )

    n = mesh.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_known[np.isclose(pts[:, 0], 0.0)] = True
    u_value = np.zeros((n, 2))
    f_value = np.zeros((n, 2))
    f_value[np.isclose(pts[:, 0], 2.0), 0] = 1e5
    from magnetite_tpu.bc import BCArrays

    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=f_value)
    res = solve_system(
        mesh, bca, MD, SolverOptions(preconditioner="amg", cg_rtol=1e-9)
    )
    assert res.converged and res.residual_rel < 1e-8
    bj = solve_system(
        mesh, bca, MD, SolverOptions(preconditioner="block_jacobi", cg_rtol=1e-9)
    )
    assert res.iterations < bj.iterations / 3
    np.testing.assert_allclose(
        res.u, bj.u, atol=1e-8 * np.abs(bj.u).max()
    )


def test_amg_cache_fingerprint_governs_reuse(plate, tmp_path):
    """A cache saved from a RENUMBERED compile must be reused on recompile
    of the same mesh (deterministic renumber -> same ordering), while a
    cache from a different ordering of the same node count is rejected."""
    from magnetite_tpu.meshing.reorder import apply_permutation
    from magnetite_tpu.persist import load_amg, save_amg

    rng = np.random.default_rng(11)
    shuffled = apply_permutation(plate, rng.permutation(plate.num_nodes))
    bca = apply_boundary_conditions(shuffled.coords, _rules())
    opts = SolverOptions(preconditioner="amg", cg_rtol=1e-10)

    p1 = compile_problem(shuffled, bca, MD, opts)
    assert p1.perm is not None  # renumbering happened
    path = str(tmp_path / "case.amg.npz")
    save_amg(path, p1.amg_setup)

    # same mesh again: the cache must be accepted (the loaded setup object
    # itself becomes the compiled problem's hierarchy -- no rebuild)
    loaded = load_amg(path)
    p2 = compile_problem(shuffled, bca, MD, opts, amg_setup=loaded)
    assert p2.amg_setup is loaded
    assert p1.solve().iterations == p2.solve().iterations

    # a DIFFERENT shuffle of the same mesh: renumber converges to the same
    # banded ordering, so the fingerprint still matches and reuse is valid;
    # a cache built on the shuffled (pre-renumber) ordering must be REJECTED
    from magnetite_tpu.fem.amg import build_amg_setup

    foreign = build_amg_setup(
        shuffled.coords, shuffled.tris, E, NU, T,
        (~bca.u_known).astype(np.float64),
    )  # built on the band-hostile ordering compile_problem renumbers away
    p3 = compile_problem(shuffled, bca, MD, opts, amg_setup=foreign)
    # rejected -> rebuilt: the foreign setup is NOT the one used
    assert p3.amg_setup is not foreign
    assert p3.solve().iterations == p1.solve().iterations


def test_amg_sweeps_auto_cuts_refined_iterations(plate):
    """Refined solves (f64 CG + f32 V-cycle) auto-engage V(3,3): the extra
    cheap f32 smoothing sweeps must CUT the expensive f64 CG iteration
    count vs an explicit V(1,1), while both converge to the same answer
    (SolverOptions.amg_sweeps; measured 19 -> 12 at 23k nodes)."""
    bca = apply_boundary_conditions(plate.coords, _rules())
    auto = compile_problem(
        plate,
        bca,
        MD,
        SolverOptions(preconditioner="amg", refine="on", cg_rtol=1e-8),
    )
    res_auto = auto.solve()
    v11 = compile_problem(
        plate,
        bca,
        MD,
        SolverOptions(
            preconditioner="amg", refine="on", cg_rtol=1e-8, amg_sweeps=1
        ),
        amg_setup=auto.amg_setup,  # same hierarchy, different schedule
    )
    res_v11 = v11.solve()
    assert res_auto.residual_rel < 1e-8
    assert res_v11.residual_rel < 1e-8
    assert res_auto.iterations < res_v11.iterations
    np.testing.assert_allclose(
        res_auto.u, res_v11.u, atol=1e-6 * np.abs(res_v11.u).max()
    )


def test_amg_sweep_schedule_policy():
    """The shared schedule policy (fem.amg.amg_sweep_schedule): V(3,3)
    only under mixed precision, V(1,1) same-precision, override wins."""
    from magnetite_tpu.fem.amg import amg_sweep_schedule

    assert amg_sweep_schedule(True) == 3
    assert amg_sweep_schedule(False) == 1
    assert amg_sweep_schedule(True, 1) == 1
    assert amg_sweep_schedule(False, 4) == 4


def _level0_operators(plate, layout):
    """(setup, op, a_op, jac0, lift) for the plate in a V-cycle layout; lift
    maps a [2, N] field into that layout."""
    import jax.numpy as jnp

    from magnetite_tpu.fem.dia import (
        assemble_dia,
        block_jacobi_inverse_t,
        build_dia_structure,
        dia_diag_blocks,
        dia_matvec,
    )
    from magnetite_tpu.fem.element import element_stiffness_matrices
    from magnetite_tpu.parallel.sweep import lane_dia_matvec

    bca = apply_boundary_conditions(plate.coords, _rules())
    free = (~bca.u_known).astype(np.float64)
    setup = build_amg_setup(plate.coords, plate.tris, E, NU, T, free)
    n = plate.num_nodes
    s = build_dia_structure(plate.tris, n)
    ke = element_stiffness_matrices(
        jnp.asarray(plate.coords), jnp.asarray(plate.tris), E, NU, T
    )
    bands = assemble_dia(ke, s.slot_ids, n, s.n_diags)
    offsets = tuple(int(o) for o in s.offsets)
    free_t = jnp.asarray(free.T)
    jac_t = block_jacobi_inverse_t(dia_diag_blocks(bands, offsets), free_t)
    if layout == "tl":
        fl = free_t[:, :, None]

        def a_op(v):
            return fl * lane_dia_matvec(bands, offsets, fl * v)

        def jac0(v):
            return jnp.stack(
                [jac_t(v[..., k]) for k in range(v.shape[-1])], axis=-1
            )

        def lift(r):
            return jnp.stack([r, 2.0 * r], axis=-1)

    else:

        def a_t(v):
            return free_t * dia_matvec(bands, offsets, free_t * v)

        if layout == "t":
            a_op, jac0 = a_t, jac_t

            def lift(r):
                return r

        else:

            def a_op(v):
                return a_t(v.T).T

            def jac0(v):
                return jac_t(v.T).T

            def lift(r):
                return r.T

    fixed = 1.0 - (free_t[:, :, None] if layout == "tl" else
                   (free_t if layout == "t" else free_t.T))

    def op(v):
        return a_op(v) + fixed * v

    return setup, op, a_op, jac0, lift


@pytest.mark.parametrize("layout", ["t", "n", "tl"])
def test_factored_transfer_vcycle_is_adjoint_and_matches_stored_ell(
    plate, layout
):
    """In every layout the factored level-0 transfers P = (I - w D^-1 A) P0
    and P^T = P0^T (I - A w D^-1) are an exact adjoint pair (so the V-cycle
    is symmetric), and the cycle equals the one built on the stored
    smoothed-P ELL pair."""
    import dataclasses

    import jax.numpy as jnp

    setup, op, a_op, jac0, lift = _level0_operators(plate, layout)
    lanes = layout == "tl"
    fast = make_amg_preconditioner(
        amg_device_arrays(setup, jnp.float64, lanes=lanes), op, jac0,
        layout=layout, a_op=a_op,
    )
    stored = make_amg_preconditioner(
        amg_device_arrays(
            dataclasses.replace(setup, fast0=None), jnp.float64, lanes=lanes
        ),
        op, jac0, layout=layout,
    )
    rng = np.random.default_rng(7)
    r1 = lift(jnp.asarray(rng.standard_normal((2, plate.num_nodes))))
    r2 = lift(jnp.asarray(rng.standard_normal((2, plate.num_nodes))))
    lhs = float(jnp.sum(fast(r1) * r2))
    rhs = float(jnp.sum(r1 * fast(r2)))
    assert abs(lhs - rhs) < 1e-9 * max(abs(lhs), abs(rhs))
    zf, zs = np.asarray(fast(r1)), np.asarray(stored(r1))
    np.testing.assert_allclose(zf, zs, atol=1e-11 * np.abs(zs).max())
