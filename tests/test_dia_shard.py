"""Node-sharded unstructured DIA+AMG solves on the 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from magnetite_tpu.bc import apply_boundary_conditions
from magnetite_tpu.config import (
    BoundaryRegion,
    ModelMetadata,
    SolverOptions,
)
from magnetite_tpu.errors import SolverError
from magnetite_tpu.fem.solve import solve_system
from magnetite_tpu.meshing.delaunay_backend import triangulate
from magnetite_tpu.parallel.dia_shard import (
    make_halo_dia_operator,
    prepare_sharded_dia_problem,
    sharded_dia_pcg_solve,
)
from tests.conftest import make_rule

E, NU, T = 69e9, 0.33, 0.5
MD = ModelMetadata(E, NU, T, 0.0, 0.03)


@pytest.fixture(scope="module")
def device_mesh():
    assert len(jax.devices()) >= 8
    return jax.make_mesh((8,), ("nodes",))


@pytest.fixture(scope="module")
def plate():
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    # h=0.03 -> ~3.7k nodes: the AMG hierarchy actually coarsens
    return triangulate([outer, hole], 0.0, 0.03)


def _bca(mesh):
    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    return apply_boundary_conditions(mesh.coords, rules)


def test_halo_dia_matvec_matches_single_device(plate, device_mesh):
    from functools import partial

    from jax.sharding import NamedSharding, PartitionSpec as P

    bca = _bca(plate)
    problem = prepare_sharded_dia_problem(
        plate, bca, MD, device_mesh, dtype=np.float64
    )
    assert problem.perm is None  # delaunay order is already banded
    np_pad = problem.free.shape[1]
    n = plate.num_nodes

    rng = np.random.default_rng(0)
    v = np.zeros((2, np_pad))
    v[:, :n] = rng.standard_normal((2, n))
    v_d = jax.device_put(v, NamedSharding(device_mesh, P(None, "nodes")))

    def local_mv(bands, u):
        return make_halo_dia_operator(
            bands, problem.offsets, problem.halo, "nodes"
        )(u)

    mv = jax.jit(
        jax.shard_map(
            local_mv,
            mesh=device_mesh,
            in_specs=(P(None, None, None, "nodes"), P(None, "nodes")),
            out_specs=P(None, "nodes"),
            check_vma=False,
        )
    )
    got = np.asarray(mv(problem.bands, v_d))[:, :n]

    # single-device reference via the dense oracle-backed dia matvec
    import jax.numpy as jnp

    from magnetite_tpu.fem.dia import (
        assemble_dia_fused,
        build_dia_structure,
        dia_matvec,
    )

    s = build_dia_structure(plate.tris, n)
    bands_ref = assemble_dia_fused(
        jnp.asarray(plate.coords), jnp.asarray(plate.tris), E, NU, T,
        jnp.asarray(s.slot_ids), n, s.n_diags,
    )
    want = np.asarray(
        dia_matvec(bands_ref, tuple(int(o) for o in s.offsets), jnp.asarray(v[:, :n]))
    )
    np.testing.assert_allclose(got, want, atol=1e-10 * np.abs(want).max())


def test_sharded_dia_amg_solve_matches_single_device(plate, device_mesh):
    bca = _bca(plate)
    problem = prepare_sharded_dia_problem(
        plate, bca, MD, device_mesh, dtype=np.float64
    )
    result, ku = sharded_dia_pcg_solve(problem, rtol=1e-10, refined=True)
    assert bool(result.converged)
    assert int(result.iterations) < 80  # AMG regime, not block-Jacobi's 700+

    n = plate.num_nodes
    u_sharded = np.asarray(result.x)[:, :n].T
    reference = solve_system(
        plate, bca, MD, SolverOptions(preconditioner="amg", cg_rtol=1e-12)
    )
    scale = np.abs(reference.u).max()
    np.testing.assert_allclose(
        u_sharded, reference.u, rtol=1e-6, atol=1e-8 * scale
    )
    # force recovery parity on constrained nodes
    f_sharded = np.asarray(ku)[:, :n].T
    np.testing.assert_allclose(
        f_sharded[bca.u_known],
        reference.f[bca.u_known],
        rtol=1e-6,
        atol=1e-6 * np.abs(reference.f).max(),
    )


def test_sharded_dia_renumbers_shuffled_mesh(plate, device_mesh):
    from magnetite_tpu.meshing.reorder import apply_permutation

    rng = np.random.default_rng(5)
    shuffle = rng.permutation(plate.num_nodes)
    shuffled = apply_permutation(plate, shuffle)
    bca_s = _bca(shuffled)
    problem = prepare_sharded_dia_problem(
        shuffled, bca_s, MD, device_mesh, dtype=np.float64
    )
    assert problem.perm is not None
    result, _ = sharded_dia_pcg_solve(problem, rtol=1e-9, refined=True)
    assert bool(result.converged)

    # un-permute: solved order -> shuffled-mesh order
    n = shuffled.num_nodes
    u = np.asarray(result.x)[:, :n].T
    u_orig = np.empty_like(u)
    u_orig[problem.perm] = u
    reference = solve_system(shuffled, bca_s, MD, SolverOptions(cg_rtol=1e-11))
    np.testing.assert_allclose(
        u_orig, reference.u, atol=1e-8 * np.abs(reference.u).max()
    )


def test_refined_requires_f64(plate, device_mesh):
    problem = prepare_sharded_dia_problem(
        plate, _bca(plate), MD, device_mesh, dtype=np.float32
    )
    with pytest.raises(SolverError, match="float64"):
        sharded_dia_pcg_solve(problem, refined=True)


def test_sharded_amg_sweeps_override(plate, device_mesh):
    """amg_sweeps reaches the sharded V-cycle: a refined solve pinned to
    V(1,1) must take MORE f64 CG iterations than the auto V(3,3)
    schedule, while both converge to the same solution (the override the
    single-device test pins in tests/test_amg.py; plumbed via
    sharded_dia_pcg_solve -> _local_dia_solve)."""
    bca = _bca(plate)
    problem = prepare_sharded_dia_problem(
        plate, bca, MD, device_mesh, dtype=np.float64
    )
    auto, _ = sharded_dia_pcg_solve(problem, rtol=1e-9, refined=True)
    v11, _ = sharded_dia_pcg_solve(
        problem, rtol=1e-9, refined=True, amg_sweeps=1
    )
    assert bool(auto.converged) and bool(v11.converged)
    assert int(auto.iterations) < int(v11.iterations)
    n = plate.num_nodes
    ua, u1 = np.asarray(auto.x)[:, :n], np.asarray(v11.x)[:, :n]
    np.testing.assert_allclose(ua, u1, atol=1e-7 * np.abs(u1).max())
