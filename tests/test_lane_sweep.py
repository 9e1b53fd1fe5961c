"""Lane-batched band matvecs and the unstructured AMG sweeps built on them.

The lane fields are [2, N, B] with the batch minormost; every lane must see
exactly the operator a single solve would (reference parity note: the
lane-batched analog of the reference's CSR SpMV hot loop,
src/solver.rs:23-37).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from magnetite_tpu.parallel.sweep import (
    _lane_weighted_band_matvec,
    lane_dia_matvec,
)

OFFSETS = tuple(sorted({0, 1, -1, 5, -5, 37, -37, 120, -120, 199, -199}))


def _dia_bands(rng, offsets, n, dtype=np.float32):
    """Random bands honoring the DIA zero contract (entries whose shifted
    index falls outside [0, N) are zero -- fem/dia.assemble_dia)."""
    bands = rng.standard_normal((len(offsets), 2, 2, n)).astype(dtype)
    for d, off in enumerate(offsets):
        idx = np.arange(n) + off
        bands[d][:, :, (idx < 0) | (idx >= n)] = 0.0
    return bands


def _dense(bands, offsets):
    """Per-lane dense operator [2N, 2N] (node-major DOFs) from bands."""
    d, m, _, n = bands.shape
    k = np.zeros((n, m, n, m))
    idx = np.arange(n)
    for b, off in enumerate(offsets):
        ok = (idx + off >= 0) & (idx + off < n)
        k[idx[ok], :, idx[ok] + off, :] += np.moveaxis(bands[b], -1, 0)[ok]
    return k.reshape(n * m, n * m)


def _apply_lanes(k, u):
    """Dense K on every lane of a [2, N, B] field."""
    two, n, b = u.shape
    flat = np.asarray(u, np.float64).transpose(1, 0, 2).reshape(2 * n, b)
    return (k @ flat).reshape(n, 2, b).transpose(1, 0, 2)


@pytest.mark.parametrize(
    "n,b,offsets",
    [
        (700, 128, OFFSETS),
        # N not a multiple of any tile; B at several lane widths
        (513, 128, (-3, -1, 0, 1, 3)),
        (300, 384, (-3, -1, 0, 1, 3)),
        (1025, 256, (-3, -1, 0, 1, 3)),
    ],
)
def test_lane_dia_matvec_matches_per_lane_dense(n, b, offsets):
    rng = np.random.default_rng(0)
    bands = _dia_bands(rng, offsets, n)
    u = rng.standard_normal((2, n, b)).astype(np.float32)
    got = np.asarray(lane_dia_matvec(jnp.asarray(bands), offsets, jnp.asarray(u)))
    want = _apply_lanes(_dense(bands, offsets), u)
    assert got.shape == (2, n, b)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_weighted_lane_matvec_matches_per_lane_dense():
    """Material lanes: K_b = wa_b Ka + wb_b Kb + wc_b Kc per lane."""
    rng = np.random.default_rng(2)
    n, b = 700, 128
    bands3 = tuple(_dia_bands(rng, OFFSETS, n) for _ in range(3))
    w3 = tuple(rng.uniform(0.5, 2.0, b).astype(np.float32) for _ in range(3))
    u = rng.standard_normal((2, n, b)).astype(np.float32)
    got = np.asarray(
        _lane_weighted_band_matvec(
            tuple(jnp.asarray(bk) for bk in bands3),
            OFFSETS,
            *(jnp.asarray(w) for w in w3),
            jnp.asarray(u),
        )
    )
    per_basis = [_apply_lanes(_dense(bk, OFFSETS), u) for bk in bands3]
    want = sum(y * w[None, None, :] for y, w in zip(per_basis, w3))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _plate():
    from tests.conftest import make_rule
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion, ModelMetadata
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.08)
    rules = (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )
    bca = apply_boundary_conditions(mesh.coords, rules)
    return mesh, bca, ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.08)


@pytest.mark.parametrize("material", [False, True])
def test_sweep_lanes_match_direct_solves(material):
    """compile_unstructured_*sweep on a real Delaunay mesh at 128 lanes: each
    lane solves its OWN operator. Load lanes converge within their budget
    and match a scipy direct solve; material lanes on this small mesh (one
    AMG level, so a Jacobi-preconditioned budget) are checked by their
    reported residual being the true f64 residual of that lane's operator."""
    from dataclasses import replace

    from magnetite_tpu import oracle
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.parallel.sweep import (
        compile_unstructured_material_sweep,
        compile_unstructured_sweep,
    )

    mesh, bca, md = _plate()
    b = 128
    rng = np.random.default_rng(3)
    u_values = np.tile(bca.u_value[None], (b, 1, 1)).astype(np.float32)
    u_values *= rng.uniform(0.5, 2.0, b).astype(np.float32)[:, None, None]
    f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)
    if material:
        e = rng.uniform(40e9, 250e9, b).astype(np.float32)
        nu = rng.uniform(0.22, 0.38, b).astype(np.float32)
        t = rng.uniform(0.2, 1.0, b).astype(np.float32)
        compiled = compile_unstructured_material_sweep(
            mesh, bca, iterations=30, refined=False
        )
        res = compiled.solve(u_values, f_values, e, nu, t)
        lane_md = [
            replace(md, youngs_modulus=float(e[i]), poisson_ratio=float(nu[i]),
                    part_thickness=float(t[i]))
            for i in range(b)
        ]
    else:
        s = rng.uniform(0.5, 2.0, b)
        compiled = compile_unstructured_sweep(
            mesh, bca, md, iterations=25, refined=False
        )
        res = compiled.solve(u_values, f_values, s)
        lane_md = [
            replace(md, youngs_modulus=md.youngs_modulus * s[i])
            for i in range(b)
        ]
    u = np.asarray(res.u)
    reported = np.asarray(res.residual_norm) / np.asarray(res.rhs_norm)
    for lane in (0, 37, 127):
        lane_bca = BCArrays(bca.u_known, u_values[lane].astype(np.float64),
                            f_values[lane].astype(np.float64))
        if material:
            k = oracle.sparse_stiffness(
                mesh.coords, mesh.tris, lane_md[lane].youngs_modulus,
                lane_md[lane].poisson_ratio, lane_md[lane].part_thickness,
            )
            true = oracle.true_relative_residual(k, lane_bca, u[lane])
            assert abs(true - reported[lane]) < 0.05 * reported[lane], (
                lane, true, reported[lane],
            )
            continue
        u_ref, _, _ = oracle.sparse_solve(
            mesh.coords, mesh.tris, lane_bca, lane_md[lane]
        )
        err = np.abs(u[lane] - u_ref).max() / np.abs(u_ref).max()
        assert err < 1e-4, (lane, err)


@pytest.mark.parametrize("material", [False, True])
def test_solve_factors_matches_dense_solve(material):
    """solve_factors (per-lane load factors, fields built on device) is
    exactly the dense solve() of u_base*factor / f_base*factor batches --
    the parametric API exists to skip the [B, N, 2] host upload, not to
    change semantics."""
    from magnetite_tpu.parallel.sweep import (
        compile_unstructured_material_sweep,
        compile_unstructured_sweep,
    )

    mesh, bca, md = _plate()
    b = 8
    rng = np.random.default_rng(4)
    u_factors = rng.uniform(0.5, 2.0, b).astype(np.float32)
    f_factors = np.ones(b, dtype=np.float32)
    # f32 base x f32 factor, matching the device-side product's rounding
    u_values = bca.u_value.astype(np.float32)[None] * u_factors[:, None, None]
    f_values = bca.f_value.astype(np.float32)[None] * f_factors[:, None, None]

    if material:
        ex = (
            rng.uniform(40e9, 250e9, b).astype(np.float32),
            rng.uniform(0.22, 0.38, b).astype(np.float32),
            rng.uniform(0.2, 1.0, b).astype(np.float32),
        )
        compiled = compile_unstructured_material_sweep(
            mesh, bca, iterations=8, refined=False
        )
    else:
        ex = (rng.uniform(0.5, 2.0, b),)
        compiled = compile_unstructured_sweep(
            mesh, bca, md, iterations=8, refined=False
        )

    dense = compiled.solve(u_values, f_values, *ex)
    fact = compiled.solve_factors(u_factors, f_factors, *ex)
    # identical math; the two jits may fuse/contract FMAs differently
    su = np.abs(np.asarray(dense.u)).max()
    sv = np.abs(np.asarray(dense.von_mises)).max()
    assert np.abs(np.asarray(fact.u) - np.asarray(dense.u)).max() < 1e-5 * su
    assert (
        np.abs(np.asarray(fact.von_mises) - np.asarray(dense.von_mises)).max()
        < 1e-5 * sv
    )
