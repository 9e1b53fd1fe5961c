"""The stencil, DIA and hybrid matvecs (plain jax.numpy, left to XLA) against
scipy.sparse matrices built entry by entry from the same arrays.

The shapes are the ones the hand-written kernels these operators replaced
were tested at: row counts that are not tile multiples, band reach across
many rows, exact power-of-two sizes, and ring-wrap offsets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from magnetite_tpu.fem.dia import (
    dia_matvec,
    dia_matvec_blocks,
    hybrid_matvec,
    make_dia_operator,
    make_hybrid_operator,
)
from magnetite_tpu.fem.element import element_stiffness_matrices
from magnetite_tpu.fem.stencil import (
    OFFSETS,
    assemble_stencil,
    build_stencil_structure,
    make_stencil_operator,
    stencil_matvec,
    stencil_to_dense,
)
from magnetite_tpu.meshing.generators import plate_with_hole_mesh, rect_mesh


def _stencil(mesh, metadata, dtype):
    rows, cols = mesh.grid_shape
    st = build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols)
    ke = element_stiffness_matrices(
        jnp.asarray(mesh.coords, dtype),
        jnp.asarray(mesh.tris),
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
    )
    return assemble_stencil(ke, st.slot_ids, rows, cols)


def _stencil_to_sparse(stencil: np.ndarray, wrap: bool):
    """Sparse twin of stencil_to_dense (same index rule, any size)."""
    _, _, _, r, c = stencil.shape
    rr, cc = np.meshgrid(np.arange(r), np.arange(c), indexing="ij")
    rows, cols, vals = [], [], []
    for s, (dr, dt) in enumerate(OFFSETS):
        r2, c2 = rr + dr, cc + dt
        ok = (r2 >= 0) & (r2 < r)
        if wrap:
            c2 = c2 % c
        else:
            ok &= (c2 >= 0) & (c2 < c)
        src = (rr * c + cc)[ok]
        dst = (r2 * c + c2)[ok]
        for i in range(2):
            for j in range(2):
                rows.append(2 * src + i)
                cols.append(2 * dst + j)
                vals.append(stencil[s, i, j][ok])
    n = 2 * r * c
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()


def _apply_grid(k, u):
    """Sparse K on a [2, R, C] field (node-major DOF order)."""
    two, r, c = u.shape
    y = k @ np.asarray(u, np.float64).transpose(1, 2, 0).reshape(-1)
    return y.reshape(r, c, 2).transpose(2, 0, 1)


@pytest.mark.parametrize("wrap", [True, False])
def test_sparse_stencil_reference_matches_stencil_to_dense(metadata, wrap):
    mesh = plate_with_hole_mesh(6, 16) if wrap else rect_mesh(9, 7)
    st = np.asarray(_stencil(mesh, metadata, np.float64))
    np.testing.assert_allclose(
        _stencil_to_sparse(st, wrap).toarray(), stencil_to_dense(st, wrap)
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize(
    "mesh_fn,wrap",
    [
        (lambda: plate_with_hole_mesh(24, 128), True),
        (lambda: rect_mesh(31, 127), False),  # rows not a power of two
    ],
)
def test_stencil_matvec_matches_sparse_reference(metadata, mesh_fn, wrap, dtype):
    mesh = mesh_fn()
    assert mesh.wrap_cols == wrap
    stencil = _stencil(mesh, metadata, dtype)
    rows, cols = mesh.grid_shape
    u = np.random.default_rng(0).standard_normal((2, rows, cols)).astype(dtype)
    got = np.asarray(stencil_matvec(stencil, jnp.asarray(u), wrap))
    want = _apply_grid(_stencil_to_sparse(np.asarray(stencil), wrap), u)
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(got, want, atol=tol * scale)


def test_stencil_operator_closure_is_the_matvec(metadata):
    mesh = plate_with_hole_mesh(8, 32)
    stencil = _stencil(mesh, metadata, np.float64)
    rows, cols = mesh.grid_shape
    u = jnp.asarray(np.random.default_rng(1).standard_normal((2, rows, cols)))
    np.testing.assert_array_equal(
        np.asarray(make_stencil_operator(stencil, True)(u)),
        np.asarray(stencil_matvec(stencil, u, True)),
    )


# ================================ DIA bands ==================================


def _random_dia(n, offsets, m=2, seed=0, dtype=np.float32):
    """Random bands zeroed wherever row + offset falls outside [0, n) -- the
    operator contract dia_matvec's wrapping rolls rely on."""
    rng = np.random.default_rng(seed)
    bands = rng.standard_normal((len(offsets), m, m, n)).astype(dtype)
    rows = np.arange(n)
    for k, off in enumerate(offsets):
        bad = (rows + off < 0) | (rows + off >= n)
        bands[k, :, :, bad] = 0.0
    return bands


def _dia_to_sparse(bands: np.ndarray, offsets):
    d, m, _, n = bands.shape
    rows, cols, vals = [], [], []
    idx = np.arange(n)
    for k, off in enumerate(offsets):
        ok = (idx + off >= 0) & (idx + off < n)
        for i in range(m):
            for j in range(m):
                rows.append(m * idx[ok] + i)
                cols.append(m * (idx[ok] + off) + j)
                vals.append(bands[k, i, j][ok])
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(m * n, m * n),
    ).tocsr()


def _apply_t(k, u):
    """Sparse K on an [m, N] field."""
    m, n = u.shape
    return (k @ np.asarray(u, np.float64).T.reshape(-1)).reshape(n, m).T


@pytest.mark.parametrize(
    "n,offsets",
    [
        # small offsets only (single-row reach)
        (9000, (-3, -1, 0, 1, 3)),
        # band reach across many rows, plus exact power-of-two offsets
        (9000, (-1300, -1024, -512, -37, 0, 37, 512, 1024, 1300)),
        # n a power of two
        (8192, (-513, -512, -511, 0, 511, 512, 513)),
        # annulus-style huge wrap offsets (ring connectivity)
        (8192, (-8000, -1, 0, 1, 8000)),
    ],
)
def test_dia_matvec_matches_sparse_reference(n, offsets):
    bands = _random_dia(n, offsets)
    u = np.random.default_rng(1).standard_normal((2, n)).astype(np.float32)
    got = np.asarray(make_dia_operator(jnp.asarray(bands), offsets)(u))
    want = _apply_t(_dia_to_sparse(bands, offsets), u)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_dia_matvec_3x3_blocks_matches_sparse_reference():
    """The m=3 form the coarse AMG levels use."""
    n, offsets = 5000, (-700, -2, 0, 2, 700)
    bands = _random_dia(n, offsets, m=3, seed=2, dtype=np.float64)
    u = np.random.default_rng(3).standard_normal((3, n))
    got = np.asarray(dia_matvec_blocks(jnp.asarray(bands), offsets, u))
    want = _apply_t(_dia_to_sparse(bands, offsets), u)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


def test_dia_matvec_f64_on_a_real_mesh_matches_oracle(metadata):
    """The f64 band matvec the refined CG runs, on an assembled operator."""
    from magnetite_tpu import oracle
    from magnetite_tpu.fem.dia import assemble_dia, build_dia_structure
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    mesh = triangulate([outer], 0.0, 0.06)
    n = mesh.num_nodes
    dia = build_dia_structure(mesh.tris, n)
    assert dia is not None
    coords = jnp.asarray(mesh.coords, jnp.float64)
    ke = element_stiffness_matrices(
        coords, jnp.asarray(mesh.tris), metadata.youngs_modulus,
        metadata.poisson_ratio, metadata.part_thickness,
    )
    bands = assemble_dia(ke, dia.slot_ids, n, dia.n_diags)
    offsets = tuple(int(o) for o in dia.offsets)
    u = np.random.default_rng(4).standard_normal((2, n))
    k = oracle.sparse_stiffness(
        mesh.coords, mesh.tris, metadata.youngs_modulus,
        metadata.poisson_ratio, metadata.part_thickness,
    )
    got = np.asarray(dia_matvec(bands, offsets, jnp.asarray(u)))
    want = _apply_t(k, u)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("n_rem", [1, 40])
def test_hybrid_operator_matches_sparse_reference(n_rem):
    n, offsets = 3000, (-60, -1, 0, 1, 60)
    rng = np.random.default_rng(5)
    bands = _random_dia(n, offsets, seed=6, dtype=np.float64)
    rem_rows = rng.integers(0, n, n_rem).astype(np.int32)
    rem_cols = rng.integers(0, n, n_rem).astype(np.int32)
    rem_vals = rng.standard_normal((n_rem, 2, 2))
    u = rng.standard_normal((2, n))
    k = _dia_to_sparse(bands, offsets) + sp.coo_matrix(
        (
            rem_vals.reshape(-1),
            (
                (2 * rem_rows[:, None, None] + np.arange(2)[None, :, None]
                 + 0 * np.arange(2)[None, None, :]).reshape(-1),
                (2 * rem_cols[:, None, None] + 0 * np.arange(2)[None, :, None]
                 + np.arange(2)[None, None, :]).reshape(-1),
            ),
        ),
        shape=(2 * n, 2 * n),
    )
    want = _apply_t(k.tocsr(), u)
    args = (jnp.asarray(bands), offsets, jnp.asarray(rem_vals),
            jnp.asarray(rem_rows), jnp.asarray(rem_cols))
    got = np.asarray(make_hybrid_operator(*args)(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())
    np.testing.assert_array_equal(
        got, np.asarray(hybrid_matvec(*args, jnp.asarray(u)))
    )
